"""Checkpoint/resume of ``repro_torch`` (``cfg.checkpoint``) and its
self-contained msgpack serializer, against the reference.

* ``repro_torch.comm.serialize.dumps`` is byte-equal to the reference's
  ``repro.comm.serialize.dumps`` (msgpack) on numpy trees that cross every
  msgpack size class; ``loads`` reads both, bf16 and NaN round-trip; the
  size estimator is byte-exact.
* Kill-and-resume continues bit for bit in the reference's four cases
  (params and the step-4 checkpoint), and with the EF store's rows spilled
  to the host tier.
* Checkpoints cross in both directions: one written by the reference
  resumes in the port within 1e-5 of the reference's uninterrupted run;
  one written by the port loads with the reference's ``load_checkpoint``.
* The store: tmp sweep, available steps, keep/gc; wrong engine and
  finetune mode refuse to resume.

Sizes are the reference's ``_make_trainer`` (``tests/test_torch_faults.py``).
"""
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

import repro_torch  # noqa: E402
from repro.checkpoint import store as ref_store  # noqa: E402
from repro.comm import serialize as ref_ser  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.comm import serialize as ser  # noqa: E402
from repro_torch.core.batched import BatchedExecutor  # noqa: E402
from repro_torch.core.tiered_store import TieredRowStore  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402
from test_torch_faults import (  # noqa: E402
    _make_trainer, _params_equal, _ref_trainer,
)

repro_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are tiny, and under
    a loaded parallel test run torch's thread pool made these runs some 20x
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the serializer
# ---------------------------------------------------------------------------

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
        2**63 - 1, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
        -2**31, -2**31 - 1, -2**63]
CASES = {
    "empty": {"d": {}, "l": [], "t": (), "s": "", "b": b""},
    "fixstr 31": "a" * 31,
    "str8 32": "b" * 32,
    "str8 255": "c" * 255,
    "str16 256": "d" * 256,
    "str32 65536": "e" * 65536,
    "bin8 255": b"x" * 255,
    "bin16 256": b"y" * 256,
    "bin32 65536": b"z" * 65536,
    "ints": INTS,
    "floats": [0.5, -0.0, float("inf"), float("nan"), 1e300],
    "nil and bools": [None, True, False],
    "fixarray 15 / array16 16": [list(range(15)), list(range(16))],
    "array32": list(range(65536)),
    "fixmap 15 / map16 16": [{f"k{i}": i for i in range(15)},
                             {f"k{i}": i for i in range(16)}],
    "map32": {str(i): i for i in range(65536)},
    "int keys": {1: "a", -5: "b"},
    "tuples": ({"a": (1, [2, (3,)])}, ()),
    "arrays": [np.zeros((0,), np.float32),
               np.arange(12, dtype=np.int64).reshape(3, 4),
               np.float32(3.5), np.int64(-7), np.ones((2, 3), bool),
               np.arange(70000, dtype=np.uint8),
               np.asfortranarray(np.arange(6, dtype=np.float64)
                                 .reshape(2, 3)),
               np.random.RandomState(0).get_state()[1]],
    "bfloat16": np.linspace(-2, 2, 9, dtype=np.float32).astype(
        ml_dtypes.bfloat16),
    "rng state": np.random.RandomState(3).get_state(),
}


@pytest.mark.parametrize("name", list(CASES))
def test_dumps_is_byte_equal_to_the_reference(name):
    tree = {"case": CASES[name], "n": name}
    want = ref_ser.dumps(tree)
    assert ser.dumps(tree) == want
    assert ser.message_bytes(tree) == len(want)
    assert ser.estimate_message_bytes(tree) == len(want)
    # and the port reads the reference's bytes as the reference does
    got, ref = ser.loads(want), ref_ser.loads(want)
    assert ref_ser.dumps(_as_numpy(got)) == ref_ser.dumps(ref)


def _as_numpy(tree):
    """Port-decoded tree -> the reference's types (bf16 tensors -> ml_dtypes
    numpy arrays) so the reference can re-encode it."""
    if isinstance(tree, torch.Tensor):
        return tree.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_numpy(v) for v in tree)
    return tree


def test_bf16_and_nan_round_trip_and_tensors_encode_as_their_arrays():
    bf = torch.tensor([1.5, -0.0, float("nan"), 3e38, -1e-38],
                      dtype=torch.bfloat16)
    f = torch.tensor([float("nan"), 1.0, -float("inf")])
    tree = {"bf": bf, "f": f, "loss": float("nan"), "i": torch.arange(3),
            "h": torch.tensor([1.0, 2.0], dtype=torch.float16)}
    back = ser.loads(ser.dumps(tree))
    assert back["bf"].dtype == torch.bfloat16
    assert torch.equal(back["bf"].view(torch.int16), bf.view(torch.int16))
    assert back["f"].dtype == np.float32
    assert np.array_equal(back["f"].view(np.int32),
                          f.numpy().view(np.int32))
    assert np.isnan(back["loss"])
    assert back["i"].dtype == np.int64 and back["h"].dtype == np.float16
    # a tensor encodes exactly as the numpy array of its values; a bf16
    # tensor as the reference's ml_dtypes array
    assert ser.dumps({"f": f}) == ref_ser.dumps({"f": f.numpy()})
    assert ser.dumps({"bf": bf}) == ref_ser.dumps(
        {"bf": bf.view(torch.int16).numpy().view(ml_dtypes.bfloat16)})
    assert ref_ser.loads(ser.dumps({"bf": bf}))["bf"].dtype.name == \
        "bfloat16"
    assert ser.estimate_message_bytes(tree) == ser.message_bytes(tree)
    with pytest.raises(ValueError, match="trailing"):
        ser.loads(ser.dumps(1) + b"\x00")


# ---------------------------------------------------------------------------
# the tiered store's snapshot
# ---------------------------------------------------------------------------


def test_tiered_store_state_spans_both_tiers_and_round_trips():
    s = TieredRowStore(2, spill="host", name="ef")
    gen = torch.Generator().manual_seed(0)
    vals = {c: [torch.randn(5, generator=gen), torch.randn(3, generator=gen)]
            for c in ("a", "b", "c", "d")}
    for c, v in vals.items():
        s.ensure([c], zero_shapes=[(5,), (3,)])
        s.scatter([c], [x[None] for x in v])
    assert set(s.spilled_ids()) == {"a", "b"} and set(s.rows) == {"c", "d"}
    snap = s.state()
    assert sorted(snap["clients"]) == ["a", "b", "c", "d"]
    t = TieredRowStore(1, spill="host", name="ef")   # another tier size
    t.load_state(ser.loads(ser.dumps(snap)))
    assert len(t) == 4 and not t.rows                # all warm
    for c, v in vals.items():
        got = t.gather([c], zero_shapes=[(5,), (3,)])
        assert all(torch.equal(g[0], x) for g, x in zip(got, v))


def test_ef_state_takes_the_legacy_dense_format():
    ex = BatchedExecutor(None, torch.device("cpu"))
    store_rows = [np.arange(12, dtype=np.float32).reshape(3, 4),
                  np.arange(6, dtype=np.float32).reshape(3, 2)]
    ex.load_ef_state({"rows": {"x": 2, "y": 0}, "store": store_rows})
    state = ex.ef_state()
    assert state["format"] == 2 and sorted(state["clients"]) == ["x", "y"]
    assert np.array_equal(np.asarray(state["clients"]["x"][0]),
                          store_rows[0][2])
    assert np.array_equal(np.asarray(state["clients"]["y"][1]),
                          store_rows[1][0])


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("execution,comp,faults,ef_rows", [
    ("sequential", "none", None, None),
    ("sequential", "stc", {"dropout_prob": 0.3, "seed": 5}, None),
    ("batched", "stc", {"dropout_prob": 0.3, "seed": 5}, None),
    ("batched", "int8", {"crash_prob": 0.3, "seed": 2}, None),
    ("batched", "stc", {"dropout_prob": 0.3, "seed": 5}, 2),
])
def test_kill_and_resume_is_bit_identical(tmp_path, monkeypatch, execution,
                                          comp, faults, ef_rows):
    """Run A trains 4 rounds straight; run B is killed after round 2 and
    resumed by a FRESH trainer from the checkpoint.  The final params and
    the step-4 checkpoint match bit for bit — the EF residuals and the
    fault sampler's decisions included.  ``ef_rows`` cuts the EF store's
    device tier so that rows sit on the host tier when they are saved.  The
    whole step-4 file is the same, measured times aside: the resumed run
    keeps the restored residuals of clients that have not trained since
    (the reference's save drops them)."""
    if ef_rows:
        monkeypatch.setattr(BatchedExecutor, "EF_MAX_CLIENTS", ef_rows)
    dir_a, dir_b = str(tmp_path / "A"), str(tmp_path / "B")
    ra = _make_trainer(execution, faults=faults, comp=comp, rounds=4,
                       ckpt={"every": 2, "dir": dir_a}).run()
    tb = _make_trainer(execution, faults=faults, comp=comp, rounds=4,
                       ckpt={"every": 2, "dir": dir_b})
    for r in range(2):                      # ... killed after round 2
        tb.run_round(r)
        tb._maybe_checkpoint(r + 1)
    if ef_rows:
        assert tb.engine._ef.spilled_ids()  # the host tier is in the save
    tc = _make_trainer(execution, faults=faults, comp=comp, rounds=4,
                       ckpt={"every": 2, "dir": dir_b})
    rc = tc.resume()
    assert _params_equal(ra["params"], rc["params"])
    assert len(rc["history"]) == 4
    cka = store.load_checkpoint(dir_a, 4)
    ckb = store.load_checkpoint(dir_b, 4)
    for a, b in zip(tree_leaves(cka["server"]["params"]),
                    tree_leaves(ckb["server"]["params"])):
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    assert [h["train_loss"] for h in cka["history"]] == \
        [h["train_loss"] for h in ckb["history"]]
    # the whole step-4 checkpoint, EF rows included, is the same file
    with open(store._path(dir_a, 4), "rb") as fa, \
            open(store._path(dir_b, 4), "rb") as fb:
        a, b = ser.loads(fa.read()), ser.loads(fb.read())
    for k in ("wall_time", "round_time"):   # measured, not state
        for h in a["history"] + b["history"]:
            h.pop(k)
    a["scheduler"] = b["scheduler"] = None
    assert ser.dumps(a) == ser.dumps(b)


def _ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("execution,comp", [("batched", "stc"),
                                            ("sequential", "int8")])
def test_reference_checkpoint_resumes_in_the_port(tmp_path, execution, comp):
    faults = {"dropout_prob": 0.3, "crash_prob": 0.1, "seed": 5}
    d = str(tmp_path / "ref")
    full = _ref_trainer(execution, faults, comp=comp, rounds=4,
                        ckpt={"every": 2, "dir": d}).run()   # uninterrupted
    port = _make_trainer(execution, faults=faults, comp=comp, rounds=4,
                         ckpt={"every": 2, "dir": d})
    res = port.resume(step=2)
    for a, b in zip(_ref_leaves(full["params"]), tree_leaves(res["params"])):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([h["train_loss"] for h in res["history"]],
                               [h["train_loss"] for h in full["history"]],
                               rtol=1e-4, atol=1e-4)
    for k in ("dropped", "crashed", "survivors"):
        assert [h[k] for h in res["history"]] == \
            [h[k] for h in full["history"]], k


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    d = str(tmp_path / "port")
    t = _make_trainer("batched", faults={"dropout_prob": 0.3, "seed": 5},
                      comp="stc", rounds=2, ckpt={"every": 2, "dir": d})
    t.run()
    ck = ref_store.load_checkpoint(d)
    assert ck["format"] == 1 and ck["round"] == 2
    assert ck["execution"] == "batched" and ck["finetune"] == "full"
    for a, b in zip(_ref_leaves(ck["server"]["params"]),
                    tree_leaves(t.server.params)):
        assert np.array_equal(a, b.numpy())
    assert ck["history"] == t.history
    ef = t.engine.ef_state()["clients"]
    assert ck["ef"]["format"] == 2 and sorted(ck["ef"]["clients"]) == \
        sorted(ef)
    for cid, rows in ef.items():
        assert all(np.array_equal(a, b.numpy())
                   for a, b in zip(ck["ef"]["clients"][cid], rows))
    state = t.server.rng.get_state()
    assert np.array_equal(ck["server"]["rng"][1], state[1])
    assert ck["server"]["rng"][2:] == state[2:]


def test_resume_with_wrong_engine_or_finetune_raises(tmp_path):
    d = str(tmp_path / "ck")
    _make_trainer("sequential", ckpt={"every": 2, "dir": d}, rounds=2).run()
    t = _make_trainer("batched", ckpt={"every": 2, "dir": d}, rounds=2)
    with pytest.raises(ValueError, match="same engine"):
        t.resume()
    state = store.load_checkpoint(d)
    state["finetune"] = "lora"
    store.save_checkpoint(d, state, step=2)
    t = _make_trainer("sequential", ckpt={"every": 2, "dir": d}, rounds=2)
    with pytest.raises(ValueError, match="finetune='lora'"):
        t.resume()


def test_checkpoint_sweeps_stale_tmp_and_lists_available_steps(tmp_path):
    d = str(tmp_path / "ck")
    os.makedirs(d)
    stale = os.path.join(d, "killed_mid_write.tmp")
    with open(stale, "wb") as f:
        f.write(b"partial")
    store.save_checkpoint(d, {"x": 1}, step=2)
    store.save_checkpoint(d, {"x": 2}, step=4)
    assert not os.path.exists(stale)
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    assert store.available_steps(d) == [2, 4]
    assert store.latest_step(d) == 4
    with pytest.raises(FileNotFoundError,
                       match=r"available steps: \[2, 4\]"):
        store.load_checkpoint(d, step=3)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        store.load_checkpoint(str(tmp_path / "none"))


def test_checkpoint_keep_gc(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        store.save_checkpoint(d, {"s": s}, step=s, keep=2)
    assert store.available_steps(d) == [4, 5]
    assert store.load_checkpoint(d) == {"s": 5}


def test_unported_settings_still_name_their_roadmap_items():
    from repro_torch.core.config import Config
    from repro_torch.core.rounds import unported_config

    def missing(**kw):
        return unported_config(Config.make(kw))

    assert missing(faults={"dropout_prob": 0.1},
                   resources={"round_deadline": 1.0},
                   checkpoint={"every": 1}) == []
    msg = "; ".join(missing(resources={"execution": "async"},
                            faults={"dropout_prob": 0.1},
                            checkpoint={"every": 1}))
    assert "fault injection under the async engine (ROADMAP M7)" in msg
    assert "checkpointing under the async engine (ROADMAP M7)" in msg
    assert missing(resources={"execution": "batched",
                              "distributed": "data"}) == [
        "resources.distributed='data' (ROADMAP M5.7)"]
