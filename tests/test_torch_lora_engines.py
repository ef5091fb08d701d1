"""LoRA (``client.finetune = "lora"``) beyond the batched engine, with
compression, under faults and across a kill-and-resume, against the
reference.

All runs use the LoRA slice's well-conditioned setting
(``tests/test_torch_lora.py``: ``tiny_lm``, rank 4 / alpha 8 on the
attention projections) with the reference's frozen base and starting
adapters injected.

* the sequential engine (eager steps through ``local_train.client_grads``
  on the adapter leaves; with the flash flag on, the flash ops under
  ``torch.func.grad`` without ``vmap``) and the async engine (FedBuff
  waves of adapters) against the reference's same engine: params 1e-5,
  train loss 1e-4, ``comm_up_bytes`` exact;
* batched LoRA with STC and with int8 (K2 / K3 on the adapter leaves)
  against the reference.  STC turns rounding into whole flips, and on
  adapters whose first updates are near zero this setting is chaotic: a
  1e-7-perturbed start moves the reference itself by ~3e-3 in one round.
  So these runs are held within max(1e-5, twice that reach, measured
  here), and int8's as well (one quantization step flips by the same
  mechanism, by ~3e-5 after three rounds); bytes within the reference
  test's STC bar (2% + 16), exact for int8;
* batched LoRA under faults against the reference under the same faults;
* a LoRA kill-and-resume, bit for bit under deterministic mode.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro as ref_api  # noqa: E402
import repro_torch  # noqa: E402
from repro.core.rounds import Trainer as RefTrainer  # noqa: E402
from repro.models import lora as ref_lora  # noqa: E402
from repro.models.llm import tiny_lm as ref_tiny_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.comm import serialize as ser  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core.rounds import Trainer  # noqa: E402
from repro_torch.kernels import attention as kattention  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models.llm import tiny_lm as port_tiny_lm  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402
from test_torch_lora import ATTN, SLICE, _InjectedBase, _max_diff  # noqa: E402

repro_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are small, and
    under a loaded parallel test run torch's thread pool made these runs
    many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_START = {}


def _start():
    """The reference trainer's frozen base and starting adapters (both
    from ``PRNGKey(0)``, its ``cfg.seed``) as numpy."""
    if not _START:
        model = ref_tiny_lm()
        base = model.init(jax.random.PRNGKey(0))
        adapters = ref_lora.lora_wrap(model, base, 4, 8.0, ATTN).init(
            jax.random.PRNGKey(0))
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        _START.update(base=to_np(base), adapters=to_np(adapters))
    return _START["base"], _START["adapters"]


def _cfg(execution, rounds=2, **over):
    cfg = {**SLICE, "server": {**SLICE["server"], "rounds": rounds},
           "resources": {"execution": execution}}
    for section, values in over.items():
        cfg[section] = {**cfg.get(section, {}), **values}
    return cfg


def _ref(cfg, perturb=0.0):
    ref_api.reset()
    ref_api.init(cfg)
    ctx = ref_api.core.api._ctx
    trainer = RefTrainer(ctx.config, ctx.model, ctx.fed_data,
                         tracker=ctx.tracker)
    trainer.server.params = jax.tree_util.tree_map(
        lambda t: t * (1.0 + perturb),
        trainer.model.init(jax.random.PRNGKey(0)))
    try:
        return trainer.run()
    finally:
        ref_api.reset()


def _port_trainer(cfg):
    base, adapters = _start()
    repro_torch.reset()
    repro_torch.register_model(_InjectedBase(port_tiny_lm(), base))
    repro_torch.init(cfg)
    ctx = api._ctx
    trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                      tracker=ctx.tracker)
    trainer.server.params = convert.params_from_jax(adapters)
    return trainer


def _port(cfg, flash=False):
    trainer = _port_trainer(cfg)
    port_attention.set_flash_attention(flash)
    try:
        return trainer.run()
    finally:
        port_attention.set_flash_attention(None)
        repro_torch.register_model(port_tiny_lm())
        repro_torch.reset()


def _gaps(port_res, ref_res):
    params = _max_diff(convert.params_to_numpy(port_res["params"]),
                       ref_res["params"])
    loss = max(abs(a["train_loss"] - b["train_loss"])
               for a, b in zip(port_res["history"], ref_res["history"]))
    return params, loss


def _bytes(res):
    return np.array([h["comm_up_bytes"] for h in res["history"]])


@pytest.mark.parametrize("execution,flash", [("sequential", True),
                                             ("sequential", False),
                                             ("async", False)])
def test_lora_engines_match_the_reference(execution, flash):
    cfg = _cfg(execution)
    if execution == "async":       # overlapping waves, aggregations of 2
        cfg["resources"].update(buffer_size=2, max_concurrency=4)
    ref_res = _ref(cfg)
    before = kattention.fwd_launches
    res = _port(cfg, flash)
    assert kattention.fwd_launches == before      # CPU: the plain versions
    params, loss = _gaps(res, ref_res)
    assert params <= 1e-5 and loss <= 1e-4, (params, loss)
    assert _bytes(res).tolist() == _bytes(ref_res).tolist()
    assert len(res["history"]) == len(ref_res["history"]) == 2
    # the trained tree is the adapters only
    assert sorted(res["params"]) == sorted(ref_res["params"])


@pytest.mark.parametrize("method", ["stc", "int8"])
def test_batched_lora_with_compression_matches_the_reference(method):
    cfg = _cfg("batched", client={"compression": method})
    ref_res = _ref(cfg)
    reach = max(_max_diff(_ref(cfg, p)["params"], ref_res["params"])
                for p in (1e-7, -1e-7))
    res = _port(cfg)
    params, loss = _gaps(res, ref_res)
    bar = max(1e-5, 2 * reach)
    assert params <= bar, (params, reach)
    assert loss <= 1e-4, loss
    ub, up = _bytes(ref_res), _bytes(res)
    if method == "int8":
        assert up.tolist() == ub.tolist()
    else:
        assert np.abs(ub - up).max() <= 0.02 * ub.max() + 16, (ub, up)


def test_batched_lora_under_faults_matches_the_reference():
    cfg = _cfg("batched", rounds=3,
               faults={"dropout_prob": 0.25, "nan_update_prob": 0.25,
                       "seed": 4})
    ref_res = _ref(cfg)
    res = _port(cfg)
    params, loss = _gaps(res, ref_res)
    assert params <= 1e-5 and loss <= 1e-4, (params, loss)
    for key in ("dropped", "rejected", "survivors", "comm_up_bytes"):
        assert [h[key] for h in res["history"]] == \
            [h[key] for h in ref_res["history"]], key
    assert sum(h["dropped"] + h["rejected"] for h in res["history"]) > 0


@pytest.mark.parametrize("execution,method", [("batched", "stc"),
                                              ("sequential", "int8")])
def test_lora_kill_and_resume_is_bit_identical(tmp_path, execution, method):
    """Run A trains 3 rounds straight; run B is killed after round 2 and a
    FRESH trainer resumes it from its checkpoint: adapters, EF residuals
    of the adapter leaves and the step-3 checkpoint bit for bit."""
    def cfg(d):
        return _cfg(execution, rounds=3, client={"compression": method},
                    checkpoint={"every": 1, "dir": d})
    dir_a, dir_b = str(tmp_path / "A"), str(tmp_path / "B")
    with _deterministic():
        ra = _port(cfg(dir_a))
        tb = _port_trainer(cfg(dir_b))
        for r in range(2):                 # ... killed after round 2
            tb.run_round(r)
            tb._maybe_checkpoint(r + 1)
        tc = _port_trainer(cfg(dir_b))
        rc = tc.resume()
        repro_torch.register_model(port_tiny_lm())
        repro_torch.reset()
    for a, b in zip(tree_leaves(ra["params"]), tree_leaves(rc["params"])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    a = store.load_checkpoint(dir_a, 3)
    b = store.load_checkpoint(dir_b, 3)
    assert a["finetune"] == "lora"
    for h in a["history"] + b["history"]:
        for k in ("wall_time", "round_time"):   # measured, not state
            h.pop(k)
    a["scheduler"] = b["scheduler"] = None
    assert ser.dumps(a) == ser.dumps(b)


class _deterministic:
    """``torch.use_deterministic_algorithms(True)`` for a block."""

    def __enter__(self):
        self.was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.was)


def test_lora_base_follows_the_shard_device(monkeypatch):
    """A shard of the sharded cohort on another device than the frozen
    base merges with its own copy of the base, made once a device (here
    the ``meta`` device stands in for a second card)."""
    from repro_torch.models import lora as port_lora

    model = port_tiny_lm()
    base = model.init(torch.Generator().manual_seed(0), "cpu")
    wrapped = port_lora.lora_wrap(model, base, 4, 8.0, ATTN)
    adapters = wrapped.init(torch.Generator().manual_seed(1), "cpu")
    x = torch.zeros((2,) + tuple(model.input_shape), dtype=torch.long)
    on_meta = {k: {n: t.to("meta") for n, t in ab.items()}
               for k, ab in adapters.items()}
    out = wrapped.apply(on_meta, x.to("meta"))
    assert out.device.type == "meta"
    assert out.shape == wrapped.apply(adapters, x).shape
    merged = []
    real = port_lora.merge_lora
    monkeypatch.setattr(port_lora, "merge_lora", lambda b, a, s: (
        merged.append(b), real(b, a, s))[1])
    wrapped.apply(on_meta, x.to("meta"))
    wrapped.apply(on_meta, x.to("meta"))
    wrapped.apply(adapters, x)
    first = tree_leaves(merged[0])[0]
    assert first.device.type == "meta" and merged[0] is merged[1]
    assert merged[2] is base              # the base's own device: no copy


def test_reset_drops_the_cached_client_steps():
    """``reset`` clears the sequential engine's cached client steps as well
    as the round programs: a LoRA model's step closes over its frozen base
    (6.14 GiB for the 2-layer GLM-4-9B of ``chip_smoke.py`` phase 4b,
    which stayed on the card after the sequential LoRA run)."""
    from repro_torch.core.batched import make_round_program
    from repro_torch.core.local_train import make_client_step
    from repro_torch.optim import sgd
    make_client_step(port_tiny_lm(), sgd(0.1))
    assert make_client_step.cache_info().currsize >= 1
    repro_torch.reset()
    assert make_client_step.cache_info().currsize == 0
    assert make_round_program.cache_info().currsize == 0
