"""The port's contracts layer (``repro_torch.analysis.contracts``,
``scripts/flcheck_torch.py --contracts``) against the reference's
(``repro.analysis.contracts``), and the executor's capture bookkeeping on
the CPU: one build of each round program and none across rounds, no host
transfer in a program, one dispatch and one host sync a fused round, the
FLOPs equal to the reference's HLO counts, the gate's trips, the capture
key's storage part, and the routing rules of ``BatchedExecutor.capture``.
The CUDA graph itself runs on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 4p)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.analysis import contracts as ref_contracts  # noqa: E402
from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.core import batched  # noqa: E402
from repro_torch.core.batched import BatchedExecutor  # noqa: E402
from repro_torch.core.client import Client  # noqa: E402
from repro_torch.core.config import ClientConfig  # noqa: E402
from repro_torch.data.fed_data import ClientData  # noqa: E402
from repro_torch.models.small import linear_model  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "flcheck_torch.py"
CPU = torch.device("cpu")

repro_torch.set_device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its tensors are small, and
    under a loaded parallel test run torch's thread pool made such runs
    many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def report():
    return contracts.check_contracts(device=CPU)


def test_contracts_hold_against_the_committed_baseline(report):
    assert report.ok, report.format()
    assert report.baseline is not None
    for prefix in ("", "lora_", "tree_", "fused_"):
        assert getattr(report, f"{prefix}traces_first_round") == 1
        assert getattr(report, f"{prefix}retraces") == 0
        assert getattr(report, f"{prefix}host_transfer_ops") == []
    assert report.fused_dispatches_per_round == 1
    assert report.fused_host_syncs_per_round == 1
    assert report.fused_captures is None          # no CUDA graph on a CPU
    assert report.format().endswith("contracts: ok")


def test_flops_equal_the_reference_contracts(report, tmp_path):
    ref = ref_contracts.check_contracts(
        update_baseline=True, baseline_path=str(tmp_path / "ref.json"))
    assert (report.flops, report.fused_flops) == (ref.flops, ref.fused_flops)
    assert (report.flops, report.fused_flops) == (32768.0, 33312.0)


def test_contracts_gate_trips_on_a_bogus_baseline(tmp_path):
    """A zero build budget and a baseline recorded for a far smaller
    program are both violations."""
    bogus = tmp_path / "baseline.json"
    bogus.write_text(json.dumps(
        {"flops": 1.0, "hbm_bytes": 1.0, "fused_flops": 1.0,
         "fused_hbm_bytes": 1.0, "tolerance": 0.15}))
    bad = contracts.check_contracts(baseline_path=str(bogus), trace_budget=0,
                                    device=CPU)
    assert not bad.ok
    joined = "\n".join(bad.violations)
    assert "build budget" in joined and "roofline ratchet" in joined
    for key in ("flops", "hbm_bytes", "fused_flops", "fused_hbm_bytes"):
        assert f"round-program {key} " in joined
    assert bad.format().endswith("contracts: FAILED")


def test_contracts_missing_baseline_is_a_violation(tmp_path):
    bad = contracts.check_contracts(
        baseline_path=str(tmp_path / "nope.json"), device=CPU)
    assert not bad.ok
    assert any("no roofline baseline" in v for v in bad.violations)


def test_committed_baseline_matches_the_fixed_federation():
    with open(REPO / "scripts" / "roofline_baseline_torch.json") as f:
        base = json.load(f)
    assert base["program"] == {
        "model": f"linear(din={contracts.DIN}, classes={contracts.CLASSES})",
        "clients": contracts.N_CLIENTS,
        "local_steps": contracts.LOCAL_STEPS, "batch": contracts.BATCH}
    assert base["tolerance"] == contracts.TOLERANCE
    assert (base["flops"], base["fused_flops"]) == (32768.0, 33312.0)
    assert base["hbm_bytes"] > 0 and base["fused_hbm_bytes"] > 0


def test_detector_flags_a_round_function_with_a_seeded_item():
    model = linear_model(din=contracts.DIN, classes=contracts.CLASSES)
    opt, args = contracts._fixed_inputs(model, CPU)
    program = batched.make_round_program(model, opt, contracts.LOCAL_STEPS,
                                         use_prox=False, use_clip=False)

    def leaky(*a):
        out = program(*a)
        if out[1].mean().item() > 1e9:     # a host read inside the round
            raise AssertionError("unreachable")
        return out

    clean = contracts._host_transfers(program, *contracts._fused_args(args))
    found = contracts._host_transfers(leaky, *contracts._fused_args(args))
    assert clean == []
    assert found == ["aten._local_scalar_dense"]


def _clients(model, n, start=0, seed=0):
    rs = np.random.RandomState(seed)
    return [Client(f"c{start + i}", model,
                   ClientData(rs.randn(contracts.POOL_ROWS, contracts.DIN)
                              .astype(np.float32),
                              rs.randint(0, contracts.CLASSES,
                                         contracts.POOL_ROWS)
                              .astype(np.int32)),
                   ClientConfig(lr=0.1, local_epochs=1),
                   batch_size=contracts.BATCH)
            for i in range(n)]


class _Recorded:
    """Stands in for ``batched.CapturedRound`` on the CPU: records each
    capture and runs the round eagerly at each call."""
    made = []

    def __init__(self, run, inputs, device):
        self.run = run
        self.calls = 0
        _Recorded.made.append(self)

    def __call__(self, inputs):
        self.calls += 1
        return self.run(inputs)


def test_capture_key_changes_when_the_ef_store_grows(monkeypatch):
    """The EF store's leaves are read in place by a captured round, so
    their storage is part of the key: a store that grows gets new storage
    and the executor captures again at once (no second warm-up), while a
    bucket's second round captures and the rounds after it replay."""
    model = linear_model(din=contracts.DIN, classes=contracts.CLASSES)
    ex = BatchedExecutor(model, CPU)
    monkeypatch.setattr(batched, "CapturedRound", _Recorded)
    monkeypatch.setattr(_Recorded, "made", [])
    ex.capture = True          # the CUDA routing, with eager "graphs"
    gen = torch.Generator().manual_seed(0)
    first = _clients(model, 4)
    keys = []
    orig = batched.capture_key

    def spy(program, inputs, ef_leaves):
        keys.append(orig(program, inputs, ef_leaves))
        return keys[-1]

    monkeypatch.setattr(batched, "capture_key", spy)
    for r in range(3):
        ex.run_round_fused(first, model.init(gen), r, method="stc")
    # new clients of the same bucket: the first four fill the store's
    # free rows, the next four grow it past them
    alloc = ex._ef.alloc
    ex.run_round_fused(_clients(model, 4, start=4, seed=1), model.init(gen),
                       3, method="stc")
    assert ex._ef.alloc == alloc
    ex.run_round_fused(_clients(model, 4, start=8, seed=2), model.init(gen),
                       4, method="stc")
    assert ex._ef.alloc > alloc
    assert keys[0] == keys[1] == keys[2] == keys[3]
    assert keys[4][:2] == keys[3][:2] and keys[4][2] != keys[3][2]
    made = _Recorded.made
    assert len(made) == 2                 # round 1, then the growth
    assert [m.calls for m in made] == [3, 1]


def test_rounds_run_eagerly_on_the_cpu_and_under_a_mesh():
    model = linear_model(din=contracts.DIN, classes=contracts.CLASSES)
    cuda = torch.device("cuda", 0)
    assert BatchedExecutor(model, cuda).capture
    assert not BatchedExecutor(model, cuda, capture=False).capture
    assert not BatchedExecutor(model, CPU).capture
    assert not BatchedExecutor(model, cuda, distributed="data",
                               devices=[cuda, cuda]).capture


def test_run_cohort_stacked_builds_its_program_once():
    model = linear_model(din=contracts.DIN, classes=contracts.CLASSES)
    ex = BatchedExecutor(model, CPU)
    clients = _clients(model, 4)
    params = model.init(torch.Generator().manual_seed(0))
    batched.make_cohort_program.cache_clear()
    n0 = batched.cohort_trace_count()
    a = ex.run_cohort_stacked(clients, params, 0)
    assert batched.cohort_trace_count() - n0 == 1
    b = ex.run_cohort_stacked(clients, params, 0)
    assert batched.cohort_trace_count() - n0 == 1
    np.testing.assert_array_equal(a["loss"], b["loss"])


def test_flcheck_torch_contracts_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(SCRIPT), "--contracts",
                          "--device", "cpu"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.rstrip().endswith("contracts: ok")
