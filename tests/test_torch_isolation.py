"""The port stands alone: it imports neither jax nor the reference package,
and without a CUDA device it refuses to run unless asked for the CPU."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _run(code, **env):
    full = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=full,
                          timeout=120)


def test_importing_the_port_loads_neither_jax_nor_repro():
    out = _run("""
        import sys
        import repro_torch
        from repro_torch.core.config import Config
        from repro_torch.models import femnist_cnn
        from repro_torch.configs import get_arch
        from repro_torch.configs.shapes import SHAPES
        from repro_torch.core import federated
        from repro_torch.launch import train
        from repro_torch.models import moe, rglru
        from repro_torch.models.model import Model
        from repro_torch.configs import (
            deepseek_v2_lite_16b, nemotron4_340b, paligemma_3b,
            recurrentgemma_9b, whisper_small,
        )
        import torch
        repro_torch.set_device("cpu")
        femnist_cnn().init(torch.Generator().manual_seed(0))
        Config()
        train.main(["--arch", "qwen3-moe-30b-a3b", "--steps", "1",
                    "--batch", "1", "--seq", "8"])
        federated.fed_input_specs(Model(get_arch("glm4-9b", reduced=True)),
                                  SHAPES["train_4k"], 2,
                                  federated.FedRoundConfig())
        for arch in ("nemotron-4-340b", "paligemma-3b",
                     "deepseek-v2-lite-16b", "recurrentgemma-9b",
                     "whisper-small"):
            Model(get_arch(arch)).defs()
        train.main(["--arch", "whisper-small", "--steps", "1", "--batch",
                    "1", "--seq", "8"])
        rglru.init_state(get_arch("recurrentgemma-9b", reduced=True), 1)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        print("LOADED", bad)
    """)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "scripts" / "flcheck_torch.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_jax_or_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "scripts" / "flcheck_torch.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_msgpack_or_ml_dtypes(path):
    """The card machine has neither: the checkpoint format is written and
    read by ``repro_torch.comm.serialize`` alone."""
    for name in _imports(path):
        assert name.split(".")[0] not in ("msgpack", "ml_dtypes"), \
            f"{path}: {name}"


def test_entry_points_refuse_the_cpu_without_a_cuda_device():
    """``init``, the remote entry points, the train driver and the service
    CLI's server and client roles raise without a card; its registry and
    tracker roles are host code, run, and leave CUDA uninitialized."""
    out = _run("""
        import repro_torch, torch
        from repro_torch.launch import service, train
        assert not torch.cuda.is_available()
        cfg = {"model": "linear", "dataset": "synthetic"}
        for call in (lambda: repro_torch.init(cfg),
                     repro_torch.get_device,
                     lambda: repro_torch.set_device("cuda")
                     or repro_torch.get_device(),
                     lambda: repro_torch.set_device(None)
                     or repro_torch.start_server({}),
                     lambda: repro_torch.start_client({}),
                     lambda: service.main(["server", "--oneshot"]),
                     lambda: service.main(["client", "--oneshot"]),
                     lambda: train.main(["--steps", "1"])):
            try:
                call()
            except RuntimeError as e:
                print("RAISED", e)
            else:
                print("RAN")
        for role in ("registry", "tracker"):
            service.main([role, "--oneshot"]).stop()
        print("CUDA INITIALIZED", torch.cuda.is_initialized())
    """, CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("RAISED") == 8, out.stdout
    assert "RAN" not in out.stdout, out.stdout
    assert "set_device('cpu')" in out.stdout
    assert "registry listening on 127.0.0.1:" in out.stdout
    assert "tracker listening on 127.0.0.1:" in out.stdout
    assert "CUDA INITIALIZED False" in out.stdout


def test_importing_the_deploy_package_needs_no_yaml():
    """The card's machine has no PyYAML: only ``write_artifacts`` imports
    it."""
    out = _run("""
        import sys
        import repro_torch.deploy
        from repro_torch.deploy import compose, dockerfile, k8s_manifests
        compose(2), dockerfile(), k8s_manifests(2)
        print("YAML", "yaml" in sys.modules)
    """)
    assert out.returncode == 0, out.stderr
    assert "YAML False" in out.stdout, out.stdout
