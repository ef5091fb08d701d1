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
        import torch
        repro_torch.set_device("cpu")
        femnist_cnn().init(torch.Generator().manual_seed(0))
        Config()
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
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_jax_or_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_entry_points_refuse_the_cpu_without_a_cuda_device():
    out = _run("""
        import repro_torch, torch
        assert not torch.cuda.is_available()
        for call in (lambda: repro_torch.init({"model": "linear",
                                               "dataset": "synthetic"}),
                     repro_torch.get_device,
                     lambda: repro_torch.set_device("cuda")
                     or repro_torch.get_device()):
            try:
                call()
            except RuntimeError as e:
                print("RAISED", e)
            else:
                print("RAN")
    """, CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("RAISED") == 3, out.stdout
    assert "set_device('cpu')" in out.stdout
