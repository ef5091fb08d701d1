"""flcheck for the port (``repro_torch.analysis``, ``scripts/flcheck_torch.py``):
each rule fires on a torch twin of ``tests/fixtures/flcheck/*_fire.py``
and stays quiet on the twin of its clean fixture, the config rules fire
on a synthetic tree, suppressions and the hot marker behave as the
reference's (``tests/test_flcheck.py``), ``src/repro_torch`` lints clean,
and the script's exit codes hold.

The twins are written into ``tmp_path`` from this file.  The reference's
``FLC301`` (buffer donation on ``jax.jit``) has no torch twin.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import RULES, lint_paths
from repro_torch.analysis.lint import ProjectContext, find_root, parse_module
from repro_torch.analysis.rules.config_rules import undocumented_config_fields

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "flcheck_torch.py"

TWINS = {
    "host_sync_fire.py": '''\
        """flcheck fixture (torch): FLC101/FLC102 firing cases."""
        import numpy as np
        import torch


        def round_step(updates, metrics):  # flcheck: hot
            torch.cuda.synchronize()                  # FLC101
            loss = metrics.cpu()                      # FLC101
            first = loss.item()                       # FLC101
            rows = updates.tolist()                   # FLC101
            return first, rows, loss.numpy()          # FLC101


        def per_client(metrics):  # flcheck: hot
            out = []
            for m in metrics:
                out.append(float(m))                  # FLC102
            total = metrics.sum
            return out, int(total)                    # FLC102


        def traced_mix(x):
            y = np.asarray(x)                         # FLC102 (under vmap)
            return torch.sum(torch.as_tensor(y))


        batched = torch.func.vmap(traced_mix)
        ''',
    "host_sync_clean.py": '''\
        """flcheck fixture (torch): FLC101/FLC102 clean twins."""
        import numpy as np
        import torch


        def round_step(updates, metrics):  # flcheck: hot
            losses = torch.stack(metrics)
            fetched = losses.cpu()  # flcheck: ignore[FLC101]  -- one batched end-of-round fetch
            return fetched


        def per_client(metrics, scale: float):  # flcheck: hot
            count = 0
            for _ in metrics:
                count += 1
            # annotated scalar param + constant-initialized counter: host
            return float(scale), float(count)


        def host_helper(x):
            # neither hot nor traced: host conversions are fine here
            return np.asarray(x), x.item(), x.cpu().tolist()
        ''',
    "traced_fire.py": '''\
        """flcheck fixture (torch): FLC201-FLC204 firing cases."""
        import time

        import numpy as np
        import torch


        def branchy(x):
            y = torch.abs(x)
            if y > 0:                        # FLC201
                return y
            while x > 0:                     # FLC202
                x = x - 1
            return x


        def clocked(x):
            t = time.time()                  # FLC203
            noise = np.random.rand(4)        # FLC204
            return (x + t + torch.as_tensor(noise)).sum()


        per_client = torch.func.vmap(branchy)
        grads = torch.func.grad(clocked)
        ''',
    "traced_clean.py": '''\
        """flcheck fixture (torch): FLC201-FLC204 clean twins."""
        import time

        import torch


        def branchless(x, flag=None, cfg=None):
            if flag is None:                 # identity test: static, clean
                flag = 0
            if cfg is not None and cfg.window:   # attribute read: static
                x = x[: cfg.window]
            y = torch.where(x > 0, x, -x)    # device-side select, clean
            return y + flag


        def host_loop(xs):
            t0 = time.time()                 # not traced: wall clock is fine
            while xs:                        # not traced: Python loop is fine
                xs = xs[:-1]
            return time.time() - t0


        per_client = torch.func.vmap(branchless)
        ''',
}


@pytest.fixture
def twins(tmp_path):
    for name, src in TWINS.items():
        (tmp_path / name).write_text(textwrap.dedent(src))
    return tmp_path


def lint_twin(root, name):
    return lint_paths([str(root / name)], root=str(root),
                      project_rules=False)


def rule_counts(findings):
    out = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return out


def test_rule_catalog_complete():
    expected = {"FLC101", "FLC102", "FLC201", "FLC202", "FLC203",
                "FLC204", "FLC401", "FLC402"}
    assert set(RULES) == expected          # FLC301 has no torch twin
    for rule in RULES.values():
        assert rule.id and rule.summary and rule.hint


def test_twins_are_valid_python(twins):
    for name in TWINS:
        compile((twins / name).read_text(), name, "exec")


def test_host_sync_fires(twins):
    counts = rule_counts(lint_twin(twins, "host_sync_fire.py"))
    # synchronize, .cpu(), .item(), .tolist(), .numpy()
    assert counts.get("FLC101") == 5
    # float(), int(), np.asarray under vmap
    assert counts.get("FLC102") == 3


def test_host_sync_clean_twin(twins):
    assert lint_twin(twins, "host_sync_clean.py") == []


def test_findings_format(twins):
    f = lint_twin(twins, "host_sync_fire.py")[0]
    line = f.format()
    assert line.startswith(f"{f.path}:{f.line} {f.rule} ")
    assert "(hint: " in line


def test_traced_control_fires(twins):
    counts = rule_counts(lint_twin(twins, "traced_fire.py"))
    assert counts == {"FLC201": 1, "FLC202": 1, "FLC203": 1, "FLC204": 1}


def test_traced_control_clean_twin(twins):
    assert lint_twin(twins, "traced_clean.py") == []


CONFIG_FIRE = '''\
from dataclasses import dataclass, field


@dataclass(frozen=True)
class FaultConfig:
    dropout_prob: float = 0.0
    seed: int = 0


@dataclass(frozen=True)
class Config:
    task_id: str = "task"
    faults: FaultConfig = field(default_factory=FaultConfig)


def validate_fault_config(cfg):
    if not 0 <= cfg.dropout_prob <= 1:
        raise ValueError("dropout_prob")


def validate_config(cfg):
    if not cfg.task_id:
        raise ValueError("task_id")
    validate_fault_config(cfg.faults)
'''

CONFIG_CLEAN = CONFIG_FIRE.replace(
    '        raise ValueError("dropout_prob")\n',
    '        raise ValueError("dropout_prob")\n'
    '    if not isinstance(cfg.seed, int):\n'
    '        raise ValueError("seed")\n')

DOC_FIRE = "`task_id` `faults` `dropout_prob`\n"
DOC_CLEAN = DOC_FIRE.rstrip() + " `seed`\n"


def _config_tree(tmp_path, config_src, doc):
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "config.md").write_text(doc)
    core = tmp_path / "src" / "core"
    core.mkdir(parents=True)
    (core / "config.py").write_text(config_src)
    return tmp_path / "src"


def test_config_rules_fire(tmp_path):
    src = _config_tree(tmp_path, CONFIG_FIRE, DOC_FIRE)
    findings = lint_paths([str(src)], root=str(tmp_path))
    counts = rule_counts(findings)
    assert counts.get("FLC401") == 1      # FaultConfig.seed unvalidated
    assert counts.get("FLC402") == 1      # FaultConfig.seed undocumented
    assert all("seed" in f.message for f in findings)


def test_config_rules_clean_twin(tmp_path):
    src = _config_tree(tmp_path, CONFIG_CLEAN, DOC_CLEAN)
    assert lint_paths([str(src)], root=str(tmp_path)) == []


def test_port_config_is_validated_and_documented():
    info = parse_module(
        str(REPO / "src" / "repro_torch" / "core" / "config.py"), str(REPO))
    ctx = ProjectContext(root=str(REPO), modules=[info])
    assert undocumented_config_fields(ctx) == []


def test_port_tree_is_flcheck_clean():
    assert lint_paths([str(REPO / "src" / "repro_torch")],
                      root=str(REPO)) == []


def test_suppression_and_hot_marker(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(
        "import torch\n\n\n"
        "def fetch(xs):  # flcheck: hot\n"
        "    return xs.cpu()\n\n\n"
        "def fetch_ok(xs):  # flcheck: hot\n"
        "    return xs.cpu()  # flcheck: ignore[FLC101]  -- why\n\n\n"
        "def helper(xs):\n"
        "    return xs.item()\n\n\n"
        "def caller(xs):  # flcheck: hot\n"
        "    return helper(xs)\n")
    findings = lint_paths([str(p)], root=str(tmp_path),
                          project_rules=False)
    assert [(f.rule, f.line) for f in findings] == [("FLC101", 5),
                                                    ("FLC101", 13)]
    assert "'helper'" in findings[1].message      # hot through the call


def test_find_root_locates_repo(twins):
    assert find_root(str(REPO / "src" / "repro_torch")) == str(REPO)


def _run_cli(*args):
    return subprocess.run([sys.executable, str(SCRIPT), *args],
                          capture_output=True, text=True, cwd=str(REPO),
                          timeout=120)


def test_cli_exit_codes(twins):
    bad = _run_cli(str(twins / "host_sync_fire.py"))
    assert bad.returncode == 1
    assert "FLC101" in bad.stdout and "finding(s)" in bad.stdout
    good = _run_cli(str(twins / "traced_clean.py"))
    assert good.returncode == 0, good.stdout + good.stderr
    assert "flcheck_torch: ok" in good.stdout
    missing = _run_cli(str(twins / "no_such_file.py"))
    assert missing.returncode == 2
    tree = _run_cli()                     # default: src/repro_torch
    assert tree.returncode == 0, tree.stdout + tree.stderr


def test_cli_self_documenting():
    r = _run_cli("--help")
    assert r.returncode == 0
    for rule_id in RULES:
        assert rule_id in r.stdout
    listed = _run_cli("--list-rules")
    assert listed.returncode == 0
    assert sorted(line.split()[0] for line in listed.stdout.splitlines()
                  if line.startswith("  FLC")) == sorted(RULES)


def test_cli_imports_neither_torch_nor_the_reference(twins):
    code = textwrap.dedent(f"""
        import runpy, sys
        ns = runpy.run_path({str(SCRIPT)!r})
        rc = ns["main"]([{str(twins / "traced_clean.py")!r}])
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("torch", "jax", "repro"))
        print("RC", rc, "LOADED", bad)
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(REPO), env=env, timeout=120)
    assert "RC 0 LOADED []" in out.stdout, out.stdout + out.stderr
