"""flcheck for the PyTorch port — static analysis of ``src/repro_torch``.

    PYTHONPATH=src python scripts/flcheck_torch.py            # lint src/repro_torch
    PYTHONPATH=src python scripts/flcheck_torch.py src/repro_torch/core

Findings print as ``file:line RULE message (hint: ...)``; exit 1 when any
survive, 0 when none do, 2 on a bad argument.  Suppress a finding inline
with ``# flcheck: ignore[FLC101]`` (comma-separate several rule IDs) and
a trailing ``-- reason``; mark a function as hot with ``# flcheck: hot``
on (or directly above) its def.  The rules share the IDs of
``scripts/flcheck.py`` (the reference package's linter): FLC1xx host
syncs in hot functions, FLC2xx host-side Python inside ``torch.func``
transforms, FLC4xx config validation and doc coverage.  Rule catalog:
``--list-rules``.
"""
from __future__ import annotations

import argparse
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Reach repro_torch.analysis without executing repro_torch/__init__ (which
# imports the whole port, torch included): the lint layer is pure stdlib.
if "repro_torch" not in sys.modules:
    _pkg = types.ModuleType("repro_torch")
    _pkg.__path__ = [os.path.join(ROOT, "src", "repro_torch")]
    sys.modules["repro_torch"] = _pkg


def rule_catalog() -> str:
    from repro_torch.analysis.rules import RULES

    lines = []
    for rid in sorted(RULES):
        r = RULES[rid]
        lines.append(f"  {rid}  {r.summary}")
        lines.append(f"          fix: {r.hint}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="flcheck_torch",
        description=__doc__,
        epilog="rules:\n" + rule_catalog(),
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: "
                         "src/repro_torch)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(rule_catalog())
        return 0

    paths = args.paths or [os.path.join(ROOT, "src", "repro_torch")]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"flcheck_torch: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2
    from repro_torch.analysis.lint import lint_paths

    findings = lint_paths(paths, root=ROOT)
    for f in findings:
        print(f.format())
    if findings:
        rules = sorted({f.rule for f in findings})
        print(f"flcheck_torch: {len(findings)} finding(s) "
              f"[{', '.join(rules)}]")
        return 1
    print("flcheck_torch: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
