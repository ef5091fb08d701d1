"""Rule registry for the flcheck AST lint layer.

Every rule has an ID (``FLC...``), a one-line summary, and a one-line fix
hint; findings print as ``file:line RULE message (hint)`` and are
suppressed inline with ``# flcheck: ignore[RULE]`` (comma-separated for
several rules) plus a trailing reason.

Rule families:

* ``FLC1xx`` — host synchronization inside hot functions (the round's
  fast path and everything it calls),
* ``FLC2xx`` — host-side Python constructs inside traced functions (run
  under ``torch.func`` transforms, ``torch.compile`` or a capture),
* ``FLC4xx`` — FL-platform contracts (config validation + doc coverage).

The reference's ``FLC3xx`` (buffer donation on param-carrying ``jax.jit``
programs) has no twin: PyTorch has no donation — the port's programs
update their carried state in place, explicitly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List


@dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    hint: str
    #: "module" rules run once per scanned file; "project" rules run once
    #: per lint invocation (they inspect fixed files like core/config.py)
    scope: str = "module"


RULES: Dict[str, Rule] = {}
_CHECKERS: Dict[str, Callable] = {}


def register(rule: Rule):
    """Class/function decorator binding a checker to its rule ID."""

    def bind(checker: Callable) -> Callable:
        RULES[rule.id] = rule
        _CHECKERS[rule.id] = checker
        return checker

    return bind


def checkers_for_scope(scope: str) -> List:
    return [(RULES[rid], fn) for rid, fn in _CHECKERS.items()
            if RULES[rid].scope == scope]


# import for side effects: each module registers its rules
from repro_torch.analysis.rules import config_rules  # noqa: E402,F401
from repro_torch.analysis.rules import host_sync  # noqa: E402,F401
from repro_torch.analysis.rules import traced_control  # noqa: E402,F401
