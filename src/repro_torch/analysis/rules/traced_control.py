"""FLC2xx — host-side Python constructs inside traced functions.

Under ``torch.func.vmap`` a Python ``if``/``while`` on a tensor raises
(a batched tensor has no single truth value); under ``grad`` or outside a
transform it syncs the host on every call, and in a CUDA-graph capture or
``torch.compile`` it breaks the graph or bakes in one branch.  Wall-clock
reads and NumPy RNG calls inside a captured program freeze to their
capture-time values.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set

from repro_torch.analysis.lint import (Finding, FuncInfo, ModuleInfo,
                                       attr_chain, make_finding)
from repro_torch.analysis.rules import Rule, register

FLC201 = Rule(
    id="FLC201",
    summary="Python 'if' on a traced value inside a traced function",
    hint="use torch.where on the tensor operands (or decide on the host "
         "before the transform)",
)
FLC202 = Rule(
    id="FLC202",
    summary="Python 'while' on a traced value inside a traced function",
    hint="loop a static number of times and mask finished iterations "
         "with torch.where",
)
FLC203 = Rule(
    id="FLC203",
    summary="wall-clock read inside a traced function",
    hint="time outside the transformed function (a capture freezes the "
         "value); pass timestamps in as arguments",
)
FLC204 = Rule(
    id="FLC204",
    summary="np.random call inside a traced function",
    hint="draw with a torch.Generator passed in (np.random runs on the "
         "host, once per capture)",
)

_CLOCK_CALLS = {"time.time", "time.perf_counter", "time.monotonic",
                "time.process_time", "datetime.now", "datetime.utcnow",
                "datetime.datetime.now", "datetime.datetime.utcnow"}


def _traced_function_for(info: ModuleInfo, node: ast.AST):
    encl = info.enclosing(node.lineno)
    return encl[-1] if encl and encl[-1].traced else None


def _traced_locals(fn: FuncInfo) -> Set[str]:
    """Names assigned from expressions that touch torch values."""
    traced: Set[str] = set()
    for node in ast.walk(fn.node):
        if not isinstance(node, ast.Assign):
            continue
        roots = {attr_chain(c).split(".")[0]
                 for c in ast.walk(node.value)
                 if isinstance(c, (ast.Attribute, ast.Name))}
        if roots & {"torch", "F"}:
            for tgt in node.targets:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name):
                        traced.add(n.id)
    return traced


def _test_traced_names(test: ast.AST, fn: FuncInfo,
                       traced_locals: Set[str]) -> List[str]:
    """Names in a condition that look traced.

    Identity tests (``x is None``) and ``isinstance`` checks are static
    even on batched tensors and are excluded, as are attribute reads off a
    name (``seg.mixer == "attn"``, ``cfg.window``): config/metadata
    structs ride through traced functions as static Python objects, and
    a tensor's ``.shape`` / ``.dtype`` / ``.device`` are static too."""
    skip: Set[int] = set()
    for node in ast.walk(test):
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            for sub in ast.walk(node):
                skip.add(id(sub))
        elif isinstance(node, ast.Call) \
                and attr_chain(node.func) in ("isinstance", "len",
                                              "hasattr", "callable"):
            for sub in ast.walk(node):
                skip.add(id(sub))
        elif isinstance(node, ast.Attribute):
            skip.add(id(node.value))
    names: List[str] = []
    for node in ast.walk(test):
        if id(node) in skip or not isinstance(node, ast.Name):
            continue
        if node.id in traced_locals or (
                node.id in fn.params):
            names.append(node.id)
    return names


def _control_findings(rule: Rule, info: ModuleInfo,
                      stmt_type) -> Iterable[Finding]:
    kw = "if" if stmt_type is ast.If else "while"
    for node in ast.walk(info.tree):
        if not isinstance(node, stmt_type):
            continue
        fn = _traced_function_for(info, node)
        if fn is None:
            continue
        names = _test_traced_names(node.test, fn, _traced_locals(fn))
        if names:
            yield make_finding(
                rule, info, node,
                f"'{kw} {'/'.join(sorted(set(names)))}' branches on a "
                f"traced value inside traced function '{fn.qualname}'")


@register(FLC201)
def check_if_on_traced(rule: Rule, info: ModuleInfo) -> List[Finding]:
    return list(_control_findings(rule, info, ast.If))


@register(FLC202)
def check_while_on_traced(rule: Rule, info: ModuleInfo) -> List[Finding]:
    return list(_control_findings(rule, info, ast.While))


@register(FLC203)
def check_clock_in_trace(rule: Rule, info: ModuleInfo) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(info.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = _traced_function_for(info, node)
        if fn is None:
            continue
        chain = attr_chain(node.func)
        if chain in _CLOCK_CALLS:
            out.append(make_finding(
                rule, info, node,
                f"'{chain}()' inside traced function '{fn.qualname}' "
                f"freezes to its capture-time value"))
    return out


@register(FLC204)
def check_np_random_in_trace(rule: Rule, info: ModuleInfo) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(info.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = _traced_function_for(info, node)
        if fn is None:
            continue
        chain = attr_chain(node.func)
        parts = chain.split(".")
        if len(parts) >= 3 and parts[0] in ("np", "numpy") \
                and parts[1] == "random":
            out.append(make_finding(
                rule, info, node,
                f"'{chain}' inside traced function '{fn.qualname}' draws "
                f"on the host, once per capture, not per call"))
    return out
