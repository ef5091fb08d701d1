"""FLC1xx — host synchronization on the hot path.

A hot function (see :mod:`repro_torch.analysis.lint` for the closure) runs
once per round for the whole cohort; any device->host transfer inside it
makes the host wait until every queued kernel finishes, and the card then
idles until the host enqueues the next.  The recurring form of this bug
is per-item Python conversion — ``float(metrics["loss"])`` once per batch
— instead of one stacked ``.cpu()`` at the end of the loop.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis.lint import (Finding, ModuleInfo, attr_chain,
                                       make_finding)
from repro_torch.analysis.rules import Rule, register

#: scalar annotations that mark a parameter as a host value already
_HOST_SCALAR_ANNOTATIONS = {"float", "int", "bool", "str", "bytes"}

FLC101 = Rule(
    id="FLC101",
    summary="explicit host sync (.item()/.cpu()/.tolist()/.numpy()/"
            "torch.cuda.synchronize) in a hot function",
    hint="fetch once per round outside the fast path, or suppress with "
         "'# flcheck: ignore[FLC101]  -- <why this one sync is intended>'",
)

FLC102 = Rule(
    id="FLC102",
    summary="implicit host conversion (float()/int()/bool() of a tensor, "
            "np.asarray under a transform) in a hot function",
    hint="keep the value on the device (torch) and convert once per round; "
         "annotate genuine scalar parameters as float/int/bool",
)

#: methods that copy a tensor to the host (no arguments)
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")


def _hot_function_for(info: ModuleInfo, node: ast.AST):
    encl = info.enclosing(node.lineno)
    return encl[-1] if encl and encl[-1].hot else None


def _walk_calls(info: ModuleInfo) -> Iterable[ast.Call]:
    for node in ast.walk(info.tree):
        if isinstance(node, ast.Call):
            yield node


@register(FLC101)
def check_explicit_sync(rule: Rule, info: ModuleInfo) -> List[Finding]:
    out: List[Finding] = []
    for call in _walk_calls(info):
        fn = _hot_function_for(info, call)
        if fn is None:
            continue
        chain = attr_chain(call.func)
        leaf = chain.split(".")[-1] if chain else ""
        if leaf == "synchronize":
            out.append(make_finding(
                rule, info, call,
                f"'{chain}' waits for the device inside hot function "
                f"'{fn.qualname}'"))
        elif isinstance(call.func, ast.Attribute) \
                and call.func.attr in _SYNC_METHODS and not call.args \
                and not call.keywords:
            recv = attr_chain(call.func.value) or "<expr>"
            out.append(make_finding(
                rule, info, call,
                f"'.{call.func.attr}()' on '{recv}' synchronizes inside hot "
                f"function '{fn.qualname}'"))
    return out


def _host_locals(fn) -> set:
    """Names bound to Python constants somewhere in the function —
    counters like ``n = 0`` are host values, not device arrays."""
    out = set()
    for node in ast.walk(fn.node):
        if not isinstance(node, ast.Assign):
            continue
        pairs = []
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                pairs.append((tgt, node.value))
            elif isinstance(tgt, (ast.Tuple, ast.List)) \
                    and isinstance(node.value, (ast.Tuple, ast.List)) \
                    and len(tgt.elts) == len(node.value.elts):
                pairs.extend(zip(tgt.elts, node.value.elts))
        for t, v in pairs:
            if isinstance(t, ast.Name) and isinstance(v, ast.Constant):
                out.add(t.id)
    return out


def _conversion_arg_flagged(call: ast.Call, fn) -> bool:
    """float()/int()/bool() with exactly one array-ish argument.

    Skipped: calls whose argument is itself a call (the conversion then
    rides on an already-host value such as ``float(np.mean(xs))``),
    constants, names that are scalar-annotated parameters of the
    enclosing function, and constant-initialized locals (counters)."""
    if len(call.args) != 1 or call.keywords:
        return False
    arg = call.args[0]
    if not isinstance(arg, (ast.Name, ast.Attribute, ast.Subscript)):
        return False
    if isinstance(arg, ast.Name):
        if arg.id in fn.params:
            ann = fn.annotations.get(arg.id, "")
            base = ann.replace("Optional[", "").rstrip("]").strip()
            if base in _HOST_SCALAR_ANNOTATIONS:
                return False
        if arg.id in _host_locals(fn):
            return False
    return True


@register(FLC102)
def check_implicit_conversion(rule: Rule, info: ModuleInfo) -> List[Finding]:
    out: List[Finding] = []
    for call in _walk_calls(info):
        encl = info.enclosing(call.lineno)
        fn = encl[-1] if encl else None
        if fn is None:
            continue
        chain = attr_chain(call.func)
        if fn.hot and chain in ("float", "int", "bool") \
                and _conversion_arg_flagged(call, fn):
            arg_txt = attr_chain(call.args[0]) or "<expr>"
            out.append(make_finding(
                rule, info, call,
                f"'{chain}({arg_txt})' forces a host transfer inside hot "
                f"function '{fn.qualname}'"))
        elif fn.traced and chain.split(".")[-1] in ("asarray", "array") \
                and chain.split(".")[0] in ("np", "numpy"):
            out.append(make_finding(
                rule, info, call,
                f"'{chain}' inside traced function '{fn.qualname}' leaves "
                f"the transform (fails on batched tensors, syncs otherwise)"))
    return out
