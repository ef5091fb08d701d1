"""FLC4xx — FL-platform config contracts.

The low-code promise means a config knob IS the user interface: every
field must fail loudly when out of range (reachable from a ``validate_*``
function in ``core/config.py``) and be documented (backticked in
``docs/config.md``).

Both rules are AST-only — they never import the config module — so they
work on fixture trees in tests and cannot be fooled by import-time side
effects.  In the port they read ``src/repro_torch/core/config.py`` against
the repo's one ``docs/config.md`` (the port keeps the reference's config
tree, field for field).
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.lint import Finding, ModuleInfo, attr_chain
from repro_torch.analysis.rules import Rule, register

FLC401 = Rule(
    id="FLC401",
    summary="config field not reachable from any validate_* function in "
            "core/config.py",
    hint="add a range/type check (or a delegation line) to a validate_* "
         "function so a bad value fails at init, not mid-round",
    scope="project",
)
FLC402 = Rule(
    id="FLC402",
    summary="config field not documented (backticked) in docs/config.md",
    hint="document the knob in docs/config.md — `field` — including its "
         "default and what it trades off",
    scope="project",
)

#: classes whose fields FLC401 requires to be validated
VALIDATED_CLASSES = ("Config", "FaultConfig", "CheckpointConfig")

CONFIG_SUFFIX = "core/config.py"
DOC_RELPATH = os.path.join("docs", "config.md")


@dataclass
class _ConfigModule:
    info: ModuleInfo
    #: class name -> [(field name, annotation string, line)]
    fields: Dict[str, List[Tuple[str, str, int]]]
    #: field names referenced from validate_* bodies (attrs, dict keys)
    validated: Set[str]


def _dataclass_fields(cls: ast.ClassDef) -> List[Tuple[str, str, int]]:
    out = []
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                          ast.Name):
            ann = ""
            try:
                ann = ast.unparse(stmt.annotation)
            except Exception:
                pass
            out.append((stmt.target.id, ann, stmt.lineno))
    return out


def _is_dataclass(cls: ast.ClassDef) -> bool:
    for deco in cls.decorator_list:
        chain = attr_chain(deco if not isinstance(deco, ast.Call)
                           else deco.func)
        if chain.split(".")[-1] == "dataclass":
            return True
    return False


def parse_config_module(info: ModuleInfo) -> _ConfigModule:
    fields: Dict[str, List[Tuple[str, str, int]]] = {}
    module_dicts: Dict[str, Set[str]] = {}
    for node in info.tree.body:
        if isinstance(node, ast.ClassDef) and _is_dataclass(node):
            fields[node.name] = _dataclass_fields(node)
        elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                         ast.Dict):
            keys = {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    module_dicts[tgt.id] = keys

    validated: Set[str] = set()
    for fn in info.functions:
        if not fn.name.startswith("validate_") or fn.parent is not None:
            continue
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Attribute):
                validated.add(node.attr)
            elif isinstance(node, ast.Name) and node.id in module_dicts:
                validated |= module_dicts[node.id]
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                # getattr-style loops name fields in string literals
                validated.add(node.value)
    return _ConfigModule(info=info, fields=fields, validated=validated)


def _reachable_from_config(cfg: _ConfigModule) -> List[str]:
    """Config-class names reachable from Config via field annotations."""
    seen: List[str] = []
    queue = ["Config"]
    while queue:
        name = queue.pop(0)
        if name in seen or name not in cfg.fields:
            continue
        seen.append(name)
        for _, ann, _ in cfg.fields[name]:
            for other in cfg.fields:
                if other != name and other in ann and other not in seen:
                    queue.append(other)
    return seen


def _find_config(ctx) -> Optional[_ConfigModule]:
    info = ctx.module_by_suffix(CONFIG_SUFFIX)
    if info is None:
        return None
    return parse_config_module(info)


@register(FLC401)
def check_validation_coverage(rule: Rule, ctx) -> List[Finding]:
    cfg = _find_config(ctx)
    if cfg is None:
        return []
    out: List[Finding] = []
    for cls in VALIDATED_CLASSES:
        for name, _, line in cfg.fields.get(cls, []):
            if name not in cfg.validated:
                out.append(Finding(
                    path=cfg.info.relpath, line=line, rule=rule.id,
                    message=f"{cls}.{name} is not referenced by any "
                            f"validate_* function", hint=rule.hint))
    return out


def undocumented_config_fields(ctx) -> List[Tuple[str, str, int]]:
    """(dotted field, class, line) for fields missing from
    docs/config.md."""
    cfg = _find_config(ctx)
    if cfg is None:
        return []
    doc_path = os.path.join(ctx.root, DOC_RELPATH)
    if not os.path.exists(doc_path):
        return [("<missing docs/config.md>", "Config", 1)]
    with open(doc_path, encoding="utf-8") as f:
        doc = f.read()
    missing = []
    for cls in _reachable_from_config(cfg):
        for name, _, line in cfg.fields[cls]:
            if f"`{name}`" not in doc:
                missing.append((f"{cls}.{name}", cls, line))
    return missing


@register(FLC402)
def check_doc_coverage(rule: Rule, ctx) -> List[Finding]:
    cfg = _find_config(ctx)
    if cfg is None:
        return []
    return [Finding(path=cfg.info.relpath, line=line, rule=rule.id,
                    message=f"{dotted} is missing from docs/config.md",
                    hint=rule.hint)
            for dotted, _, line in undocumented_config_fields(ctx)]
