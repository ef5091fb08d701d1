"""AST lint driver: file discovery, hot/traced closure, suppression.

The reference's ``repro.analysis.lint`` with PyTorch's idioms in place of
JAX's.  The driver parses every scanned file once into a
:class:`ModuleInfo` — functions with their parameters/annotations, an
intra-module call graph, and the *hot* and *traced* closures — then hands
it to each registered module-scope rule (:mod:`repro_torch.analysis.
rules`).  Project-scope rules (config validation/doc coverage) run once
per invocation against the fixed files they inspect.

Definitions the rules share:

* **hot** — a function on the round's fast path: everything in the seed
  hot files (``core/batched.py``, ``core/async_engine.py``,
  ``kernels/*``), any function carrying a ``# flcheck: hot`` marker on
  its ``def``/decorator line (or the line directly above), every
  function lexically nested in a hot function, and — transitively —
  every same-module function a hot function calls.  A host sync here
  makes the host wait for every queued kernel of the round.
* **traced** — a function whose body runs under a functorch transform or
  a capture: decorated with ``torch.compile`` / ``torch.jit.script`` /
  ``torch.func.vmap`` (incl. via ``functools.partial``), passed by name to
  ``vmap``/``grad``/``grad_and_value``/``vjp``/``jvp``/``jacrev``/
  ``jacfwd``/``functional_call``/``checkpoint``/``compile``/
  ``make_graphed_callables``/..., nested in a traced function, or called
  from one (same-module closure).  Python control flow on a tensor here
  fails under ``vmap`` (a batched tensor has no single truth value) and
  breaks a graph capture.

Suppression is per line: ``# flcheck: ignore[FLC101]`` (comma-separate
for several rules) with a trailing ``-- reason`` comment.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: files whose every function is hot (relative-path suffix match)
HOT_FILE_SUFFIXES = ("core/batched.py", "core/async_engine.py")
HOT_DIR_PARTS = ("kernels",)

_IGNORE_RE = re.compile(r"#\s*flcheck:\s*ignore\[([A-Za-z0-9_,\s]+)\]")
_HOT_RE = re.compile(r"#\s*flcheck:\s*hot\b")

#: callables whose function-valued arguments become traced
_TRACING_CALLS = {
    "vmap", "grad", "grad_and_value", "vjp", "jvp", "jacrev", "jacfwd",
    "hessian", "functional_call", "checkpoint", "compile", "script",
    "trace", "make_graphed_callables",
}
#: decorators that make the decorated function traced
_TRACING_DECORATORS = {"vmap", "grad", "compile", "script", "checkpoint"}


def attr_chain(node: ast.AST) -> str:
    """Dotted name of a Name/Attribute chain ('' when not a plain chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _annotation_str(node: Optional[ast.AST]) -> str:
    if node is None:
        return ""
    try:
        return ast.unparse(node)
    except Exception:
        return ""


@dataclass
class FuncInfo:
    qualname: str
    name: str
    node: ast.AST                      # FunctionDef | AsyncFunctionDef | Lambda
    params: Tuple[str, ...]
    annotations: Dict[str, str]
    calls: Set[str]                    # bare names of same-module callees
    parent: Optional[str] = None       # qualname of lexical parent function
    hot: bool = False
    traced: bool = False


@dataclass
class ModuleInfo:
    path: str                          # absolute
    relpath: str                       # repo-root relative (posix)
    tree: ast.Module
    lines: List[str]
    suppressions: Dict[int, Set[str]] = field(default_factory=dict)
    hot_lines: Set[int] = field(default_factory=set)
    functions: List[FuncInfo] = field(default_factory=list)
    #: bare function name -> FuncInfos (collisions keep all)
    by_name: Dict[str, List[FuncInfo]] = field(default_factory=dict)

    def enclosing(self, node_line: int) -> List[FuncInfo]:
        """Functions whose body spans ``node_line`` (innermost last)."""
        out = [f for f in self.functions
               if f.node.lineno <= node_line <= f.node.end_lineno]
        out.sort(key=lambda f: f.node.lineno)
        return out


@dataclass(frozen=True)
class Finding:
    path: str                          # repo-root relative
    line: int
    rule: str
    message: str
    hint: str = ""

    def format(self) -> str:
        tail = f" (hint: {self.hint})" if self.hint else ""
        return f"{self.path}:{self.line} {self.rule} {self.message}{tail}"


@dataclass
class ProjectContext:
    """Handed to project-scope rules: the scan root + parsed modules."""
    root: str                          # repo root (dir containing docs/)
    modules: List[ModuleInfo]

    def module_by_suffix(self, suffix: str) -> Optional[ModuleInfo]:
        for m in self.modules:
            if m.relpath.endswith(suffix):
                return m
        return None


# ---------------------------------------------------------------------------
# Module parsing
# ---------------------------------------------------------------------------


def _is_tracing_decorator(deco: ast.AST) -> bool:
    chain = attr_chain(deco)
    if chain.split(".")[-1] in _TRACING_DECORATORS:
        return True
    if isinstance(deco, ast.Call):
        fn = attr_chain(deco.func)
        if fn.split(".")[-1] in _TRACING_DECORATORS:
            return True
        # functools.partial(torch.func.vmap, ...) / partial(vmap, ...)
        if fn.split(".")[-1] == "partial" and deco.args:
            first = attr_chain(deco.args[0])
            if first.split(".")[-1] in _TRACING_DECORATORS:
                return True
    return False


def _func_params(node: ast.AST) -> Tuple[Tuple[str, ...], Dict[str, str]]:
    if isinstance(node, ast.Lambda):
        args = node.args
    else:
        args = node.args
    names: List[str] = []
    annotations: Dict[str, str] = {}
    for a in (list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)):
        names.append(a.arg)
        ann = _annotation_str(a.annotation)
        if ann:
            annotations[a.arg] = ann
    return tuple(names), annotations


class _ModuleBuilder(ast.NodeVisitor):
    def __init__(self, info: ModuleInfo):
        self.info = info
        self.stack: List[FuncInfo] = []
        self.class_stack: List[str] = []
        #: names passed to tracing calls anywhere in the module
        self.traced_arg_names: Set[str] = set()

    # -- function collection ------------------------------------------
    def _add_function(self, node) -> FuncInfo:
        params, annotations = _func_params(node)
        traced = any(_is_tracing_decorator(deco)
                     for deco in getattr(node, "decorator_list", []))
        prefix = ".".join(c for c in (self.class_stack +
                                      [f.name for f in self.stack]) if c)
        qual = f"{prefix}.{node.name}" if prefix else node.name
        fi = FuncInfo(qualname=qual, name=node.name, node=node,
                      params=params, annotations=annotations,
                      calls=set(),
                      parent=self.stack[-1].qualname if self.stack else None,
                      traced=traced)
        self.info.functions.append(fi)
        self.info.by_name.setdefault(node.name, []).append(fi)
        return fi

    def visit_FunctionDef(self, node):
        fi = self._add_function(node)
        self.stack.append(fi)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    # -- call graph + traced-argument collection ----------------------
    def visit_Call(self, node: ast.Call):
        chain = attr_chain(node.func)
        leaf = chain.split(".")[-1] if chain else ""
        if self.stack and leaf:
            self.stack[-1].calls.add(leaf)
        if leaf in _TRACING_CALLS:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                name = attr_chain(arg)
                if name:
                    self.traced_arg_names.add(name.split(".")[-1])
        self.generic_visit(node)


def _is_hot_file(relpath: str) -> bool:
    p = relpath.replace(os.sep, "/")
    if any(p.endswith(suf) for suf in HOT_FILE_SUFFIXES):
        return True
    parts = p.split("/")
    return any(d in parts[:-1] for d in HOT_DIR_PARTS)


def parse_module(path: str, root: str) -> Optional[ModuleInfo]:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return None                    # ruff/compileall own syntax errors
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    info = ModuleInfo(path=path, relpath=rel, tree=tree,
                      lines=source.splitlines())
    for i, line in enumerate(info.lines, start=1):
        m = _IGNORE_RE.search(line)
        if m:
            info.suppressions[i] = {
                r.strip() for r in m.group(1).split(",") if r.strip()}
        if _HOT_RE.search(line):
            info.hot_lines.add(i)

    builder = _ModuleBuilder(info)
    builder.visit(tree)

    hot_file = _is_hot_file(rel)
    seeds: List[FuncInfo] = []
    for fi in info.functions:
        node = fi.node
        marker_lines = {node.lineno, node.lineno - 1}
        marker_lines |= {d.lineno for d in
                         getattr(node, "decorator_list", [])}
        if hot_file or (marker_lines & info.hot_lines):
            fi.hot = True
            seeds.append(fi)
        if fi.name in builder.traced_arg_names:
            fi.traced = True

    _close_over_calls(info, attr="hot")
    _close_over_calls(info, attr="traced")
    return info


def _close_over_calls(info: ModuleInfo, attr: str) -> None:
    """Propagate ``hot``/``traced`` to lexical children and same-module
    callees until fixpoint."""
    by_qual = {f.qualname: f for f in info.functions}
    changed = True
    while changed:
        changed = False
        for fi in info.functions:
            if not getattr(fi, attr):
                continue
            targets = [by_qual[c.qualname] for c in info.functions
                       if c.parent == fi.qualname]
            for callee_name in fi.calls:
                targets.extend(info.by_name.get(callee_name, []))
            for t in targets:
                if not getattr(t, attr):
                    setattr(t, attr, True)
                    changed = True


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p) and p.endswith(".py"):
            yield p
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"
                               and not d.startswith(".")]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def find_root(start: str) -> str:
    """Repo root: nearest ancestor holding docs/ or .git (else ``start``)."""
    d = os.path.abspath(start)
    if os.path.isfile(d):
        d = os.path.dirname(d)
    cur = d
    while True:
        if os.path.isdir(os.path.join(cur, "docs")) \
                or os.path.isdir(os.path.join(cur, ".git")):
            return cur
        nxt = os.path.dirname(cur)
        if nxt == cur:
            return d
        cur = nxt


def _suppressed(info: ModuleInfo, finding: Finding) -> bool:
    rules = info.suppressions.get(finding.line, set())
    return finding.rule in rules or "ALL" in rules


def lint_paths(paths: Sequence[str], root: Optional[str] = None,
               project_rules: bool = True) -> List[Finding]:
    """Run every registered rule over ``paths``; return surviving findings.

    ``root`` anchors relative paths in findings and locates ``docs/`` for
    the project-scope rules; it defaults to the nearest ancestor of the
    first path that has a ``docs/`` directory (or ``.git``).
    ``project_rules=False`` restricts to per-module rules (used by fixture
    tests that scan standalone files).
    """
    # imported here, not at module top: rule modules import this module's
    # helpers, so the registry must load after lint.py finishes defining
    from repro_torch.analysis.rules import checkers_for_scope

    paths = list(paths)
    if not paths:
        return []
    if root is None:
        root = find_root(paths[0])

    modules: List[ModuleInfo] = []
    for path in _iter_py_files(paths):
        info = parse_module(path, root)
        if info is not None:
            modules.append(info)

    findings: List[Finding] = []
    for info in modules:
        for rule, checker in checkers_for_scope("module"):
            for f in checker(rule, info):
                if not _suppressed(info, f):
                    findings.append(f)
    if project_rules:
        ctx = ProjectContext(root=root, modules=modules)
        for rule, checker in checkers_for_scope("project"):
            for f in checker(rule, ctx):
                info = next((m for m in ctx.modules
                             if m.relpath == f.path), None)
                if info is None or not _suppressed(info, f):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def make_finding(rule: Rule, info: ModuleInfo, node: ast.AST,
                 message: str) -> Finding:
    return Finding(path=info.relpath, line=getattr(node, "lineno", 1),
                   rule=rule.id, message=message, hint=rule.hint)
