"""Shared infrastructure for the ktpu-lint passes.

The engine owns everything pass-agnostic: discovering and parsing the
tree's modules, the `Finding` record and its stable suppression key,
the triaged baseline, and a handful of AST helpers (decorator / call
target resolution, import-alias tables, an intra-package call graph)
the passes share.

Design constraints:

- **zero dependencies**: stdlib `ast` only — the container bakes no
  linters, and the passes are repo-SPECIFIC (jit purity of the solve
  path, the KTPU_* flag registry) in a way generic tools can't be.
- **stable finding keys**: baseline entries must survive unrelated
  edits, so keys are `(pass, code, relpath, symbol)` — no line
  numbers. `symbol` is the enclosing function's qualname plus a short
  detail anchor (the flagged call or name), which moves with the code
  it describes.

Copy of `kubernetes_tpu/analysis/engine.py`, pointed at this package: it
walks `kubernetes_tpu_torch/` plus `chip_smoke.py`, skips this package's
generated `ktpu_pb2.py`, and reads this package's own baseline.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field

#: files never analyzed (generated descriptors, vendored bytes).
EXCLUDE_RELPATHS = frozenset((
    "kubernetes_tpu_torch/apiserver/proto/ktpu_pb2.py",
))


def repo_root() -> str:
    """The repo checkout containing this package (…/kubernetes_tpu_torch/..)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


@dataclass
class Finding:
    pass_id: str      # "jit-purity" | "lock-discipline" | "flag-registry" | "metrics-lint"
    code: str         # e.g. "JP101"
    path: str         # repo-relative, forward slashes
    line: int
    symbol: str       # enclosing qualname + detail anchor (key material)
    message: str

    @property
    def key(self) -> str:
        return f"{self.pass_id}:{self.code}:{self.path}:{self.symbol}"

    def as_dict(self) -> dict:
        return {"pass": self.pass_id, "code": self.code, "path": self.path,
                "line": self.line, "symbol": self.symbol,
                "message": self.message, "key": self.key}


@dataclass
class Module:
    path: str                 # absolute
    rel: str                  # repo-relative, forward slashes
    tree: ast.Module
    source: str
    #: import aliases visible anywhere in the module (module-level AND
    #: function-local imports): alias -> dotted module path. Covers
    #: `import x.y as z`, `from kubernetes_tpu_torch.ops import kernels`.
    aliases: dict[str, str] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str, root: str) -> "Module":
        with open(path, encoding="utf-8") as f:
            src = f.read()
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        mod = cls(path=path, rel=rel, tree=ast.parse(src, filename=path),
                  source=src)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod.aliases[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    # `from pkg.sub import name` — name may be a module
                    # (the call-graph resolver checks) or an object.
                    mod.aliases[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
        return mod


def load_modules(root: str | None = None,
                 extra: tuple[str, ...] = ("chip_smoke.py",)
                 ) -> list[Module]:
    """Every analyzable module: kubernetes_tpu_torch/**/*.py plus `extra`
    top-level files. Tests are deliberately NOT loaded — they monkeypatch
    env and exercise kill switches in ways the hygiene rules exempt."""
    root = root or repo_root()
    out: list[Module] = []
    pkg = os.path.join(root, "kubernetes_tpu_torch")
    for dirpath, _dirnames, filenames in os.walk(pkg):
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            if rel in EXCLUDE_RELPATHS:
                continue
            out.append(Module.load(path, root))
    for fn in extra:
        path = os.path.join(root, fn)
        if os.path.exists(path):
            out.append(Module.load(path, root))
    return out


# -- AST helpers -------------------------------------------------------------

def dotted(node: ast.expr) -> str | None:
    """`a.b.c` attribute/name chain as a string, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    """Dotted name of a call's target (None for computed targets)."""
    return dotted(node.func)


def decorator_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> list[str]:
    """Dotted names of a function's decorators; `partial(jax.jit, ...)`
    and `jax.jit(...)` call-form decorators contribute BOTH the outer
    name and the inner callable's name (so `@partial(jax.jit, ...)`
    yields ["partial", "jax.jit"])."""
    names: list[str] = []
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call):
            n = call_name(dec)
            if n:
                names.append(n)
            for arg in dec.args:
                a = dotted(arg)
                if a:
                    names.append(a)
        else:
            n = dotted(dec)
            if n:
                names.append(n)
    return names


class FunctionIndex:
    """Per-module table of every function/method (nested included),
    keyed by qualname, with parent links — the call-graph substrate."""

    def __init__(self, module: Module):
        self.module = module
        #: qualname -> FunctionDef/AsyncFunctionDef
        self.functions: dict[str, ast.AST] = {}
        #: id(node) -> qualname
        self.qualname_of: dict[int, str] = {}
        #: last-segment name -> [qualnames] (bare-name call resolution)
        self.by_name: dict[str, list[str]] = {}
        self._walk(module.tree, ())

    def _walk(self, node: ast.AST, scope: tuple[str, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = ".".join(scope + (child.name,))
                self.functions[qn] = child
                self.qualname_of[id(child)] = qn
                self.by_name.setdefault(child.name, []).append(qn)
                self._walk(child, scope + (child.name,))
            elif isinstance(child, ast.ClassDef):
                self._walk(child, scope + (child.name,))
            else:
                self._walk(child, scope)


def own_statements(fn: ast.AST):
    """Walk a function's body EXCLUDING nested function/class bodies —
    nested defs are separate graph nodes (and separately reachable)."""
    stack = list(getattr(fn, "body", []))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# -- baseline ----------------------------------------------------------------

def baseline_path(root: str | None = None) -> str:
    return os.path.join(root or repo_root(),
                        "kubernetes_tpu_torch", "analysis", "baseline.json")


def load_baseline(path: str | None = None) -> dict[str, str]:
    """{finding key: triage reason}. Missing file = empty baseline."""
    path = path or baseline_path()
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    out = {}
    for entry in data.get("suppressions", []):
        out[entry["key"]] = entry.get("reason", "")
    return out


def apply_baseline(findings: list[Finding], baseline: dict[str, str]
                   ) -> tuple[list[Finding], list[Finding], list[str]]:
    """(unsuppressed, suppressed, stale keys). Stale = baseline entries
    matching nothing — reported as warnings so triage rot is visible,
    but non-fatal (a fixed defect must not break the gate)."""
    keys = {f.key for f in findings}
    unsuppressed = [f for f in findings if f.key not in baseline]
    suppressed = [f for f in findings if f.key in baseline]
    stale = [k for k in baseline if k not in keys]
    return unsuppressed, suppressed, stale
