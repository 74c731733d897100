"""Pass 1 — jit-purity of everything the fused programs close over.

Entry points are discovered, not configured: every function decorated
with `jax.jit` / `partial(jax.jit, ...)` / `jax.vmap` / `shard_map`,
plus every named function passed as the first argument to `lax.scan`,
`jax.vmap`, `lax.cond`, `jax.jit` or `shard_map`, inside the solve-path
modules (ops/, parallel/, serving/fastpath). The pass then walks the
intra-package call graph from those entries (bare-name calls resolve
within the module; `alias.name(...)` calls resolve through the import
table into sibling modules) and flags, inside any reachable function:

- JP101 host sync: `.item()` / `.tolist()` / `.block_until_ready()`,
  `np.asarray` / `np.array` / `jax.device_get` — a traced value forced
  to host mid-program is a device round-trip per trace at best and a
  tracer leak at worst. The sanctioned fetch seams (`_fetch_assign`,
  the fast path's post-solve fetch) are host drivers, not jit-reachable,
  so they never enter the walk.
- JP102 wall-clock / randomness / IO: `time.*`, `random.*`,
  `np.random.*`, `datetime.now`, `print`, `os.environ` — values baked
  in at trace time and re-used on every later call of the compiled
  program (the classic "why is my timestamp frozen" bug).
- JP103 Python branching on a traced value: an `if`/`while`/`assert`
  whose test contains a direct `jnp.*` / `lax.*` call — under trace
  this raises `TracerBoolConversionError` on good days and silently
  specializes on bad ones (`bool()` on a jnp call is the same defect
  spelled differently, and is flagged too, as are `float()`/`int()`).

Heuristic boundaries, stated honestly: the pass has no type inference,
so it flags *syntactically certain* host ops rather than guessing at
tracer-hood of every name — `int(x.shape[0])` stays legal, `if
jnp.any(mask):` does not. That is exactly the precision the solve-path
invariants need: every genuine violation class above is syntactically
visible, and the differential suites own the semantic rest.

Copy of `kubernetes_tpu/analysis/jit_purity.py` over this package's solve
path (the JAX package's `ops/pallas_kernel.py` has no counterpart here).
This package imports no `jax`, so the pass finds no entry point in it
and reports nothing; its seeded fixtures show that it still fires.
"""

from __future__ import annotations

import ast

from kubernetes_tpu_torch.analysis.engine import (
    Finding,
    FunctionIndex,
    Module,
    call_name,
    decorator_names,
    own_statements,
)

PASS_ID = "jit-purity"

#: modules whose functions can be jit entry points (the solve path).
ENTRY_MODULE_SUFFIXES = (
    "kubernetes_tpu_torch/ops/solver.py",
    "kubernetes_tpu_torch/ops/kernels.py",
    "kubernetes_tpu_torch/ops/backend.py",
    "kubernetes_tpu_torch/ops/affinity.py",
    "kubernetes_tpu_torch/parallel/sharded.py",
    "kubernetes_tpu_torch/parallel/mesh.py",
    "kubernetes_tpu_torch/serving/fastpath.py",
    "kubernetes_tpu_torch/topology/device.py",
)

_JIT_DECORATORS = ("jax.jit", "jit", "jax.vmap", "shard_map",
                   "jax.named_call")
_TRACE_WRAPPERS = ("lax.scan", "jax.lax.scan", "jax.vmap", "vmap",
                   "lax.cond", "jax.lax.cond", "jax.jit", "jit",
                   "shard_map", "lax.while_loop", "jax.lax.while_loop",
                   "lax.fori_loop", "jax.checkpoint", "jax.remat",
                   "pl.pallas_call", "pallas_call")

_HOST_SYNC_ATTRS = ("item", "tolist", "block_until_ready")
_HOST_SYNC_CALLS = ("np.asarray", "numpy.asarray", "np.array",
                    "numpy.array", "jax.device_get", "onp.asarray")
_IMPURE_PREFIXES = ("time.", "random.", "np.random.", "numpy.random.",
                    "datetime.", "os.environ", "os.getenv")
_IMPURE_CALLS = ("print", "input", "open")
_TRACED_PREFIXES = ("jnp.", "jax.numpy.", "lax.", "jax.lax.")


def _is_traced_expr(node: ast.expr) -> ast.Call | None:
    """A direct jnp./lax. call anywhere inside the expression."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            n = call_name(sub)
            if n and n.startswith(_TRACED_PREFIXES):
                return sub
    return None


def _entry_functions(index: FunctionIndex) -> set[str]:
    """Qualnames of jit/scan entry points in one module."""
    entries: set[str] = set()
    for qn, fn in index.functions.items():
        for dec in decorator_names(fn):
            if dec in _JIT_DECORATORS or dec.endswith(".jit"):
                entries.add(qn)
    # Named functions handed to trace wrappers: lax.scan(step, ...),
    # jax.vmap(one)(...), jax.jit(body), lax.cond(pred, f, g, ...).
    for node in ast.walk(index.module.tree):
        if not isinstance(node, ast.Call):
            continue
        n = call_name(node)
        if n not in _TRACE_WRAPPERS:
            continue
        for arg in node.args:
            if isinstance(arg, ast.Name) and arg.id in index.by_name:
                entries.update(index.by_name[arg.id])
    return entries


def _reachable(indices: dict[str, FunctionIndex],
               entry_map: dict[str, set[str]]) -> set[tuple[str, str]]:
    """Closure of (module rel, qualname) reachable from the entries.

    A reachable function pulls in (a) its own nested defs — they execute
    under the same trace — and (b) every call target resolvable within
    the package: bare names in the same module, `alias.fn` through the
    import table into a sibling module's index."""
    # module path -> index, for alias resolution
    by_modpath: dict[str, FunctionIndex] = {}
    for rel, idx in indices.items():
        modpath = rel[:-3].replace("/", ".")
        if modpath.endswith(".__init__"):
            modpath = modpath[: -len(".__init__")]
        by_modpath[modpath] = idx

    seen: set[tuple[str, str]] = set()
    work: list[tuple[str, str]] = [
        (rel, qn) for rel, qns in entry_map.items() for qn in qns]
    while work:
        rel, qn = work.pop()
        if (rel, qn) in seen:
            continue
        seen.add((rel, qn))
        idx = indices[rel]
        fn = idx.functions.get(qn)
        if fn is None:
            continue
        # nested defs trace with their parent
        for sub_qn in idx.functions:
            if sub_qn.startswith(qn + ".") and (rel, sub_qn) not in seen:
                work.append((rel, sub_qn))
        for node in own_statements(fn):
            if not isinstance(node, ast.Call):
                continue
            n = call_name(node)
            if not n:
                continue
            head, _, tail = n.partition(".")
            if not tail and n in idx.by_name:
                for cand in idx.by_name[n]:
                    work.append((rel, cand))
            elif tail:
                target_mod = idx.module.aliases.get(head)
                if target_mod and target_mod.startswith(
                        "kubernetes_tpu_torch"):
                    tgt = by_modpath.get(target_mod)
                    if tgt is not None:
                        for cand in tgt.by_name.get(
                                tail.split(".")[-1], ()):
                            work.append((tgt.module.rel, cand))
    return seen


def run(modules: list[Module]) -> list[Finding]:
    entry_mods = [m for m in modules
                  if m.rel.endswith(ENTRY_MODULE_SUFFIXES)
                  or any(m.rel == s for s in ENTRY_MODULE_SUFFIXES)]
    indices = {m.rel: FunctionIndex(m) for m in entry_mods}
    entry_map = {rel: _entry_functions(idx)
                 for rel, idx in indices.items()}
    reachable = _reachable(indices, entry_map)

    findings: list[Finding] = []

    def emit(code, rel, node, qn, anchor, msg):
        findings.append(Finding(
            pass_id=PASS_ID, code=code, path=rel,
            line=getattr(node, "lineno", 0),
            symbol=f"{qn}:{anchor}", message=msg))

    for rel, qn in sorted(reachable):
        idx = indices[rel]
        fn = idx.functions.get(qn)
        if fn is None:
            continue
        for node in own_statements(fn):
            if isinstance(node, ast.Call):
                n = call_name(node)
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _HOST_SYNC_ATTRS:
                    emit("JP101", rel, node, qn, node.func.attr,
                         f"host sync `.{node.func.attr}()` inside "
                         f"jit-reachable `{qn}` — forces a device "
                         "round-trip / tracer leak under trace")
                elif n in _HOST_SYNC_CALLS:
                    emit("JP101", rel, node, qn, n,
                         f"host materialization `{n}(...)` inside "
                         f"jit-reachable `{qn}`")
                elif n and (n.startswith(_IMPURE_PREFIXES)
                            or n in _IMPURE_CALLS):
                    emit("JP102", rel, node, qn, n,
                         f"impure call `{n}(...)` inside jit-reachable "
                         f"`{qn}` — the value is frozen at trace time")
                elif n in ("float", "bool", "int") and node.args:
                    traced = _is_traced_expr(node.args[0])
                    if traced is not None:
                        emit("JP103", rel, node, qn, f"{n}()",
                             f"`{n}()` on a traced expression "
                             f"(`{call_name(traced)}`) inside "
                             f"jit-reachable `{qn}` — concretizes a "
                             "tracer")
            elif isinstance(node, (ast.If, ast.While, ast.Assert)):
                test = node.test
                traced = _is_traced_expr(test)
                if traced is not None:
                    kind = type(node).__name__.lower()
                    emit("JP103", rel, node, qn, kind,
                         f"Python `{kind}` on a traced expression "
                         f"(`{call_name(traced)}`) inside jit-reachable "
                         f"`{qn}` — branch on device values with "
                         "jnp.where/lax.cond")
    return findings
