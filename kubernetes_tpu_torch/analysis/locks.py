"""Pass 2 — static lock discipline across the control-plane threads.

The tree is asyncio-first, but three thread populations really do share
state: the event loop, the backend's `to_thread` solve-fetch workers,
and XLA's own callback threads. The locks guarding that shared state
(today: the metrics registry's per-metric locks, via
`utils/locking.new_lock`) and the asyncio conditions coordinating the
queues are what this pass audits:

- **LK201 lock-order cycle**: the acquisition graph (edges outer→inner
  from nested `with` blocks, plus one level of same-class method calls
  under a held lock) contains a cycle — the static ABBA.
- **LK202 await under a lock**: `await` inside `with <threading lock>`
  (impossible to be correct — the loop thread blocks every other
  holder) or an `asyncio.sleep`/fetch/send await inside `async with
  <condition>`. `cond.wait()` / `cond.wait_for()` on the HELD condition
  is the sanctioned pattern (it releases the lock) and is exempt, also
  when wrapped in `asyncio.wait_for`.
- **LK203 device fetch under a lock**: `np.asarray` / `.item()` /
  `block_until_ready` / `jax.device_get` while holding any lock — a
  device round-trip (up to ~100 ms on a relay) stalls every other
  holder. The runtime twin is `locking.check_dispatch_seam` at the
  sanctioned fetch seams.
- **LK204 wire send under a lock**: `transport.write` / `.sendall` /
  `writer.drain` while holding a lock.
- **LK205 guarded state read without the lock**: an attribute written
  under `with self.<lock>` in one method of a class is ITERATED (for
  loop, comprehension, `sorted`/`list`/`tuple`/`dict` call) in another
  method with no lock held. This is the race that motivated the pass:
  `Counter._render` iterated `self._values` lock-free while to_thread
  fetch workers `inc()`ed — "dictionary changed size during iteration"
  on the serving seam. Applies to THREADING locks only; asyncio
  conditions serialize on the loop and don't need read-side locking.
- **LK206 file I/O under a lock**: `open()` / `os.rename` / `os.replace`
  / `os.remove` / `os.unlink` while holding any lock. Added for the
  audit sink workers: the rotation sink's segment shuffle and
  batch append are disk I/O — milliseconds on a loaded box — and a lock
  held across them stalls every emitter. The runtime twin is the
  `check_dispatch_seam` guard in `policy/audit.py`'s `_write_batch` /
  webhook `_send`.
- **LK207 process spawn/join under a lock**: `subprocess.run`/`Popen`/
  `call`/`check_call`/`check_output`, `os.waitpid`/`os.fork`,
  `multiprocessing.Process(...)`, or a `.start()`/`.join()`/`.wait()`/
  `.terminate()`/`.kill()` on a process-ish receiver (`*proc*`,
  `*process*`, `*child*`, `*worker*`) while holding any lock. Added for
  the multi-process control plane: an interpreter spawn is
  hundreds of milliseconds and a join is unbounded — either one under
  the shared RV counter's lock (or any registry lock) stalls every
  shard's write path.

Lock identity is the attribute site (`module.Class.attr`); anything
assigned from `threading.Lock/RLock/Condition`, `asyncio.Lock/
Condition/Semaphore` or `new_lock(...)` counts, as does any `with
self.<name>` whose attribute LOOKS like a lock (`*lock*`, `*cond*`,
`*mutex*`) — so a lock the detector didn't see constructed still
participates.

Copy of `kubernetes_tpu/analysis/locks.py`.
"""

from __future__ import annotations

import ast

from kubernetes_tpu_torch.analysis.engine import (
    Finding,
    Module,
    call_name,
    dotted,
)

PASS_ID = "lock-discipline"

_THREAD_LOCK_CALLS = ("threading.Lock", "threading.RLock",
                      "threading.Condition", "Lock", "RLock",
                      "new_lock", "locking.new_lock")
_ASYNC_LOCK_CALLS = ("asyncio.Lock", "asyncio.Condition",
                     "asyncio.Semaphore", "asyncio.BoundedSemaphore")
_LOCKISH_FRAGMENTS = ("lock", "cond", "mutex", "_mu")

_FETCH_ATTRS = ("item", "block_until_ready")
_FETCH_CALLS = ("np.asarray", "numpy.asarray", "np.array",
                "jax.device_get")
_SEND_ATTRS = ("sendall", "send_bytes", "drain")
_SEND_CALLS = ("self.transport.write", "transport.write")
_FILE_CALLS = ("open", "os.rename", "os.replace", "os.remove",
               "os.unlink")
_PROC_CALLS = ("subprocess.run", "subprocess.Popen", "subprocess.call",
               "subprocess.check_call", "subprocess.check_output",
               "os.waitpid", "os.fork", "multiprocessing.Process")
_PROC_ATTRS = ("start", "join", "wait", "terminate", "kill")
#: receiver fragments that make a bare `.join()`/`.wait()` process-ish
#: (so `",".join(...)` and `cond.wait()` never match).
_PROC_RECEIVERS = ("proc", "process", "child", "worker")


def _lockish_attr(name: str) -> bool:
    low = name.lower()
    return any(f in low for f in _LOCKISH_FRAGMENTS)


class _ClassLocks(ast.NodeVisitor):
    """Collect declared lock attributes per class: {class: {attr: kind}}
    with kind in {"thread", "async"}."""

    def __init__(self):
        self.locks: dict[str, dict[str, str]] = {}
        self._cls: list[str] = []

    def visit_ClassDef(self, node: ast.ClassDef):
        self._cls.append(node.name)
        self.locks.setdefault(node.name, {})
        self.generic_visit(node)
        self._cls.pop()

    def visit_Assign(self, node: ast.Assign):
        if self._cls and isinstance(node.value, ast.Call):
            n = call_name(node.value)
            kind = None
            if n in _THREAD_LOCK_CALLS:
                kind = "thread"
            elif n in _ASYNC_LOCK_CALLS:
                kind = "async"
            if kind:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) \
                            and isinstance(tgt.value, ast.Name) \
                            and tgt.value.id == "self":
                        self.locks[self._cls[-1]][tgt.attr] = kind
        self.generic_visit(node)


def _with_lock_attr(item: ast.withitem) -> str | None:
    """`with self.X:` / `async with self.X:` — X when lock-ish."""
    expr = item.context_expr
    d = dotted(expr)
    if d and d.startswith("self.") and d.count(".") == 1:
        attr = d.split(".", 1)[1]
        if _lockish_attr(attr):
            return attr
    return None


def _held_cond_wait(call: ast.Call, held: list[tuple[str, str, bool]]
                    ) -> bool:
    """`self.<heldcond>.wait()` / `.wait_for()` (possibly inside
    asyncio.wait_for(...)) — the sanctioned release-and-wait."""
    held_attrs = {attr for attr, _kind, _async in held}
    for sub in ast.walk(call):
        if isinstance(sub, ast.Call):
            n = call_name(sub)
            if n and n.startswith("self.") and (
                    n.endswith(".wait") or n.endswith(".wait_for")):
                attr = n.split(".")[1]
                if attr in held_attrs:
                    return True
    return False


def run(modules: list[Module]) -> list[Finding]:
    findings: list[Finding] = []
    #: name-level acquisition edges across the whole tree:
    #: (outer "mod.Class.attr", inner ...) -> (rel, line)
    edges: dict[tuple[str, str], tuple[str, int]] = {}

    for mod in modules:
        decl = _ClassLocks()
        decl.visit(mod.tree)
        modbase = mod.rel.rsplit("/", 1)[-1][:-3]

        for cls_node in [n for n in ast.walk(mod.tree)
                         if isinstance(n, ast.ClassDef)]:
            cls_locks = decl.locks.get(cls_node.name, {})
            thread_locks = {a for a, k in cls_locks.items()
                            if k == "thread"}

            #: attrs written while holding each thread lock, and
            #: (attr-iterated, method, line) sites with no lock held.
            guarded_writes: dict[str, set[str]] = {}
            bare_iterations: list[tuple[str, str, int]] = []

            for meth in [n for n in cls_node.body
                         if isinstance(n, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))]:
                qn = f"{cls_node.name}.{meth.name}"
                _scan_body(
                    mod, modbase, qn, meth.body, [], cls_locks,
                    findings, edges, guarded_writes, bare_iterations)

            # LK205: iterate-without-lock on state some method guards.
            guarded_attrs = set()
            for lock_attr in thread_locks:
                guarded_attrs |= guarded_writes.get(lock_attr, set())
            for attr, qn, line in bare_iterations:
                if attr in guarded_attrs:
                    findings.append(Finding(
                        pass_id=PASS_ID, code="LK205", path=mod.rel,
                        line=line, symbol=f"{qn}:{attr}",
                        message=f"`{qn}` iterates `self.{attr}` without "
                                "a lock, but other methods mutate it "
                                "under one — racing writers can resize "
                                "the dict mid-iteration"))

    # LK201: cycle detection on the name-level edge graph (pairwise
    # inversions plus longer cycles via DFS).
    adj: dict[str, set[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
    state: dict[str, int] = {}

    def dfs(node: str, path: list[str]) -> list[str] | None:
        state[node] = 1
        for nxt in adj.get(node, ()):
            if state.get(nxt) == 1:
                return path[path.index(nxt):] + [nxt] \
                    if nxt in path else [node, nxt]
            if state.get(nxt, 0) == 0:
                cyc = dfs(nxt, path + [nxt])
                if cyc:
                    return cyc
        state[node] = 2
        return None

    for start in sorted(adj):
        if state.get(start, 0) == 0:
            cyc = dfs(start, [start])
            if cyc:
                rel, line = edges.get((cyc[0], cyc[1]), ("", 0))
                findings.append(Finding(
                    pass_id=PASS_ID, code="LK201", path=rel, line=line,
                    symbol="->".join(cyc),
                    message="lock-order cycle in the static acquisition "
                            f"graph: {' -> '.join(cyc)} — an ABBA "
                            "deadlock candidate"))
                break
    return findings


def _scan_body(mod, modbase, qn, body, held, cls_locks, findings,
               edges, guarded_writes, bare_iterations):
    """Walk one method body tracking the held-lock stack.

    held: [(attr, lock_id, is_async_with)]. Statements are visited
    exactly once: a compound statement contributes its OWN expressions
    (test / iter / value) at the current held depth, then its nested
    statements recurse — `with` blocks push onto the stack."""
    cls_name = qn.split(".")[0]

    def lock_id(attr: str) -> str:
        return f"{modbase}.{cls_name}.{attr}"

    def kind_of(attr: str) -> str:
        # undeclared lock-ish attrs default to "thread" (conservative).
        return cls_locks.get(attr, "thread")

    def handle_exprs(stmt: ast.stmt) -> None:
        own = [c for c in ast.iter_child_nodes(stmt)
               if isinstance(c, ast.expr)]
        for expr in own:
            if held:
                _check_held(mod, qn, expr, held, cls_locks, findings)
            else:
                for attr, line in _iterated_self_attrs(expr):
                    bare_iterations.append((attr, qn, line))
        if not held and isinstance(stmt, (ast.For, ast.AsyncFor)):
            # `for k in self.attr:` — the iter expr alone, no call.
            a = _src_attr(stmt.iter)
            if a:
                bare_iterations.append((a, qn, stmt.lineno))

    for node in body:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in node.items:
                if held or acquired:
                    # `with open(...)`-style context expressions execute
                    # while the outer locks are held — hazard-check them
                    # (the rotation sink's file-I/O shape, LK206).
                    # `acquired` covers the one-statement form
                    # `with self._lock, open(...)`: items to the left
                    # are already held when this item's expr runs.
                    _check_held(mod, qn, item.context_expr,
                                held + acquired, cls_locks, findings)
                attr = _with_lock_attr(item)
                if attr is not None:
                    for outer_attr, outer_id, _a in held:
                        if outer_attr != attr:
                            edges[(outer_id, lock_id(attr))] = \
                                (mod.rel, node.lineno)
                    acquired.append(
                        (attr, lock_id(attr),
                         isinstance(node, ast.AsyncWith)))
                    if kind_of(attr) == "thread":
                        guarded_writes.setdefault(attr, set()).update(
                            _written_attrs(node.body))
            _scan_body(mod, modbase, qn, node.body, held + acquired,
                       cls_locks, findings, edges, guarded_writes,
                       bare_iterations)
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        handle_exprs(node)
        # nested statements (if/for/try bodies, except handlers …)
        inner: list[ast.stmt] = []
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                inner.append(child)
            elif isinstance(child, ast.excepthandler):
                inner.extend(child.body)
        if inner:
            _scan_body(mod, modbase, qn, inner, held, cls_locks,
                       findings, edges, guarded_writes, bare_iterations)


def _check_held(mod, qn, node, held, cls_locks, findings):
    """Hazards inside a statement while locks are held (LK202-204)."""
    any_thread = any(cls_locks.get(a, "thread") == "thread"
                     for a, _i, _aw in held)
    held_names = [i for _a, i, _aw in held]

    for sub in ast.walk(node):
        if isinstance(sub, ast.Await):
            if isinstance(sub.value, ast.Call) \
                    and _held_cond_wait(sub.value, held):
                continue
            n = call_name(sub.value) if isinstance(sub.value, ast.Call) \
                else None
            hazardous = any_thread or (
                n is not None and (n.startswith("asyncio.sleep")
                                   or n in _FETCH_CALLS
                                   or n in _SEND_CALLS))
            if hazardous:
                findings.append(Finding(
                    pass_id=PASS_ID, code="LK202", path=mod.rel,
                    line=sub.lineno, symbol=f"{qn}:await",
                    message=f"`{qn}` awaits while holding "
                            f"{held_names} — the lock is held across "
                            "the suspension"))
        elif isinstance(sub, ast.Call):
            n = call_name(sub)
            if (isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _FETCH_ATTRS) \
                    or n in _FETCH_CALLS:
                findings.append(Finding(
                    pass_id=PASS_ID, code="LK203", path=mod.rel,
                    line=sub.lineno,
                    symbol=f"{qn}:{n or sub.func.attr}",
                    message=f"`{qn}` performs a device fetch while "
                            f"holding {held_names} — a device "
                            "round-trip stalls every other holder"))
            elif (isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _SEND_ATTRS) \
                    or n in _SEND_CALLS:
                findings.append(Finding(
                    pass_id=PASS_ID, code="LK204", path=mod.rel,
                    line=sub.lineno,
                    symbol=f"{qn}:{n or sub.func.attr}",
                    message=f"`{qn}` sends on a wire while holding "
                            f"{held_names}"))
            elif n in _FILE_CALLS:
                findings.append(Finding(
                    pass_id=PASS_ID, code="LK206", path=mod.rel,
                    line=sub.lineno, symbol=f"{qn}:{n}",
                    message=f"`{qn}` performs file I/O while holding "
                            f"{held_names} — disk latency stalls every "
                            "other holder (rotate/append outside the "
                            "lock)"))
            elif n in _PROC_CALLS or _procish_call(sub):
                findings.append(Finding(
                    pass_id=PASS_ID, code="LK207", path=mod.rel,
                    line=sub.lineno,
                    symbol=f"{qn}:{n or sub.func.attr}",
                    message=f"`{qn}` spawns or joins an OS process "
                            f"while holding {held_names} — interpreter "
                            "boot is ~100s of ms and a join is "
                            "unbounded; every other holder stalls"))


def _procish_call(call: ast.Call) -> bool:
    """`<receiver>.start()/join()/wait()/terminate()/kill()` where the
    dotted receiver names a process (`self._procs[i].join()`,
    `worker.terminate()`); plain `",".join()` / `cond.wait()` don't."""
    if not isinstance(call.func, ast.Attribute) \
            or call.func.attr not in _PROC_ATTRS:
        return False
    recv = call.func.value
    if isinstance(recv, ast.Subscript):
        recv = recv.value
    low = (dotted(recv) or "").lower()
    return any(f in low for f in _PROC_RECEIVERS)


def _written_attrs(body) -> set[str]:
    """self.<attr> targets mutated anywhere in these statements."""
    out: set[str] = set()
    for stmt in body:
        for sub in ast.walk(stmt):
            tgt = None
            if isinstance(sub, (ast.Assign,)):
                for t in sub.targets:
                    tgt = t
                    out |= _self_attr_of_target(tgt)
            elif isinstance(sub, ast.AugAssign):
                out |= _self_attr_of_target(sub.target)
    return out


def _self_attr_of_target(t: ast.expr) -> set[str]:
    # self.attr = / self.attr[k] = / self.attr[k] +=
    if isinstance(t, ast.Subscript):
        t = t.value
    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
            and t.value.id == "self":
        return {t.attr}
    return set()


def _src_attr(e: ast.expr) -> str | None:
    """self.attr | self.attr.items()/keys()/values() → attr."""
    if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
            and e.func.attr in ("items", "keys", "values"):
        e = e.func.value
    if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
            and e.value.id == "self":
        return e.attr
    return None


def _iterated_self_attrs(node: ast.AST):
    """(attr, line) for self.<attr> iterated anywhere in this expression:
    comprehension sources and materializing calls (sorted/list/…) over
    self.<attr> or self.<attr>.items() and friends."""
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, (ast.ListComp, ast.SetComp, ast.DictComp,
                            ast.GeneratorExp)):
            for gen in sub.generators:
                a = _src_attr(gen.iter)
                if a:
                    out.append((a, sub.lineno))
        elif isinstance(sub, ast.Call):
            n = call_name(sub)
            if n in ("sorted", "list", "tuple", "set", "dict", "max",
                     "min", "sum", "itertools.accumulate"):
                for arg in sub.args:
                    a = _src_attr(arg)
                    if a:
                        out.append((a, sub.lineno))
    return out
