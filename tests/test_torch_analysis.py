"""The port's ktpu-lint (`kubernetes_tpu_torch.analysis`) on the CPU against
the JAX package's, and the port's own tier-1 gate.

- The seeded fixtures of the reference's `tests/test_static_analysis.py`
  (jit purity, lock discipline, the flag registry, the metrics lint) go
  through both packages' passes, each fixture planted at the package's own
  path. The findings must be identical by code, symbol, line and message,
  with the package prefix of paths and messages mapped.
- The baseline round-trips; keys survive moved lines; stale suppressions
  are reported.
- The CLI exits 0 on a clean tree, 1 on findings and 2 on an internal
  error, and `--write-readme-flags` rewrites only the port's README table.
- The gate: `run_all()` over the port's tree (`kubernetes_tpu_torch/` and
  `chip_smoke.py`) gives no unsuppressed finding and no stale suppression
  with the port's empty baseline; the port's README table is in sync and
  the reference's FL305 still finds nothing.

Tolerance: none (exact host logic).
"""

import json
import os
import re
import subprocess
import sys
import textwrap
from importlib import import_module
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")


def lint(root: str, sub: str = ""):
    return import_module(f"{root}.analysis{'.' + sub if sub else ''}")


def plant(tmp_path, root: str, rel: str, source: str):
    """The fixture `source` at `<root>/<rel>` under `tmp_path/root`, loaded
    by that package's engine."""
    base = tmp_path / root
    path = base / root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return lint(root, "engine").Module.load(str(path), str(base))


def portable(findings, root: str) -> list:
    """Findings with the package prefix of paths and messages mapped to a
    placeholder, in the pass's order."""
    pat = re.compile(rf"\b{root}(?=[./])")
    return [(f.pass_id, f.code, pat.sub("<pkg>", f.path), f.line, f.symbol,
             pat.sub("<pkg>", f.message), pat.sub("<pkg>", f.key))
            for f in findings]


# The fixtures are the reference's (tests/test_static_analysis.py).
JIT_FIXTURE = """
    import time
    import jax
    import jax.numpy as jnp
    import numpy as np
    from functools import partial
    from jax import lax


    @jax.jit
    def bad(x):
        v = float(jnp.max(x))          # JP103: cast concretizes
        y = np.asarray(x)              # JP101: host materialization
        t = time.time()                # JP102: frozen at trace time
        if jnp.any(x > 0):             # JP103: python branch
            return x
        return helper(x)

    def helper(x):
        return x.item()                # JP101, via the call graph

    def scan_user(xs):
        def step(carry, x):
            print(carry)               # JP102 inside a scan body
            return carry, x
        return lax.scan(step, 0, xs)

    def host_driver(x):
        return np.asarray(x)
"""

JIT_CLEAN = """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def clean(x, y):
        m = jnp.where(x > 0, x, y)
        n = int(x.shape[0])   # shape math is static — legal
        return m * n
"""

LOCK_FIXTURE = """
    import asyncio
    import threading

    import numpy as np


    class Inverted:
        def __init__(self):
            self._lock_a = threading.Lock()
            self._lock_b = threading.Lock()

        def ab(self):
            with self._lock_a:
                with self._lock_b:
                    return 1

        def ba(self):
            with self._lock_b:
                with self._lock_a:
                    return 2


    class HeldAcross:
        def __init__(self):
            self._lock = threading.Lock()
            self._values = {}

        def fetch(self):
            with self._lock:
                return np.asarray([1.0])

        async def sleepy(self):
            with self._lock:
                await asyncio.sleep(0.1)

        def send(self, sock):
            with self._lock:
                sock.sendall(b"x")

        def rotate(self, path):
            with self._lock:
                with open(path, "a") as f:
                    f.write("x")

        def shuffle(self, path):
            with self._lock:
                import os
                os.replace(path, path + ".1")

        def one_statement(self, path):
            with self._lock, open(path, "a") as f:
                f.write("x")

        def rotate_outside(self, path):
            segment = None
            with self._lock:
                segment = dict(self._values)
            with open(path, "a") as f:
                f.write(str(segment))

        def write(self, k):
            with self._lock:
                self._values[k] = 1

        def render(self):
            return sorted(self._values.items())


    class CondOk:
        def __init__(self):
            self._cond = asyncio.Condition()
            self._items = []

        async def wait(self):
            async with self._cond:
                await self._cond.wait()
                await asyncio.wait_for(self._cond.wait_for(
                    lambda: self._items), 1.0)
                return list(self._items)


    class ProcSpawner:
        def __init__(self):
            self._lock = threading.Lock()
            self._proc = None
            self._workers = []

        def spawn(self):
            import subprocess
            with self._lock:
                subprocess.run(["true"])

        def boot(self):
            import multiprocessing
            with self._lock:
                self._proc = multiprocessing.Process(target=print)
                self._proc.start()

        def reap(self):
            with self._lock:
                self._workers[0].join()

        def tag(self, parts):
            with self._lock:
                return ",".join(parts)

        def reap_outside(self, proc):
            with self._lock:
                alive = bool(self._proc)
            proc.join()
            return alive
"""

FLAG_FIXTURE = """
    import os

    def bad():
        a = os.environ.get("KTPU_SERVING", "1")     # FL301
        b = os.environ["KTPU_BOGUS_FLAG"]           # FL301+FL302
        c = os.getenv("KTPU_CLASS_PAD")             # FL301
        os.environ["KTPU_SERVING"] = "0"            # write: legal
        os.environ.pop("KTPU_SERVING", None)        # write: legal
        return a, b, c
"""

FLAG_READER = """
    import os

    def read(name):
        return os.environ.get(name) or os.environ.get("KTPU_X")
"""

METRICS_FIXTURE = """
    class Metrics:
        def __init__(self, r):
            self.a = r.counter("foo_count", "no _total")
            self.b = r.gauge("window_ms", "bad unit")
            self.c = r.histogram("req_duration", "no unit")
            self.d = r.counter("x_total", "hot label",
                               labels=("pod",))
            self.e = r.gauge("ok_gauge_total", "fake counter")
            self.f = r.histogram(
                "apiserver_request_duration_seconds", "clean",
                labels=("verb", "resource", "code"))
            self.g = r.gauge("bad-name", "invalid name")
            self.h = r.gauge("ok_gauge", "invalid label",
                             labels=("bad-label",))
"""

AUDIT_FIXTURE = """
    class Sink:
        def __init__(self, r):
            self.drops = r.counter("audit_dropped", "no _total")
"""

#: (id, pass module, package-relative path, source, runs with root=)
FIXTURES = (
    ("jit-seeded", "jit_purity", "ops/solver.py", JIT_FIXTURE, False),
    ("jit-clean", "jit_purity", "ops/kernels.py", JIT_CLEAN, False),
    ("lock-seeded", "locks", "store/fixture.py", LOCK_FIXTURE, False),
    ("flag-seeded", "flags_pass", "ops/fixture.py", FLAG_FIXTURE, True),
    ("flag-reader", "flags_pass", "utils/flags.py", FLAG_READER, True),
    ("metrics-seeded", "metrics_lint", "metrics/registry.py",
     METRICS_FIXTURE, False),
    ("metrics-audit", "metrics_lint", "policy/audit.py", AUDIT_FIXTURE,
     False),
)


def run_fixture(tmp_path, root, pass_name, rel, source, with_root):
    m = plant(tmp_path, root, rel, source)
    p = lint(root, pass_name)
    if with_root:
        return p.run([m], root=str(tmp_path / root))
    return p.run([m])


@pytest.mark.parametrize("fixture", FIXTURES, ids=[f[0] for f in FIXTURES])
def test_seeded_fixture_findings_match_the_reference(tmp_path, fixture):
    _, pass_name, rel, source, with_root = fixture
    got = {root: portable(run_fixture(tmp_path, root, pass_name, rel,
                                      source, with_root), root)
           for root in PACKAGES}
    assert got["kubernetes_tpu_torch"] == got["kubernetes_tpu"]


def test_the_port_fixtures_fire(tmp_path):
    """The reference test's assertions, on the port's passes: the jit
    pass still fires on a seeded fixture although the port's own tree has
    no entry point."""
    def found(fid):
        f = next(x for x in FIXTURES if x[0] == fid)
        return run_fixture(tmp_path, "kubernetes_tpu_torch", *f[1:])

    jit = sorted((f.code, f.symbol.split(":")[0])
                 for f in found("jit-seeded"))
    assert ("JP101", "bad") in jit and ("JP101", "helper") in jit
    assert ("JP102", "bad") in jit and ("JP102", "scan_user.step") in jit
    assert sum(1 for c, s in jit if s == "bad" and c == "JP103") == 2
    assert not any(s.startswith("host_driver") for _, s in jit)
    assert found("jit-clean") == []
    lk = found("lock-seeded")
    assert {"LK201", "LK202", "LK203", "LK204", "LK205", "LK206",
            "LK207"} <= {f.code for f in lk}
    assert len([f for f in lk if f.code == "LK207"]) == 4
    fl = found("flag-seeded")
    assert sorted(f.symbol for f in fl if f.code == "FL301") == \
        ["KTPU_BOGUS_FLAG", "KTPU_CLASS_PAD", "KTPU_SERVING"]
    assert "kubernetes_tpu_torch.utils.flags.get" in fl[0].message
    assert not any(f.code == "FL301" for f in found("flag-reader"))
    mt = {f.code for f in found("metrics-seeded")}
    assert {"MT402", "MT403", "MT404", "MT405", "MT406", "MT407"} <= mt
    assert [f.code for f in found("metrics-audit")] == ["MT402"]


# -- baseline ------------------------------------------------------------------

def test_baseline_round_trip(tmp_path):
    engine = lint("kubernetes_tpu_torch", "engine")
    fp = lint("kubernetes_tpu_torch", "flags_pass")
    src = """
        import os
        def bad():
            return os.environ.get("KTPU_SERVING")
    """
    m = plant(tmp_path, "kubernetes_tpu_torch", "ops/fixture.py", src)
    found = fp.run([m], root=str(tmp_path / "kubernetes_tpu_torch"))
    assert len(found) == 1
    assert found[0].key == ("flag-registry:FL301:kubernetes_tpu_torch/ops/"
                            "fixture.py:KTPU_SERVING")
    baseline_file = tmp_path / "baseline.json"
    baseline_file.write_text(json.dumps({
        "version": 1,
        "suppressions": [{"key": found[0].key,
                          "reason": "fixture: deliberate"}]}))
    baseline = engine.load_baseline(str(baseline_file))
    unsup, sup, stale = engine.apply_baseline(found, baseline)
    assert unsup == [] and len(sup) == 1 and stale == []
    # the key survives moved lines
    moved = plant(tmp_path, "kubernetes_tpu_torch", "ops/fixture.py",
                  "\n\n# moved down\n" + textwrap.dedent(src))
    again = fp.run([moved], root=str(tmp_path / "kubernetes_tpu_torch"))
    assert again[0].key == found[0].key and again[0].line != found[0].line
    # stale suppressions are reported
    assert engine.apply_baseline([], baseline)[2] == [found[0].key]


def test_port_baseline_is_its_own_and_empty():
    engine = lint("kubernetes_tpu_torch", "engine")
    path = Path(engine.baseline_path())
    assert path == ROOT / "kubernetes_tpu_torch" / "analysis" / \
        "baseline.json"
    assert json.loads(path.read_text()) == {"version": 1,
                                            "suppressions": []}
    assert engine.load_baseline() == {}


# -- the CLI -------------------------------------------------------------------

@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A repo-shaped tree with one unrouted flag read, and the port's lint
    pointed at it."""
    base = tmp_path / "repo"
    path = base / "kubernetes_tpu_torch" / "ops" / "fixture.py"
    path.parent.mkdir(parents=True)
    path.write_text(textwrap.dedent("""
        import os
        def bad():
            return os.environ.get("KTPU_SERVING")
    """))
    engine = lint("kubernetes_tpu_torch", "engine")
    monkeypatch.setattr(engine, "repo_root", lambda: str(base))
    return base


def test_cli_exit_codes(tree, capsys, tmp_path):
    main = lint("kubernetes_tpu_torch").main
    assert main([]) == 1
    out = capsys.readouterr().out
    assert "FL301" in out and "1 unsuppressed" in out
    assert main(["--json"]) == 1
    data = json.loads(capsys.readouterr().out)
    assert set(data) == {"findings", "suppressed", "stale_suppressions",
                         "per_pass"}
    assert set(data["per_pass"]) == {"jit-purity", "lock-discipline",
                                     "flag-registry", "metrics-lint"}
    key = data["findings"][0]["key"]
    ok = tmp_path / "ok.json"
    ok.write_text(json.dumps({"version": 1, "suppressions": [
        {"key": key, "reason": "fixture"}]}))
    assert main(["--baseline", str(ok)]) == 0
    assert "1 suppressed by baseline, 0 unsuppressed" in \
        capsys.readouterr().out
    broken = tmp_path / "broken.json"
    broken.write_text("{not json")
    assert main(["--baseline", str(broken)]) == 2


def test_write_readme_flags_touches_only_the_port_table(tree, capsys):
    fp = lint("kubernetes_tpu_torch", "flags_pass")
    ref_fp = lint("kubernetes_tpu", "flags_pass")
    readme = tree / "README.md"
    text = ("# r\n\n" + fp.README_BEGIN + "\nstale port table\n"
            + fp.README_END + "\n\n## Flags\n\n" + ref_fp.README_BEGIN
            + "\nthe reference's table\n" + ref_fp.README_END + "\n")
    readme.write_text(text)
    found = fp.run([], root=str(tree))
    assert [f.code for f in found if f.code == "FL305"] == ["FL305"]
    assert lint("kubernetes_tpu_torch").main(["--write-readme-flags"]) == 0
    assert "updated" in capsys.readouterr().out
    new = readme.read_text()
    flags = import_module("kubernetes_tpu_torch.utils.flags")
    assert flags.render_markdown_table() in new
    assert "stale port table" not in new
    tail = new[new.index("## Flags"):]
    assert tail == text[text.index("## Flags"):]
    assert not any(f.code == "FL305" for f in fp.run([], root=str(tree)))
    assert lint("kubernetes_tpu_torch").main(["--write-readme-flags"]) == 0
    assert "already current" in capsys.readouterr().out


def test_flag_registry_is_the_reference_cut():
    """The port's registry: each flag's default, doc and kill-switch bit
    are the reference's where the reference has the flag."""
    port = import_module("kubernetes_tpu_torch.utils.flags").FLAGS
    ref = import_module("kubernetes_tpu.utils.flags").FLAGS
    assert set(port) <= set(ref)
    for name, flag in port.items():
        assert flag.default == ref[name].default, name
        assert flag.kill_switch == ref[name].kill_switch, name
        assert flag.doc.strip(), name
    assert "KTPU_PALLAS" not in port and "KTPU_TEST_PLATFORM" not in port


def test_module_entry_point_exits_zero_on_the_tree():
    out = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.analysis"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 unsuppressed" in out.stdout


# -- the gate ------------------------------------------------------------------

def test_port_tree_is_clean():
    """The port's gate: no unsuppressed finding on its tree, and the empty
    baseline has nothing stale."""
    unsup, sup, stale, per_pass = lint("kubernetes_tpu_torch").run_all()
    assert unsup == [], "\n".join(
        f"{f.path}:{f.line}: {f.code} {f.message}" for f in unsup)
    assert sup == [] and stale == []
    assert set(per_pass) == {"jit-purity", "lock-discipline",
                             "flag-registry", "metrics-lint"}


def test_port_lint_walks_the_port_tree():
    engine = lint("kubernetes_tpu_torch", "engine")
    mods = engine.load_modules()
    rels = {m.rel for m in mods}
    assert "chip_smoke.py" in rels and "bench.py" not in rels
    assert not any(r.startswith("kubernetes_tpu/") for r in rels)
    assert "kubernetes_tpu_torch/apiserver/grpc_server.py" in rels
    assert "kubernetes_tpu_torch/apiserver/proto/ktpu_pb2.py" not in rels
    assert "kubernetes_tpu_torch/apiserver/proto/ktpu_pb2.py" in \
        engine.EXCLUDE_RELPATHS
    # the port imports no jax: the solve-path modules are there, and the
    # purity pass finds no entry point in them
    jp = lint("kubernetes_tpu_torch", "jit_purity")
    entry = [m for m in mods if m.rel.endswith(jp.ENTRY_MODULE_SUFFIXES)]
    assert len(entry) == len(jp.ENTRY_MODULE_SUFFIXES)
    assert all(not jp._entry_functions(engine.FunctionIndex(m))
               for m in entry)
    # the metrics lint reaches the same registrations as the reference's
    ml = lint("kubernetes_tpu_torch", "metrics_lint")
    ref_ml = lint("kubernetes_tpu", "metrics_lint")
    ref_mods = {m.rel: m for m in lint("kubernetes_tpu",
                                       "engine").load_modules()}
    by_rel = {m.rel: m for m in mods}
    for rel in ("metrics/registry.py", "policy/audit.py", "policy/vap.py"):
        names = {n for _k, n, _l, _ln in ml._registrations(
            by_rel[f"kubernetes_tpu_torch/{rel}"])}
        ref_names = {n for _k, n, _l, _ln in ref_ml._registrations(
            ref_mods[f"kubernetes_tpu/{rel}"])}
        assert names == ref_names and names, rel


def test_readme_tables_in_sync_in_both_packages():
    for root in PACKAGES:
        fp = lint(root, "flags_pass")
        found = fp.run([], root=str(ROOT))
        assert not any(f.code == "FL305" for f in found), \
            (root, [f.message for f in found])
    text = (ROOT / "README.md").read_text()
    port_fp = lint("kubernetes_tpu_torch", "flags_pass")
    ref_fp = lint("kubernetes_tpu", "flags_pass")
    # the two tables have markers of their own
    assert text.count(port_fp.README_BEGIN) == 1
    assert text.count(ref_fp.README_BEGIN) == 1
    assert text.count(port_fp.README_END) == 1
    assert text.count(ref_fp.README_END) == 1
