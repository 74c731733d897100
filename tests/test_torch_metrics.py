"""The port's metrics registry and lock check on the CPU against the JAX
package's.

- One seeded sequence of observations (attempts by result and profile,
  plugin timings, pending gauges, solver counters, label values that need
  escaping, the watch and watch-cache families registered into a server
  registry) gives the identical Prometheus exposition text from both
  packages, the same bucket-edge percentiles over a window, and the same
  exact windowed percentiles (`WindowedLatencyRecorder`, its ring wrapped).
- Under KTPU_LOCK_CHECK=1 `new_lock` instruments: a lock-order inversion
  raises LockOrderError, and a dispatch seam entered with a lock held
  raises LockHeldAcrossDispatchError, in both packages; in the port the
  seams are live on `TorchBackend.assign`'s chunk fetch and the fast
  path's index fetch.

Tolerance: none.
"""

import math

import numpy as np
import pytest

from kubernetes_tpu.metrics import registry as jregistry
from kubernetes_tpu.utils import locking as jlocking
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.metrics import registry as tregistry
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
from kubernetes_tpu_torch.scheduler.framework import Framework
from kubernetes_tpu_torch.scheduler.plugins.registry import (
    DEFAULT_SCORE_WEIGHTS, build_plugins)
from kubernetes_tpu_torch.scheduler.types import PodInfo
from kubernetes_tpu_torch.serving import ResidentPlanes, SinglePodFastPath
from kubernetes_tpu_torch.utils import locking as tlocking

RESULTS = ("scheduled", "unschedulable", "error")
PROFILES = ("default-scheduler", 'odd"name\\x\ny')


def observe(registry, seed: int):
    rng = np.random.default_rng(seed)
    m = registry.SchedulerMetrics()
    for _ in range(500):
        u = rng.random()
        v = float(rng.exponential(0.01))
        if u < 0.4:
            m.observe_attempt(str(rng.choice(RESULTS)),
                              str(rng.choice(PROFILES)), v)
        elif u < 0.6:
            m.observe_plugin(str(rng.choice(["NodeResourcesFit", "Bind"])),
                             str(rng.choice(["Filter", "Score"])), v)
        elif u < 0.7:
            m.set_pending({"active": int(rng.integers(0, 50)),
                           "backoff": int(rng.integers(0, 5))})
        elif u < 0.8:
            m.solve_duration.observe(v * 10)
            m.solver_wave_commits.inc(int(rng.integers(0, 64)))
            m.solver_wave_width.set(32)
        elif u < 0.9:
            m.serving_fast_path_pods.inc()
            m.resident_plane_refresh.observe(v / 10)
        else:
            m.backend_degradations.inc(kind="host_fallback")
            m.preemption_victims.observe(int(rng.integers(1, 40)))
    wm, wcm = registry.WatchMetrics(), registry.WatchCacheMetrics()
    wm.events_dispatched.inc(7)
    wcm.ring_len.set(3, resource="pods")
    wm.register_into(m.registry)
    wcm.register_into(m.registry)
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_exposition_text_matches_reference(seed):
    jm, tm = observe(jregistry, seed), observe(tregistry, seed)
    text = tm.registry.render()
    assert text == jm.registry.render()
    assert "scheduler_schedule_attempts_total{" in text
    assert 'odd\\"name\\\\x\\ny' in text
    assert "watch_cache_ring_len{resource=\"pods\"} 3" in text
    labels = {"result": "scheduled", "profile": "default-scheduler"}
    for q in (0.5, 0.9, 0.99):
        assert tm.attempt_duration.percentile(q, **labels) \
            == jm.attempt_duration.percentile(q, **labels)


def test_windowed_recorder_matches_reference():
    rng = np.random.default_rng(3)
    vals = rng.exponential(1.0, size=700).tolist()
    j, t = (jregistry.WindowedLatencyRecorder(capacity=256),
            tregistry.WindowedLatencyRecorder(capacity=256))
    qs = (0.5, 0.9, 0.99, 0.999)
    marks = []
    for k, v in enumerate(vals):
        if k % 100 == 0:
            marks.append((j.mark(), t.mark()))
        j.observe(v)
        t.observe(v)
    for jm, tm_ in marks:
        assert t.percentiles_since(tm_, qs) == j.percentiles_since(jm, qs)
        assert t.count_since(tm_) == j.count_since(jm)
    assert all(math.isnan(v) for v in t.percentiles_since(t.mark(),
                                                          qs).values())


@pytest.fixture
def lock_check(monkeypatch):
    monkeypatch.setenv("KTPU_LOCK_CHECK", "1")
    jlocking.reset_observed()
    tlocking.reset_observed()
    yield
    jlocking.reset_observed()
    tlocking.reset_observed()


@pytest.mark.parametrize("locking", [jlocking, tlocking],
                         ids=["jax", "port"])
def test_lock_order_inversion_and_seam_raise(lock_check, locking):
    a, b = locking.new_lock("test.a"), locking.new_lock("test.b")
    assert isinstance(a, locking.InstrumentedLock)
    with a:
        with b:
            assert locking.held_locks() == ("test.a", "test.b")
    with b:
        with pytest.raises(locking.LockOrderError, match="inversion"):
            a.acquire()
        with pytest.raises(locking.LockHeldAcrossDispatchError,
                           match="backend.fetch_assign"):
            locking.check_dispatch_seam("backend.fetch_assign")
    locking.check_dispatch_seam("backend.fetch_assign")  # nothing held


def test_lock_check_off_builds_plain_locks(monkeypatch):
    monkeypatch.delenv("KTPU_LOCK_CHECK", raising=False)
    lk = tlocking.new_lock("test.plain")
    assert not isinstance(lk, tlocking.InstrumentedLock)
    with lk:
        tlocking.check_dispatch_seam("backend.fetch_assign")


def test_port_seams_are_live(lock_check):
    cache = SchedulerCache()
    for i in range(6):
        cache.add_node(make_node(f"n{i}"))
    fwk = Framework(build_plugins(), DEFAULT_SCORE_WEIGHTS)
    backend = TorchBackend(device="cpu", max_batch=8)
    pods = [PodInfo(make_pod(f"p{i}", requests={"cpu": "100m"}))
            for i in range(3)]
    held = tlocking.new_lock("test.held")
    with held:
        with pytest.raises(tlocking.LockHeldAcrossDispatchError,
                           match="backend.fetch_assign"):
            backend.assign(pods, cache.update_snapshot(), fwk)
    fast = SinglePodFastPath(backend, ResidentPlanes(backend))
    with held:
        with pytest.raises(tlocking.LockHeldAcrossDispatchError,
                           match="serving.fastpath.fetch"):
            fast.try_schedule(pods[0], cache.light_snapshot(), fwk)
    assert fast.try_schedule(pods[0], cache.light_snapshot(), fwk)
    got, _ = backend.assign(pods, cache.update_snapshot(), fwk)
    assert all(got.values())
