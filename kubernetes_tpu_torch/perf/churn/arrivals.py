"""Seeded open-loop arrival processes for the churn battery.

An arrival process is a pure function of (spec, seed): `timeline(duration)`
returns the sorted list of arrival offsets (seconds from phase start) and
is bit-identical across runs — the determinism contract ChurnDriver and the
fault scheduler share (tests/test_torch_churn.py pins it). ChurnDriver
enqueues a pod at each offset on an ABSOLUTE clock anchored at phase
start: a saturated scheduler never slows arrivals down, it only grows the
queue (open-loop, unlike the drain families whose create windows are
implicitly closed-loop behind barriers).

Models (performance-config.yaml `arrival:` spec / bench --churn-model):

- poisson: homogeneous Poisson at `rate` arrivals/s (exponential gaps) —
  the steady-state trickle.
- burst:   all arrivals come in bursts of `burstSize` every
  burstSize/rate seconds (same mean rate, maximally bunched) — informer
  storms and controller sync waves look like this.
- ramp:    inhomogeneous Poisson ramping linearly from `rate` to
  `endRate` over the phase — the knee walked inside ONE run.

Copy of `kubernetes_tpu/perf/churn/arrivals.py`.
"""

from __future__ import annotations

import hashlib
import math
import random
from typing import Mapping


def stable_seed(*parts) -> int:
    """Deterministic rng seed from mixed parts: sha256 of the repr
    string, NOT hash() (str hashes are randomized per process, which
    would silently break the cross-run bit-identical contract)."""
    h = hashlib.sha256("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big")


class ArrivalProcess:
    """Base: subclasses fill `kind` and `_generate(rng, duration)`."""

    kind = "arrival"

    def __init__(self, rate: float, seed: int = 0):
        if rate <= 0:
            raise ValueError(f"arrival rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.seed = int(seed)

    def timeline(self, duration: float) -> list[float]:
        """Sorted arrival offsets in [0, duration). Deterministic: a fresh
        seeded rng per call, so repeated calls (and re-runs) are
        bit-identical."""
        rng = random.Random(
            stable_seed(self.kind, self.seed, self.rate, duration))
        out = self._generate(rng, float(duration))
        assert all(0.0 <= t < duration for t in out)
        return out

    def _generate(self, rng: random.Random,
                  duration: float) -> list[float]:
        raise NotImplementedError


class PoissonArrivals(ArrivalProcess):
    kind = "poisson"

    def _generate(self, rng: random.Random,
                  duration: float) -> list[float]:
        out: list[float] = []
        t = rng.expovariate(self.rate)
        while t < duration:
            out.append(t)
            t += rng.expovariate(self.rate)
        return out


class BurstArrivals(ArrivalProcess):
    """Bursts of `burst_size` simultaneous arrivals every
    burst_size/rate seconds: the mean rate matches Poisson at the same
    `rate`, but the queue sees the worst-case bunching."""

    kind = "burst"

    def __init__(self, rate: float, seed: int = 0, burst_size: int = 32):
        super().__init__(rate, seed)
        self.burst_size = max(1, int(burst_size))

    def _generate(self, rng: random.Random,
                  duration: float) -> list[float]:
        period = self.burst_size / self.rate
        out: list[float] = []
        t = 0.0
        while t < duration:
            out.extend([t] * self.burst_size)
            t += period
        return out


class RampArrivals(ArrivalProcess):
    """Linear rate ramp rate → end_rate over the phase, realized as an
    inhomogeneous Poisson process by inversion: unit-exponential gaps in
    cumulative-intensity space Λ(t) = r0·t + (r1−r0)·t²/(2D), mapped
    back through the quadratic root."""

    kind = "ramp"

    def __init__(self, rate: float, seed: int = 0,
                 end_rate: float | None = None):
        super().__init__(rate, seed)
        self.end_rate = float(end_rate if end_rate is not None
                              else 4 * rate)
        if self.end_rate <= 0:
            raise ValueError("ramp endRate must be > 0")

    def _generate(self, rng: random.Random,
                  duration: float) -> list[float]:
        r0, r1, dur = self.rate, self.end_rate, duration
        slope = (r1 - r0) / dur
        out: list[float] = []
        lam = rng.expovariate(1.0)
        while True:
            if abs(slope) < 1e-12:
                t = lam / r0
            else:
                disc = r0 * r0 + 2 * slope * lam
                if disc < 0:
                    # Ramp-DOWN only: Λ is concave, so a Λ beyond its
                    # reachable maximum has no root — no more arrivals
                    # fit in the window (naively sqrt'ing raised a
                    # math domain error here).
                    return out
                # Solve slope/2·t² + r0·t − Λ = 0 for the positive root.
                t = (-r0 + math.sqrt(disc)) / slope
            if t >= dur:
                return out
            out.append(t)
            lam += rng.expovariate(1.0)


def make_arrival_process(spec: Mapping, seed: int = 0) -> ArrivalProcess:
    """Build a process from a workload-YAML `arrival:` spec:
    {model: poisson|burst|ramp, rate: N, burstSize: N, endRate: N}."""
    model = str(spec.get("model", "poisson"))
    rate = float(spec["rate"])
    if model == "poisson":
        return PoissonArrivals(rate, seed)
    if model == "burst":
        return BurstArrivals(rate, seed,
                             burst_size=int(spec.get("burstSize", 32)))
    if model == "ramp":
        return RampArrivals(rate, seed, end_rate=spec.get("endRate"))
    raise ValueError(f"unknown arrival model {model!r}")
