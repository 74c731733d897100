"""DefaultPreemption: PostFilter that evicts lower-priority victims.

Parity target: pkg/scheduler/framework/preemption/preemption.go
(`Evaluator.Preempt`: find candidates → pick min-cost node → delete victims →
set status.nominatedNodeName) + plugins/defaultpreemption/default_preemption.go
(`SelectVictimsOnNode`: dry-run removing lower-priority pods, re-run Filter,
add back as many as possible in priority order; `pickOneNodeForPreemption`
ordering: fewest PDB violations → lowest max victim priority → smallest
priority sum → fewest victims → latest start time).

TPU-first (SURVEY §7 phase 6 "preemption as solve-with-victim-relaxation"):
the candidate search is VECTORIZED over a wave. A preemption wave (a batch
of failed high-priority pods) shares one dense tensor state — per node, the
priority-ascending victim prefix: cumulative releasable resources, priority
prefix sums/maxima. Per preemptor, the minimal victim count per node and
the reference's cost ordering are numpy reductions over (N, Kmax); only
the CHOSEN candidate is re-verified with the full host Filter chain (one
dry-run, not N), falling back to the next-best candidate on mismatch.
Victims claimed by earlier preemptors in the wave are excluded and the
preemptor's own consumption is charged, so concurrent preemptors spread
instead of stacking on one node. The reprieve subtlety (a non-resource
filter re-admitting a mid-priority resident) is covered by the exact
verify: on divergence the per-node host scan (`_select_victims`) answers.

Copy of `kubernetes_tpu/scheduler/plugins/defaultpreemption.py`. The wave
state stays host numpy, as in the reference; `prime_wave`'s batched
proposal runs the port's `ops/solver.propose_victims` (PyTorch ops, one
CUDA graph replay per preemptor on the card) on `device`: the scheduler
sets it to its backend's device, and with none it is cuda:0 (pass
device="cpu" to run on the CPU). A failure of the device proposal
propagates to the caller. `clock` (default `time.monotonic`) is the
source of the wave-age and promise-TTL times. `paths` counts which route
answered each `post_filter` call (the reference keeps no such count).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Mapping

import numpy as np
import torch

from kubernetes_tpu_torch.scheduler.framework import (
    CycleState,
    Plugin,
    Status,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Snapshot


class _WaveState:
    """Dense victim-relaxation tensors for one snapshot generation.

    Arrays (N nodes × Kmax victim prefix × R resources):
    - rel[n, k, r]: resources released by evicting the k+1 lowest-priority
      unclaimed residents of node n
    - vprio[n, k]: priority of the k-th victim (asc); INT_MAX padding
    - vsum/vmax[n, k]: priority prefix sums / maxima
    - used[n, r] / alloc[n, r], pods_used/alloc[n]
    """

    __slots__ = ("nodes", "resources", "r_index", "rel", "vreq", "vprio",
                 "vsum", "vmax", "vcount", "used", "alloc", "pods_used",
                 "pods_alloc", "victims", "generation", "names_hash")

    INF = np.iinfo(np.int64).max

    def __init__(self, snapshot: Snapshot, claimed: set[str],
                 promised: dict[str, list[dict]]):
        nodes = list(snapshot.nodes)
        self.nodes = nodes
        self.generation = getattr(snapshot, "generation", None)
        #: node-order fingerprint: DiagMap.banned_mask rows from the
        #: solve-time snapshot only apply when the order still matches.
        self.names_hash = hash(tuple(ni.name for ni in nodes))
        res: dict[str, None] = {}
        for ni in nodes:
            for r in ni.allocatable.res:
                res.setdefault(r)
        self.resources = list(res)
        self.r_index = {r: j for j, r in enumerate(self.resources)}
        N, R = len(nodes), len(self.resources)
        kmax = 1
        per_node: list[list[PodInfo]] = []
        for ni in nodes:
            cand = sorted(
                (p for p in ni.pods if p.key not in claimed),
                key=lambda p: (p.priority, p.key))
            per_node.append(cand)
            kmax = max(kmax, len(cand))
        self.victims = per_node
        self.rel = np.zeros((N, kmax, R), dtype=np.int64)
        #: per-victim request vectors (rel is their prefix sum) — the
        #: device proposal scan re-derives prefixes after in-scan claims,
        #: which needs the per-victim granularity.
        self.vreq = np.zeros((N, kmax, R), dtype=np.int64)
        self.vprio = np.full((N, kmax), self.INF, dtype=np.int64)
        self.vsum = np.zeros((N, kmax), dtype=np.int64)
        self.vmax = np.zeros((N, kmax), dtype=np.int64)
        self.vcount = np.zeros((N,), dtype=np.int64)
        self.used = np.zeros((N, R), dtype=np.int64)
        self.alloc = np.zeros((N, R), dtype=np.int64)
        self.pods_used = np.zeros((N,), dtype=np.int64)
        self.pods_alloc = np.zeros((N,), dtype=np.int64)
        for n, ni in enumerate(nodes):
            for r, v in ni.requested.res.items():
                j = self.r_index.get(r)
                if j is not None:
                    self.used[n, j] = v
            for r, v in ni.allocatable.res.items():
                self.alloc[n, self.r_index[r]] = v
            self.pods_used[n] = ni.requested.pods
            self.pods_alloc[n] = ni.allocatable.pods
            # Unbound-but-promised preemptors charge their target node.
            for q, _ts in (promised.get(ni.name) or {}).values():
                for r, v in q.items():
                    j = self.r_index.get(r)
                    if j is not None:
                        self.used[n, j] += v
                self.pods_used[n] += 1
            cand = per_node[n]
            self.vcount[n] = len(cand)
            acc = np.zeros((R,), dtype=np.int64)
            psum = 0
            pmax = 0
            for k, p in enumerate(cand):
                for r, v in p.requests.items():
                    j = self.r_index.get(r)
                    if j is not None:
                        acc[j] += v
                        self.vreq[n, k, j] = v
                psum += p.priority
                pmax = max(pmax, p.priority)
                self.rel[n, k] = acc
                self.vprio[n, k] = p.priority
                self.vsum[n, k] = psum
                self.vmax[n, k] = pmax

    def candidates(self, pod: PodInfo,
                   banned: set[int]) -> list[tuple[int, int]]:
        """[(node index, victim count)] sorted by the reference cost
        ordering — each entry is the MINIMAL victim prefix on that node
        that fits the pod (resources + pod count), victims restricted to
        priorities below the preemptor's."""
        N, kmax, R = self.rel.shape
        q = np.zeros((R,), dtype=np.int64)
        for r, v in pod.requests.items():
            j = self.r_index.get(r)
            if j is not None:
                q[j] = v
        # eligible[n, k]: prefix k+1 consists solely of lower-prio victims
        eligible = self.vprio < pod.priority
        fits = np.all(
            self.used[:, None, :] - self.rel + q[None, None, :]
            <= self.alloc[:, None, :], axis=-1)
        fits &= (self.pods_used[:, None] - (np.arange(kmax)[None, :] + 1)
                 + 1 <= self.pods_alloc[:, None])
        ok = eligible & fits
        any_ok = ok.any(axis=1)
        if banned:
            for n in banned:
                any_ok[n] = False
        idxs = np.nonzero(any_ok)[0]
        if idxs.size == 0:
            return []
        kmin = ok[idxs].argmax(axis=1)  # first fitting prefix per node
        vmax = self.vmax[idxs, kmin]
        vsum = self.vsum[idxs, kmin]
        order = np.lexsort((idxs, kmin + 1, vsum, vmax))
        return [(int(idxs[i]), int(kmin[i]) + 1) for i in order]

    def claim(self, n: int, count: int, pod: PodInfo,
              claimed: set[str], promised: dict,
              now: float) -> list[PodInfo]:
        """Commit a choice: mark victims claimed, charge the preemptor
        (promised at `now`), and refresh node n's tensors IN PLACE
        (O(K·R)) — a full rebuild per preemptor made 1000-node waves
        O(wave² ) in python loops."""
        victims = self.victims[n][:count]
        for v in victims:
            claimed.add(v.key)
        promised.setdefault(self.nodes[n].name, {})[pod.key] = (
            dict(pod.requests), now)
        # Victims leave, the preemptor's load lands.
        remaining = self.victims[n][count:]
        self.victims[n] = remaining
        for v in victims:
            for r, val in v.requests.items():
                j = self.r_index.get(r)
                if j is not None:
                    self.used[n, j] -= val
        for r, val in pod.requests.items():
            j = self.r_index.get(r)
            if j is not None:
                self.used[n, j] += val
        self.pods_used[n] += 1 - count
        self.rel[n] = 0
        self.vreq[n] = 0
        self.vprio[n] = self.INF
        self.vsum[n] = 0
        self.vmax[n] = 0
        self.vcount[n] = len(remaining)
        acc = np.zeros((self.rel.shape[2],), dtype=np.int64)
        psum = 0
        pmax = 0
        for k, p in enumerate(remaining):
            for r, val in p.requests.items():
                j = self.r_index.get(r)
                if j is not None:
                    acc[j] += val
                    self.vreq[n, k, j] = val
            psum += p.priority
            pmax = max(pmax, p.priority)
            self.rel[n, k] = acc
            self.vprio[n, k] = p.priority
            self.vsum[n, k] = psum
            self.vmax[n, k] = pmax
        return list(victims)


class DefaultPreemption(Plugin):
    NAME = "DefaultPreemption"
    EXTENSION_POINTS = ("PostFilter",)

    def __init__(self, args=None, framework=None, evict=None, device=None,
                 clock: Callable[[], float] | None = None):
        """`framework` runs the Filter dry-runs; `evict(pod_key, victim_keys,
        node)` is the side-effect callback the scheduler injects (API deletes
        + nominatedNodeName patch happen there); `device` is where
        `prime_wave`'s proposal runs (None: cuda:0); `clock` gives the
        monotonic seconds of the wave-age and promise-TTL rules."""
        super().__init__(args)
        self.framework = framework
        self.evict = evict
        self.device = device
        self.clock = clock if clock is not None else time.monotonic
        self._rng = random.Random(self.args.get("seed", 0))
        #: wave tensors: kept across a preemption wave with in-place claim
        #: updates; resynced to the live snapshot on a budget (claims are
        #: exact in-wave, external drift is caught by the live verify).
        self._wave: _WaveState | None = None
        self._wave_claims = 0
        self._wave_built = 0.0
        #: victim keys promised to earlier preemptors; pruned when the
        #: victim is no longer resident (its deletion landed).
        self._claimed: set[str] = set()
        #: node name -> {preemptor pod key -> (requests, promised-at)};
        #: entries drop when the pod binds (appears among residents), when
        #: it re-nominates elsewhere, or on TTL (pod deleted pre-bind).
        self._promised: dict[str, dict[str, tuple]] = {}
        self._promised_pods: dict[str, str] = {}  # pod key -> node name
        #: pod key -> victim keys evicted for it — while any is still
        #: resident on the promised node, a retry re-nominates the same
        #: node WITHOUT a second eviction (preemption.go
        #: PodEligibleToPreemptOthers: a preemptor whose victims are still
        #: terminating must not preempt again).
        self._promised_victims: dict[str, list[str]] = {}
        #: device-proposed (wave, node, count) per pod key — see prime_wave.
        self._primed: dict[str, tuple] = {}
        #: post_filter calls by the route that answered: an in-flight
        #: re-nomination, a committed device-primed proposal, a committed
        #: ranked host candidate, or the per-node host scan.
        self.paths = {"in_flight": 0, "primed": 0, "ranked": 0, "scan": 0}

    def _in_flight_node(self, pod: PodInfo, snapshot: Snapshot) -> str | None:
        """The node already promised to this pod, if its eviction is still
        in flight (some claimed victim remains resident there). Retries
        re-nominate it instead of evicting a second set of victims."""
        node = self._promised_pods.get(pod.key)
        if node is None:
            return None
        vkeys = self._promised_victims.get(pod.key)
        if not vkeys:
            return None
        ni = snapshot.get(node)
        if ni is None:
            return None
        resident = {p.key for p in ni.pods}
        return node if any(vk in resident for vk in vkeys) else None

    def prime_wave(self, pods: list[PodInfo], snapshot: Snapshot,
                   statuses_by_pod: Mapping[str, Mapping[str, Status]]
                   ) -> None:
        """Batched device victim proposal for a failure wave (SURVEY §7
        phase 6): ONE `solver.propose_victims` call ranks a candidate per
        (preemptor, node) for every resolvable failed pod, threading
        in-wave claims on device. `post_filter` then verifies each primed
        proposal against the live snapshot with the full Filter chain and
        evicts exactly as before — only the SEARCH moved off host.

        Proposals assume claims land in wave order; a host-verify
        divergence (stale wave, non-resource filter) drops to the ranked
        host search for that pod, and every later proposal is still
        individually verified before use."""
        self._primed.clear()
        if self.framework is None or not pods:
            return
        wave = self._wave_state(snapshot)
        name_to_idx = {ni.name: n for n, ni in enumerate(wave.nodes)}
        elig: list[PodInfo] = []
        banned_rows: list[np.ndarray] = []
        N = len(wave.nodes)
        for pi in pods:
            if self._in_flight_node(pi, snapshot) is not None:
                continue  # the guard answers without a new eviction
            statuses = statuses_by_pod.get(pi.key) or {}
            # DiagMap (the batched backend's diagnostics) precomputes both
            # aggregates; plain dicts take the O(N) scan.
            bm = getattr(statuses, "banned_mask", None)
            if bm is not None and \
                    statuses.banned_nodes_hash == wave.names_hash:
                if not statuses.resolvable:
                    continue
                ban = bm
            else:
                ban = np.zeros((N,), dtype=bool)
                resolvable = not statuses
                for name, st in statuses.items():
                    if st.code == UNSCHEDULABLE_AND_UNRESOLVABLE:
                        j = name_to_idx.get(name)
                        if j is not None:
                            ban[j] = True
                    else:
                        resolvable = True
                if not resolvable:
                    continue  # _handle_failure won't run PostFilter on it
            elig.append(pi)
            banned_rows.append(ban)
        if not elig:
            return
        from kubernetes_tpu_torch.ops import solver
        dev = torch.device(self.device if self.device is not None
                           else "cuda:0")

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        R = wave.rel.shape[2]
        # FIXED preemptor bucket + power-of-two victim-prefix padding:
        # wave widths vary per batch, and an exact-shape jit signature
        # would recompile the scan per distinct width. Waves wider than
        # the bucket run in chunks, threading the post-claim device carry
        # (the scan state IS the claim ledger). Padding rows carry
        # INT32_MIN priority + all-banned, so they propose nothing.
        P = len(elig)
        PB = self.WAVE_DEVICE_BUCKET
        K = wave.vreq.shape[1]
        K2 = max(8, 1 << (K - 1).bit_length())
        cap = 2**31 - 1
        req64 = np.zeros((P, R), dtype=np.int64)
        prio = np.zeros((P,), dtype=np.int32)
        for i, pi in enumerate(elig):
            for r, v in pi.requests.items():
                j = wave.r_index.get(r)
                if j is not None:
                    req64[i, j] = v
            prio[i] = min(pi.priority, cap - 1)
        banned = np.stack(banned_rows)
        # Conservative per-column power-of-two quantization: byte
        # quantities (memory, ephemeral-storage) overflow int32, and the
        # scan cumsums released resources — so scale each column until
        # its max fits 2^30 (headroom for the in-scan sums). Rounding
        # direction is one-sided: consumption (used, preemptor request)
        # rounds UP, supply (alloc, released victim resources) rounds
        # DOWN, so a scaled "fits" always implies a true fit; the rare
        # false reject only costs a fallback to the ranked host search.
        lim = np.int64(1 << 30)
        colmax = np.maximum(wave.alloc.max(axis=0, initial=0),
                            wave.used.max(axis=0, initial=0))
        colmax = np.maximum(colmax, req64.max(axis=0, initial=0))
        shift = np.zeros((R,), dtype=np.int64)
        over = colmax > lim
        if over.any():
            shift[over] = np.ceil(
                np.log2(colmax[over] / lim)).astype(np.int64)

        def up(a):  # consumption: ceil
            return ((a + (np.int64(1) << shift) - 1) >> shift).astype(
                np.int32)

        def down(a):  # supply: floor
            return (a >> shift).astype(np.int32)

        req = up(req64)
        vreq = np.zeros((N, K2, R), dtype=np.int32)
        vreq[:, :K] = down(wave.vreq)
        vprio = np.full((N, K2), cap, dtype=np.int32)
        vprio[:, :K] = np.minimum(wave.vprio, cap)
        carry = (put(up(wave.used)), put(down(wave.alloc)),
                 put(wave.pods_used.astype(np.int32)),
                 put(wave.pods_alloc.astype(np.int32)),
                 put(vreq), put(vprio))
        used_d, alloc_d, pused_d, palloc_d, vreq_d, vprio_d = carry
        nodes_out = np.empty((P,), dtype=np.int32)
        counts_out = np.empty((P,), dtype=np.int32)
        for lo in range(0, P, PB):
            hi = min(lo + PB, P)
            w = hi - lo
            req_c = np.zeros((PB, R), dtype=np.int32)
            req_c[:w] = req[lo:hi]
            prio_c = np.full((PB,), -2**31, dtype=np.int32)
            prio_c[:w] = prio[lo:hi]
            ban_c = np.ones((PB, N), dtype=bool)
            ban_c[:w] = banned[lo:hi]
            offsets = np.fromiter(
                (self._rng.randrange(N) for _ in range(PB)),
                dtype=np.int32, count=PB)
            node, count, used_d, pused_d, vreq_d, vprio_d = \
                solver.propose_victims(
                    put(req_c), put(prio_c), put(ban_c), used_d, alloc_d,
                    pused_d, palloc_d, vreq_d, vprio_d, put(offsets))
            nodes_out[lo:hi] = node.cpu().numpy()[:w]
            counts_out[lo:hi] = count.cpu().numpy()[:w]
        for i, pi in enumerate(elig):
            if nodes_out[i] >= 0:
                self._primed[pi.key] = (N, int(nodes_out[i]),
                                        int(counts_out[i]))

    def post_filter(self, state: CycleState, pod: PodInfo, snapshot: Snapshot,
                    filtered_status: Mapping[str, Status]) -> tuple[str, Status]:
        if self.framework is None:
            return "", Status.unschedulable()
        in_flight = self._in_flight_node(pod, snapshot)
        if in_flight is not None:
            self.paths["in_flight"] += 1
            return in_flight, Status.success()
        wave = self._wave_state(snapshot)
        # Device-primed proposal (prime_wave): verify + commit without the
        # ranked host search. Validation is SEMANTIC, not wave-identity —
        # the wave resync budget (WAVE_MAX_CLAIMS/AGE) rebuilds mid-wave,
        # and a rebuilt wave's minimal prefix on the proposed node is still
        # a valid (claimed-victim-free) choice; the full live-filter verify
        # in _verify_and_commit guards feasibility either way. Primes that
        # no longer have an eligible prefix fall to the ranked path below.
        primed = self._primed.pop(pod.key, None)
        if primed is not None and primed[0] == len(wave.nodes):
            n, count = primed[1], primed[2]
            if count <= len(wave.victims[n]) and all(
                    v.priority < pod.priority
                    for v in wave.victims[n][:count]):
                committed = self._verify_and_commit(
                    state, pod, snapshot, wave, n, count)
                if committed is not None:
                    self.paths["primed"] += 1
                    return committed, Status.success()
        banned: set[int] = set()
        # Nodes rejected as UnschedulableAndUnresolvable can't be helped by
        # preemption (preemption.go `nodesWherePreemptionMightHelp`).
        bm = getattr(filtered_status, "banned_mask", None)
        if bm is not None and \
                filtered_status.banned_nodes_hash == wave.names_hash:
            banned = set(np.nonzero(bm)[0])
        else:
            for n, ni in enumerate(wave.nodes):
                st = filtered_status.get(ni.name)
                if st is not None and \
                        st.code == UNSCHEDULABLE_AND_UNRESOLVABLE:
                    banned.add(n)
        ranked = wave.candidates(pod, banned)
        # Seeded tie shuffle among equal-cost leaders (the reference scans
        # a Go map whose iteration order is randomized, which spreads
        # concurrent preemptors across equal-cost nodes — a deterministic
        # first-min made every preemptor in a wave nominate the SAME node
        # and retry quadratically).
        if len(ranked) > 1:
            lead_cost = self._cost_of(wave, ranked[0])
            tie_end = 1
            while tie_end < len(ranked) and \
                    self._cost_of(wave, ranked[tie_end]) == lead_cost:
                tie_end += 1
            head = ranked[:tie_end]
            self._rng.shuffle(head)
            ranked = head + ranked[tie_end:]
        # Exact verify on the chosen candidate only; on divergence (a
        # non-resource filter still failing), try the next best, then the
        # per-node host scan.
        for attempt, (n, count) in enumerate(ranked):
            if attempt >= 8:
                break
            committed = self._verify_and_commit(
                state, pod, snapshot, wave, n, count)
            if committed is not None:
                self.paths["ranked"] += 1
                return committed, Status.success()
        self.paths["scan"] += 1
        return self._post_filter_scan(state, pod, snapshot, filtered_status)

    def _verify_and_commit(self, state: CycleState, pod: PodInfo,
                           snapshot: Snapshot, wave: _WaveState,
                           n: int, count: int) -> str | None:
        """Verify one (node, victim count) candidate against the LIVE node
        with the full Filter chain (the wave may be a bounded-age batch
        view); on success, claim in the wave ledger and evict. Returns the
        node name, or None on divergence."""
        ni = wave.nodes[n]
        victims = wave.victims[n][:count]
        live_ni = snapshot.get(ni.name) or ni
        dry = live_ni.clone()
        for v in victims:
            dry.remove_pod(v.key)
        if not self.framework.run_filters(
                state.clone(), pod, dry).is_success():
            return None
        self._drop_promise(pod.key)  # re-nomination moves the charge
        chosen = wave.claim(n, count, pod, self._claimed, self._promised,
                            self.clock())
        self._promised_pods[pod.key] = ni.name
        self._promised_victims[pod.key] = [v.key for v in chosen]
        self._wave_claims += 1
        if self.evict is not None:
            self.evict(pod, [v.key for v in chosen], ni.name)
        return ni.name

    @staticmethod
    def _cost_of(wave: _WaveState, entry: tuple[int, int]):
        n, count = entry
        return (int(wave.vmax[n, count - 1]), int(wave.vsum[n, count - 1]),
                count)

    #: fixed preemptor-axis width of one propose_victims call: one jit
    #: signature regardless of wave width (wider waves chunk + thread the
    #: device carry; narrower ones pad with inert rows).
    WAVE_DEVICE_BUCKET = 128
    #: resync budget: rebuild from the live snapshot after this many
    #: claims or this much wall time, whichever first. Claims are exact
    #: in-wave (in-place ledger) and every candidate is live-verified
    #: before eviction, so the budget only bounds cost-ranking staleness;
    #: 512 lets a 1k-preemptor wave run with ~2 rebuilds instead of 8.
    WAVE_MAX_CLAIMS = 512
    WAVE_MAX_AGE_S = 0.5
    #: a nominated preemptor that never binds stops being charged.
    PROMISE_TTL_S = 30.0

    def _drop_promise(self, pod_key: str) -> None:
        self._promised_victims.pop(pod_key, None)
        node = self._promised_pods.pop(pod_key, None)
        if node is not None:
            entries = self._promised.get(node)
            if entries is not None:
                entries.pop(pod_key, None)
                if not entries:
                    self._promised.pop(node, None)

    def _wave_state(self, snapshot: Snapshot) -> _WaveState:
        wave = self._wave
        if wave is not None and len(wave.nodes) == len(snapshot.nodes) \
                and self._wave_claims < self.WAVE_MAX_CLAIMS \
                and self.clock() - self._wave_built < self.WAVE_MAX_AGE_S:
            return wave
        # Prune ledgers against live residency before rebuilding: a
        # claimed victim still resident keeps its claim (delete in
        # flight); one that vanished is done. A promised preemptor that
        # bound is now a resident and stops being charged separately;
        # one that never binds (deleted pre-bind) ages out on TTL.
        resident: set[str] = set()
        for ni in snapshot.nodes:
            for p in ni.pods:
                resident.add(p.key)
        self._claimed &= resident
        now = self.clock()
        for node in list(self._promised):
            entries = self._promised[node]
            for pk in list(entries):
                _reqs, ts = entries[pk]
                if pk in resident or now - ts > self.PROMISE_TTL_S:
                    entries.pop(pk, None)
                    self._promised_pods.pop(pk, None)
                    self._promised_victims.pop(pk, None)
            if not entries:
                self._promised.pop(node, None)
        wave = _WaveState(snapshot, self._claimed, self._promised)
        self._wave = wave
        self._wave_claims = 0
        self._wave_built = self.clock()
        return wave

    # -- legacy exact scan (fallback + differential reference) -------------

    def _post_filter_scan(self, state: CycleState, pod: PodInfo,
                          snapshot: Snapshot,
                          filtered_status: Mapping[str, Status]
                          ) -> tuple[str, Status]:
        candidates: list[tuple[str, list[PodInfo]]] = []
        for node in snapshot:
            st = filtered_status.get(node.name)
            if st is not None and st.code == UNSCHEDULABLE_AND_UNRESOLVABLE:
                continue
            victims = self._select_victims(state, pod, node)
            if victims is not None:
                candidates.append((node.name, victims))
        if not candidates:
            return "", Status.unschedulable(
                "preemption: 0/%d nodes are available" % len(snapshot))
        node_name, victims = self._pick_one(candidates)
        for v in victims:
            self._claimed.add(v.key)
        self._drop_promise(pod.key)
        self._promised.setdefault(node_name, {})[pod.key] = (
            dict(pod.requests), self.clock())
        self._promised_pods[pod.key] = node_name
        self._promised_victims[pod.key] = [v.key for v in victims]
        self._wave = None
        if self.evict is not None:
            self.evict(pod, [v.key for v in victims], node_name)
        return node_name, Status.success()

    def _select_victims(self, state: CycleState, pod: PodInfo,
                        node: NodeInfo) -> list[PodInfo] | None:
        """Dry-run: remove ALL lower-priority pods; if pod fits, add back as
        many as possible (highest priority first), keeping feasibility."""
        lower = [p for p in node.pods
                 if p.priority < pod.priority and p.key not in self._claimed]
        if not lower:
            return None
        dry = node.clone()
        for v in lower:
            dry.remove_pod(v.key)
        if not self.framework.run_filters(state.clone(), pod, dry).is_success():
            return None
        # Reprieve pass: re-add in priority-desc order while still feasible.
        victims: list[PodInfo] = []
        for v in sorted(lower, key=lambda p: -p.priority):
            dry.add_pod(v)
            if self.framework.run_filters(state.clone(), pod, dry).is_success():
                continue  # reprieved
            dry.remove_pod(v.key)
            victims.append(v)
        return victims if victims else None

    def _pick_one(self, candidates: list[tuple[str, list[PodInfo]]]
                  ) -> tuple[str, list[PodInfo]]:
        """pickOneNodeForPreemption cost ordering (no PDB tier yet —
        disruption controller integration adds it)."""
        def cost(entry):
            _, victims = entry
            return (
                max((v.priority for v in victims), default=0),
                sum(v.priority for v in victims),
                len(victims),
            )
        best = min(cost(e) for e in candidates)
        ties = [e for e in candidates if cost(e) == best]
        return ties[self._rng.randrange(len(ties))]
