#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Drives the port's five paths at scheduler_perf SchedulingBasic/5000Nodes
size (5000 nodes of cpu 8 / memory 32Gi / pods 110, 1000 init pods, then
10000 measured pods of cpu 100m / memory 250Mi in 1024-pod chunks, K=4
orders): `TorchBackend.assign` with KTPU_SOLVE_MODE=greedy pinned (the
greedy wavefront batch solve, W=32), the node-sharded solver of
`kubernetes_tpu_torch.parallel` on a 1-shard and a 4-shard mesh of cuda:0
(each wave two kernel launches, no host sync), flagless
`TorchBackend.assign` (KTPU_SOLVE_MODE=auto, the reference's default:
every chunk through the Sinkhorn plan, rounded by one W=1 launch of
wave_solve), and the serving fast path (1000 lone pods, one at a time,
through `SinglePodFastPath.try_schedule` over a `SchedulerCache`), and the
scheduler loop (`Scheduler.run` through the port's scheduler_perf
`PerfRunner`, pods created in a store and bound through informers, the
queue and the serving tier), with the constraint families, gangs
(Coscheduling in the batched solve) and preemption (DefaultPreemption
with the device victim proposal); and bench.py's 50k-node preset (50000
nodes, 500 + 5000 pods) through `TorchBackend.assign` and the loop (the
card's full-width wave_solve), with the shortlist-pruned solve and its
block prefilter forced and held to it; and the device-topology workloads
(DeviceTopology/1000Nodes with NodeResourceTopologyMatch, and
DeviceTopologyDRA/1000Nodes with DynamicResources and resource claims)
through the loop; and slice-shaped gangs (TopologySlice's contiguous
sub-mesh plan, its scan as PyTorch ops on the card) with agent-backed
nodes and the open-loop churn harness (ChurnSlicePacking at 64 and 256
agents, ChurnDay/5000Nodes-trickle); and the runner's last in-process
families (SchedulingGated, AgentRelistStorm at 2000 and 5000 agents,
ChurnDayFaults with a node death and the node lifecycle controller,
ChurnRebalance with the descheduler off and on); and the apiserver
boundary with the policy chain; and the control plane as processes (the
apiserver with its write-ahead log, two leader-elected schedulers with
the batched solve on the card, node agents); and the sharded control
plane (bench.py's 200k preset over 8 store shards) and the multi-process
control plane (a shard apiserver process per store shard, a
leader-elected scheduler pair, a killed leader); and the controller
manager (Deployments, ReplicaSets, the garbage collector and an Indexed
Job over 5000 KWOK nodes, every pod placed by the scheduler process on
the card); and the gRPC service, the protobuf content type over HTTP and
the CLI —
after
building the hand-written kernels from
`kubernetes_tpu_torch/csrc/` with nvcc and holding each against its plain
PyTorch version on the card.

Phases (any failure raises and the script exits non-zero with no result):
  1. build csrc/wave_solve.cu and csrc/wave_eval.cu for sm_90a, one nvcc
     each, started together, into one library (nvcc's -Xptxas -v report
     printed);
  2. the probe kernel against x + 1 (vector and scalar forms), timed back
     to back in turns with x + 1 and per launch under torch.profiler;
  3. wave_solve against wave_solve_reference, identical assignments and
     counters required, each case printing the launch plan it took: on
     the class planes the port's own prep builds for a 1024-pod chunk
     over 5000 nodes (K=4 poison=True and K=1 poison=False at W=32); on
     seeded heterogeneous chunks (several node shapes, near-ties,
     exception columns, an exhausted resource) at N=5000 and N=4093
     under each strategy, K=4 poison and K=1 replay, at R=16, N=20000
     in the global-carry form, and at N=320 R=11 and N=5120 R=10, whose
     shared memory lies just under 48 KB; and on a seeded conflict storm
     that drives the in-wave replay, the poisoned chunk and its W=1
     rerun; plus the whole CUDA backend against the CPU backend on a
     small cluster;
  4. the main path, with every launch counter set to 0 just before it:
     every pod placed, no node over capacity on a host re-check, the
     kernels launched;
  5. timings (CUDA events), the device's busy share and wave_solve's
     device time per launch (torch.profiler), and the launch-plan sweep
     (clusters of 4, 8, 16 blocks x 128, 256 threads);
  6. the sharded path: (a) wave_eval against wave_eval_reference, masked
     scores and gated mask identical, at W=32, R=2, C=2, local_n 5120 and
     1280, each strategy, with pinned members whose column lies in
     another shard, padding members, an all-infeasible class row and
     uniform nodes; (a') the two-launch wave step (wave_step) against
     wave_step_reference wave by wave, assignments, commit/replay decision
     and carry identical: the first uniform 5k chunk at 1 and 4 shards,
     heterogeneous chunks (W = 1, 8, 32, 64), storms that replay, a 2 x 2
     multislice mesh, members with no feasible node, padding members and
     exception columns; and W=65 raising; (b) the conflict storm through
     the 4-shard route, identical to the one-pod-per-step solver; (c) the
     10000 measured pods through sharded_masks_scores and
     sharded_greedy_assign(wave_w=32, kernel=True) on a 1-shard and a
     4-shard mesh, the used state chained from chunk to chunk, every wave
     loop under torch.cuda.set_sync_debug_mode("error"), every launch
     counter set to 0 just before each and read just after: every pod
     placed, no node over capacity, assignments identical to the
     kernel-off route, the single-device wave scan and TorchBackend.assign,
     exactly two launches per wave (none with the kernel off); (d) pods/s,
     one profiled chunk (device busy, idle share, kernel count, launch A's
     and B's device time), the wave step's ms per wave back to back, plain
     ms and bound, and the standalone wave_eval's ms, plain ms and bound;
  7. the flagless route, under a scoped KTPU_SOLVE_MODE=auto: (a) with
     TF32 off asserted, `sinkhorn_plan` on the card against the port's
     plan on the CPU — on the first flagless measured chunk's planes and on
     three heterogeneous chunks — within the tests' plan tolerance, the
     -1e30 sanitization identical, and one value per group of identical
     columns; (b) `wave_solve` at W=1, poison=False, K=4 on those
     log-plans with w_fit = w_bal = 0 (rows of -1e30 included) identical
     to wave_solve_reference; (c) the 1000 init and 10000 measured pods
     through `TorchBackend()`, every launch counter set to 0 just before
     it and every device pass under torch.cuda.set_sync_debug_mode("error"):
     every pod placed, no node over capacity on a host re-check, every
     chunk an optimal solve, exactly one wave_solve launch per chunk, and
     the first measured chunk placed identically by
     `TorchBackend(device="cpu")` from the same snapshot; (d) pods/s and the
     prep / device / verify split, the device's busy and idle share over a
     profiled repeat of the phase, the plan's ms per chunk (CUDA events),
     its host enqueue time, device kernels and device time (profiler) and
     bound, the W=1 wave_solve's ms and device time per chunk and bound,
     and fragmentation_occupied (%) after the greedy and the flagless
     measured phases; (e) `sharded_sinkhorn_plan` on 1- and 4-shard meshes
     of cuda:0 against the single-device plan;
  8. the serving fast path (`SinglePodFastPath` over `ResidentPlanes` and a
     `SchedulerCache`), under a scoped KTPU_SOLVE_MODE=auto: (a) on 5000
     heterogeneous nodes from `--seed` (three shapes, NoSchedule and
     PreferNoSchedule taints, one cordoned node), 256 lone pods (random
     requests, tolerations, hostname selectors, a few shapes the fast path
     must not take) each through the card's fast path, the CPU port's and,
     when eligible, `TorchBackend(max_batch=16).assign([pi])` on the card —
     all the same node or all None — then assumed; every solve under
     torch.cuda.set_sync_debug_mode("error"); the resident pack equal to a
     fresh pack and the placed/ineligible/no_fit counts equal to the
     CPU's; (b) SchedulingBasic/5000Nodes: the 1000 init pods by flagless
     `TorchBackend.assign`, assumed, `warm`, then 1000 lone pods of the
     measured template through light_snapshot -> try_schedule ->
     assume_pod, every placement equal to the CPU port's over the same
     sequence and every 50th to `TorchBackend.assign([pi])`; the
     per-placement wall (p50/p90/p99/max), serial pods/s, the split of a
     placement, host syncs per placement, and under torch.profiler over 100
     placements the device kernels, device time and idle share;
  9. the scheduler loop (`Scheduler.run` over a port store, informers,
     the SchedulingQueue and the serving tier), under a scoped
     KTPU_SOLVE_MODE=auto with serving on: (a) a heterogeneous cluster
     from `--seed` (64 nodes of three shapes, taints, a zone label, a
     cordoned node) and 300 pre-created pods (random requests and
     priorities, tolerations, zone selectors, preferred node affinity,
     pods that fit nowhere) through `TorchBackend()` on the card and
     through `TorchBackend(device="cpu")`: the same nodeName for every
     pod, the same unschedulable set and FailedScheduling messages, no
     node over capacity; then 64 lone pods trickled, each awaited until
     bound: all bound, some through the fast path, no node over
     capacity; (b) SchedulingBasic/5000Nodes through the port's
     `PerfRunner` (`Scheduler.run`, `TorchBackend()`, batch_size 16384),
     the launch counters set to 0 just before the measured createPods and
     read just after: all 11000 pods bound, no node over capacity on an
     exact host re-check of the store, more pods through the card (backend
     dispatches and the fast path) than through the host path, wave_solve
     launched; printed: SchedulingThroughput, measured_seconds, the exact
     attempt p50/p90/p99/p999, fragmentation_pct and
     fragmentation_occupied_pct, the route counts, `TorchBackend.timings`
     over the window, events emitted and dropped, and over a repeat under
     torch.profiler the device's busy time and idle share (the repeat
     under cProfile that gave the host's own time by area is cut to keep
     the smoke inside its time);
 10. the constraint families (InterPodAffinity and PodTopologySpread),
     under a scoped KTPU_SOLVE_MODE=auto with serving on: (a) the spread
     scans (W=1 and W=32, two strategies, 600 nodes, 256 pods, three
     union-table constraints with keyless and ineligible nodes, a
     minDomains deficit and exception pins) on the card under sync debug
     "error" against CPU torch; one chunk of each constraint shape
     (hostname anti-affinity flagless and greedy, zone affinity and
     preferred terms, hard spread, every template together) through
     `TorchBackend()` against `TorchBackend(device="cpu")` on a 96-node
     cluster in three zones with keyless and tainted nodes and resident
     pods carrying terms: identical assignments, reasons, counters and
     spread domain counts; and every template pre-created through
     `Scheduler.run` on the card and on the CPU: identical bindings and
     FailedScheduling messages; (b) a one-assign flagless probe of 1024
     anti-affinity pods on 5000 nodes (the Sinkhorn route's rounding and
     the verify's rejections), then SchedulingPodAntiAffinity/5000Nodes
     through `PerfRunner` with greedy pinned: every pod bound, no two
     `color: blue` pods on one node, wave_solve launched, no node over
     capacity; (c) TopologySpreading/3000Nodes flagless, every spread scan
     under sync debug "error": every pod bound, the app=spread-me zone
     counts within 1, spread chunks in the window; (d)
     SchedulingPodAffinity/500Nodes: every worker bound in a zone holding
     a hub. (b) and (c) print what 9(b) prints, (b) with a torch.profiler
     repeat at the family's smaller workload (SchedulingPodAnti-
     Affinity/500Nodes); no cProfile repeat, and none of the profiler
     for (c) (cut, as in 12(c), 13(c) and 14(b)-(c), to keep the smoke
     inside its time);
 12. gangs and preemption, under a scoped KTPU_SOLVE_MODE=auto with
     serving on: (a) the five gang chunk shapes of `gang_chunk` (gangs
     that fit; a 64-member gang with one member no node holds; a gang
     whose quota is cut by members already assembled; 18 gangs in one
     chunk, so the overflow counter fires; a gang of hard-spread pods in
     a spread chunk, folded out of the domain counts) through
     `TorchBackend()` with Coscheduling in the profile, flagless and with
     greedy pinned, every flagless device pass and every spread scan
     under sync debug "error", against `TorchBackend(device="cpu")`: identical
     assignments, diagnostics, solver metrics, gang_overflow and spread
     counts; (b) SchedulingBasic/5000Nodes' cluster and 1000 init pods,
     then 156 gangs of 64 (9984 pods of cpu 100m / memory 250Mi,
     minMember 64), a gang held by PreEnqueue (minMember 65) and a gang
     with one member no node holds, created in 512-pod gathers into
     `Scheduler(store, backend=TorchBackend()).run` with the default
     profile plus Coscheduling: every assembling gang bound whole, the
     two failing gangs unbound after their scheduleTimeoutSeconds (5 s),
     no partial gang, no node over capacity; pods/s over the window, the
     optimal solves and wave_solve launches, gang_overflow and `assign`'s
     share of the window (its torch.profiler repeat is cut to keep the
     smoke inside half its time limit); (c) one `propose_victims` bucket (128 preemptors) on the
     card under sync debug "error" against the CPU port at N=1000 and
     N=5000 and on priorities near 2^31 (printed, not required equal),
     then Preemption/1000Nodes (1000 nodes, 4000 fillers, 100 warm-up and
     1000 measured preemptors; not cut) through the port's `PerfRunner`:
     every preemptor bound, victims evicted, none of priority at or above
     its preemptor's, no node over capacity; SchedulingThroughput,
     DefaultPreemption's routes (device-primed, ranked host search,
     per-node host scan, in-flight), `propose_victims` calls, ms per call
     and graph replays, and over a repeat under torch.profiler at
     Preemption/100Nodes the idle share;
 13. large clusters (the shortlist and the block index), under a scoped
     KTPU_SOLVE_MODE=auto with serving on: (a) the shortlist route on the
     card against the CPU port on the eight `shortlist_case` fixtures
     (N=8257, so a ragged last block of 65 columns; 128 pods, K=64, block
     width 128, waves of 32): bound-check fallbacks on a tight cluster,
     ties at the K boundary, a uniform fleet the uniform arm prunes, a
     uniform block before the selection (the full-width pass), a drain
     frontier, padding columns, exception columns and a storm that
     poisons the multistart orders and reruns the chunk — the block
     prefilter (the full-width one too on the uniform fleet), then the
     identity and multistart scans at W=1 and in waves: cand, thresh, sc0
     at the candidates, assignments, fallbacks, commits/replays and blocks
     scanned/pruned identical, every scan under sync debug "error" but
     the counted host reads (`solver._any_flag`: one per block
     prefilter, per single-order scan and per multistart chunk); the five
     block kernels on three strategies; and the spread shortlist scan
     with its domain counts (600 nodes, 256 pods); (b)
     `TorchBackend.assign` at bench.py's 50k preset (50000 nodes of cpu 8
     / memory 32Gi / pods 110, 500 + 5000 pods of cpu 100m / memory
     250Mi, every device pass under sync debug "error" but the host
     reads), flagless (the card's tuner keeps the full-width wave_solve
     at W=64: shortlist pods 0, scan width 50000, at least one launch per
     measured chunk), then on the first measured chunk alone (a cut of
     depth for the smoke's time) with KTPU_SHORTLIST_K=1024 (shortlist
     pods = pods solved, scan width 2048, W=64, the full-width
     prefilter: no block scanned) and with KTPU_BLOCK_WIDTH=128 as well
     (the reference's route: blocks scanned and pruned > 0); each run:
     every pod placed, no node over capacity on an exact
     host re-check, the same assignments as flagless, wave_solve launches
     counted over its measured assign alone; the first measured chunk
     placed identically by `TorchBackend(device="cpu")` (the shortlist
     and block prefilter, the CPU tuner's route); printed: pods/s and the
     prep / device / verify split of each run, the block prefilter's, the
     full-width prefilter's and the narrow scans' ms per chunk and the
     full-width wave_solve's against its bound (CUDA events), the busy
     and idle share over a profiled repeat of the first measured chunk on
     the flagless route (the forced routes' repeats are cut), fallbacks
     and host reads; (c) the same preset through
     the port's `PerfRunner` (`Scheduler.run`, `TorchBackend()`,
     batch_size 16384, bench.py's template: createNodes, createPods
     (warm-up), barrier, createPods (measured), barrier), flagless: all
     5500 pods bound, no node over capacity, the full-width route in the
     window; printed as 9(b), with the node staging seconds, without the
     torch.profiler repeat (cut, like 12(b)'s); (d) one
     chunk of 512 hard zone-spread pods on 9000 nodes in three zones
     through `TorchBackend()` with KTPU_SHORTLIST_K=1024 (the
     spread-shortlist route, W=1) and `TorchBackend(device="cpu")`:
     identical assignments, domain counts and counters; and flagless
     `TorchBackend()` (the spread wave scan): the same assignments and
     domain counts; (e) the sharded route with shortlist_k=64 and
     block_w=128 at W=1 on 1- and 4-shard meshes of cuda:0 against the
     single-device shortlist solve (8192 nodes, 256 pods, two fixtures),
     as are the sharded serial and W=32 wave routes, each timed at 4
     shards;
 14. device topology (NodeResourceTopologyMatch, DynamicResources and
     NodePorts), under a scoped KTPU_SOLVE_MODE=auto with serving on, the
     card's name and power limit printed first: (a) the three
     `device_case` chunks (64 nodes in eight NUMA-zone shapes with seeded
     residents and zone-fitting, zone-misaligned, cpu-heavy, cpu-only and
     memory-only pods; 64 nodes in eight ResourceSlice shapes with
     allocated and unallocated resident claims and single-request,
     unconstrained, two-requests-one-constraint, GPU, wide and pinned
     claims; 16 nodes with residents on 8080/TCP 0.0.0.0 and 9090/TCP
     10.0.0.1 and pods on conflicting and free ports) through
     `TorchBackend()` on the card and `TorchBackend(device="cpu")`,
     flagless and with greedy pinned: identical assignments, diagnostics,
     solver metrics, host-fallback counts and backend counters; (b)
     DeviceTopology/1000Nodes (1000 nodes of cpu 16 / 64Gi / 8 TPUs in two
     NUMA zones, 100 + 3000 pods of cpu 2 / 1Gi / 2 TPUs; not cut) through
     the port's `PerfRunner` with `TorchBackend()` and the workload's own
     schedulerConfig: all 3100 bound, no unschedulable attempt, the
     store's pods re-packed into their nodes' zones with `pack_zones` (no
     zone over capacity, every pod's TPUs in one zone); (c)
     DeviceTopologyDRA/1000Nodes (a ResourceSlice of 8 devices per node,
     4 per numa; one claim per pod for 2 devices matching on numa; not
     cut): all 3100 bound, every claim allocated on its pod's node on one
     numa, 6200 devices in use, none twice. (b) and (c) print what 9(b)
     prints ((b)'s torch.profiler repeat at 100Nodes; (c)'s is cut to keep
     the smoke inside its time), with the optimal
     and greedy dispatches and verify rejects of the measured window,
     whose wave_solve launches must be above 0;
 15. the chunk stream and the volume plugins, under a scoped
     KTPU_SOLVE_MODE=auto with serving on, the card's name and power limit
     printed first (every loop phase above already takes
     `TorchBackend.assign_stream`, as the reference's loop does): (a)
     SchedulingBasic/5000Nodes' first measured 1024-pod chunk after its
     1000 init pods flagless and its first three greedy, a conflict
     storm (48 nodes of 2 CPUs, 256 pods, greedy: replays) and a chunk
     with failures (200 nodes, 512 pods, one in eight fitting nowhere)
     through `assign` and `assign_stream` on the card and `assign` on
     the CPU: identical
     assignments, diagnostics, counters and solver metrics, the stream's
     chunk order `assign`'s finalize order, each yielded chunk's keys
     final; (b) SchedulingBasic/5000Nodes (not cut) through the loop
     through the stream and through `AssignOnly` (`assign` alone), each
     under torch.profiler (one pair: the unprofiled pair is cut to keep
     the smoke inside its time); printed: pods/s, the `assign` share, the idle share and the binds
     that began before their dispatch's last chunk fetch returned; then
     the same 11000 pods pre-created (queued before the loop starts: one
     dispatch of 11 chunks), stream then assign, the stream's
     early binds required above 0 and `assign`'s 0; (c)
     `volume_case`'s chunk (200 nodes in three zones, pre-bound zonal,
     WaitForFirstConsumer and local claims, a shared ReadWriteOncePod
     claim, nodes at their `attachable-volumes-csi` limit) through
     `TorchBackend()` and `TorchBackend(device="cpu")`, flagless and
     greedy: identical assignments, diagnostics, verify rejects and
     host-fallback counts; (d) `volume_loop` at 5000 nodes in three zones
     (250 + 250 pods of one claim each, half bound in advance to zonal
     PVs, half WaitForFirstConsumer claims the ported PV binder
     provisions beside the loop): every pod bound, every claim bound to a
     PV admitting its pod's node, no node over its volume limit, no
     ReadWriteOncePod claim used twice; printed: pods/s, the `assign`
     share, prep and verify and the PreBind waits (the profiled repeat is
     cut to keep the smoke inside its time);
 16. slice topology, the node agents and the churn harness, under a
     scoped KTPU_SOLVE_MODE=auto with serving on, the card's name and
     power limit printed first: (a) `topology.device.device_scan` on the
     card against the port's scan on the CPU over SCAN_MESHES (the 4x4
     torus, the walled 4x8 mesh, the 3x5x2 torus, the 71x71 auto torus of
     5000 nodes, the 8x8x16 torus) x SCAN_SHAPES ((2,2), (1,3), (2,4),
     (4,4), (8,8), (2,2,2), (2,2,8), (4,4,4) and the mesh's full span) x
     `scan_masks` from `--seed` (fully free, random at 0.9 and 0.6,
     symmetric holes, the wrap band): keys, feasibility, frag and
     coverage identical, None on both where the size contract declines,
     `best_key` identical at 1, 4 and 8 shards; the ms per scan (CUDA
     events) and the device kernels and device time per scan
     (torch.profiler) of SCAN_TIMED; (b) the SLICE_CASES fixtures (two
     2x2 gangs on a 4x4 auto torus with a busy cell, a 2x2x2 gang on
     4x4x2, an impossible 1x3 gang) as one chunk (flagless and greedy)
     and through `Scheduler.run`, on the card and on the CPU: identical
     placements, every gang whole on a contiguous sub-mesh, the 1x3 gang
     pending whole, no node over capacity; (c) ChurnSlicePacking/
     64Agents-2x2 and /256Agents-4x4 (the YAML's params: 64 and 256
     in-process NodeAgents on the auto torus, rate 20 and 40 for 6 s, a
     2x2 and a 4x4 gang at 1 s, its node killed at 3.5 s; not cut)
     through the port's `PerfRunner` with `TorchBackend()`: both faults
     recovered, each gang whole on a contiguous sub-mesh, the replacement
     off the dead node, no node over capacity; printed: recovery, attempt
     p50/p99/p999, arrivals, backlog peak, slice fragmentation, plans
     (oracle plans), wave_solve launches and solve_one calls in the
     window (the 64-agent cell's profiled repeat is cut to keep the smoke
     inside its time); (d) ChurnDay/5000Nodes-trickle (5000 nodes, 300 warm-up
     pods, 250/s for 10 s; not cut): no node over capacity, no create
     error; the attempt percentiles and the fast-path share;
 17. the runner's last in-process families, at the YAML's own params
     through the port's `PerfRunner` with `TorchBackend()`, under a
     scoped KTPU_SOLVE_MODE=auto with serving on, the card's name and
     power limit printed first: (a) SchedulingGated/100Nodes (1000 gated
     pods): all bound, measured_pods 1000, none bound before ungatePods;
     pods/s and wave_solve's launches in the window; (b)
     AgentRelistStorm/2000Agents and /5000Agents: relist_storm_agents ==
     N, no direct store scan during the storm, at least N watch-cache
     hits; storm seconds, agent boot seconds, measured pods/s; (c)
     ChurnDayFaults/500Agents-nodeDeath (200/s for 10 s, the agent killed
     at 3 s, grace 2 s, toleration 0.25 s): the fault recovered, the dead
     node and no other tainted unreachable, every displaced pod evicted,
     one replacement per displaced pod, each bound, no node over
     capacity; recovery, the displaced pods (the seed's node may hold
     none at the kill), replacements bound back to the dead node (the
     taint is NoExecute and tolerated 300 s, as in the reference),
     attempt p50/p99/p999, backlog peak and final;
     (d) ChurnRebalance/200Nodes-deschedulerOff and -On: evictions the
     sum of the descheduler's cycles, none over the budget (none with it
     off), the curve sampled, no node over capacity; both curves,
     evictions, recovery, and whether occupied fragmentation ends lower
     with the descheduler on (printed, not gated); (e)
     `solver.consolidation_scores` on the card against the CPU on (d)'s
     last rebalance state and a random 50,000-node state: identical bits;
     CUDA-event ms per call; (f) `solve_provenance()`, then (a)'s
     workload through a `PerfRunner` with a `profile_dir` under build/: one
     Chrome trace naming `wave_solve_kernel`, the result's provenance
     equal to the call's;
 18. the apiserver boundary and the policy chain, through the port's
     `PerfRunner` with `TorchBackend()` under a scoped
     KTPU_SOLVE_MODE=auto with serving on, the card's name and power
     limit printed first: (a) PolicyScale/5000Nodes-1kPolicies at the
     YAML's params (5000 nodes, 1000 + 10000 pods, 1000
     ValidatingAdmissionPolicies over 100 tenants) over the KTPU wire
     (`WireServer.for_apiserver(host="unix:")`, msgpack frames): every
     pod bound, no policy denial, `POLICY_SCALE_EVALS_PER_POD` evaluations
     per measured pod (pinned against the JAX runner on the CPU), index
     hits, `solve_provenance` naming the card and its power limit, a
     wave_solve launch in the window; printed: SchedulingThroughput,
     attempt p50/p99/p999, the index's hits, residue scans and rebuilds,
     staging seconds and the codec; (b) SchedulingBasic/5000Nodes over
     the same wire with no policies: every pod bound; its throughput and
     (a)'s over it (printed, not gated); (c) SchedulingBasic's template
     at 500 nodes, 100 + 1000 pods, through `RemoteStore` over HTTP with
     10 uniform policies: every pod bound, 10 evaluations per measured
     pod;
 19. the control plane as processes, each started with `python -m` as a
     fresh interpreter under a scoped KTPU_SOLVE_MODE=auto with serving on
     (logs, the data dir and the audit log under build/phase19/):
     `kubernetes_tpu_torch.apiserver` with `--data-dir` (fsync batch),
     bearer tokens and an audit policy on the schedulers' pod updates, 4
     `kubernetes_tpu_torch.agent` processes registering their nodes, and
     two `kubernetes_tpu_torch.scheduler` processes with `TPUScorer=true`,
     `--batch-size 16384` and leader election on a 6 s lease; the parent
     stages SchedulingBasic/5000Nodes over `WireStore` (4996 nodes and
     the agents' 4; 1000 init pods, then 10000 measured). (a) pods/s from
     the first measured create to the last bind the parent's informer
     sees: every pod bound once, no node over capacity, the Lease naming
     the one leader, whose line shows `solve_kernel: cuda`; the leader is
     then stopped with SIGTERM and its stop line must show wave_solve
     launches above 0, and a third scheduler is started; (b) SIGKILL
     whichever of the standby and the third scheduler took the lease,
     create 100 canaries after its exit, and time the kill to the last
     canary bound: the other holds the Lease, every canary bound once, by
     its user in the audit log, no pod rebound; (d) 4 pods pinned to the agents' nodes: the nodes
     registered, every pod bound to them marked Running; (c) three flush
     intervals after the last read (and after the newest snapshot on
     disk), SIGKILL the apiserver and restart it on the same data dir and
     ports: every pod back with its nodeName and resource version, the
     highest RV back, and a watch resumed from the last RV sees the next
     write and nothing before it, no 410; then SIGTERM every process,
     each exiting 0, the remaining scheduler's stop line giving its
     launch counts;
 20. the sharded and the multi-process control plane, under a scoped
     KTPU_SOLVE_MODE=auto with serving on (the shard processes' WALs under
     build/phase20/): (a) bench.py's 200k preset (200000 nodes, 500 +
     5000 pods) through the port's `PerfRunner` in process, flagless:
     `store.control_plane_shards` gives 8 shards (KTPU_SHARD_THRESHOLD),
     the runner builds the `ShardedNodeStore`; every pod bound, no node
     over capacity, `shard_count` 8, `shard_tensor_rebuilds_total` above
     0 and at most 8 x the window's ClusterTensors builds with at least
     one delta build (`ClusterTensors.delta_build`), a wave_solve launch
     in the window, `solve_provenance` naming the card; then one full
     chunk at the loop's launch shape (the backend's `max_batch` pods,
     its K multistart orders, poison on) over the run's 200000 nodes (its
     scheduler's last snapshot), on the run's backend's own prep, through
     wave_solve and wave_solve_reference: identical assignments and
     counters (poison flags included), every pod placed by each order
     not poisoned, the
     kernel's ms against `wave_bound_ms`; printed: pods/s, attempt
     p50/p99/p999, staging seconds, the four shard counters, the solve
     route and the launches; (b) SchedulingBasic/5000Nodes (not cut)
     through `PerfRunner(processes=4)`: 4 shard apiserver processes with
     their WALs, a leader-elected scheduler pair with `TorchBackend` on
     cuda:0, the parent through `ProcessShardedStore`: every pod bound
     once (the parent's informer sees no pod change nodes), no node over
     capacity, `process_count` 4, `leader_elections_total` >= 1, a
     wave_solve launch in the leader, and, before the processes stop,
     the merged LISTs of nodes and pods equal to what the shards hold,
     name by name and RV by RV, each node on its crc32 shard; (c)
     ChurnDay/1000Nodes-r100 (1000 nodes, 300 warm-up pods, Poisson
     100/s for 10 s, seed 17) with a `killLeader` fault at 3 s,
     processes=2, KTPU_LEASE_DURATION=6 and a trailing barrier: the fault
     names the killed leader and recovers, every canary and arrival bound
     once, one live Lease holder (not the killed one) at the end,
     `leader_elections_total` >= 2; printed: the time to recovery;
 21. the controller manager, each process started with `python -m` as
     a fresh interpreter under a scoped KTPU_SOLVE_MODE=auto with serving
     on, the card's name and power limit printed first (logs, the data
     dir and the audit log under build/phase21/): one
     `kubernetes_tpu_torch.apiserver` with `--data-dir` (fsync batch),
     bearer tokens and an audit policy on every pod create and delete;
     one `kubernetes_tpu_torch.scheduler` with `TPUScorer=true` and
     `--batch-size 16384`; two `kubernetes_tpu_torch.controllers`
     processes over the KTPU wire, each with its own token,
     `--leader-elect` (KTPU_LEASE_DURATION=6) and `--controllers
     deployment,replicaset,job,gc,podgc` (printed); the parent runs
     `KwokController(node_count=5000, lease_period=10.0)` over `WireStore`
     with SchedulingBasic's node. (a) 20 Deployments of 250 replicas
     (SchedulingBasic's pod, RollingUpdate 25%/25%): pods/s from the
     first create to the last pod Running the parent's informer sees;
     each Deployment one ReplicaSet at 250 replicas and 250 ready, 5000
     live pods each owned by its ReplicaSet, bound once and Running, no
     node over capacity, every live pod's create in the audit log by a
     controller-manager user and none by another, the scheduler's line
     showing `solve_kernel: cuda`; printed: the pods the ReplicaSets
     created and deleted; (b) SIGKILL the lease holder: seconds until
     the other holds the `kube-controller-manager` Lease; (c) every
     template bumped once: seconds until each new ReplicaSet has 250
     ready, each old one 0 and no old pod is left, the end state of (a)
     again; printed, not gated: each Deployment's peak of live pods and
     low of bound pods against 250 + 63 and 250 - 62, the creates and
     deletes; (d) delete 10 Deployments: seconds until the garbage
     collector has removed their ReplicaSets and 2500 pods, the other 10
     Deployments' pods with their names, nodes and RVs; (e) an Indexed
     Job (completions 1024, parallelism 256, KWOK's complete-after 1 s):
     seconds to its Complete condition, `succeeded` 1024, each index
     Succeeded once; then SIGTERM every process, each exiting 0, the
     scheduler's stop line showing wave_solve launches above 0;
 22. the gRPC service, protobuf over HTTP and the CLI, through the port's
     `PerfRunner` with `TorchBackend()` (`transport_runner_cls`: the
     runner itself has no such transport) under a scoped
     KTPU_SOLVE_MODE=auto with serving on, the card's name and power
     limit printed first: (a) SchedulingBasic/5000Nodes (not cut), every
     workload write, informer list and watch, and bind through
     `GRPCRemoteStore` to a `GRPCAPIServer` over the backing store with
     the `WebhookAdmission` and the `AuditPipeline`, the admission window
     pinned (GRPC_ADMISSION_WINDOW_MS): every pod bound, no
     node over capacity, a wave_solve launch in the measured window,
     `solve_provenance` naming the card and its power limit, the store a
     `GRPCRemoteStore`; printed: pods/s, the window, launches, dispatches
     and 18(b)'s wire rate over this one; (b) SchedulingBasic's template
     at 500 nodes, 100 + 1000 pods, with 10 uniform policies through
     `RemoteStore(url, protobuf=True)`: 18(c)'s gates, no node over
     capacity, protobuf responses above 0; (c) before (b)'s `APIServer`
     stops, `python -m kubernetes_tpu_torch.cli --server URL`
     subprocesses, each exiting 0: `get nodes` (a row per node), `get
     pods -o json` (the store's names and nodeNames), `describe nodes` of
     the busiest node (its object), `cordon` then `uncordon` (the store's
     `spec.unschedulable` flips), `top nodes` (each node's requests the
     sum of `pod_requests` of its pods);
 23. the result lines (phase 11 before phase 12 existed, phase 13 before
     phase 14): the whole smoke's wall time, a `kernels` JSON line
     (wave_solve's entry also carries the flagless path's W=1 launches,
     ms, device ms, plain ms and bound, the loop's launches in phase
     9(b)'s measured window, `constraint_launches`, those of 10(b)'s probe
     and the measured windows of 10(b) and 10(d), `gang_launches`, those
     of 12(b)'s window, `gang_chunk_launches`, those of 12(a), and phase
     13's: `large_scan_launches` (13(a)'s poisoned reruns),
     `large_launches` (13(b)'s flagless measured assign, full width),
     `large_shortlist_launches` (its two forced-shortlist measured
     assigns: poisoned reruns), `large_full_width_ms` per chunk against
     `large_full_width_bound_ms`, `large_prefilter_ms` (block),
     `large_plain_prefilter_ms` (full width), `large_narrow_ms` and
     `large_loop_launches`; and phase 14's: `device_chunk_launches` (14(a)'s
     card chunks), `device_topology_launches` and
     `device_topology_dra_launches` (the measured windows of 14(b) and
     14(c)); and phase 15's: `volume_chunk_launches` (15(c)'s card
     chunks) and `volume_loop_launches` (15(d)'s measured window); and
     phase 16's: `slice_fixture_launches` (16(b) on the card),
     `churn_slice_64_launches`, `churn_slice_256_launches` and
     `churn_day_launches` (the measured windows of 16(c) and 16(d)); and
     phase 17's: `gated_launches`, `relist_storm_2000_launches`,
     `relist_storm_5000_launches`, `node_death_launches`,
     `rebalance_off_launches` and `rebalance_on_launches` (the measured
     windows of 17(a)-(d)); and phase 18's: `policy_scale_launches`,
     `wire_basic_launches` and `http_basic_launches` (the measured windows
     of 18(a)-(c)); and phase 19's: `control_plane_launches` (19(a)'s
     leader process, over its life) and `control_plane_failover_launches`
     (19(b)-(d)'s remaining scheduler process); and phase 20's:
     `sharded_200k_launches` (20(a)'s measured window), `huge_chunk_ms`,
     `huge_chunk_plain_ms`, `huge_chunk_bound_ms` and
     `huge_chunk_bound_by` (20(a)'s full chunk at N=200000 with the
     loop's K orders),
     `multiproc_launches` (20(b)'s leader process, over its life) and
     `kill_leader_launches` (20(c)'s surviving leader); and phase 21's:
     `controller_manager_launches` (its scheduler process, over its
     life); and phase 22's: `grpc_launches` and `protobuf_launches` (the
     measured windows of 22(a) and 22(b)); the probe's, its launches over
     phase 9(b)'s run and over 10(b)'s, phase 19's two processes', phase
     20's, phase 21's and phase 22's runs under the same keys), the card's
     name
     and power limit from nvidia-smi, and last {"ok": true, "device":
     {...}}.

Run from the repository root: `python3 chip_smoke.py [--seed N]`; with
`--phase13-only` (or `--phase14-only`, `--phase15-only`,
`--phase16-only`, `--phase17-only`, `--phase18-only`,
`--phase19-only`, `--phase20-only`, `--phase21-only`, `--phase22-only`)
it builds the kernels and runs phase 13 (or 14, 15, ..., 22) alone (no
result lines). It needs one CUDA device;
without one, or outside a checkout of the repository, it exits non-zero.
"""

from __future__ import annotations

import asyncio
import contextlib
import copy
import json
import math
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np

#: NVIDIA H100 SXM published peaks (data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

N_NODES, N_INIT, N_MEASURED = 5000, 1000, 10000
POD_REQUESTS = {"cpu": "100m", "memory": "250Mi"}


def stamped_snapshot(nodes, generation: int):
    """A Snapshot of hand-built NodeInfos, every node stamped with the
    snapshot's generation. A backend that built an earlier snapshot
    re-quantizes only the nodes whose generation moved (the incremental
    ClusterTensors build, as in the reference), and these nodes gain pods
    with no SchedulerCache to bump their generations."""
    from kubernetes_tpu_torch.scheduler.types import Snapshot

    for ni in nodes:
        ni.generation = generation
    return Snapshot(nodes, generation)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls, CUDA events, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def kernel_ms_from(prof, match: str) -> float | None:
    """Mean device milliseconds per launch of the kernels whose name holds
    `match` in a torch.profiler session, or None if it recorded none."""
    hits = [(device_us(e), e.count) for e in prof.key_averages()
            if match in e.key and device_us(e) > 0]
    if not hits:
        return None
    return sum(t for t, _ in hits) / sum(c for _, c in hits) / 1e3


def profiled_kernel_ms(torch, fn, reps: int, match: str) -> float | None:
    """`kernel_ms_from` over `reps` calls of fn under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return kernel_ms_from(prof, match)


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.5f} ms"


def wave_bound_ms(p: int, n: int, r: int, c: int, k: int, s: int,
                  feasible_evals: int) -> tuple[float, str]:
    """Least time for one wave_solve launch: the larger of its bytes (each
    input read once, each output — assign and the counters — written once)
    over HBM bandwidth and its float operations over the fp32 peak. The
    operations are one live score per (order, pod, feasible node) — the
    serial algorithm's own work,
    `feasible_evals` summed over orders and pods — at 9R + 10 float ops
    each (fit: 2 converts, sub/mul, div, compare, mul, 2 adds per column
    plus the mean; balanced: div, min, add, sub, mul, add per column plus
    two divides, sqrt, sub, mul; 4 for the static + weighted sum)."""
    bytes_in = 4 * (2 * p * r + 2 * p + k * p + 3 * n * r + n) \
        + c * math.ceil(n / 8) + 4 * c * n + 5 * r + 8 * s
    bytes_out = 4 * (k * p + 4 * k)
    t_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S
    t_ops = feasible_evals * (9 * r + 10) / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def wave_eval_bound_ms(shards: int, local_n: int, c: int, r: int, w: int,
                       pts: int) -> tuple[float, str]:
    """Least time for one wave_eval launch over `shards` shards: the larger
    of its bytes (each input read once — class mask and static planes,
    node state, member vectors, parameters — and the (W, L) score and mask
    outputs written once) over HBM bandwidth, and its float operations,
    one live score per (shard, member, node) at 9R + 10 each (see
    `wave_bound_ms`), over the fp32 peak."""
    bytes_in = shards * (5 * c * local_n + 4 * (3 * r + 1) * local_n
                         + 4 * w) + w * (8 * r + 13) + 5 * r + 8 * pts
    bytes_out = 5 * shards * w * local_n
    t_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S
    t_ops = shards * w * local_n * (9 * r + 10) / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def wave_step_bound_ms(n: int, r: int, w: int, rows_read: int,
                       pts: int) -> tuple[float, str]:
    """Least time for one wave step over n nodes (all shards together): the
    larger of its bytes — the node state read once (alloc, free_q, used_nz:
    R ints each, and free_pods), the mask byte and static float of each of
    the `rows_read` distinct plane rows the wave's members read, the member
    vectors and parameters, the picks' node state and the (W,) assignments
    written — over HBM bandwidth, and its float operations — one live score
    per (member, node) and one per (member, earlier pick) of the conflict
    check, 9R + 10 each (see `wave_bound_ms`) — over the fp32 peak."""
    bytes_in = 4 * (3 * r + 1) * n + 5 * rows_read * n + w * (8 * r + 9) \
        + 5 * r + 8 * pts
    bytes_out = 4 * w * (2 * r + 1) + 4 * w + 4
    t_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S
    t_ops = (w * n + w * w) * (9 * r + 10) / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def compare_wave_steps(torch, t: dict, rows, exc, sizes, w: int,
                       w_fit: float, w_bal: float,
                       strategy: str) -> tuple[int, int]:
    """The wave step kernel against `wave_step_reference` on the card,
    wave by wave from one carry: the (W,) assignments, the commit/replay
    decision and the carry (free_q, free_pods, used_nz) after each wave
    must be identical. `t` holds the solve's tensors on the card (the
    names of `storm`'s arrays), `sizes` the mesh axes. Returns (waves,
    waves replayed); raises at the first difference."""
    from kubernetes_tpu_torch.ops import solver, wave_eval

    def shards():
        return wave_eval.Shards(
            sizes, t["free_q"], t["free_pods"], t["used_nz_q"], t["alloc_q"],
            t["mask"], t["static_scores"], t["fit_col_w"], t["bal_col_mask"],
            t["shape_u"], t["shape_s"], w_fit, w_bal, strategy)
    kern, plain = shards(), shards()
    (req_w, req_nz_w, rows_w, ex_w), real_w = solver._wave_split(
        w, (t["req_q"], t["req_nz_q"], rows, exc))
    replayed = 0
    for i in range(req_w.shape[0]):
        wave = (req_w[i], req_nz_w[i], rows_w[i], ex_w[i], real_w[i])
        before = (wave_eval.wave_eval.launches,
                  wave_eval.wave_resolve.launches)
        got = wave_eval.wave_step(kern, *wave)
        if (wave_eval.wave_eval.launches, wave_eval.wave_resolve.launches) \
                != (before[0] + 1, before[1] + 1):
            raise RuntimeError("the wave step did not launch its kernels")
        want = wave_eval.wave_step_reference(plain, *wave)
        torch.cuda.synchronize()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        carry = all(torch.equal(a, b)
                    for a, b in zip(kern.carry(), plain.carry()))
        if not (same and carry):
            raise RuntimeError(
                f"wave step kernel differs from wave_step_reference at wave "
                f"{i}: assignments {got[0].tolist()} vs {want[0].tolist()}, "
                f"replayed {got[1].tolist()} vs {want[1].tolist()}, carry "
                f"{'identical' if carry else 'DIFFERS'}")
        replayed += int(want[1])
    return req_w.shape[0], replayed


def wave_eval_case(seed: int, n: int, shards: int, uniform: bool,
                   w: int = 32, r: int = 2, c: int = 2) -> dict:
    """Seeded arguments of one wave_eval launch over `shards` shards of
    n / shards nodes (numpy, shard axis leading). Class row 0 is
    infeasible everywhere; the last three members are padding; member 1 is
    pinned to a column of the last shard and member 2 to one of shard 0,
    so their local column lies outside [0, n / shards) on every other
    shard; `uniform` makes every node identical, so every score ties."""
    rng = np.random.default_rng(seed)
    local_n = n // shards
    if uniform:
        alloc = np.tile(rng.integers(4, 9, size=(1, r)) * 1000, (n, 1))
    else:
        alloc = rng.integers(2, 9, size=(n, r)) * 1000
    alloc = alloc.astype(np.int32)
    used = (alloc * rng.uniform(0, 0.7, size=(n, r))).astype(np.int32)
    free_pods = rng.integers(0, 4, size=(n,)).astype(np.int32)
    if uniform:
        used[:] = used[0]
        free_pods[:] = 3
    mask = rng.random((c, n)) > 0.1
    mask[0] = False
    static = (np.repeat(rng.integers(0, 3, size=(c, 1)), n, axis=1)
              if uniform else rng.uniform(0, 4, size=(c, n)))
    req = rng.integers(100, 2500, size=(w, r)).astype(np.int32)
    e = np.full((w,), -1, np.int32)
    e[1], e[2] = n - 3, 5
    base = np.arange(shards, dtype=np.int32) * local_n

    def by_shard(x, axis):                 # node axis → (shards, ..., L)
        rest = x.shape[:axis] + x.shape[axis + 1:]
        x = np.moveaxis(x, axis, 0).reshape((shards, local_n) + rest)
        return np.ascontiguousarray(np.moveaxis(x, 1, 1 + axis))
    return dict(
        mask=by_shard(mask, 1), static_sc=by_shard(static.astype(
            np.float32), 1),
        alloc_q=by_shard(alloc, 0), free_q=by_shard(alloc - used, 0),
        free_pods=by_shard(free_pods, 0), used_nz=by_shard(used, 0),
        req=req, req_nz=req,
        row=rng.integers(0, c, size=(w,)).astype(np.int32),
        e=e, el=(e[None, :] - base[:, None]).astype(np.int32),
        real=np.arange(w) < w - 3,
        fit_col_w=np.ones((r,), np.float32),
        bal_col_mask=np.ones((r,), np.bool_),
        shape_u=np.array([0.0, 50.0, 100.0], np.float32),
        shape_s=np.array([0.0, 4.0, 10.0], np.float32),
        w_fit=1.0, w_bal=1.0)


def storm(seed: int, n: int = 64, p: int = 256, r: int = 2, k: int = 4):
    """Seeded conflict storm over class planes: identical small nodes
    (every score ties), contested capacity and pod slots, exception
    columns, k pod orders."""
    rng = np.random.default_rng(seed)
    alloc = np.tile(rng.integers(3, 6, size=(1, r)) * 1000,
                    (n, 1)).astype(np.int32)
    used = np.zeros((n, r), np.int32)
    used[n // 2:] = alloc[n // 2:] // 4
    class_req = rng.integers(400, 1800, size=(4, r)).astype(np.int32)
    rows = rng.integers(1, 4, size=(p,)).astype(np.int32)
    mask = rng.random((4, n)) > 0.1
    mask[0] = False
    exc = np.full((p,), -1, np.int32)
    exc[rng.choice(p, size=16, replace=False)] = rng.integers(
        0, n, size=16).astype(np.int32)
    perms = np.stack([np.arange(p, dtype=np.int32)]
                     + [rng.permutation(p).astype(np.int32)
                        for _ in range(k - 1)])
    arrays = dict(
        req_q=class_req[rows], req_nz_q=class_req[rows],
        free_q=alloc - used,
        free_pods=rng.integers(1, 3, size=(n,)).astype(np.int32),
        used_nz_q=used, alloc_q=alloc, mask=mask,
        static_scores=np.repeat(rng.integers(0, 3, size=(4, 1)), n,
                                axis=1).astype(np.float32),
        fit_col_w=np.ones((r,), np.float32),
        bal_col_mask=np.ones((r,), np.bool_),
        shape_u=np.array([0.0, 50.0, 100.0], np.float32),
        shape_s=np.array([0.0, 4.0, 10.0], np.float32))
    return arrays, rows, exc, perms


def hetero_chunk(seed: int, n: int, p: int = 1024, r: int = 2,
                 classes: int = 10, k: int = 4, groups: int = 24):
    """Seeded heterogeneous chunk over class planes, for comparisons that a
    wrong reduction across the blocks of a cluster cannot pass: nodes of
    four allocatable shapes in `groups` groups of identical nodes (equal
    state and static scores, so picks tie inside a group: near-ties), one
    resource near exhaustion on a third of the groups, few pod slots, pods
    of `classes - 1` classes of mixed requests (row 0 is the reserved
    empty class), 24 exception columns, and k pod orders. Same return as
    `storm`."""
    rng = np.random.default_rng(seed)
    shapes = np.stack([np.array([4000, 8000, 16000, 32000]) * (1 + (i % 3))
                       for i in range(r)], axis=1)            # (4, r)
    group = rng.integers(0, groups, size=(n,))
    alloc = shapes[rng.integers(0, 4, size=(groups,))][group].astype(
        np.int32)
    used = (alloc * rng.uniform(0, 0.6, size=(groups, r))[group]).astype(
        np.int32)
    tight = rng.random(groups) < 1 / 3                        # exhaustion
    used[tight[group], r - 1] = alloc[tight[group], r - 1] - 600
    free_pods = rng.integers(1, 4, size=(groups,))[group].astype(np.int32)
    class_req = np.concatenate([
        rng.integers(50, 400, size=(classes // 2, r)),
        rng.integers(300, 3000, size=(classes - classes // 2, r))])
    class_req = class_req.astype(np.int32)
    rows = rng.integers(1, classes, size=(p,)).astype(np.int32)
    mask = rng.random((classes, n)) > 0.2
    mask[0] = False
    static = rng.integers(0, 4, size=(classes, groups))[:, group]
    exc = np.full((p,), -1, np.int32)
    exc[rng.choice(p, size=24, replace=False)] = rng.integers(
        0, n, size=24).astype(np.int32)
    perms = np.stack([np.arange(p, dtype=np.int32)]
                     + [rng.permutation(p).astype(np.int32)
                        for _ in range(k - 1)])
    arrays = dict(
        req_q=class_req[rows], req_nz_q=class_req[rows],
        free_q=alloc - used, free_pods=free_pods, used_nz_q=used,
        alloc_q=alloc, mask=mask,
        static_scores=np.ascontiguousarray(static, dtype=np.float32),
        fit_col_w=np.ones((r,), np.float32),
        bal_col_mask=np.ones((r,), np.bool_),
        shape_u=np.array([0.0, 50.0, 100.0], np.float32),
        shape_s=np.array([0.0, 4.0, 10.0], np.float32))
    return arrays, rows, exc, perms


@contextlib.contextmanager
def no_host_sync_in_wave_loop(torch):
    """Run every wave loop of the sharded route
    (`parallel.sharded._wave_body`) and every spread scan
    (`solver.greedy_assign_rescoring_spread` and its wave form) under
    `torch.cuda.set_sync_debug_mode("error")`: a torch operation that
    synchronises the host with the card inside one raises."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.parallel import sharded

    def guard(fn):
        def guarded(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return guarded

    targets = ((sharded, "_wave_body"),
               (solver, "greedy_assign_rescoring_spread"),
               (solver, "greedy_assign_rescoring_spread_wave"))
    saved = [getattr(mod, name) for mod, name in targets]
    for (mod, name), fn in zip(targets, saved):
        setattr(mod, name, guard(fn))
    try:
        yield
    finally:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, fn)


def sharded_phase(torch, dev, fwk, init_pods, init_assign, measured,
                  main_assignments, node_infos) -> list[dict]:
    """Phase 6, the node-sharded solver on the card; see the module
    docstring. Returns the `wave_eval` and `wave_step` entries of the
    kernels line."""
    from kubernetes_tpu_torch.ops import solver, wave_eval, wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend, chunk_planes
    from kubernetes_tpu_torch.ops.tensorize import NODE_PAD
    from kubernetes_tpu_torch.parallel import (
        build_mesh, build_mesh_2d, sharded, sharded_greedy_assign,
        sharded_masks_scores)

    def on_card(case):
        return {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                else v for k, v in case.items()}

    # -- (a) the kernel against its plain version ---------------------------
    n_pad = math.ceil(N_NODES / NODE_PAD) * NODE_PAD       # 5120
    max_err = 0.0
    for shards in (1, 4):
        local_n = n_pad // shards
        for strategy in wave_kernel.STRATEGIES:
            for uniform in (False, True):
                case = on_card(wave_eval_case(
                    7 + shards, n_pad, shards, uniform))
                before = wave_eval.wave_eval.launches
                got = wave_eval.wave_eval(**case, strategy=strategy)
                ref = wave_eval.wave_eval_reference(**case,
                                                    strategy=strategy)
                torch.cuda.synchronize()
                if wave_eval.wave_eval.launches != before + 1:
                    raise RuntimeError("wave_eval did not launch")
                finite = torch.isfinite(ref[0])
                err = float((got[0] - ref[0])[finite].abs().max())
                same = torch.equal(got[0], ref[0]) and torch.equal(
                    got[1], ref[1])
                max_err = max(max_err, err)
                feasible = int(finite.sum())
                nodes_kind = "uniform" if uniform else "random"
                print(f"compare wave_eval local_n={local_n} shards="
                      f"{shards} {strategy} {nodes_kind} nodes: "
                      f"{'identical' if same else 'DIFFER'}, max |masked "
                      f"diff| {err}, {feasible} feasible of "
                      f"{finite.numel()}")
                if not same:
                    raise RuntimeError("wave_eval differs from its plain "
                                       "version")
                m = got[1].cpu()
                if m[:, -3:].any() or m[:, 1].sum() > 1 or m[:, 2].sum() > 1:
                    raise RuntimeError("wave_eval gated a padding member "
                                       "or a foreign pinned column")

    # -- (b) the conflict storm at 4 shards (before the full-width path: it
    # also warms up every op of the route before that is timed) ---------------
    arrays, rows, exc, _ = storm(seed=1)
    t = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    rows_t, exc_t = torch.from_numpy(rows).to(dev), torch.from_numpy(
        exc).to(dev)
    storm_args = (t["req_q"], t["req_nz_q"], t["free_q"], t["free_pods"],
                  t["used_nz_q"], t["alloc_q"], t["mask"],
                  t["static_scores"], t["fit_col_w"], t["bal_col_mask"],
                  t["shape_u"], t["shape_s"], 1.0, 1.0, "LeastAllocated")
    want = solver.greedy_assign_rescoring(*storm_args, rows=rows_t,
                                          exc=exc_t)
    _, _, replays = solver.greedy_assign_rescoring_wave(
        *storm_args, 32, rows=rows_t, exc=exc_t)
    for kernel in (True, False):
        got = sharded_greedy_assign(build_mesh(4, device=dev), *storm_args,
                                    rows=rows_t, exc=exc_t, wave_w=32,
                                    kernel=kernel)
        same = torch.equal(got, want)
        print(f"compare storm, 4-shard route (kernel "
              f"{'on' if kernel else 'off'}) vs one pod per step: "
              f"{'identical' if same else 'DIFFER'} "
              f"({int((got >= 0).sum())}/{got.numel()} placed, {replays} "
              f"pods replayed by the single-device wave scan)")
        if not same:
            raise RuntimeError("sharded storm differs")

    # -- the full-width chunks -------------------------------------------------
    nodes = node_infos()
    by_name = {ni.name: ni for ni in nodes}
    for pi in init_pods:
        by_name[init_assign[pi.key]].add_pod(pi)
    host = TorchBackend(device=dev)         # its host prep: class planes
    ctx = host._start(measured, stamped_snapshot(nodes, 4), fwk)
    preps = [host._prep_chunk(chunk, ctx) for chunk in ctx.chunks]
    st, prm = host.ensure_static(ctx.ct), ctx.params
    used0 = host.used.pack.clone()
    r = st["alloc_q"].shape[1]
    tf = st["taint_f"].shape[1]
    n = st["alloc_q"].shape[0]
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    score_args = (prm["fit_col_w"], prm["bal_col_mask"], prm["shape_u"],
                  prm["shape_s"], prm["w_fit"], prm["w_bal"],
                  prm["strategy"])

    def chain(used, req_q, req_nz_q, assign):
        hit = assign >= 0
        inc = torch.cat([req_q, req_nz_q, hit.to(torch.int32)[:, None]], 1)
        return used + torch.zeros((n + 1, used.shape[1]), dtype=used.dtype,
                                  device=dev).index_add_(
            0, torch.where(hit, assign, n).long(),
            torch.where(hit[:, None], inc, 0))[:n]

    def solve_inputs(prep, used, mesh2d):
        """The chunk's mask/score phase on `mesh2d`; returns the solver's
        tensors under `storm`'s names, the rows and the exceptions."""
        pack, cls = prep["dev_pack"], prep["dev_cls"]
        cmask = ((prep["dev_mask"][:, :, None] >> shifts) & 1).reshape(
            pack.shape[0], -1).to(torch.bool)[:, :n]
        mask, _, static = sharded_masks_scores(
            mesh2d, st["alloc_q"], used[:, :r], used[:, r:2 * r],
            st["alloc_pods"], used[:, 2 * r], pack[:, :r],
            pack[:, r:2 * r], pack[:, 2 * r:2 * r + tf].to(torch.bool),
            pack[:, 2 * r + tf:].to(torch.bool), st["taint_f"],
            st["taint_p"], cmask, prep["dev_scores"].to(torch.float32),
            prm["w_taint"], prm["taint_filter_on"], prm["strategy"])
        return dict(
            req_q=pack[:, :r][cls.long()],
            req_nz_q=pack[:, r:2 * r][cls.long()],
            free_q=st["alloc_q"] - used[:, :r],
            free_pods=st["alloc_pods"] - used[:, 2 * r],
            used_nz_q=used[:, r:2 * r], alloc_q=st["alloc_q"], mask=mask,
            static_scores=static, fit_col_w=prm["fit_col_w"],
            bal_col_mask=prm["bal_col_mask"], shape_u=prm["shape_u"],
            shape_s=prm["shape_s"]), cls, prep["dev_exc"]

    def sharded_route(shards: int, kernel: bool, chunks=preps):
        mesh2d = build_mesh_2d(shards, device=dev)
        mesh = build_mesh(shards, device=dev)
        used, out = used0, []
        for prep in chunks:
            t, cls, exc = solve_inputs(prep, used, mesh2d)
            assign = sharded_greedy_assign(
                mesh, *t.values(), *score_args[4:], rows=cls, exc=exc,
                row_req_q=prep["dev_pack"][:, :r],
                row_req_nz_q=prep["dev_pack"][:, r:2 * r], wave_w=32,
                kernel=kernel)
            used = chain(used, t["req_q"], t["req_nz_q"], assign)
            out.append(assign[:prep["batch"].p_real])
        return torch.cat(out)

    def single_device_route():
        used, out = used0, []
        for prep in preps:
            pl = chunk_planes(st["alloc_q"], used, st["alloc_pods"],
                              prep["dev_pack"], prep["dev_cls"],
                              st["taint_f"], st["taint_p"], prep["dev_mask"],
                              prep["dev_scores"], prm["w_taint"],
                              prm["taint_filter_on"])
            assign, _, _ = solver.greedy_assign_rescoring_wave(
                pl["req_q"], pl["req_nz_q"], pl["free_q"], pl["free_pods"],
                pl["used_nz_q"], st["alloc_q"], pl["mask"],
                pl["static_scores"], *score_args, 32, rows=prep["dev_cls"],
                exc=prep["dev_exc"])
            used = chain(used, pl["req_q"], pl["req_nz_q"], assign)
            out.append(assign[:prep["batch"].p_real])
        return torch.cat(out)

    # -- (a') the wave step kernels against wave_step_reference ---------------
    step_cases = []
    t5k, cls5k, exc5k = solve_inputs(preps[0], used0, build_mesh_2d(
        1, device=dev))
    for shards in (1, 4):
        step_cases.append((f"uniform 5k chunk, {shards} shard(s), W=32",
                           t5k, cls5k, exc5k, (shards,), 32,
                           prm["w_fit"], prm["w_bal"], prm["strategy"]))

    def seeded(builder, what, seed, sizes, w, strategy, empty_rows=3,
               **kw):
        arrays, rows, exc, _ = builder(seed=seed, k=1, **kw)
        rows = rows.copy()
        rows[:empty_rows] = 0              # members with no feasible node
        step_cases.append((
            what, {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                   for k, v in arrays.items()},
            torch.from_numpy(rows).to(dev), torch.from_numpy(exc).to(dev),
            sizes, w, 1.0, 1.0, strategy))
    for shards in (1, 4):
        seeded(hetero_chunk, f"hetero 5120 nodes, {shards} shard(s), W=32",
               5120 + shards, (shards,), 32, "LeastAllocated", n=5120,
               p=500)
    seeded(hetero_chunk, "hetero 5120 nodes, 4 shards, W=64", 11, (4,), 64,
           "MostAllocated", n=5120, p=500)
    seeded(hetero_chunk, "hetero 1024 nodes, 4 shards, W=8", 12, (4,), 8,
           "RequestedToCapacityRatio", n=1024, p=250)
    seeded(hetero_chunk, "hetero 1024 nodes, 1 shard, W=1", 13, (1,), 1,
           "LeastAllocated", n=1024, p=60)
    seeded(storm, "storm (PR 4's seed), 4 shards, W=32", 1, (4,), 32,
           "LeastAllocated", empty_rows=0)
    seeded(storm, "storm, 4 shards, W=64", 2, (4,), 64, "MostAllocated",
           p=250)
    seeded(storm, "storm, 2 x 2 multislice mesh, W=32", 3, (2, 2), 32,
           "RequestedToCapacityRatio", p=250)
    step_replays = 0
    for what, t, rows_c, exc_c, sizes, w, w_fit, w_bal, strategy \
            in step_cases:
        waves, replayed = compare_wave_steps(torch, t, rows_c, exc_c, sizes,
                                             w, w_fit, w_bal, strategy)
        step_replays += replayed if what.startswith("storm") else 0
        print(f"compare wave step {what}, {rows_c.numel()} pods, "
              f"{strategy}: identical (assignments, commit/replay, carry) "
              f"over {waves} waves, {replayed} replayed")
    if not step_replays:
        raise RuntimeError("the storms replayed no wave on the card")
    t, rows_c, exc_c = step_cases[0][1:4]
    try:
        compare_wave_steps(torch, t, rows_c, exc_c, (4,), 65, 1.0, 1.0,
                           "LeastAllocated")
    except ValueError as err:
        print(f"wave step at W=65 raises: {err}")
    else:
        raise RuntimeError("a wave step wider than its top lists ran")

    # -- (c) the full-width path ---------------------------------------------
    waves = sum(math.ceil(prep["batch"].req_q.shape[0] / 32)
                for prep in preps)
    routes, launches, rates = {}, {}, {}
    with no_host_sync_in_wave_loop(torch):
        for shards in (1, 4):
            torch.cuda.synchronize()
            wave_eval.wave_eval.launches = 0
            wave_eval.wave_resolve.launches = 0
            t0 = time.perf_counter()
            routes[shards] = sharded_route(shards, kernel=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[shards] = (wave_eval.wave_eval.launches,
                                wave_eval.wave_resolve.launches)
            rates[shards] = N_MEASURED / wall
            print(f"sharded route, {shards} shard(s) of {dev}, kernel on: "
                  f"{N_MEASURED} pods in {wall:.3f} s = {rates[shards]:.1f} "
                  f"pods/s; launches: wave_eval (A) {launches[shards][0]}, "
                  f"wave_resolve (B) {launches[shards][1]} ({waves} waves "
                  f"in {len(preps)} chunks), no host sync in the wave loop")
            if launches[shards] != (waves, waves):
                raise RuntimeError(f"{launches[shards]} launches for "
                                   f"{waves} waves, not 2 per wave")
    wave_eval.wave_eval.launches = 0
    wave_eval.wave_resolve.launches = 0
    off = {shards: sharded_route(shards, kernel=False) for shards in (1, 4)}
    single = single_device_route()
    off_launches = (wave_eval.wave_eval.launches,
                    wave_eval.wave_resolve.launches)
    print(f"kernel-off routes and the single-device wave scan: launches "
          f"wave_eval {off_launches[0]}, wave_resolve {off_launches[1]}")
    if any(off_launches):
        raise RuntimeError("the kernel-off route launched a wave kernel")
    for shards in (1, 4):
        for what, other in (("kernel off", off[shards]),
                            ("single-device wave scan", single)):
            same = torch.equal(routes[shards], other)
            print(f"compare sharded {shards}-shard route vs {what}: "
                  f"{'identical' if same else 'DIFFER'}")
            if not same:
                raise RuntimeError(f"sharded route differs from {what}")
    assign = routes[4].cpu().numpy()
    if len(assign) != N_MEASURED or (assign < 0).any():
        raise RuntimeError(f"{int((assign < 0).sum())} pods unplaced by "
                           "the sharded route")
    names = ctx.ct.node_names
    for pi, j in zip(measured, assign):
        by_name[names[j]].add_pod(pi)
    for ni in nodes:
        over = [q for q, v in ni.requested.res.items()
                if v > ni.allocatable.get(q)]
        if over or ni.requested.pods > ni.allocatable.pods:
            raise RuntimeError(f"{ni.name} over capacity: {over}")
    differ = sum(main_assignments[pi.key] != names[j]
                 for pi, j in zip(measured, assign))
    print(f"compare sharded route vs TorchBackend.assign (phase 4): "
          f"{differ} of {N_MEASURED} placements differ")
    if differ:
        raise RuntimeError("the sharded route places differently from "
                           "TorchBackend.assign")

    # -- (d) numbers ----------------------------------------------------------
    # One chunk of the 4-shard route, kernel on, under torch.profiler: the
    # device's busy share and the kernels it launched.
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sharded_route(4, kernel=True, chunks=preps[:1])
        torch.cuda.synchronize()
        chunk_wall = time.perf_counter() - t0
    busy_us = sum(device_us(e) for e in prof.key_averages())
    device_kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                         for e in prof.events())
    a_dev_ms = kernel_ms_from(prof, "wave_eval_kernel<true>")
    b_dev_ms = kernel_ms_from(prof, "wave_resolve_kernel")
    print(f"profiled 4-shard chunk: wall {chunk_wall:.4f} s, device busy "
          f"{busy_us / 1e6:.4f} s, idle share "
          f"{1 - busy_us / 1e6 / chunk_wall:.4f}, {device_kernels} device "
          f"kernels; device time per launch: A (wave_eval, top lists) "
          f"{fmt_ms(a_dev_ms)}, B (wave_resolve) {fmt_ms(b_dev_ms)}")

    # The wave step back to back: the first chunk's waves through
    # `_wave_body` on a fresh copy of its node state each time (CUDA
    # events, the state built outside the timed window).
    (req_w, req_nz_w, rows_w, ex_w), _ = solver._wave_split(
        32, (t5k["req_q"], t5k["req_nz_q"], cls5k, exc5k))
    n_waves = req_w.shape[0]
    rows_read = int(torch.unique(cls5k).numel())

    def fresh(shards):
        return wave_eval.Shards(
            (shards,), t5k["free_q"], t5k["free_pods"], t5k["used_nz_q"],
            t5k["alloc_q"], t5k["mask"], t5k["static_scores"],
            *score_args)

    step_ms, step_plain_ms, host_ms = {}, {}, {}
    for shards in (1, 4):
        times, host = [], []
        for state in [fresh(shards) for _ in range(6)]:
            t0e = torch.cuda.Event(enable_timing=True)
            t1e = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0e.record()
            t0 = time.perf_counter()
            sharded._wave_body(state, t5k["req_q"], t5k["req_nz_q"], cls5k,
                               exc5k, 32, True)
            host.append((time.perf_counter() - t0) * 1e3 / n_waves)
            t1e.record()
            torch.cuda.synchronize()
            times.append(t0e.elapsed_time(t1e) / n_waves)
        # The first run is the warm-up; `host` is the time the host takes
        # to enqueue a wave (the loop returns before the card finishes).
        step_ms[shards] = sum(times[1:]) / len(times[1:])
        host_ms[shards] = sum(host[1:]) / len(host[1:])
        state = fresh(shards)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded._wave_body(state, t5k["req_q"], t5k["req_nz_q"], cls5k,
                           exc5k, 32, False)
        torch.cuda.synchronize()
        step_plain_ms[shards] = (time.perf_counter() - t0) * 1e3 / n_waves
    pts = prm["shape_u"].shape[0]
    step_bound, step_bound_by = wave_step_bound_ms(n, r, 32, rows_read, pts)
    print(f"wave step per wave at W=32, N={n}, R={r}, {rows_read} plane "
          f"row(s) read: {step_ms[1]:.4f} ms (1 shard), {step_ms[4]:.4f} ms "
          f"(4 shards) back to back over the first chunk's {n_waves} waves "
          f"(CUDA events, 5 runs); the host enqueues a wave in "
          f"{host_ms[1]:.4f} / {host_ms[4]:.4f} ms; plain "
          f"{step_plain_ms[1]:.4f} / "
          f"{step_plain_ms[4]:.4f} ms; bound {step_bound:.6f} ms "
          f"({step_bound_by}) per wave, {step_bound * n_waves:.6f} ms per "
          f"chunk")

    case = on_card(wave_eval_case(8, n_pad, 1, False))
    ms = cuda_ms(torch, lambda: wave_eval.wave_eval(
        **case, strategy="LeastAllocated"), 200)
    dev_ms = profiled_kernel_ms(torch, lambda: wave_eval.wave_eval(
        **case, strategy="LeastAllocated"), 50, "wave_eval_kernel<false>")
    plain_ms = cuda_ms(torch, lambda: wave_eval.wave_eval_reference(
        **case, strategy="LeastAllocated"), 20)
    bound_ms, bound_by = wave_eval_bound_ms(1, n_pad, 2, r, 32,
                                            case["shape_u"].shape[0])
    print(f"wave_eval (standalone) per launch at W=32, local_n={n_pad}, "
          f"R={r}, C=2: {ms:.4f} ms back to back (CUDA events), "
          f"{fmt_ms(dev_ms)} of device time (profiler); plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}); "
          f"sharded route {rates[1]:.1f} pods/s at 1 shard, {rates[4]:.1f} "
          f"at 4")
    src = "kubernetes_tpu_torch/csrc/wave_eval.cu"
    replaces = "kubernetes_tpu/ops/pallas_kernel.py:434"
    return [
        {"name": "wave_eval", "route": "cuda", "source": src,
         "replaces": replaces,
         "launches": launches[1][0] + launches[4][0], "max_abs_err": max_err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None},
        {"name": "wave_step", "route": "cuda", "source": src,
         "replaces": replaces,
         "launches": launches[1][1] + launches[4][1], "max_abs_err": 0.0,
         "ms": step_ms[4], "plain_ms": step_plain_ms[4],
         "bound_ms": step_bound, "bound_by": step_bound_by,
         "library_ms": None},
    ]


#: The port's plan tolerance, stated in tests/test_torch_optimal.py (the
#: reference's own parity tolerance): on the plan and the log-plan.
PLAN_RTOL, PLAN_ATOL = 1e-4, 1e-5


def plan_bound_ms(c: int, n: int, iters: int) -> tuple[float, str]:
    """Least time for one `sinkhorn_plan` over (C, N) planes: the larger of
    its bytes (feasible, cost, row counts and capacities read once, the
    log-plan and the plan written once) over HBM bandwidth, and its float
    operations over the fp32 peak: per iteration 4CN (the row marginal's
    and the column sums' products and adds) + 2C + 3N (the two clamps and
    divides and the column min), plus 18CN to set up (row max, shift,
    three stage kernels of divide, exp, flush and mask) and 6CN to finish
    (two products, add, log, the sanitization)."""
    bytes_io = c * n + 4 * c * n + 4 * c + 4 * n + 8 * c * n
    ops = iters * (4 * c * n + 2 * c + 3 * n) + 24 * c * n
    t_bytes, t_ops = bytes_io / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def identical_column_groups(torch, feasible, cost, cap, log_plan) -> int:
    """Raise unless every group of identical columns (feasibility, cost and
    capacity equal in every class row) has bit-identical log-plan columns;
    return the number of groups."""
    key = torch.cat([feasible.to(torch.float32), cost.to(torch.float32),
                     cap.to(torch.float32)[None, :]])
    _, inv = torch.unique(key, dim=1, return_inverse=True)
    groups = int(inv.max()) + 1
    idx = inv[None, :].expand_as(log_plan)
    shape = (log_plan.shape[0], groups)
    lo = torch.full(shape, math.inf, device=log_plan.device).scatter_reduce(
        1, idx, log_plan, "amin")
    hi = torch.full(shape, -math.inf, device=log_plan.device).scatter_reduce(
        1, idx, log_plan, "amax")
    if not torch.equal(lo, hi):
        raise RuntimeError("identical columns got different log-plan values")
    return groups


def compare_plan(torch, what, feasible, cost, counts, cap, iters, temp):
    """The plan on the card against the port's plan on the CPU: the
    log-plan and the plan within (PLAN_RTOL, PLAN_ATOL), the sanitization
    mask identical, identical columns bit-identical on the card. Returns
    (the card's log-plan, max |log-plan diff| on feasible entries)."""
    from kubernetes_tpu_torch.ops import solver

    got = solver.sinkhorn_plan(feasible, cost, counts, cap, iters, temp)
    want = solver.sinkhorn_plan(feasible.cpu(), cost.cpu(), counts.cpu(),
                                cap.cpu(), iters, temp)
    torch.cuda.synchronize()
    close = all(bool(((g.cpu() - w).abs()
                      <= PLAN_ATOL + PLAN_RTOL * w.abs()).all())
                for g, w in zip(got, want))
    same_mask = torch.equal(got[0].cpu() == -1e30, want[0] == -1e30)
    feas = feasible.cpu()
    err = float((got[0].cpu() - want[0])[feas].abs().max()) \
        if bool(feas.any()) else 0.0
    groups = identical_column_groups(torch, feasible, cost, cap, got[0])
    print(f"compare plan {what}: C={cost.shape[0]} N={cost.shape[1]}, "
          f"card vs CPU max |log-plan diff| {err} (tolerance rtol "
          f"{PLAN_RTOL}, atol {PLAN_ATOL}: {'within' if close else 'OUT'}), "
          f"sanitization {'identical' if same_mask else 'DIFFERS'}, "
          f"{groups} groups of identical columns, one value each")
    if not (close and same_mask):
        raise RuntimeError(f"the plan on the card differs from the CPU's: "
                           f"{what}")
    return got[0], err


@contextlib.contextmanager
def no_host_sync_in_device_pass(torch):
    """Run every `TorchBackend` device pass (`backend.mask_solve_update`:
    masks, the plan, the rounding launch, the state update) under
    `torch.cuda.set_sync_debug_mode("error")`: a torch operation that
    waits for the card inside it raises."""
    from kubernetes_tpu_torch.ops import backend

    fn = backend.mask_solve_update

    def guarded(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    backend.mask_solve_update = guarded
    try:
        yield
    finally:
        backend.mask_solve_update = fn


def occupied_fragmentation(torch, backend) -> float:
    """`solver.fragmentation_occupied` (%) of a backend's chained used
    state over the real nodes."""
    from kubernetes_tpu_torch.ops import solver

    st = backend.ensure_static(backend._ct)
    pack = backend.used.pack
    r = st["alloc_q"].shape[1]
    valid = torch.arange(pack.shape[0], device=pack.device) \
        < backend._ct.n_real
    return float(solver.fragmentation_occupied(
        st["alloc_q"] - pack[:, :r], st["alloc_q"], pack[:, 2 * r], valid))


def optimal_phase(torch, dev, fwk, init_pods, measured, node_infos,
                  greedy_frag: float) -> dict:
    """Phase 7, the flagless route (`KTPU_SOLVE_MODE=auto`, which the
    caller scopes: every chunk of 64 or more pods to the Sinkhorn plan and
    its W=1 rounding); see the module docstring. Returns the flagless keys
    of wave_solve's entry in the kernels line."""
    from kubernetes_tpu_torch.ops import kernels, solver, wave_kernel
    from kubernetes_tpu_torch.ops.backend import (
        TorchBackend, chunk_planes, plan_inputs)
    from kubernetes_tpu_torch.parallel import (
        build_mesh, sharded_sinkhorn_plan)
    from kubernetes_tpu_torch.scheduler.types import Snapshot
    from kubernetes_tpu_torch.utils import flags

    if flags.get("KTPU_SOLVE_MODE") != "auto":
        raise RuntimeError("the flagless phase runs under the default "
                           "KTPU_SOLVE_MODE=auto")
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("float32 products may run in TF32 here")
    print("TF32: torch.backends.cuda.matmul.allow_tf32 False, "
          "float32 matmul precision 'highest'")
    iters = max(1, flags.get("KTPU_SINKHORN_ITERS"))
    temp = float(np.float32(flags.get("KTPU_SINKHORN_TEMP")))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def init_nodes(assign):
        nodes = node_infos()
        by_name = {ni.name: ni for ni in nodes}
        for pi in init_pods:
            by_name[assign[pi.key]].add_pod(pi)
        return nodes

    # -- (a) the plan on the card against the CPU's -------------------------
    # The first flagless measured chunk: its class planes after a flagless
    # init, from the backend's own prep.
    host = TorchBackend(device=dev)
    first_init, _ = host.assign(init_pods, stamped_snapshot(node_infos(), 1),
                               fwk)
    ctx = host._start(measured, stamped_snapshot(init_nodes(first_init), 2),
                      fwk)
    prep = host._prep_chunk(ctx.chunks[0], ctx)
    if prep["solve_mode"] != "optimal" or prep["wave_w"] != 0:
        raise RuntimeError(f"the first flagless chunk routed "
                           f"{prep['solve_mode']} at W={prep['wave_w']}")
    st, prm = host.ensure_static(ctx.ct), ctx.params
    pl = chunk_planes(st["alloc_q"], host.used.pack, st["alloc_pods"],
                      prep["dev_pack"], prep["dev_cls"], st["taint_f"],
                      st["taint_p"], prep["dev_mask"], prep["dev_scores"],
                      prm["w_taint"], prm["taint_filter_on"])
    problem = plan_inputs(pl, st["alloc_q"], prep["dev_pack"],
                          prep["dev_cls"], prm["fit_col_w"],
                          prm["bal_col_mask"], prm["shape_u"],
                          prm["shape_s"], prm["w_fit"], prm["w_bal"],
                          prm["strategy"])
    log_plan, plan_err = compare_plan(torch, "first flagless 5k chunk",
                                      *problem, iters, temp)
    hetero = []
    for seed, n in ((31, 5000), (32, 4093), (33, 5120)):
        arrays, rows, exc, perms = hetero_chunk(seed=seed, n=n, p=256)
        t = {k: put(v) for k, v in arrays.items()}
        r = arrays["req_q"].shape[1]
        class_req = np.zeros((arrays["mask"].shape[0], r), np.int32)
        class_req[rows] = arrays["req_q"]
        creq = put(class_req)
        fit0 = (t["free_pods"] >= 1)[None, :] & torch.all(
            creq[:, None, :] <= t["free_q"][None, :, :], dim=-1)
        cost = kernels.chunk_start_scores(
            t["alloc_q"], t["used_nz_q"], creq, t["static_scores"],
            t["fit_col_w"], t["bal_col_mask"], t["shape_u"], t["shape_s"],
            1.0, 1.0, "LeastAllocated")
        counts = put(np.bincount(rows, minlength=class_req.shape[0]).astype(
            np.float32))
        lp, err = compare_plan(torch, f"hetero N={n} seed {seed}",
                               t["mask"] & fit0, cost, counts,
                               t["free_pods"], iters, temp)
        plan_err = max(plan_err, err)
        hetero.append((f"hetero N={n} seed {seed}", t, lp, put(rows),
                       put(exc), put(perms)))

    # -- (b) the rounding: wave_solve at W=1 against its plain version ------
    def rounding_args(t, static):
        return (t["req_q"], t["req_nz_q"], t["free_q"], t["free_pods"],
                t["used_nz_q"], t["alloc_q"], t["mask"], static,
                t["fit_col_w"], t["bal_col_mask"], t["shape_u"],
                t["shape_s"], 0.0, 0.0, prm["strategy"])
    chunk_t = dict(req_q=pl["req_q"], req_nz_q=pl["req_nz_q"],
                   free_q=pl["free_q"], free_pods=pl["free_pods"],
                   used_nz_q=pl["used_nz_q"], alloc_q=st["alloc_q"],
                   mask=pl["mask"], fit_col_w=prm["fit_col_w"],
                   bal_col_mask=prm["bal_col_mask"],
                   shape_u=prm["shape_u"], shape_s=prm["shape_s"])
    cases = [("first flagless 5k chunk", chunk_t, log_plan, prep["dev_cls"],
              prep["dev_exc"], prep["dev_perms"])] + hetero
    w1_plain_ms = None
    for what, t, lp, rows_t, exc_t, perms_t in cases:
        args = rounding_args(t, lp)
        kw = dict(rows=rows_t, exc=exc_t, poison=False, perms=perms_t)
        before = wave_kernel.wave_solve.launches
        got = wave_kernel.wave_solve(*args, 1, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = wave_kernel.wave_solve_reference(*args, 1, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if w1_plain_ms is None:
            w1_plain_ms = plain_ms
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        sanitized = int((lp == -1e30).sum())
        print(f"compare rounding {what}: wave_solve W=1 poison=False "
              f"K={perms_t.shape[0]}, w_fit = w_bal = 0, {sanitized} "
              f"entries at -1e30: {'identical' if same else 'DIFFER'} to "
              f"wave_solve_reference ({int((got[0] >= 0).sum())} of "
              f"{got[0].numel()} placed; plain {plain_ms:.1f} ms)")
        if not same or wave_kernel.wave_solve.launches != before + 1:
            raise RuntimeError(f"W=1 rounding differs: {what}")

    # -- (c) the flagless measured phase at full width -----------------------
    with no_host_sync_in_device_pass(torch):
        torch.cuda.synchronize()
        wave_kernel.wave_solve.launches = 0
        wave_kernel.probe.launches = 0
        backend = TorchBackend()
        init_assign, _ = backend.assign(
            init_pods, stamped_snapshot(node_infos(), 1), fwk)
        if any(v is None for v in init_assign.values()):
            raise RuntimeError("flagless init pods unplaced")
        nodes = init_nodes(init_assign)
        cpu_nodes = init_nodes(init_assign)
        before_t = dict(backend.timings)
        before_c = dict(backend.counters)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        assignments, _ = backend.assign(measured, stamped_snapshot(nodes, 2),
                                        fwk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    launches = {"wave_solve": wave_kernel.wave_solve.launches,
                "probe": wave_kernel.probe.launches}
    phases = {k: round(v - before_t[k], 6)
              for k, v in backend.timings.items()}
    chunks = backend.counters["chunks"] - before_c["chunks"]
    solves = backend.counters["optimal_solves"] - before_c["optimal_solves"]
    unplaced = [k for k, v in assignments.items() if v is None]
    if len(assignments) != N_MEASURED or unplaced:
        raise RuntimeError(f"{len(unplaced)} flagless pods unplaced")
    by_name = {ni.name: ni for ni in nodes}
    for pi in measured:
        by_name[assignments[pi.key]].add_pod(pi)
    for ni in nodes:
        over = [q for q, v in ni.requested.res.items()
                if v > ni.allocatable.get(q)]
        if over or ni.requested.pods > ni.allocatable.pods:
            raise RuntimeError(f"{ni.name} over capacity: {over}")
    total_chunks = backend.counters["chunks"]
    if solves != chunks or backend.counters["optimal_solves"] \
            != total_chunks:
        raise RuntimeError(f"{solves} optimal solves for {chunks} chunks")
    if launches["wave_solve"] != total_chunks or launches["probe"] < 1:
        raise RuntimeError(f"launches {launches} for {total_chunks} chunks "
                           "(init included), not one wave_solve each")
    flag_frag = occupied_fragmentation(torch, backend)
    rate = N_MEASURED / wall
    print(f"flagless path (KTPU_SOLVE_MODE=auto): {N_MEASURED} measured pods "
          f"in {wall:.3f} s = {rate:.1f} pods/s; {chunks} chunks, "
          f"{solves} optimal solves, Sinkhorn iterations "
          f"{backend.counters['sinkhorn_iterations']}; launches {launches} "
          f"({total_chunks} chunks with the init); no host sync in any "
          f"device pass")
    print(f"flagless measured phase host-clock seconds: {json.dumps(phases)}")
    # The device's busy share: the same measured phase again, on a fresh
    # copy of the post-init cluster, under torch.profiler.
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t2 = time.perf_counter()
        again, _ = backend.assign(
            measured, stamped_snapshot(init_nodes(init_assign), 4), fwk)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t2
    if again != assignments:
        raise RuntimeError("a repeated flagless phase placed pods differently")
    busy_us = sum(device_us(e) for e in prof.key_averages())
    print(f"profiled flagless measured phase: wall {prof_wall:.3f} s, device "
          f"busy {busy_us / 1e6:.4f} s" + (
              f", idle share {1 - busy_us / 1e6 / prof_wall:.4f}"
              if busy_us else ", device time not measured by the profiler")
          + f"; wave_solve device time per launch "
          f"{fmt_ms(kernel_ms_from(prof, 'wave_solve_kernel'))}")
    cpu_assign, _ = TorchBackend(device="cpu").assign(
        measured[:1024], Snapshot(cpu_nodes, 3), fwk)
    differ = sum(cpu_assign[pi.key] != assignments[pi.key]
                 for pi in measured[:1024])
    print(f"compare flagless first chunk, card vs TorchBackend(device='cpu') "
          f"from the same snapshot: {differ} of 1024 placements differ")
    if differ:
        raise RuntimeError("the flagless first chunk places differently on "
                           "the card and on the CPU")

    # -- (d) numbers ---------------------------------------------------------
    def plan_call():
        return solver.sinkhorn_plan(*problem, iters, temp)
    plan_ms = cuda_ms(torch, plan_call, 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        plan_call()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        plan_call()
        torch.cuda.synchronize()
    plan_kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                       for e in prof.events())
    plan_dev_ms = sum(device_us(e) for e in prof.key_averages()) / 1e3
    c, n = problem[1].shape
    pbound, pbound_by = plan_bound_ms(c, n, iters)
    print(f"sinkhorn_plan per chunk, C={c} N={n}, {iters} iterations: "
          f"{plan_ms:.4f} ms back to back (CUDA events, 20 calls), the host "
          f"enqueues one in {enqueue_ms:.4f} ms, {plan_kernels} device "
          f"kernels and {plan_dev_ms:.5f} ms of device time per plan "
          f"(profiler); bound {pbound:.6f} ms ({pbound_by})")
    w1_args = rounding_args(chunk_t, log_plan)
    w1_kw = dict(rows=prep["dev_cls"], exc=prep["dev_exc"], poison=False,
                 perms=prep["dev_perms"])
    w1_ms = cuda_ms(torch, lambda: wave_kernel.wave_solve(
        *w1_args, 1, **w1_kw), 10)
    w1_dev_ms = profiled_kernel_ms(torch, lambda: wave_kernel.wave_solve(
        *w1_args, 1, **w1_kw), 5, "wave_solve_kernel")
    p, r = pl["req_q"].shape
    k = prep["dev_perms"].shape[0]
    class_req = prep["dev_pack"][:, :r]
    feasible = pl["mask"] & (pl["free_pods"] >= 1)[None, :] & torch.all(
        class_req[:, None, :] <= pl["free_q"][None, :, :], dim=-1)
    evals = k * int(feasible.sum(dim=1)[prep["dev_cls"].long()].sum())
    w1_bound, w1_bound_by = wave_bound_ms(
        p, n, r, c, k, prm["shape_u"].shape[0], evals)
    print(f"wave_solve W=1 (the rounding) per 1024-pod chunk: {w1_ms:.4f} ms "
          f"back to back (CUDA events), {fmt_ms(w1_dev_ms)} of device time "
          f"(profiler), plan {wave_kernel.wave_launch_plan(n, r, 1)}; plain "
          f"{w1_plain_ms:.1f} ms; bound {w1_bound:.6f} ms ({w1_bound_by})")
    print(f"fragmentation_occupied after the measured phase: greedy "
          f"{greedy_frag:.4f} %, flagless {flag_frag:.4f} %")

    # -- (e) the sharded plan -----------------------------------------------
    for shards in (1, 4):
        got = sharded_sinkhorn_plan(build_mesh(shards, device=dev),
                                    *problem, iters, temp)
        want = plan_call()
        torch.cuda.synchronize()
        close = all(bool(((g - w).abs()
                          <= PLAN_ATOL + PLAN_RTOL * w.abs()).all())
                    for g, w in zip(got, want))
        same_mask = torch.equal(got[0] == -1e30, want[0] == -1e30)
        print(f"compare sharded_sinkhorn_plan, {shards} shard(s) of {dev}, vs "
              f"the single-device plan: max |log-plan diff| "
              f"{float((got[0] - want[0])[problem[0]].abs().max())}, "
              f"{'within' if close else 'OUT OF'} tolerance, sanitization "
              f"{'identical' if same_mask else 'DIFFERS'}")
        if not (close and same_mask):
            raise RuntimeError("the sharded plan differs")
    return {"flagless_launches": launches["wave_solve"],
            "flagless_ms": w1_ms, "flagless_device_ms": w1_dev_ms,
            "flagless_plain_ms": w1_plain_ms, "flagless_bound_ms": w1_bound,
            "flagless_bound_by": w1_bound_by,
            "flagless_plan_max_abs_err": plan_err}


SERVING_SHAPES = ({"cpu": "8", "memory": "32Gi", "pods": "110"},
                  {"cpu": "16", "memory": "64Gi", "pods": "110"},
                  {"cpu": "4", "memory": "16Gi", "pods": "32"})
N_LONE_CHECKED, N_TRICKLE, N_PROFILED = 256, 1000, 100


def solve_one_case(torch, seed: int, n: int, strategy: str,
                   uniform: bool = False, bucket: int = 0) -> tuple:
    """Seeded positional arguments of `solver.solve_one` on the CPU (or,
    with `bucket` > 0, of `solve_one_fresh`, with `bucket` delta rows
    padded by repeating the first): n nodes of random capacity and usage,
    or identical ones (`uniform`: every score ties), random taint
    membership, a 90%-dense base mask, an f16 host score row."""
    rng = np.random.default_rng(seed)
    r, tf, tp = 2, 3, 2
    if uniform:
        alloc_q = np.tile(np.array([8000, 32768], np.int32), (n, 1))
        used_q = alloc_q // 4
    else:
        alloc_q = rng.choice([4000, 8000, 16000], size=(n, r)).astype(
            np.int32)
        used_q = (alloc_q * rng.uniform(0, 1.05, size=(n, r))).astype(
            np.int32)
    used_pods = rng.integers(0, 12, size=n).astype(np.int32)
    pack = np.concatenate([used_q, used_q, used_pods[:, None]], axis=1)
    m = rng.random(((n + 7) // 8) * 8) < 0.9
    m[n:] = False
    req = rng.integers(100, 1200, size=r).astype(np.int32)
    arrays = [alloc_q, pack.astype(np.int32),
              rng.choice([10, 110], size=n).astype(np.int32),
              rng.random((n, tf)) < (0 if uniform else 0.15),
              rng.random((n, tp)) < (0 if uniform else 0.3), np.packbits(m),
              rng.choice([0.0, 12.5, 50.0], size=n).astype(np.float16)
              * (not uniform),
              np.concatenate([req, req, (rng.random(tf) < 0.5),
                              (rng.random(tp) < 0.6)]).astype(np.int32)]
    if bucket:
        real = max(1, bucket - 1)
        rows = np.sort(rng.choice(n, size=real, replace=False))
        rows = np.concatenate([rows, rows[:1].repeat(bucket - real)])
        vals = rng.integers(0, 40, size=(real, 2 * r + 1))
        vals = np.concatenate([vals, vals[:1].repeat(bucket - real, 0)])
        arrays[2:2] = [rows.astype(np.int32), vals.astype(np.int32)]
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    params = [torch.tensor([1.0, 2.0]), torch.ones(r, dtype=torch.bool),
              torch.tensor([0.0, 50.0, 100.0]), torch.tensor([10.0, 3.0, 0.0])]
    return (*tensors, *params, 1.0, 1.0, 3.0, True, strategy)


def serving_nodes(seed: int, n: int = N_NODES) -> list[dict]:
    """Phase 8(a)'s cluster: n nodes of three allocatable shapes drawn
    from `seed`, a NoSchedule taint on every 7th node, a PreferNoSchedule
    taint on every 11th, and node 13 cordoned."""
    from kubernetes_tpu_torch.api.types import make_node

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        taints = []
        if i % 7 == 0:
            taints.append({"key": "dedicated", "value": "infra",
                           "effect": "NoSchedule"})
        if i % 11 == 0:
            taints.append({"key": "spot", "value": "true",
                           "effect": "PreferNoSchedule"})
        out.append(make_node(
            f"node-{i}", allocatable=dict(
                SERVING_SHAPES[int(rng.integers(0, 3))]),
            taints=taints or None, unschedulable=(i == 13)))
    return out


def lone_pods(seed: int, count: int, n: int = N_NODES) -> list[tuple]:
    """Phase 8(a)'s traffic: (PodInfo, kind) with random requests, ~30%
    tolerating the NoSchedule taint, ~25% pinned by a hostname
    nodeSelector, and a few of each shape the fast path must not take
    (kind != "plain"): inter-pod affinity, host ports, preferred node
    affinity, a nominated node; and pods that fit nowhere ("huge")."""
    from kubernetes_tpu_torch.api.types import make_pod
    from kubernetes_tpu_torch.scheduler.types import PodInfo

    rng = np.random.default_rng(seed + 1)
    out = []
    for t in range(count):
        kw = {"requests": {
            "cpu": f"{int(rng.choice([100, 250, 500, 900, 1700]))}m",
            "memory": f"{int(rng.choice([128, 512, 1024, 3000]))}Mi"}}
        if rng.random() < 0.3:
            kw["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        if rng.random() < 0.25:
            kw["node_selector"] = {
                "kubernetes.io/hostname": f"node-{rng.integers(0, n)}"}
        kind, u = "plain", rng.random()
        if u < 0.02:
            kind, kw["requests"] = "huge", {"cpu": "64"}
        elif u < 0.04:
            kind, kw["affinity"] = "affinity", {"podAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "topologyKey": "kubernetes.io/hostname",
                    "labelSelector": {"matchLabels": {"app": "x"}}}]}}
        elif u < 0.05:
            kind, kw["host_ports"] = "ports", [8080]
        elif u < 0.06:
            kind, kw["affinity"] = "preferred", {"nodeAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 5, "preference": {"matchExpressions": [{
                        "key": "kubernetes.io/hostname", "operator": "In",
                        "values": ["node-1"]}]}}]}}
        elif u < 0.07:
            kind = "nominated"
        pi = PodInfo(make_pod(f"lone-{t}", uid=f"lone-{t}", **kw))
        if kind == "nominated":
            pi.nominated_node = "node-0"
        out.append((pi, kind))
    return out


@contextlib.contextmanager
def counted_solves(torch, sync_error: bool):
    """Count the fast path's `solver.solve_one` (plain) and
    `solve_one_fresh` (fused) calls; with `sync_error`, each runs under
    `torch.cuda.set_sync_debug_mode("error")`, so a torch operation that
    waits for the card inside the solve raises."""
    from kubernetes_tpu_torch.ops import solver

    counts = {"plain": 0, "fused": 0}
    fns = {"plain": solver.solve_one, "fused": solver.solve_one_fresh}

    def wrap(kind):
        def call(*args, **kw):
            counts[kind] += 1
            if sync_error:
                torch.cuda.set_sync_debug_mode("error")
            try:
                return fns[kind](*args, **kw)
            finally:
                if sync_error:
                    torch.cuda.set_sync_debug_mode("default")
        return call
    solver.solve_one, solver.solve_one_fresh = wrap("plain"), wrap("fused")
    try:
        yield counts
    finally:
        solver.solve_one, solver.solve_one_fresh = fns["plain"], fns["fused"]


def compare_solve_one(torch, dev, seed: int, n: int, strategy: str,
                      uniform: bool = False, bucket: int = 0) -> int:
    """`solver.solve_one` (or, with `bucket`, `solve_one_fresh`) on the
    card against the same call on the CPU, on `solve_one_case`'s inputs:
    the index (and the refreshed pack) must be identical, the card's call
    must not wait for the card (sync debug mode "error"), and the input
    pack must be left as it was. Returns the index."""
    from kubernetes_tpu_torch.ops import solver

    args = solve_one_case(torch, seed, n, strategy, uniform, bucket)
    on_card = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                    for a in args)
    fn = solver.solve_one_fresh if bucket else solver.solve_one
    want = fn(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, got = (want, got) if bucket else ((want,), (got,))
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    if not same or not torch.equal(on_card[1].cpu(), args[1]):
        raise RuntimeError(f"solve_one{'_fresh' if bucket else ''} on the "
                           f"card differs from the CPU: seed {seed}, n {n}, "
                           f"{strategy}, uniform {uniform}, bucket {bucket}")
    return int(want[0])


def fresh_pack(torch, ct):
    return torch.from_numpy(np.concatenate(
        [ct.used_q, ct.used_nz_q, ct.used_pods.astype(np.int32)[:, None]],
        axis=1))


def serving_phase(torch, fwk, init_pods, seed: int) -> None:
    """Phase 8, the serving fast path; see the module docstring."""
    import warnings

    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
    from kubernetes_tpu_torch.scheduler.types import PodInfo
    from kubernetes_tpu_torch.serving import ResidentPlanes, SinglePodFastPath

    def fast_path(device=None):
        backend = TorchBackend(device=device)
        return SinglePodFastPath(backend, ResidentPlanes(backend))

    # -- (a) solve_one on the card against the CPU, then the whole path ----
    dev = torch.device("cuda:0")
    picks = [compare_solve_one(torch, dev, seed + k, 5120, strategy,
                               uniform=uniform, bucket=bucket)
             for k, strategy in enumerate(wave_kernel.STRATEGIES)
             for uniform in (False, True) for bucket in (0, 1, 2, 4)]
    print(f"compare solve_one / solve_one_fresh, card vs CPU at N=5120 "
          f"(each strategy, random and tied nodes, buckets 0/1/2/4): "
          f"{len(picks)} identical, none waiting for the card; picks "
          f"{picks}")

    # -- (a) the card, the batch path's first step and the CPU port --------
    t0 = time.perf_counter()
    cache = SchedulerCache()
    for nd in serving_nodes(seed):
        cache.add_node(nd)
    card, cpu = fast_path(), fast_path("cpu")
    batch = TorchBackend(max_batch=16)
    batch_checked = 0
    kinds: dict[str, int] = {}
    with counted_solves(torch, sync_error=True) as solves:
        for pi, kind in lone_pods(seed, N_LONE_CHECKED):
            kinds[kind] = kinds.get(kind, 0) + 1
            snap = cache.update_snapshot()
            got = card.try_schedule(pi, snap, fwk)
            want = cpu.try_schedule(pi, snap, fwk)
            if got != want:
                raise RuntimeError(f"{pi.key} ({kind}): the card's fast path "
                                   f"says {got}, the CPU port's {want}")
            if kind in ("plain", "huge"):
                first, _ = batch.assign([pi], snap, fwk)
                batch_checked += 1
                if first[pi.key] != got:
                    raise RuntimeError(
                        f"{pi.key} ({kind}): fast path {got}, "
                        f"TorchBackend(max_batch=16).assign {first[pi.key]}")
            elif got is not None:
                raise RuntimeError(f"{pi.key} ({kind}) took the fast path")
            if got is not None:
                cache.assume_pod(pi, got)
                cache.finish_binding(pi.key)
    snap = cache.update_snapshot()
    ct = card.backend._tensors(snap)
    if not torch.equal(card.resident.used_pack(ct, snap).cpu(),
                       fresh_pack(torch, ct)):
        raise RuntimeError("the card's resident pack differs from a fresh "
                           "pack of the final ClusterTensors")
    counts = (card.placed, card.ineligible, card.no_fit)
    if counts != (cpu.placed, cpu.ineligible, cpu.no_fit):
        raise RuntimeError(f"placed/ineligible/no_fit {counts} on the card, "
                           f"{(cpu.placed, cpu.ineligible, cpu.no_fit)} on "
                           "the CPU")
    print(f"compare serving fast path, {N_LONE_CHECKED} lone pods at "
          f"{N_NODES} heterogeneous nodes (seed {seed}; kinds {kinds}): card "
          f"= CPU port on all, = TorchBackend(max_batch=16).assign on "
          f"{batch_checked} eligible; placed/ineligible/no_fit {counts} "
          f"on both; solves {solves['plain']} plain, {solves['fused']} "
          f"fused, none waiting for the card; resident pack = fresh pack "
          f"({card.resident.full_rebuilds} full rebuilds, "
          f"{card.resident.row_refreshes} row refreshes); "
          f"{time.perf_counter() - t0:.1f} s")

    # -- (b) the full-width trickle ------------------------------------------
    t0 = time.perf_counter()

    def basic_cluster(init_assign=None):
        c = SchedulerCache()
        for i in range(N_NODES):
            c.add_node(make_node(f"node-{i}"))
        if init_assign is not None:
            for pi in init_pods:
                c.assume_pod(pi, init_assign[pi.key])
                c.finish_binding(pi.key)
        return c

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wave_kernel.wave_solve.launches = 0
    wave_kernel.probe.launches = 0
    cache = basic_cluster()
    fp = fast_path()
    init_assign, _ = fp.backend.assign(init_pods, cache.update_snapshot(),
                                       fwk)
    if any(v is None for v in init_assign.values()):
        raise RuntimeError("serving init pods unplaced")
    for pi in init_pods:
        cache.assume_pod(pi, init_assign[pi.key])
        cache.finish_binding(pi.key)
    trickle = [PodInfo(make_pod(f"trickle-{i}", uid=f"trickle-{i}",
                                requests=POD_REQUESTS))
               for i in range(N_TRICKLE + N_PROFILED + 20)]
    fp.warm(PodInfo(make_pod("warm", requests=POD_REQUESTS)),
            cache.light_snapshot(), fwk)
    check = TorchBackend(max_batch=16)
    walls, snap_s, placed = [], 0.0, []
    before = dict(fp.timings)
    with counted_solves(torch, sync_error=False) as solves:
        for i, pi in enumerate(trickle[:N_TRICKLE]):
            if i % 50 == 0:
                first, _ = check.assign([pi], cache.update_snapshot(), fwk)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            snap = cache.light_snapshot()
            t2 = time.perf_counter()
            node = fp.try_schedule(pi, snap, fwk)
            if node is not None:
                cache.assume_pod(pi, node)
            walls.append(time.perf_counter() - t1)
            snap_s += t2 - t1
            if node is None:
                raise RuntimeError(f"trickle pod {i} unplaced")
            if i % 50 == 0 and first[pi.key] != node:
                raise RuntimeError(
                    f"trickle pod {i}: fast path {node}, "
                    f"TorchBackend.assign {first[pi.key]}")
            placed.append(node)
    launches = {"wave_solve": wave_kernel.wave_solve.launches,
                "probe": wave_kernel.probe.launches}
    split = {"snapshot_s": snap_s, **{
        k: v - before[k] for k, v in fp.timings.items()}}
    peak = torch.cuda.max_memory_allocated()
    w = np.sort(np.array(walls)) * 1e3
    pct = {q: float(np.percentile(w, q)) for q in (50, 90, 99)}
    rate = N_TRICKLE / float(np.sum(walls))
    # Host syncs of one placement: torch warns at each operation that
    # waits for the card.
    syncs = []
    for pi in trickle[N_TRICKLE:N_TRICKLE + 20]:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                node = fp.try_schedule(pi, cache.light_snapshot(), fwk)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        cache.assume_pod(pi, node)
        syncs.append(sum("synchroniz" in str(c.message) for c in caught))
    # Device kernels, device time and idle share over N_PROFILED
    # placements.
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for pi in trickle[N_TRICKLE + 20:]:
            node = fp.try_schedule(pi, cache.light_snapshot(), fwk)
            cache.assume_pod(pi, node)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    busy_us = sum(device_us(e) for e in prof.key_averages())
    on_card = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    h2d = sum("HtoD" in k for k in on_card)
    d2h = sum("DtoH" in k for k in on_card)
    n_kernels = sum(not k.startswith(("Memcpy", "Memset")) for k in on_card)
    by_name: dict[str, int] = {}
    for k in on_card:
        k = k.replace("void ", "").replace("(anonymous namespace)::", "")
        k = k.split("<")[0].split("(")[0].strip()
        by_name[k] = by_name.get(k, 0) + 1
    # The CPU port over the same sequence.
    cpu_cache = basic_cluster(init_assign)
    cpu_fp = fast_path("cpu")
    cpu_fp.warm(PodInfo(make_pod("warm", requests=POD_REQUESTS)),
                cpu_cache.light_snapshot(), fwk)
    for i, pi in enumerate(trickle[:N_TRICKLE]):
        got = cpu_fp.try_schedule(pi, cpu_cache.light_snapshot(), fwk)
        if got != placed[i]:
            raise RuntimeError(f"trickle pod {i}: card {placed[i]}, CPU "
                               f"port {got}")
        cpu_cache.assume_pod(pi, got)
    print(f"serving trickle (SchedulingBasic/{N_NODES}Nodes, {N_INIT} init "
          f"pods by flagless TorchBackend.assign, then {N_TRICKLE} lone pods "
          f"of {POD_REQUESTS} through light_snapshot -> try_schedule -> "
          f"assume_pod): all placed, identical to the CPU port on all "
          f"{N_TRICKLE} and to TorchBackend.assign on every 50th; solves "
          f"{solves['plain']} plain, {solves['fused']} fused; launches "
          f"{launches}; resident {fp.resident.full_rebuilds} full rebuilds, "
          f"{fp.resident.row_refreshes} row refreshes; "
          f"max_memory_allocated {peak} bytes")
    print(f"serving per-placement wall (host clock): p50 {pct[50]:.4f} ms, "
          f"p90 {pct[90]:.4f} ms, p99 {pct[99]:.4f} ms, max "
          f"{float(w[-1]):.4f} ms; serial {rate:.1f} lone pods/s")
    print(f"serving placement split, ms per placement: " + json.dumps(
        {k: round(v * 1e3 / N_TRICKLE, 5) for k, v in split.items()}))
    print(f"serving host syncs per placement (set_sync_debug_mode warn, "
          f"{len(syncs)} placements): {syncs}")
    print(f"profiled serving placements ({N_PROFILED}): wall "
          f"{prof_wall:.4f} s, device kernels {n_kernels} "
          f"({n_kernels / N_PROFILED:.1f} per placement), device busy "
          f"{busy_us / 1e3:.4f} ms ({busy_us / 1e3 / N_PROFILED:.5f} ms per "
          f"placement), idle share {1 - busy_us / 1e6 / prof_wall:.4f}; "
          f"copies host->device {h2d} ({h2d / N_PROFILED:.2f} per "
          f"placement), device->host {d2h} ({d2h / N_PROFILED:.2f} per "
          f"placement); phase 8(b) {time.perf_counter() - t0:.1f} s")
    print("serving device launches per placement by kernel: " + json.dumps(
        {k: v / N_PROFILED for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])}))


# -- phase 9: the scheduler loop -----------------------------------------

#: Phase 9(a)'s cluster and traffic sizes, and 9(b)'s super-batch (the
#: reference bench's default --batch-size).
N_LOOP_NODES, N_LOOP_PODS, N_LOOP_TRICKLE = 64, 300, 64
LOOP_BATCH = 16384


def port_loop_api():
    """This package's store, informer factory, scheduler and object
    constructors, as the `api` run_loop takes (a test builds the JAX
    package's counterpart and drives both through the same code)."""
    from types import SimpleNamespace

    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.client import (InformerFactory,
                                             ResourceEventHandler)
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.store import (install_core_validation,
                                            new_cluster_store)
    return SimpleNamespace(
        make_node=make_node, make_pod=make_pod,
        InformerFactory=InformerFactory, Scheduler=Scheduler,
        ResourceEventHandler=ResourceEventHandler,
        install_core_validation=install_core_validation,
        new_cluster_store=new_cluster_store)


def loop_cluster(seed: int, n_nodes: int, n_pods: int,
                 prefix: str = "p") -> tuple[list, list]:
    """A seeded heterogeneous workload for the scheduler loop, as
    (name, make_node kwargs) and (name, make_pod kwargs) pairs, so each
    package builds its own objects: nodes of SERVING_SHAPES, a NoSchedule
    taint on every 7th, a PreferNoSchedule taint on every 11th, a zone
    label on every 3rd and node 5 cordoned; pods with random requests and
    priorities 0-3, ~30% tolerating the NoSchedule taint, ~10% selecting
    the zone, ~3% preferring a node (the fast path does not take them),
    and ~5% that fit nowhere (too big, or a zone no node has). The
    preferring pods get priority 0 and the misfits -1, so a pre-created
    dispatch pops them last."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        taints = []
        if i % 7 == 0:
            taints.append({"key": "dedicated", "value": "infra",
                           "effect": "NoSchedule"})
        if i % 11 == 0:
            taints.append({"key": "spot", "value": "true",
                           "effect": "PreferNoSchedule"})
        kw = {"allocatable": dict(SERVING_SHAPES[int(rng.integers(0, 3))])}
        if taints:
            kw["taints"] = taints
        if i % 3 == 0:
            kw["labels"] = {"zone": "a"}
        if i == 5:
            kw["unschedulable"] = True
        nodes.append((f"node-{i}", kw))
    pods = []
    for t in range(n_pods):
        kw = {"requests": {
            "cpu": f"{int(rng.choice([100, 250, 500, 900, 1700]))}m",
            "memory": f"{int(rng.choice([128, 512, 1024, 3000]))}Mi"},
            "priority": int(rng.integers(0, 4))}
        if rng.random() < 0.3:
            kw["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        u = rng.random()
        if u < 0.1:
            kw["node_selector"] = {"zone": "a"}
        elif u < 0.13:
            kw["affinity"] = {"nodeAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 5, "preference": {"matchExpressions": [{
                        "key": "kubernetes.io/hostname", "operator": "In",
                        "values": [f"node-{int(rng.integers(0, n_nodes))}"]
                    }]}}]}}
            kw["priority"] = 0
        elif u < 0.16:
            kw["requests"], kw["priority"] = {"cpu": "64"}, -1
        elif u < 0.18:
            kw["node_selector"], kw["priority"] = {"zone": "nowhere"}, -1
        pods.append((f"{prefix}-{t}", kw))
    return nodes, pods


async def start_scheduler(api, store, seed: int = 42, **kw):
    """The scheduler bootstrap of run_loop and LoopRun: a Scheduler over
    `store` with its informers started and synced."""
    sched = api.Scheduler(store, seed=seed, **kw)
    factory = api.InformerFactory(store)
    await sched.setup_informers(factory)
    factory.start()
    await factory.wait_for_sync()
    return sched, factory


class AssignOnly:
    """A batched backend seen through `assign` alone: the scheduler loop
    takes the backend's chunk stream (`assign_stream`) or `assign_async`
    when it has them, so this hides both (phase 15(b)'s comparison, and
    the no-fallback tests). Every other attribute, read or written, is the
    wrapped backend's."""

    _HIDDEN = ("assign_stream", "assign_async")

    def __init__(self, backend):
        object.__setattr__(self, "_backend", backend)

    def __getattr__(self, name):
        if name in AssignOnly._HIDDEN:
            raise AttributeError(name)
        return getattr(self._backend, name)

    def __setattr__(self, name, value):
        setattr(self._backend, name, value)


class LoopRun:
    """One scheduler loop over a fresh store of `api`'s package."""

    def __init__(self, api, backend, batch_size: int):
        self.api, self.backend, self.batch_size = api, backend, batch_size
        self.store = self.sched = self.factory = self.task = None

    async def start(self, nodes, profiles=None) -> None:
        """`profiles`: None for the package's default profile, or a
        callable taking the store and returning the Scheduler's profiles."""
        api = self.api
        self.store = api.new_cluster_store()
        api.install_core_validation(self.store)
        for name, kw in nodes:
            await self.store.create("nodes", api.make_node(name, **kw))
        kw = {} if profiles is None else {"profiles": profiles(self.store)}
        self.sched, self.factory = await start_scheduler(
            api, self.store, backend=self.backend, **kw)

    async def create(self, pods) -> None:
        for name, kw in pods:
            await self.store.create("pods", self.api.make_pod(name, **kw))

    def open(self) -> None:
        """Start `Scheduler.run`."""
        self.task = asyncio.ensure_future(
            self.sched.run(batch_size=self.batch_size))

    async def wait(self, cond, what: str, timeout: float = 300.0) -> None:
        """Poll `cond` until it holds; raises the loop's own exception if
        `run` ended with one, TimeoutError after `timeout` s."""
        deadline = time.monotonic() + timeout
        while not cond():
            if self.task is not None and self.task.done() \
                    and not self.task.cancelled() \
                    and self.task.exception() is not None:
                raise self.task.exception()
            if time.monotonic() > deadline:
                raise TimeoutError(f"scheduler loop: {what}")
            await asyncio.sleep(0.005)

    def queued(self) -> int:
        st = self.sched.queue.stats()
        return st["active"] + st["gated"]

    def settled(self, names) -> bool:
        """Every pod bound or parked unschedulable, no cycle or binding
        in flight, the event buffer drained."""
        q, rec = self.sched.queue, self.sched.recorder
        st = q.stats()
        if st["active"] or st["backoff"] or st["in_flight"] \
                or self.sched._binding_tasks or rec._pending \
                or rec._draining:
            return False
        table = self.store._table("pods")
        return all((table[f"default/{n}"].get("spec") or {}).get("nodeName")
                   or f"default/{n}" in q._unschedulable for n in names)

    async def results(self) -> tuple[dict, dict, list, list]:
        """({pod name: node or None}, {pod name: FailedScheduling
        messages}, node objects, pod objects) from the store."""
        pods = (await self.store.list("pods")).items
        nodes = (await self.store.list("nodes")).items
        assignments = {p["metadata"]["name"]:
                       (p.get("spec") or {}).get("nodeName") or None
                       for p in pods}
        failed: dict[str, set] = {}
        for ev in (await self.store.list("events")).items:
            if ev.get("reason") == "FailedScheduling":
                failed.setdefault(ev["involvedObject"]["name"], set()).add(
                    ev["message"])
        return assignments, failed, nodes, pods

    async def close(self) -> None:
        if self.sched is not None:
            await self.sched.stop()
        if self.task is not None:
            self.task.cancel()
            await asyncio.gather(self.task, return_exceptions=True)
        if self.factory is not None:
            self.factory.stop()
        if self.store is not None:
            self.store.stop()


async def run_loop(api, nodes, pods, backend, batch_size: int,
                   trickle: bool = False, residents=()) -> dict:
    """Schedule `pods` on `nodes` through `api`'s Scheduler and `backend`.
    `residents` (pods with a node_name) are created first, and the loop
    waits until the scheduler's cache holds them. Pre-created (trickle
    False): every pod is created and queued before `run` opens the loop.
    Trickle: each pod is created once the one before it is bound or
    parked unschedulable. Returns the assignments, the FailedScheduling
    messages per pod, the store's objects, the metrics and the serving
    tier."""
    lr = LoopRun(api, backend, batch_size)
    await lr.start(nodes)
    names = [name for name, _ in pods]
    try:
        if residents:
            await lr.create(residents)
            await lr.wait(lambda: sum(
                len(ni.pods) for ni in lr.sched.cache.update_snapshot().nodes)
                == len(residents), "residents cached")
        if not trickle:
            await lr.create(pods)
            await lr.wait(lambda: lr.queued() == len(pods), "pods queued")
            lr.open()
        else:
            lr.open()
            for k, pod in enumerate(pods):
                await lr.create([pod])
                await lr.wait(lambda: lr.settled(names[:k + 1]),
                              f"pod {pod[0]} placed")
        await lr.wait(lambda: lr.settled(names), "pods placed")
        assignments, failed, node_objs, pod_objs = await lr.results()
        return {"assignments": assignments, "failed": failed,
                "nodes": node_objs, "pods": pod_objs,
                "metrics": lr.sched.metrics, "serving": lr.sched.serving}
    finally:
        await lr.close()


def over_capacity(nodes, pods) -> list[str]:
    """Nodes whose bound pods exceed their allocatable: an exact host
    re-check of a store's objects with NodeInfo's integer arithmetic."""
    from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo

    infos = {n["metadata"]["name"]: NodeInfo(n) for n in nodes}
    for p in pods:
        node = (p.get("spec") or {}).get("nodeName")
        if node:
            infos[node].add_pod(PodInfo(p))
    return [ni.name for ni in infos.values()
            if any(v > ni.allocatable.get(r)
                   for r, v in ni.requested.res.items())
            or ni.requested.pods > ni.allocatable.pods]


def loop_equality_phase(torch, seed: int) -> None:
    """Phase 9(a): the loop on the card against the loop on the CPU."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    api = port_loop_api()
    nodes, pods = loop_cluster(seed, N_LOOP_NODES, N_LOOP_PODS)
    t0 = time.perf_counter()
    wave_kernel.wave_solve.launches = 0
    card = asyncio.run(run_loop(api, nodes, pods, TorchBackend(), LOOP_BATCH))
    launches = wave_kernel.wave_solve.launches
    cpu = asyncio.run(run_loop(api, nodes, pods, TorchBackend(device="cpu"),
                               LOOP_BATCH))
    placed = sum(v is not None for v in card["assignments"].values())
    unsched = sorted(k for k, v in card["assignments"].items() if v is None)
    same = (card["assignments"] == cpu["assignments"],
            card["failed"] == cpu["failed"])
    print(f"compare scheduler loop, pre-created ({N_LOOP_NODES} nodes, "
          f"{N_LOOP_PODS} pods, batch_size {LOOP_BATCH}), card vs CPU: "
          f"nodeName {'identical' if same[0] else 'DIFFER'}, "
          f"FailedScheduling messages "
          f"{'identical' if same[1] else 'DIFFER'}; {placed} bound, "
          f"{len(unsched)} unschedulable, fast-path pods "
          f"{int(card['metrics'].serving_fast_path_pods.value())}, "
          f"wave_solve launches {launches}")
    if not all(same):
        raise RuntimeError("the scheduler loop on the card placed pods "
                           "differently from the CPU")
    if not unsched or set(unsched) != set(card["failed"]):
        raise RuntimeError(f"unschedulable pods {unsched} and their "
                           f"FailedScheduling events {sorted(card['failed'])}"
                           " do not match")
    bad = over_capacity(card["nodes"], card["pods"])
    if bad:
        raise RuntimeError(f"nodes over capacity: {bad}")
    _, lone = loop_cluster(seed + 1, N_LOOP_NODES, N_LOOP_TRICKLE, "lone")
    lone = [(n, kw) for n, kw in lone if kw["priority"] >= 0]
    trickle = asyncio.run(run_loop(api, nodes, lone, TorchBackend(),
                                   LOOP_BATCH, trickle=True))
    fast = int(trickle["metrics"].serving_fast_path_pods.value())
    unbound = [k for k, v in trickle["assignments"].items() if v is None]
    bad = over_capacity(trickle["nodes"], trickle["pods"])
    print(f"scheduler loop trickle: {len(lone)} lone pods, each awaited, "
          f"{len(lone) - len(unbound)} bound, fast-path pods {fast}; nodes "
          f"over capacity: {len(bad)}; phase 9(a) "
          f"{time.perf_counter() - t0:.1f} s")
    if unbound or fast == 0 or bad:
        raise RuntimeError(f"trickle: unbound {unbound}, fast-path pods "
                           f"{fast}, over capacity {bad}")


def count_backend_routes(sched, routes: dict) -> None:
    """Count the loop's backend dispatches and their pods in `routes`,
    whichever entry the loop takes (`assign_stream`, else `assign_async`,
    else `assign`), and in `routes["early_binds"]` the binds of a dispatch's
    pods that began before its last chunk's fetch returned (the stream's
    overlap; 0 through `assign`)."""
    backend = sched.backend
    live: set = set()
    binds = [0]
    bind = sched._assume_and_bind

    async def counted_bind(fwk, state, pi, node):
        if pi.key in live:
            binds[0] += 1
        return await bind(fwk, state, pi, node)

    def begin(pods):
        routes["backend_dispatches"] += 1
        routes["backend_pods"] += len(pods)
        live.clear()
        live.update(pi.key for pi in pods)
        binds[0] = 0

    sched._assume_and_bind = counted_bind
    assign = backend.assign

    def counted_assign(pods, snapshot, fwk):
        begin(pods)
        return assign(pods, snapshot, fwk)

    backend.assign = counted_assign
    if hasattr(backend, "assign_stream"):
        stream = backend.assign_stream

        async def counted_stream(pods, snapshot, fwk):
            begin(pods)
            before = 0
            async for item in stream(pods, snapshot, fwk):
                # Reached once this chunk's fetch returned: the binds so
                # far began before it.
                before = binds[0]
                yield item
            routes["early_binds"] += before

        backend.assign_stream = counted_stream
    elif hasattr(backend, "assign_async"):
        run_async = backend.assign_async

        async def counted_async(pods, snapshot, fwk):
            begin(pods)
            return await run_async(pods, snapshot, fwk)

        backend.assign_async = counted_async


def counting_runner_cls(torch):
    """PerfRunner that counts each route's pods over the measured window,
    sets the launch counters to 0 just before the measured createPods and
    reads them just after, and, when asked, profiles that window:
    `profile` "device" (torch.profiler)."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.perf.scheduler_perf import PerfRunner

    class CountingRunner(PerfRunner):
        def __init__(self, backend, profile: str | None,
                     scheduler_config=None, **boundary):
            super().__init__(backend=backend, batch_size=LOOP_BATCH,
                             scheduler_config=scheduler_config, **boundary)
            self.profile = profile
            self.routes = dict.fromkeys(
                ("backend_dispatches", "backend_pods", "host_path_pods",
                 "early_binds"), 0)
            self.window: dict = {}

        async def _drive(self, template_ops, params, timeout, backing,
                         store, metrics, sched, factory, *boundary):
            self.store = backing
            #: the workload's store: `backing`, or the boundary's client
            self.client = store
            count_backend_routes(sched, self.routes)
            host = sched._schedule_host_path

            async def counted_host(pi, snapshot):
                self.routes["host_path_pods"] += 1
                return await host(pi, snapshot)

            sched._schedule_host_path = counted_host
            return await super()._drive(template_ops, params, timeout,
                                        backing, store, metrics, sched,
                                        factory, *boundary)

        def _begin_measure(self, metrics, backing):
            torch.cuda.synchronize()
            # In place: count_backend_routes' wrappers hold this dict.
            self.routes.update(dict.fromkeys(self.routes, 0))
            wave_kernel.wave_solve.launches = 0
            self.window = {"timings": dict(self.backend.timings),
                           "counters": dict(self.backend.counters)}
            if self.profile == "device":
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                self.prof.start()
            self.window["t0"] = time.perf_counter()
            return super()._begin_measure(metrics, backing)

        def _end_measure(self, result, metrics, backing, base, count):
            super()._end_measure(result, metrics, backing, base, count)
            torch.cuda.synchronize()
            w = self.window
            w["wall"] = time.perf_counter() - w["t0"]
            if self.profile == "device":
                self.prof.stop()
            elif self.profile == "host":
                self.prof.disable()
            w["launches"] = wave_kernel.wave_solve.launches
            w["routes"] = dict(self.routes)
            w["timings"] = {k: round(v - w["timings"][k], 6)
                            for k, v in self.backend.timings.items()}
            w["counters"] = {k: v - w["counters"][k]
                             for k, v in self.backend.counters.items()
                             if k != "sinkhorn_iterations"}

    return CountingRunner


def perf_run(torch, family: dict, workload: str, profile: str | None,
             wrap=None):
    """One run of `family`'s `workload` through the port's PerfRunner and
    `Scheduler.run` with `TorchBackend()` (seen through `wrap`, e.g.
    `AssignOnly`, when given): every created pod must be bound and no node
    over capacity on an exact host re-check of the store. Returns (runner,
    result, probe launches over the run, pod objects)."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    template = family["workloadTemplate"]
    params = next(w["params"] for w in family["workloads"]
                  if w["name"] == workload)
    want = sum(params[op["countParam"][1:]] for op in template
               if op["opcode"] == "createPods")
    wave_kernel.probe.launches = 0
    backend = TorchBackend() if wrap is None else wrap(TorchBackend())
    runner = counting_runner_cls(torch)(backend, profile,
                                        family.get("schedulerConfig"))
    result = asyncio.run(runner.run(template, params, timeout=900.0))
    pods = asyncio.run(runner.store.list("pods")).items
    nodes = asyncio.run(runner.store.list("nodes")).items
    bound = sum(bool((p.get("spec") or {}).get("nodeName")) for p in pods)
    bad = over_capacity(nodes, pods)
    if bound != want or len(pods) != want or bad:
        raise RuntimeError(f"{family['name']}/{workload}: {bound}/{want} "
                           f"bound, nodes over capacity: {bad[:5]}")
    return runner, result, wave_kernel.probe.launches, pods


def report_perf(torch, label: str, family: dict, workload: str, first,
                phase: str, t0: float, device_workload: str | None = None,
                device_profile: bool = True) -> None:
    """Print a family run's numbers (`first` from perf_run), then, with
    `device_profile`, repeat it under torch.profiler (the device's busy
    time and idle share; of `device_workload` where given, a smaller
    workload of the family whose trace the profiler processes in
    seconds)."""
    runner, result, probe_launches, _ = first
    w, r = runner.window, result.as_dict()
    routes = w["routes"]
    print(f"{label} {family['name']}/{workload} (PerfRunner, Scheduler.run, "
          f"TorchBackend(), batch_size {LOOP_BATCH}): SchedulingThroughput "
          f"{r['throughput_pods_per_sec']} pods/s, measured_seconds "
          f"{result.measured_seconds:.6f}, attempt ms p50 "
          f"{r['attempt_p50_ms']} p90 {r['attempt_p90_ms']} p99 "
          f"{r['attempt_p99_ms']} p999 {r['attempt_p999_ms']} (exact "
          f"{r['attempt_percentiles_exact']}), fragmentation_pct "
          f"{r['fragmentation_pct']}, fragmentation_occupied_pct "
          f"{r['fragmentation_occupied_pct']}; every pod bound, no node over "
          f"capacity")
    print(f"{label} routes over the measured window: fast-path pods "
          f"{r['serving_fast_path_pods_total']}, backend dispatches "
          f"{routes['backend_dispatches']} with {routes['backend_pods']} "
          f"pods (binds begun before their dispatch's last chunk fetch "
          f"returned {routes['early_binds']}), host-path pods "
          f"{routes['host_path_pods']}, unschedulable "
          f"attempts (requeued) {r['unschedulable_total']}; "
          f"TorchBackend.counters {json.dumps(w['counters'])}, wave_solve "
          f"launches {w['launches']}; probe launches over the run "
          f"{probe_launches}")
    print(f"{label} TorchBackend.timings over the measured window: "
          f"{json.dumps(w['timings'])}; window wall {w['wall']:.6f} s, "
          f"assign share {w['timings']['assign_s'] / w['wall']:.4f}; events "
          f"emitted {result.events_emitted_total}, dropped "
          f"{result.events_dropped_total}")
    card_pods = routes["backend_pods"] + r["serving_fast_path_pods_total"]
    if card_pods <= routes["host_path_pods"] or probe_launches == 0:
        raise RuntimeError(f"the measured window did not run on the card: "
                           f"routes {routes}, fast-path pods "
                           f"{r['serving_fast_path_pods_total']}, probe "
                           f"launches {probe_launches}")
    if not device_profile:
        print(f"{label}: no profiled repeat; phase {phase} "
              f"{time.perf_counter() - t0:.1f} s")
        return
    prof_workload = device_workload or workload
    prof_runner, prof_result, _, _ = perf_run(torch, family, prof_workload,
                                              "device")
    pw = prof_runner.window
    busy_us = sum(device_us(e) for e in prof_runner.prof.key_averages())
    print(f"profiled {label} measured window ({family['name']}/"
          f"{prof_workload}): wall {pw['wall']:.6f} s, "
          f"throughput {prof_result.throughput:.1f} pods/s, device busy "
          f"{busy_us / 1e6:.6f} s" + (
              f", idle share {1 - busy_us / 1e6 / pw['wall']:.4f}"
              if busy_us else ", device time not measured by the profiler")
          + f"; phase {phase} {time.perf_counter() - t0:.1f} s")


def scheduler_perf_phase(torch) -> dict:
    """Phase 9(b): SchedulingBasic/5000Nodes through the port's PerfRunner
    and `Scheduler.run`; returns the kernels line's loop entries."""
    from kubernetes_tpu_torch.perf.scheduler_perf import SCHEDULING_BASIC

    t0 = time.perf_counter()
    first = perf_run(torch, SCHEDULING_BASIC, "5000Nodes", None)
    launches = first[0].window["launches"]
    if launches == 0:
        raise RuntimeError("phase 9(b): no wave_solve launch in the "
                           "measured window")
    report_perf(torch, "scheduler loop", SCHEDULING_BASIC, "5000Nodes",
                first, "9(b)", t0)
    return {"loop_launches": launches, "loop_probe_launches": first[2]}


# -- phase 10: the constraint families -------------------------------------

HOSTNAME_KEY = "kubernetes.io/hostname"
ZONE_KEY = "topology.kubernetes.io/zone"
ZONES = ("zone-a", "zone-b", "zone-c")
#: Hostname anti-affinity among `color: blue` pods (SchedulingPodAntiAffinity).
ANTI_BLUE = {"podAntiAffinity": {
    "requiredDuringSchedulingIgnoredDuringExecution": [{
        "labelSelector": {"matchLabels": {"color": "blue"}},
        "topologyKey": HOSTNAME_KEY}]}}
#: Phase 10(a)'s pod templates (see `constraint_pod`).
CONSTRAINT_KINDS = ("anti", "worker", "pref", "spread", "md", "plain",
                    "zonal")
N_CONSTRAINT_NODES, N_CONSTRAINT_PODS = 96, 288


def _term(sel: dict, key: str, ns_sel=None) -> dict:
    t = {"labelSelector": {"matchLabels": sel}, "topologyKey": key}
    if ns_sel is not None:
        t["namespaceSelector"] = ns_sel
    return t


def constraint_cluster(seed: int, n_nodes: int) -> tuple[list, list]:
    """A seeded cluster for the constraint families, as (name, make_node
    kwargs) and resident (name, make_pod kwargs) pairs, so each package
    builds its own objects: nodes of cpu 8 / memory 32Gi / pods 20 in
    three zones, every 11th from the 6th without the zone key, a
    NoSchedule taint on every 9th from the 5th; 0-2 resident pods per node
    in two namespaces, labeled web / db / hub (tier: hub) / batch, half the
    db pods with hostname anti-affinity to `color: blue`, half the batch
    pods preferring zones with web pods."""
    rng = np.random.default_rng(seed)
    nodes, residents = [], []
    for i in range(n_nodes):
        name = f"node-{i}"
        kw = {"allocatable": {"cpu": "8", "memory": "32Gi", "pods": "20"}}
        if i % 11 != 5:
            kw["labels"] = {ZONE_KEY: ZONES[i % 3]}
        if i % 9 == 4:
            kw["taints"] = [{"key": "dedicated", "value": "infra",
                             "effect": "NoSchedule"}]
        nodes.append((name, kw))
        for k in range(int(rng.integers(0, 3))):
            kind = int(rng.integers(0, 4))
            labels = {"app": ("web", "db", "hub", "batch")[kind]}
            pkw = {"requests": {"cpu": "500m", "memory": "1Gi"},
                   "node_name": name, "namespace": ("default", "other")[k % 2]}
            if kind == 1 and rng.random() < 0.5:
                pkw["affinity"] = ANTI_BLUE
            elif kind == 3 and rng.random() < 0.5:
                pkw["affinity"] = {"podAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [{
                        "weight": 10,
                        "podAffinityTerm": _term({"app": "web"}, ZONE_KEY)}]}}
            if kind == 2:
                labels["tier"] = "hub"
            pkw["labels"] = labels
            residents.append((f"res-{i}-{k}", pkw))
    return nodes, residents


def constraint_pod(kind: str, i: int) -> tuple[str, dict]:
    """One pending pod of a phase 10(a) template, as (name, make_pod
    kwargs): `anti` hostname anti-affinity to `color: blue` (and blue
    itself); `worker` required zone affinity to hubs; `pref` preferred zone
    affinity to db pods and preferred hostname anti-affinity to its own
    template under a `{}` namespace selector; `spread` a hard zone spread
    (maxSkew 1) with a soft hostname spread (maxSkew 5); `md` a hard zone
    spread whose minDomains (5) exceeds the zone count; `plain` a labeled
    pod (PodTopologySpread's default constraints score it); `zonal` a
    `spread` pod that is also blue and requires zone anti-affinity to
    blue pods (the verify rejects it once a blue pod of the same batch
    holds its zone, and its count folds out of the chained spread
    counts)."""
    small = {"cpu": "100m", "memory": "250Mi"}
    if kind == "anti":
        return f"anti-{i}", {"labels": {"app": "anti", "color": "blue"},
                             "requests": small, "affinity": ANTI_BLUE}
    if kind == "worker":
        return f"worker-{i}", {
            "labels": {"tier": "worker"},
            "requests": {"cpu": "200m", "memory": "500Mi"},
            "affinity": {"podAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    _term({"tier": "hub"}, ZONE_KEY)]}}}
    if kind == "pref":
        return f"pref-{i}", {
            "labels": {"app": "pref"},
            "requests": {"cpu": "300m", "memory": "500Mi"},
            "affinity": {
                "podAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [{
                        "weight": 50,
                        "podAffinityTerm": _term({"app": "db"}, ZONE_KEY)}]},
                "podAntiAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [{
                        "weight": 20, "podAffinityTerm":
                        _term({"app": "pref"}, HOSTNAME_KEY, {})}]}}}
    if kind == "spread":
        sel = {"matchLabels": {"app": "spread-me"}}
        return f"spread-{i}", {
            "labels": {"app": "spread-me"}, "requests": small,
            "topology_spread_constraints": [
                {"maxSkew": 1, "topologyKey": ZONE_KEY,
                 "whenUnsatisfiable": "DoNotSchedule", "labelSelector": sel},
                {"maxSkew": 5, "topologyKey": HOSTNAME_KEY,
                 "whenUnsatisfiable": "ScheduleAnyway",
                 "labelSelector": sel}]}
    if kind == "zonal":
        name, kw = constraint_pod("spread", i)
        kw["labels"] = {"app": "spread-me", "color": "blue"}
        kw["affinity"] = {"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                _term({"color": "blue"}, ZONE_KEY)]}}
        return f"zonal-{i}", kw
    if kind == "md":
        return f"md-{i}", {
            "labels": {"app": "md"}, "requests": small,
            "topology_spread_constraints": [
                {"maxSkew": 2, "topologyKey": ZONE_KEY, "minDomains": 5,
                 "whenUnsatisfiable": "DoNotSchedule",
                 "labelSelector": {"matchLabels": {"app": "md"}}}]}
    return f"plain-{i}", {"labels": {"app": "web"},
                          "requests": {"cpu": "250m", "memory": "500Mi"}}


def constraint_pods(kinds, count: int) -> list[tuple[str, dict]]:
    return [constraint_pod(kinds[i % len(kinds)], i) for i in range(count)]


def constraint_snapshot(types_mod, make_node, make_pod, nodes, residents,
                        generation: int = 1):
    """A Snapshot of `types_mod`'s package over `constraint_cluster`'s
    nodes and residents."""
    by_node: dict[str, list] = {}
    for name, kw in residents:
        by_node.setdefault(kw["node_name"], []).append(make_pod(name, **kw))
    infos = []
    for name, kw in nodes:
        ni = types_mod.NodeInfo(make_node(name, **kw))
        for pd in by_node.get(name, ()):
            ni.add_pod(types_mod.PodInfo(pd))
        infos.append(ni)
    return types_mod.Snapshot(infos, generation)


def spread_case(seed: int, n: int = 40, p: int = 56, r: int = 2):
    """A seeded chunk and union spread table for the spread scans: uniform
    and half-size nodes, five class rows (tied static scores) and the empty
    class, ~10% exception pins; three constraints over a zone key (3
    values, ~10% keyless) and a rack key (5 values, ~15% keyless), the
    second constraint eligible on ~70% of the nodes and under a minDomains
    deficit; pods of no template, of the first constraint's, or of the
    other two's, a template's pods counted by it ~85% of the time
    (non-self-matching selectors otherwise), and ~10% of the template-free
    pods counted by the first. Returns (solve arrays, table arrays in
    index form, counts, applies, contrib, rows, exc), all numpy."""
    rng = np.random.default_rng(seed)
    alloc = np.tile(np.array([[8000, 16000]], np.int32), (n, 1))
    alloc[rng.random(n) < 0.3] = [4000, 8000]
    used = (alloc * rng.choice([0.0, 0.25, 0.5], (n, 1))).astype(np.int32)
    free_pods = rng.integers(2, 9, n).astype(np.int32)
    classes = 6
    mask = rng.random((classes, n)) < 0.9
    mask[0] = False
    static = rng.choice([0.0, 10.0, 20.0], (classes, n)).astype(np.float32)
    req_rows = np.array([[0, 0], [500, 1000], [1000, 2000], [250, 500],
                         [2000, 1000], [500, 4000]], np.int32)
    rows = (1 + rng.integers(0, classes - 1, p)).astype(np.int32)
    rows[rng.random(p) < 0.05] = 0      # the empty class: fits nowhere
    exc = np.full((p,), -1, np.int32)
    pinned = rng.random(p) < 0.1
    exc[pinned] = rng.integers(0, n, int(pinned.sum()))
    zone = rng.integers(0, 3, n)
    zone[rng.random(n) < 0.1] = -1
    rack = rng.integers(0, 5, n)
    rack[rng.random(n) < 0.15] = -1
    keys = (zone, zone, rack)
    elig = np.ones((3, n), bool)
    elig[1] = rng.random(n) < 0.7
    C = 3
    node_dom = np.full((n, C), -1, np.int64)
    has_key = np.zeros((n, C), bool)
    dom_cid = []
    for c, key in enumerate(keys):
        has_key[:, c] = key >= 0
        for v in np.unique(key[(key >= 0) & elig[c]]):
            node_dom[(key == v) & elig[c], c] = len(dom_cid)
            dom_cid.append(c)
    dom_cid = np.asarray(dom_cid, np.int64)
    counts = rng.integers(0, 4, len(dom_cid)).astype(np.int32)
    tpl = rng.integers(0, 3, p)          # 0: none, 1: cons 0, 2: cons 1+2
    applies = np.zeros((p, C), bool)
    applies[tpl == 1, 0] = True
    applies[tpl == 2, 1:] = True
    contrib = (applies & (rng.random((p, C)) < 0.85)).astype(np.int32)
    contrib[(tpl == 0) & (rng.random(p) < 0.3), 0] = 1
    arrays = dict(
        req_q=req_rows[rows], req_nz_q=req_rows[rows],
        free_q=alloc - used, free_pods=free_pods, used_nz_q=used,
        alloc_q=alloc, mask=mask, static_scores=static,
        fit_col_w=np.ones((r,), np.float32),
        bal_col_mask=np.ones((r,), np.bool_),
        shape_u=np.array([0.0, 100.0], np.float32),
        shape_s=np.array([0.0, 10.0], np.float32),
        w_fit=np.float32(1.0), w_bal=np.float32(1.0))
    table = dict(node_dom=node_dom, dom_cid=dom_cid,
                 max_skew=np.array([1, 2, 1], np.int32),
                 min_ok=np.array([True, False, True]), has_key=has_key)
    return arrays, table, counts, applies, contrib, rows, exc


#: the order of the solve arrays in the scans' signatures.
SOLVE_ORDER = ("req_q", "req_nz_q", "free_q", "free_pods", "used_nz_q",
               "alloc_q", "mask", "static_scores", "fit_col_w",
               "bal_col_mask", "shape_u", "shape_s", "w_fit", "w_bal")


def run_spread_scan(torch, case, strategy: str, wave_w: int, device):
    """The port's spread scan (W=1 or its wave form) on `case` on
    `device`. Returns (assign, counts, (commits, replays) or None), numpy
    and ints."""
    from kubernetes_tpu_torch.ops import solver

    arrays, table, counts, applies, contrib, rows, exc = case

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    args = [float(arrays[k]) if k in ("w_fit", "w_bal") else put(arrays[k])
            for k in SOLVE_ORDER]
    tab = solver.SpreadTable(*(put(table[k]) for k in (
        "node_dom", "dom_cid", "max_skew", "min_ok", "has_key")))
    rest = (put(counts), put(applies), put(contrib))
    if wave_w == 1:
        a, c = solver.greedy_assign_rescoring_spread(
            *args, strategy, tab, *rest, rows=put(rows), exc=put(exc))
        return a.cpu().numpy(), c.cpu().numpy(), None
    a, c, com, rep = solver.greedy_assign_rescoring_spread_wave(
        *args, strategy, wave_w, tab, *rest, rows=put(rows), exc=put(exc))
    return a.cpu().numpy(), c.cpu().numpy(), (int(com), int(rep))


def spread_scan_phase(torch, dev, seed: int) -> None:
    """Phase 10(a), the spread scans: W=1 and W=32 on the card (under
    sync debug "error") against CPU torch on the same seeded cases."""
    for k, strategy in enumerate(("LeastAllocated", "MostAllocated")):
        case = spread_case(seed + k, n=600, p=256)
        for w in (1, 32):
            with no_host_sync_in_wave_loop(torch):
                card = run_spread_scan(torch, case, strategy, w, dev)
            cpu = run_spread_scan(torch, case, strategy, w, "cpu")
            same = (np.array_equal(card[0], cpu[0])
                    and np.array_equal(card[1], cpu[1])
                    and card[2] == cpu[2])
            print(f"compare spread scan W={w} ({strategy}, 600 nodes, 256 "
                  f"pods, 3 constraints), card vs CPU: "
                  f"{'identical' if same else 'DIFFER'}; placed "
                  f"{int((card[0] >= 0).sum())}, commits/replays {card[2]}")
            if not same:
                raise RuntimeError("the spread scan on the card differs "
                                   "from CPU torch")


def constraint_assign(backend, snapshot, fwk, pods, mode: str):
    """`backend`'s assign() over `pods` under KTPU_SOLVE_MODE `mode`,
    keeping the context (its chained spread counts)."""
    from kubernetes_tpu_torch.utils import flags

    with flags.scoped_set("KTPU_SOLVE_MODE", mode):
        backend._check_supported(pods, fwk)
        ctx = backend._start(pods, snapshot, fwk)
        backend._run_chunks(ctx)
    return ctx


def constraint_chunks_phase(torch, seed: int) -> None:
    """Phase 10(a), the backend: one chunk of each constraint shape
    through `TorchBackend()` on the card and `TorchBackend(device="cpu")`:
    identical assignments, diagnostics' reasons and spread counts."""
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.scheduler import types
    from kubernetes_tpu_torch.scheduler.framework import Framework
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        DEFAULT_SCORE_WEIGHTS, build_plugins)

    fwk = Framework(build_plugins(), DEFAULT_SCORE_WEIGHTS)
    nodes, residents = constraint_cluster(seed, N_CONSTRAINT_NODES)
    shapes = (("anti-affinity, flagless", ("anti",), 80, "auto"),
              ("anti-affinity, greedy", ("anti",), 80, "greedy"),
              ("affinity and preferred terms", ("worker", "pref", "plain"),
               96, "auto"),
              ("hard spread", ("spread",), 96, "auto"),
              ("hetero", CONSTRAINT_KINDS, N_CONSTRAINT_PODS, "auto"))
    for what, kinds, count, mode in shapes:
        pods = [types.PodInfo(make_pod(n, **kw))
                for n, kw in constraint_pods(kinds, count)]
        out = []
        for backend in (TorchBackend(), TorchBackend(device="cpu")):
            snap = constraint_snapshot(types, make_node, make_pod, nodes,
                                       residents)
            with no_host_sync_in_wave_loop(torch):
                ctx = constraint_assign(backend, snap, fwk, pods, mode)
            counts = None
            if ctx.spread and ctx.spread["cons"]:
                counts = ctx.spread["dev_counts"].cpu().numpy()
            reasons = {k: sorted(getattr(d, "reason_counts", None) or {
                n: s.reasons for n, s in d.items()}.items())
                for k, d in ctx.diagnostics.items()}
            out.append((ctx.assignments, reasons, counts,
                        dict(backend.counters)))
        card, cpu = out
        same = card[0] == cpu[0] and card[1] == cpu[1] and (
            (card[2] is None and cpu[2] is None)
            or np.array_equal(card[2], cpu[2])) and card[3] == cpu[3]
        placed = sum(v is not None for v in card[0].values())
        print(f"compare TorchBackend chunk, {what} ({count} pods on "
              f"{N_CONSTRAINT_NODES} nodes, KTPU_SOLVE_MODE={mode}), card vs "
              f"CPU: {'identical' if same else 'DIFFER'}; placed {placed}, "
              f"counters {json.dumps(card[3])}, spread domain counts "
              f"{None if card[2] is None else card[2].tolist()}")
        if not same:
            raise RuntimeError(f"TorchBackend on the card differs from the "
                               f"CPU on the {what} chunk")


def constraint_loop_phase(torch, seed: int) -> None:
    """Phase 10(a), the loop: the phase's cluster with its residents and
    every template pre-created, through `Scheduler.run` on the card and
    on the CPU: identical bindings and FailedScheduling messages."""
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    api = port_loop_api()
    nodes, residents = constraint_cluster(seed, N_CONSTRAINT_NODES)
    pods = constraint_pods(CONSTRAINT_KINDS, N_CONSTRAINT_PODS)
    t0 = time.perf_counter()
    with no_host_sync_in_wave_loop(torch):
        card = asyncio.run(run_loop(api, nodes, pods, TorchBackend(),
                                    LOOP_BATCH, residents=residents))
    cpu = asyncio.run(run_loop(api, nodes, pods, TorchBackend(device="cpu"),
                               LOOP_BATCH, residents=residents))
    same = (card["assignments"] == cpu["assignments"],
            card["failed"] == cpu["failed"])
    pending = {name for name, _ in pods}
    placed = sum(v is not None for k, v in card["assignments"].items()
                 if k in pending)
    print(f"compare scheduler loop, constraint templates pre-created "
          f"({N_CONSTRAINT_NODES} nodes, {len(residents)} residents, "
          f"{N_CONSTRAINT_PODS} pods), card vs CPU: nodeName "
          f"{'identical' if same[0] else 'DIFFER'}, FailedScheduling "
          f"messages {'identical' if same[1] else 'DIFFER'}; {placed} bound, "
          f"{len(card['failed'])} with FailedScheduling events; "
          f"{time.perf_counter() - t0:.1f} s")
    if not all(same):
        raise RuntimeError("the constraint loop on the card placed pods "
                           "differently from the CPU")
    bad = over_capacity(card["nodes"], card["pods"])
    if bad:
        raise RuntimeError(f"nodes over capacity: {bad}")


def blue_pods_share_a_node(pods) -> list[str]:
    seen: dict[str, str] = {}
    clash = []
    for p in pods:
        node = (p.get("spec") or {}).get("nodeName")
        labels = p["metadata"].get("labels") or {}
        if node and labels.get("color") == "blue":
            if node in seen:
                clash.append(node)
            seen[node] = p["metadata"]["name"]
    return clash


def flagless_anti_probe(torch, nodes_n: int, pods_n: int) -> dict:
    """One flagless assign() of `pods_n` anti-affinity pods at `nodes_n`
    empty nodes: the Sinkhorn route's rounding and the verify's
    rejections of pods that share a node."""
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.scheduler import types
    from kubernetes_tpu_torch.scheduler.framework import Framework
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        DEFAULT_SCORE_WEIGHTS, build_plugins)
    from kubernetes_tpu_torch.utils import flags

    snap = types.Snapshot([types.NodeInfo(make_node(
        f"node-{i}", labels={ZONE_KEY: "zone-a"})) for i in range(nodes_n)],
        1)
    fwk = Framework(build_plugins(), DEFAULT_SCORE_WEIGHTS)
    pods = [types.PodInfo(make_pod(f"anti-{i}", **constraint_pod("anti", i)[1]))
            for i in range(pods_n)]
    backend = TorchBackend()
    wave_kernel.wave_solve.launches = 0
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"):
        got, _ = backend.assign(pods, snap, fwk)
    return {"placed": sum(v is not None for v in got.values()),
            "optimal_solves": backend.counters["optimal_solves"],
            "verify_rejects": backend.counters["verify_rejects"],
            "wave_solve_launches": wave_kernel.wave_solve.launches}


def anti_affinity_phase(torch) -> dict:
    """Phase 10(b): SchedulingPodAntiAffinity/5000Nodes through the port's
    PerfRunner and `Scheduler.run` with `TorchBackend()`, greedy pinned.
    Flagless, every full dispatch takes the Sinkhorn route, whose W=1
    rounding of one class's plan packs the class onto one node at a time,
    so the verify rejects all but one pod per node and the rest wait for a
    requeue event (the reference does the same); a one-assign probe of
    that route is printed first."""
    from kubernetes_tpu_torch.perf.scheduler_perf import (
        SCHEDULING_POD_ANTI_AFFINITY)
    from kubernetes_tpu_torch.utils import flags

    t0 = time.perf_counter()
    probe = flagless_anti_probe(torch, 5000, 1024)
    print(f"flagless anti-affinity probe (1024 pods, 5000 empty nodes, one "
          f"TorchBackend().assign, KTPU_SOLVE_MODE=auto): "
          f"{json.dumps(probe)}")
    with flags.scoped_set("KTPU_SOLVE_MODE", "greedy"):
        first = perf_run(torch, SCHEDULING_POD_ANTI_AFFINITY, "5000Nodes",
                         None)
        clash = blue_pods_share_a_node(first[3])
        launches = first[0].window["launches"]
        if clash or launches == 0:
            raise RuntimeError(f"phase 10(b): blue pods share nodes "
                               f"{clash[:5]}, wave_solve launches "
                               f"{launches}")
        print("SchedulingPodAntiAffinity/5000Nodes: no two color: blue pods "
              "share a node")
        report_perf(torch, "constraint loop (greedy pinned)",
                    SCHEDULING_POD_ANTI_AFFINITY, "5000Nodes", first,
                    "10(b)", t0, device_workload="500Nodes")
    return {"launches": launches + probe["wave_solve_launches"],
            "probe_launches": first[2]}


def topology_spreading_phase(torch) -> None:
    """Phase 10(c): TopologySpreading/3000Nodes, flagless, every spread
    scan under sync debug "error": every pod bound, the final zone counts
    of app=spread-me within 1 of each other. No torch.profiler repeat
    (its TopologySpreading/300Nodes repeat went to keep the smoke in its
    time)."""
    from kubernetes_tpu_torch.perf.scheduler_perf import TOPOLOGY_SPREADING

    t0 = time.perf_counter()
    with no_host_sync_in_wave_loop(torch):
        first = perf_run(torch, TOPOLOGY_SPREADING, "3000Nodes", None)
    n = next(w["params"]["initNodes"] for w in TOPOLOGY_SPREADING["workloads"]
             if w["name"] == "3000Nodes")
    per_zone = dict.fromkeys(ZONES, 0)
    for p in first[3]:
        if (p["metadata"].get("labels") or {}).get("app") == "spread-me":
            i = int(p["spec"]["nodeName"].rsplit("-", 1)[1])
            per_zone[ZONES[i // n]] += 1
    skew = max(per_zone.values()) - min(per_zone.values())
    counters = first[0].window["counters"]
    print(f"TopologySpreading/3000Nodes: app=spread-me per zone "
          f"{json.dumps(per_zone)}, skew {skew}; spread chunks in the window "
          f"{counters['spread_chunks']}; spread_poisoned 0 (a pod that "
          f"misses the union table raises)")
    if skew > 1 or counters["spread_chunks"] == 0:
        raise RuntimeError(f"phase 10(c): zone skew {skew}, spread chunks "
                           f"{counters['spread_chunks']}")
    report_perf(torch, "constraint loop", TOPOLOGY_SPREADING, "3000Nodes",
                first, "10(c)", t0, device_profile=False)


def pod_affinity_phase(torch) -> int:
    """Phase 10(d): SchedulingPodAffinity/500Nodes, flagless: every worker
    bound in a zone that holds a hub. Returns wave_solve's launches in its
    measured window."""
    from kubernetes_tpu_torch.perf.scheduler_perf import (
        SCHEDULING_POD_AFFINITY)

    t0 = time.perf_counter()
    runner, result, _, pods = perf_run(torch, SCHEDULING_POD_AFFINITY,
                                       "500Nodes", None)
    n = next(w["params"]["initNodes"]
             for w in SCHEDULING_POD_AFFINITY["workloads"]
             if w["name"] == "500Nodes")

    def zone(p):
        return ZONES[int(p["spec"]["nodeName"].rsplit("-", 1)[1]) // n]

    hub_zones = {zone(p) for p in pods
                 if p["metadata"]["labels"].get("tier") == "hub"}
    workers = [p for p in pods
               if p["metadata"]["labels"].get("tier") == "worker"]
    stray = [p["metadata"]["name"] for p in workers
             if zone(p) not in hub_zones]
    w = runner.window
    print(f"constraint loop SchedulingPodAffinity/500Nodes: "
          f"SchedulingThroughput {result.throughput:.2f} pods/s, "
          f"measured_seconds {result.measured_seconds:.6f}; {len(workers)} "
          f"workers bound, all in a zone holding a hub ({sorted(hub_zones)}): "
          f"{not stray}; TorchBackend.counters {json.dumps(w['counters'])}, "
          f"wave_solve launches {w['launches']}; phase 10(d) "
          f"{time.perf_counter() - t0:.1f} s")
    if stray:
        raise RuntimeError(f"phase 10(d): workers outside hub zones "
                           f"{stray[:5]}")
    return w["launches"]


# -- phase 12: gangs and preemption ----------------------------------------

#: Coscheduling's pod-group label.
GANG_LABEL = "scheduling.x-k8s.io/pod-group"
#: Phase 12(a)'s gang chunk shapes (see `gang_chunk`), its cluster size
#: (`constraint_cluster`) and chunk.
GANG_CASES = ("fit", "stranded", "assembled", "overflow", "spread")
N_GANG_CHUNK_NODES, GANG_CHUNK = 36, 128
#: Phase 12(b): SchedulingBasic/5000Nodes' cluster and pod template, its
#: 10000 measured pods as 156 gangs of 64 (minMember 64), plus a gang held
#: by PreEnqueue (minMember 65) and a gang with one member no node holds.
N_GANGS, GANG_SIZE, GANG_TIMEOUT_S = 156, 64, 5.0


class PodGroupIndex:
    """A stand-in for Coscheduling's PodGroup informer in direct `assign`
    calls: the plugin reads `pg_informer.indexer.get(group key)` and
    nothing else of it."""

    def __init__(self, groups: dict):
        self.indexer = self
        self._groups = groups

    def get(self, key: str):
        return self._groups.get(key)


def gang_chunk(kind: str) -> tuple[list, dict, list]:
    """One pending chunk of a phase 12(a) shape, as (PodGroups [(name,
    minMember)], members already assembled {group: count}, pods [(name,
    make_pod kwargs)]); a member "no node can hold" asks for 64 CPUs.
    `fit`: six gangs of 10 and 16 lone pods, all placeable; `stranded`: a
    64-member gang with one such member, so none of the 64 places, and 16
    lone pods; `assembled`: a gang of minMember 12 with 6 members already
    bound and 8 in the chunk, 2 of them unplaceable (its quota falls to 6,
    so 6 place), a gang of 8 with one unplaceable member, and 8 lone pods;
    `overflow`: 18 gangs of 4, three with an unplaceable member: the first
    16 are masked in the solve (gang 0 places nothing), gangs 16 and 17
    are left to the Permit barrier (their other members place); `spread`:
    a gang of 12 hard-zone-spread pods (`constraint_pod`'s `spread`
    template) with one unplaceable member, between 24 spread pods that are
    in no gang, and 8 lone pods — the gang's 11 placements are dropped and
    folded out of the chained domain counts."""
    small = {"cpu": "500m", "memory": "1Gi"}
    groups: list = []
    assembled: dict = {}
    pods: list = []

    def gang(g: str, members: int, min_member: int, unfit=(),
             template: str | None = None) -> None:
        groups.append((g, min_member))
        for i in range(members):
            kw = copy.deepcopy(constraint_pod(template, i)[1]) \
                if template else {"requests": dict(small)}
            kw["labels"] = {**(kw.get("labels") or {}), GANG_LABEL: g}
            if i in unfit:
                kw["requests"] = {"cpu": "64", "memory": "1Gi"}
            pods.append((f"{g}-{i}", kw))

    def lone(n: int) -> None:
        pods.extend((f"solo-{i}", {"requests": dict(small)})
                    for i in range(n))

    if kind == "fit":
        for g in range(6):
            gang(f"fit{g}", 10, 10)
        lone(16)
    elif kind == "stranded":
        gang("big", 64, 64, unfit=(31,))
        lone(16)
    elif kind == "assembled":
        gang("half", 8, 12, unfit=(2, 5))
        assembled["half"] = 6
        gang("whole", 8, 8, unfit=(7,))
        lone(8)
    elif kind == "overflow":
        for g in range(18):
            gang(f"ov{g}", 4, 4, unfit=(1,) if g in (0, 16, 17) else ())
    elif kind == "spread":
        pods.extend(constraint_pod("spread", i) for i in range(12))
        gang("sg", 12, 12, unfit=(5,), template="spread")
        pods.extend(constraint_pod("spread", i) for i in range(12, 24))
        lone(8)
    else:
        raise ValueError(kind)
    return groups, assembled, pods


def gang_framework(registry, framework_mod, make_pod_group, groups,
                   assembled, store=None):
    """A Framework of `registry`'s package: the port's default profile plus
    Coscheduling. With `groups` ([(name, minMember)]) its PodGroup informer
    is a `PodGroupIndex` over them and `assembled` ({group: count}) members
    are already bound; with `groups` None the scheduler wires informers."""
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        DEFAULT_PLUGINS)

    plugins = registry.build_plugins(list(DEFAULT_PLUGINS) + ["Coscheduling"],
                                     store=store)
    if groups is not None:
        cos = plugins[-1]
        cos.pg_informer = PodGroupIndex({
            f"default/{g}": make_pod_group(g, mm) for g, mm in groups})
        for g, n in assembled.items():
            cos._bound[f"default/{g}"] = {f"default/{g}-assembled-{k}"
                                          for k in range(n)}
    return framework_mod.Framework(plugins, registry.DEFAULT_SCORE_WEIGHTS)


def gang_outcome(assignments: dict, pods) -> dict:
    """{group: (members placed, members)} from `pods`' gang labels;
    `assignments` keyed by pod key (assign()) or by pod name (the loop)."""
    out: dict = {}
    for name, kw in pods:
        g = (kw.get("labels") or {}).get(GANG_LABEL)
        if g is None:
            continue
        node = assignments.get(f"default/{name}", assignments.get(name))
        placed, total = out.get(g, (0, 0))
        out[g] = (placed + (node is not None), total + 1)
    return out


def port_gang_chunk(backend, kind: str, mode: str):
    """Phase 12(a)'s `kind` chunk through the port's `backend` (with its
    metrics attached) under KTPU_SOLVE_MODE `mode`: (context, metrics)."""
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.metrics.registry import SchedulerMetrics
    from kubernetes_tpu_torch.scheduler import framework, types
    from kubernetes_tpu_torch.scheduler.plugins import registry
    from kubernetes_tpu_torch.scheduler.plugins.coscheduling import (
        make_pod_group)

    nodes, residents = constraint_cluster(3, N_GANG_CHUNK_NODES)
    groups, assembled, pods = gang_chunk(kind)
    fwk = gang_framework(registry, framework, make_pod_group, groups,
                         assembled)
    backend.metrics = SchedulerMetrics()
    snap = constraint_snapshot(types, make_node, make_pod, nodes, residents)
    ctx = constraint_assign(backend, snap, fwk,
                            [types.PodInfo(make_pod(n, **kw))
                             for n, kw in pods], mode)
    return ctx, backend.metrics


#: The solver metrics a gang chunk is compared on.
GANG_METRICS = ("solver_optimal_solves", "solver_optimal_fallbacks",
                "solver_wave_commits", "solver_wave_replays")


def diagnostics_view(diagnostics) -> dict:
    """Each diagnostic's reasons, plugins and resolvability (a FitError's
    statuses), or its per-node statuses."""
    out = {}
    for key, d in diagnostics.items():
        if hasattr(d, "reason_counts"):
            out[key] = (sorted(d.reason_counts.items()), sorted(d.plugins),
                        d.resolvable)
        else:
            out[key] = sorted((n, st.code, list(st.reasons), st.plugin)
                              for n, st in d.items())
    return out


def gang_chunk_view(ctx, metrics) -> dict:
    """What phase 12(a) and the tests compare: assignments, each
    diagnostic's reasons, plugins and resolvability, the solver metrics,
    the gang-overflow degradations and the chained spread counts."""
    diags = diagnostics_view(ctx.diagnostics)
    counts = None
    if ctx.spread and ctx.spread.get("cons"):
        counts = [int(c) for c in np.asarray(
            ctx.spread["dev_counts"].cpu()
            if hasattr(ctx.spread["dev_counts"], "cpu")
            else ctx.spread["dev_counts"])]
    return {"assignments": dict(ctx.assignments), "diagnostics": diags,
            "metrics": {m: getattr(metrics, m).value() for m in GANG_METRICS},
            "gang_overflow": metrics.backend_degradations.value(
                kind="gang_overflow"),
            "spread_counts": counts}


def gang_chunks_phase(torch) -> int:
    """Phase 12(a): each gang chunk shape through `TorchBackend()` on the
    card and `TorchBackend(device="cpu")`, flagless and with greedy pinned:
    identical assignments, diagnostics, solver metrics, gang-overflow
    counts and spread counts; every flagless device pass and every spread
    scan under sync debug "error". Returns wave_solve's launches."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    t0 = time.perf_counter()
    launches = 0
    for kind in GANG_CASES:
        _, _, pods = gang_chunk(kind)
        for mode in ("auto", "greedy"):
            wave_kernel.wave_solve.launches = 0
            # The greedy wave route reads its poison flags back (the W=1
            # rerun is a host decision), so only flagless passes run under
            # the device-pass guard.
            with no_host_sync_in_wave_loop(torch), (
                    no_host_sync_in_device_pass(torch) if mode == "auto"
                    else contextlib.nullcontext()):
                card = gang_chunk_view(*port_gang_chunk(
                    TorchBackend(max_batch=GANG_CHUNK), kind, mode))
            launches += wave_kernel.wave_solve.launches
            cpu = gang_chunk_view(*port_gang_chunk(
                TorchBackend(device="cpu", max_batch=GANG_CHUNK), kind,
                mode))
            same = card == cpu
            outcome = gang_outcome(card["assignments"], pods)
            placed = sum(v is not None for v in card["assignments"].values())
            print(f"compare gang chunk {kind} ({len(pods)} pods on "
                  f"{N_GANG_CHUNK_NODES} nodes, KTPU_SOLVE_MODE={mode}), "
                  f"card vs CPU: {'identical' if same else 'DIFFER'}; "
                  f"placed {placed}, per gang (placed, members) "
                  f"{json.dumps(outcome)}, metrics "
                  f"{json.dumps(card['metrics'])}, gang_overflow "
                  f"{card['gang_overflow']}, spread counts "
                  f"{card['spread_counts']}")
            if not same:
                raise RuntimeError(f"gang chunk {kind} ({mode}) differs on "
                                   f"the card from the CPU")
            partial = [g for g, (k, n) in outcome.items()
                       if 0 < k < n and not g.startswith(("half", "ov1"))]
            if partial:
                raise RuntimeError(f"gang chunk {kind}: partial gangs "
                                   f"{partial}")
    print(f"phase 12(a) {time.perf_counter() - t0:.1f} s, wave_solve "
          f"launches {launches}")
    return launches


def victim_case(seed: int, n: int, p: int = 128, k: int = 8, r: int = 2,
                near_max: bool = False) -> tuple:
    """One seeded `propose_victims` bucket, as numpy arrays in its argument
    order: nodes of 4000 / 16384 quantized units (Preemption's cpu 4 /
    memory 16Gi), most full of 0-4 victims ascending in priority (0, 10,
    100 or 1000; with `near_max`, priorities within 200 of 2^31 - 1 and
    preemptors at 2^31 - 2, where the float32 priority sums are no longer
    exact), a few with free room; preemptors of priority 1000 (a few
    lower), ~5% of nodes banned per preemptor, the last 8 rows padding
    (INT32_MIN priority, every node banned) as `prime_wave` pads a bucket;
    offsets uniform over the nodes."""
    rng = np.random.default_rng(seed)
    alloc = np.tile(np.array([[4000, 16384]], np.int32), (n, 1))
    pods_alloc = np.full((n,), 32, np.int32)
    vreq = np.zeros((n, k, r), np.int32)
    vprio = np.full((n, k), 2**31 - 1, np.int32)
    used = np.zeros((n, r), np.int32)
    pods_used = np.zeros((n,), np.int32)
    levels = np.array([2**31 - 200, 2**31 - 100, 2**31 - 3, 2**31 - 2]
                      if near_max else [0, 10, 100, 1000], np.int64)
    for i in range(n):
        m = int(rng.integers(0, 5))
        pr = np.sort(rng.choice(levels[:3] if near_max else levels,
                                size=m))
        vprio[i, :m] = pr
        vreq[i, :m, 0] = rng.choice([500, 1000, 2000], size=m)
        vreq[i, :m, 1] = rng.choice([1024, 2048, 4096], size=m)
        used[i] = vreq[i].sum(axis=0)
        if rng.random() < 0.9:
            used[i] = np.maximum(used[i], alloc[i] - rng.choice([0, 250]))
        pods_used[i] = m
    req = np.tile(np.array([[1000, 1024]], np.int32), (p, 1))
    req[rng.random(p) < 0.2] = [2000, 4096]
    prio = np.full((p,), 2**31 - 2 if near_max else 1000, np.int32)
    low = rng.random(p) < 0.1
    prio[low] = int(levels[1]) if near_max else 100
    banned = rng.random((p, n)) < 0.05
    prio[p - 8:] = -2**31
    banned[p - 8:] = True
    offsets = rng.integers(0, n, size=p).astype(np.int32)
    return (req, prio, banned, used, alloc, pods_used, pods_alloc, vreq,
            vprio, offsets)


@contextlib.contextmanager
def no_host_sync_in_victim_scan(torch):
    """Run every `solver.propose_victims` under
    `torch.cuda.set_sync_debug_mode("error")`: a torch operation that
    waits for the card inside the scan raises."""
    from kubernetes_tpu_torch.ops import solver

    fn = solver.propose_victims

    def guarded(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    solver.propose_victims = guarded
    try:
        yield
    finally:
        solver.propose_victims = fn


def victim_scan_phase(torch) -> None:
    """Phase 12(c), the scan: one `propose_victims` bucket (128
    preemptors) on the card under sync debug "error" against the CPU port
    at N=1000 and N=5000, and on the near-2^31 priorities; each card
    call's ms (CUDA events) beside the CPU's."""
    from kubernetes_tpu_torch.ops import solver

    for n, near in ((1000, False), (5000, False), (1000, True)):
        args = victim_case(11 + n, n, near_max=near)
        cpu_args = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
        dev_args = [a.cuda() for a in cpu_args]
        with no_host_sync_in_victim_scan(torch):
            card = solver.propose_victims(*dev_args)
        want = solver.propose_victims(*cpu_args)
        same = all(torch.equal(c.cpu(), w) for c, w in zip(card, want))
        ms = cuda_ms(torch, lambda: solver.propose_victims(*dev_args), 5)
        t0 = time.perf_counter()
        solver.propose_victims(*cpu_args)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        found = int((want[0] >= 0).sum())
        what = "near-2^31 priorities" if near else "priorities 0-1000"
        print(f"compare propose_victims, N={n}, P=128, K=8, {what}, card "
              f"(sync debug error) vs CPU: "
              f"{'identical' if same else 'DIFFER'} (nodes, counts and the "
              f"carry); {found} proposals; card {ms:.4f} ms per bucket "
              f"(128 graph replays), CPU {cpu_ms:.1f} ms")
        if not same and not near:
            raise RuntimeError(f"propose_victims at N={n} differs on the "
                               f"card from the CPU")


async def gang_loop(api, profiles, make_pod_group, nodes, init, groups, pods,
                    backend, batch_size: int, precreate: bool,
                    settle_s: float = 0.0, timeout: float = 600.0,
                    window_hook=None) -> dict:
    """A gang workload through `api`'s `Scheduler.run`: the nodes, the
    `init` pods (bound first), the PodGroups `groups` ([(name, minMember,
    scheduleTimeoutSeconds)]) and the gang `pods`. Pre-created: every pod
    is queued (or gated by PreEnqueue) before `run` opens the loop;
    otherwise pods are created in 512-pod gathers into the running loop.
    The window runs from the first gang create to the bind of the last
    pod of every gang that can assemble (its members all placeable and at
    least minMember of them), as seen by an informer; the loop then runs
    `settle_s` more seconds. `window_hook(start)` is called at the window's
    start (True) and end (False). Returns the assignments, the window's
    seconds, the store's objects, the scheduler and the metrics."""
    lr = LoopRun(api, backend, batch_size)
    await lr.start(nodes, profiles=profiles)
    bound: set = set()

    def track(obj):
        if (obj.get("spec") or {}).get("nodeName"):
            bound.add(f"default/{obj['metadata']['name']}")

    lr.factory.informer("pods").add_event_handler(api.ResourceEventHandler(
        on_add=track, on_update=lambda old, new: track(new)))
    minm = {g: mm for g, mm, _ in groups}
    members: dict = {}
    for name, kw in pods:
        g = (kw.get("labels") or {}).get(GANG_LABEL)
        members.setdefault(g, []).append((name, kw))
    want = {f"default/{name}" for g, ms in members.items()
            if g is None or (len(ms) >= minm[g] and all(
                kw["requests"].get("cpu") != "64" for _, kw in ms))
            for name, _ in ms}
    try:
        if init:
            lr.open()
            await _create_gathered(lr, api, init)
            await lr.wait(lambda: len(bound) >= len(init), "init pods bound",
                          timeout)
        for g, mm, tmo in groups:
            await lr.store.create("podgroups", make_pod_group(
                g, mm, schedule_timeout_seconds=tmo))
        if window_hook is not None:
            window_hook(True)
        t0 = time.perf_counter()
        if precreate:
            await _create_gathered(lr, api, pods)
            await lr.wait(lambda: lr.queued() == len(pods), "pods queued",
                          timeout)
            if lr.task is None:
                lr.open()
        else:
            if lr.task is None:
                lr.open()
            await _create_gathered(lr, api, pods)
        await lr.wait(lambda: want <= bound, "gangs bound", timeout)
        window = time.perf_counter() - t0
        if window_hook is not None:
            window_hook(False)
        await asyncio.sleep(settle_s)
        assignments, failed, node_objs, pod_objs = await lr.results()
        return {"assignments": assignments, "failed": failed,
                "window": window, "nodes": node_objs, "pods": pod_objs,
                "sched": lr.sched, "metrics": lr.sched.metrics}
    finally:
        await lr.close()


async def _create_gathered(lr, api, pods) -> None:
    for lo in range(0, len(pods), 512):
        await asyncio.gather(*(
            lr.store.create("pods", api.make_pod(name, **kw))
            for name, kw in pods[lo:lo + 512]))


def gang_groups(n_gangs: int, size: int, timeout_s: float) -> tuple:
    """Phase 12(b)'s PodGroups and pods: `n_gangs` gangs of `size`
    (minMember `size`) of SchedulingBasic's pod template, one gang `held`
    of `size` whose minMember is `size` + 1 (PreEnqueue never admits it),
    and one gang `stranded` of `size` with one member asking for 64 CPUs
    (no node holds it), every group's scheduleTimeoutSeconds `timeout_s`.
    Returns ([(name, minMember, timeout)], [(name, make_pod kwargs)])."""
    groups, pods = [], []
    for g in range(n_gangs + 2):
        name = "held" if g == n_gangs else "stranded" \
            if g == n_gangs + 1 else f"gang{g}"
        groups.append((name, size + (name == "held"), timeout_s))
        for i in range(size):
            req = {"cpu": "64", "memory": "250Mi"} \
                if name == "stranded" and i == size // 2 else POD_REQUESTS
            pods.append((f"{name}-{i}", {
                "requests": dict(req), "labels": {GANG_LABEL: name}}))
    return groups, pods


def gang_loop_phase(torch) -> int:
    """Phase 12(b): SchedulingBasic/5000Nodes' cluster and 1000 init pods,
    then 156 gangs of 64 (9984 pods), a held gang and a stranded gang,
    through `Scheduler(store, backend=TorchBackend()).run` with the default
    profile plus Coscheduling: every assembling gang bound whole, the two
    failing gangs unbound, no partial gang, no node over capacity; pods/s
    over the window, the routes, the optimal solves and wave_solve
    launches, gang_overflow and `assign`'s share of the window (no profiled
    repeat: cut to keep the smoke inside half its time limit). Returns
    wave_solve's launches in the window."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.scheduler import framework
    from kubernetes_tpu_torch.scheduler.plugins import registry
    from kubernetes_tpu_torch.scheduler.plugins.coscheduling import (
        make_pod_group)

    t0 = time.perf_counter()
    api = port_loop_api()
    nodes = [(f"node-{i}", {}) for i in range(N_NODES)]
    init = [(f"init-{i}", {"requests": dict(POD_REQUESTS)})
            for i in range(N_INIT)]
    groups, pods = gang_groups(N_GANGS, GANG_SIZE, GANG_TIMEOUT_S)

    def profiles(store):
        return {"default-scheduler": gang_framework(
            registry, framework, make_pod_group, None, {}, store=store)}

    def run() -> tuple:
        backend = TorchBackend()
        w: dict = {}

        def hook(start: bool) -> None:
            torch.cuda.synchronize()
            if start:
                wave_kernel.wave_solve.launches = 0
                w["timings"] = dict(backend.timings)
                w["counters"] = dict(backend.counters)
                return
            w["launches"] = wave_kernel.wave_solve.launches
            w["timings"] = {k: v - w["timings"][k]
                            for k, v in backend.timings.items()}
            w["counters"] = {k: v - w["counters"][k]
                             for k, v in backend.counters.items()
                             if k != "sinkhorn_iterations"}

        out = asyncio.run(gang_loop(
            api, profiles, make_pod_group, nodes, init, groups, pods,
            backend, LOOP_BATCH, precreate=False,
            settle_s=GANG_TIMEOUT_S + 1.0, window_hook=hook))
        return out, w

    out, w = run()
    outcome = gang_outcome(out["assignments"], pods)
    whole = sum(k == n for k, n in outcome.values())
    rejected = sorted(g for g, (k, _) in outcome.items() if k == 0)
    partial = sorted(g for g, (k, n) in outcome.items() if 0 < k < n)
    bad = over_capacity(out["nodes"], out["pods"])
    m = out["metrics"]
    overflow = m.backend_degradations.value(kind="gang_overflow")
    n_good = N_GANGS * GANG_SIZE
    print(f"gang loop SchedulingBasic/5000Nodes cluster, {N_INIT} init pods, "
          f"{N_GANGS} gangs of {GANG_SIZE} + held + stranded "
          f"(Scheduler.run, TorchBackend(), default profile + "
          f"Coscheduling): {n_good / out['window']:.2f} pods/s over the "
          f"window ({out['window']:.6f} s); gangs bound whole {whole}, "
          f"rejected whole {rejected}, partial {len(partial)}; "
          f"TorchBackend.counters {json.dumps(w['counters'])}, wave_solve "
          f"launches {w['launches']}, gang_overflow {overflow}; "
          f"TorchBackend.timings {json.dumps(w['timings'])}, assign share "
          f"{w['timings']['assign_s'] / out['window']:.4f}; nodes over "
          f"capacity {len(bad)}; phase 12(b) {time.perf_counter() - t0:.1f} s")
    if partial or bad or whole != N_GANGS \
            or rejected != ["held", "stranded"]:
        raise RuntimeError(f"phase 12(b): partial {partial[:5]}, whole "
                           f"{whole}, rejected {rejected}, over capacity "
                           f"{bad[:5]}")
    return w["launches"]


def preemption_counts_cls(torch):
    """counting_runner_cls's runner that also records, over the measured
    window, DefaultPreemption's route per preemptor (device-primed,
    ranked host search, per-node host scan, in-flight re-nomination), the
    `propose_victims` calls, their host-clock ms and graph replays, and
    every eviction (preemptor priority, victim keys); the victims'
    priorities are read from their delete events."""
    from kubernetes_tpu_torch.ops import solver

    base = counting_runner_cls(torch)

    class PreemptionRunner(base):
        async def _drive(self, template_ops, params, timeout, backing,
                         store, metrics, sched, factory, *boundary):
            self.evictions: list = []
            self.victim_prio: dict = {}
            self.scan = {"calls": 0, "ms": 0.0, "replays": 0}
            plugin = next(p for p in sched.profiles[
                "default-scheduler"].post_filter_plugins
                if p.NAME == "DefaultPreemption")
            self.plugin = plugin
            evict = plugin.evict

            def recorded(pod, victim_keys, node):
                self.evictions.append((pod.priority, list(victim_keys)))
                return evict(pod, victim_keys, node)
            plugin.evict = recorded

            def on_delete(obj):
                self.victim_prio[f"default/{obj['metadata']['name']}"] = \
                    int((obj.get("spec") or {}).get("priority") or 0)
            from kubernetes_tpu_torch.client import ResourceEventHandler
            factory.informer("pods").add_event_handler(
                ResourceEventHandler(on_delete=on_delete))
            fn = solver.propose_victims

            def timed(*args, **kw):
                t = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.scan["calls"] += 1
                self.scan["ms"] += (time.perf_counter() - t) * 1e3
                self.scan["replays"] += int(args[0].shape[0])
                return out
            solver.propose_victims = timed
            try:
                return await super()._drive(template_ops, params, timeout,
                                            backing, store, metrics, sched,
                                            factory, *boundary)
            finally:
                solver.propose_victims = fn

        def _begin_measure(self, metrics, backing):
            self.paths0 = dict(self.plugin.paths)
            self.scan = dict.fromkeys(self.scan, 0)
            self.evictions = []
            return super()._begin_measure(metrics, backing)

        def _end_measure(self, result, metrics, backing, base, count):
            super()._end_measure(result, metrics, backing, base, count)
            self.window["paths"] = {k: v - self.paths0[k]
                                    for k, v in self.plugin.paths.items()}
            self.window["scan"] = dict(self.scan)
            self.window["evictions"] = list(self.evictions)

    return PreemptionRunner


def preemption_run(torch, workload: str, profile: str | None):
    """One run of Preemption/`workload` through the port's PerfRunner and
    `Scheduler.run` with `TorchBackend()`, every propose_victims under sync
    debug "error": every preemptor bound (the scoped barriers), victims
    evicted, none of priority at or above its preemptor's, no node over
    capacity. Returns (runner, result, pod objects)."""
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.perf.scheduler_perf import PREEMPTION

    params = next(w["params"] for w in PREEMPTION["workloads"]
                  if w["name"] == workload)
    runner = preemption_counts_cls(torch)(TorchBackend(), profile)
    with no_host_sync_in_victim_scan(torch):
        result = asyncio.run(runner.run(PREEMPTION["workloadTemplate"],
                                        params, timeout=900.0))
    pods = asyncio.run(runner.store.list("pods")).items
    nodes = asyncio.run(runner.store.list("nodes")).items
    high = [p for p in pods if (p["spec"].get("priority") or 0) >= 1000]
    unbound = [p["metadata"]["name"] for p in high
               if not p["spec"].get("nodeName")]
    wrong = [(pp, vk, runner.victim_prio.get(vk))
             for pp, keys in runner.window["evictions"] for vk in keys
             if runner.victim_prio.get(vk, pp) >= pp]
    n_pre = params["warmupPreemptors"] + params["measurePods"]
    bad = over_capacity(nodes, pods)
    if unbound or len(high) != n_pre or wrong or bad \
            or not runner.window["evictions"]:
        raise RuntimeError(f"Preemption/{workload}: unbound preemptors "
                           f"{unbound[:5]} of {len(high)}, victims at or "
                           f"above their preemptor {wrong[:5]}, over "
                           f"capacity {bad[:5]}")
    return runner, result, pods


def preemption_phase(torch) -> None:
    """Phase 12(c): Preemption/1000Nodes (1000 nodes, 4000 fillers, 100
    warm-up and 1000 measured preemptors; not cut) through the port's
    PerfRunner, then a repeat of Preemption/100Nodes under
    torch.profiler."""
    t0 = time.perf_counter()
    runner, result, pods = preemption_run(torch, "1000Nodes", None)
    w, r = runner.window, result.as_dict()
    victims = sum(len(keys) for _, keys in w["evictions"])
    scan = w["scan"]
    print(f"Preemption/1000Nodes (PerfRunner, Scheduler.run, TorchBackend(), "
          f"batch_size {LOOP_BATCH}): SchedulingThroughput "
          f"{r['throughput_pods_per_sec']} pods/s, measured_seconds "
          f"{result.measured_seconds:.6f}; every preemptor bound, victims "
          f"evicted in the window {victims} (by {len(w['evictions'])} "
          f"preemptions), none of priority at or above its preemptor; "
          f"{len(pods)} pods left; DefaultPreemption routes in the window "
          f"{json.dumps(w['paths'])}; propose_victims calls {scan['calls']}, "
          f"{scan['ms'] / max(scan['calls'], 1):.3f} ms per call "
          f"(host clock to results), graph replays {scan['replays']}; "
          f"backend dispatches {w['routes']['backend_dispatches']} with "
          f"{w['routes']['backend_pods']} pods, host-path pods "
          f"{w['routes']['host_path_pods']}, unschedulable attempts "
          f"{r['unschedulable_total']}; TorchBackend.timings "
          f"{json.dumps(w['timings'])}, window wall {w['wall']:.6f} s")
    if scan["calls"] == 0 or w["paths"]["primed"] == 0:
        raise RuntimeError("phase 12(c): no device-primed preemption in the "
                           "measured window")
    prof_runner, prof_result, _ = preemption_run(torch, "100Nodes", "device")
    pw = prof_runner.window
    busy_us = sum(device_us(e) for e in prof_runner.prof.key_averages())
    print(f"profiled Preemption/100Nodes measured window: wall "
          f"{pw['wall']:.6f} s, throughput {prof_result.throughput:.1f} "
          f"pods/s, device busy {busy_us / 1e6:.6f} s" + (
              f", idle share {1 - busy_us / 1e6 / pw['wall']:.4f}"
              if busy_us else ", device time not measured by the profiler")
          + f"; phase 12(c) {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 13: large clusters (the shortlist and the block index)
# ---------------------------------------------------------------------------

#: The fixtures of the shortlist phase, each driving one arm: bound-check
#: fallbacks, ties at the K boundary, the uniform arm, a uniform block
#: before a selected block (the full-width pass), a drain frontier (the
#: selection mid-range), padding columns, exception columns, and a storm
#: that poisons the multistart orders.
SHORTLIST_CASES = ("tight", "ties", "uniform", "before", "frontier",
                   "padded", "pinned", "storm")


def shortlist_case(kind: str, seed: int, n: int, p: int, block_w: int,
                   r: int = 2, k_orders: int = 4):
    """A seeded class-plane chunk for the shortlist prefilters and scans.

    Four class rows (row 0 the reserved empty class), pods of the three
    others, k_orders pod orders (the identity first). `kind` names the arm
    it drives (SHORTLIST_CASES); an `n` that is not a multiple of block_w
    gives every fixture a ragged last block, and "padded" leaves its last
    columns unreal (alloc 0, mask False), as the backend's node padding
    is. Returns (arrays in SOLVE_ORDER with w_fit and w_bal, class_req
    (C, R), rows (P,), exc (P,), perms (k_orders, P), n_real), all
    numpy."""
    rng = np.random.default_rng(seed)
    n_real = n - block_w - 7 if kind == "padded" else n
    classes = 4
    alloc = np.tile(np.array([[8000, 32000]], np.int32)[:, :r], (n, 1))
    used = np.zeros((n, r), np.int32)
    free_pods = np.full((n,), 110, np.int32)
    static = np.zeros((classes, n), np.float32)
    class_req = np.array([[0, 0], [100, 250], [400, 1000], [1000, 4000]],
                         np.int32)[:, :r]
    w = 1.0
    if kind in ("tight", "pinned"):
        # Heterogeneous nodes: three shapes, random usage, random statics.
        shape = rng.integers(0, 3, size=(n,))
        alloc = (np.array([[4000, 16000], [8000, 32000], [16000, 64000]],
                          np.int32)[:, :r][shape])
        used = (alloc * rng.uniform(0, 0.6, size=(n, r))).astype(np.int32)
        static = rng.integers(0, 3, size=(classes, n)).astype(np.float32)
    if kind == "tight":
        # Few pod slots and big requests: the winners' columns run out
        # mid-chunk, and steps cannot prove their winner.
        free_pods = rng.integers(1, 3, size=(n,)).astype(np.int32)
        class_req = np.array([[0, 0], [1500, 6000], [2500, 9000],
                              [3000, 12000]], np.int32)[:, :r]
    elif kind == "ties":
        # Quantized statics and no live weights: exact float ties at the
        # K boundary.
        static = rng.integers(0, 2, size=(classes, n)).astype(np.float32)
        w = 0.0
    elif kind == "before":
        # Identical nodes, the last half scoring a hair better (under
        # BLOCK_UB_EPS): the selection sits in the better half, and the
        # uniform blocks before it can neither lose strictly nor win
        # their ties, so the chunk takes the full-width pass.
        static[:, n // 2:] = 0.001
    elif kind == "frontier":
        # A drain frontier on identical nodes: the first third full, so
        # the selection sits mid-range.
        used[: n // 3] = alloc[: n // 3] - 50
    elif kind == "storm":
        # Small identical nodes and two slots each: the orders contend,
        # waves conflict and the multistart orders poison.
        alloc[:] = np.array([3000, 6000], np.int32)[:r]
        used[n // 2:] = alloc[n // 2:] // 4
        free_pods = rng.integers(1, 3, size=(n,)).astype(np.int32)
        class_req = np.array([[0, 0], [400, 900], [900, 1800],
                              [1400, 2500]], np.int32)[:, :r]
    mask = rng.random((classes, n)) > 0.1 if kind != "uniform" \
        else np.ones((classes, n), bool)
    mask[0] = False
    if n_real < n:
        alloc[n_real:] = 0
        used[n_real:] = 0
        free_pods[n_real:] = 0
        mask[:, n_real:] = False
    rows = rng.integers(1, classes, size=(p,)).astype(np.int32)
    exc = np.full((p,), -1, np.int32)
    pins = max(1, p // 16) if kind in ("pinned", "storm") else 0
    if pins:
        exc[rng.choice(p, size=pins, replace=False)] = rng.integers(
            0, n_real, size=pins).astype(np.int32)
    perms = np.stack([np.arange(p, dtype=np.int32)]
                     + [rng.permutation(p).astype(np.int32)
                        for _ in range(k_orders - 1)])
    arrays = dict(
        req_q=class_req[rows], req_nz_q=class_req[rows],
        free_q=alloc - used, free_pods=free_pods, used_nz_q=used,
        alloc_q=alloc, mask=mask, static_scores=static,
        fit_col_w=np.ones((r,), np.float32),
        bal_col_mask=np.ones((r,), np.bool_),
        shape_u=np.array([0.0, 50.0, 100.0], np.float32),
        shape_s=np.array([0.0, 4.0, 10.0], np.float32),
        w_fit=np.float32(w), w_bal=np.float32(w))
    return arrays, class_req, rows, exc, perms, n_real


def shortlist_inputs(case):
    """The class-level prefilter inputs of a `shortlist_case` as the
    backends build them: (chunk-start feasibility (C, N), has_node (P,)),
    numpy."""
    arrays, class_req, rows, exc, _, _ = case
    fits0 = np.all(class_req[:, None, :] <= arrays["free_q"][None], axis=-1) \
        & (arrays["free_pods"] >= 1)[None]
    feasible = arrays["mask"] & fits0
    has_c = arrays["mask"].any(axis=1)[rows]
    has_node = np.where(exc >= 0, arrays["mask"][rows, np.maximum(exc, 0)],
                        has_c)
    return feasible, has_node


def run_shortlist(torch, case, strategy: str, k: int, block_w: int,
                  wave_w: int, device) -> dict:
    """The port's shortlist route on one `shortlist_case` on `device`:
    the prefilter (`block_bound_prefilter` with block_w > 0, else the
    full-width one), then the identity scans (W=1, and waves of wave_w)
    and the multistart scans (W=1 and waves) over the case's orders, each
    from the prefilter's shortlists. Every result comes back as numpy or
    ints: {"cand", "thresh", "sc0_at_cand", "scanned", "pruned",
    "identity": (assign, fallbacks), "wave": (assign, fallbacks, commits,
    replays), "multistart": (assign, fallbacks), "multistart_wave":
    (assign, fallbacks, commits, replays)}."""
    from kubernetes_tpu_torch.ops import kernels, solver

    arrays, class_req, rows, exc, perms, n_real = case
    feasible, has_node = shortlist_inputs(case)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    args = [float(arrays[k_]) if k_ in ("w_fit", "w_bal")
            else put(arrays[k_]) for k_ in SOLVE_ORDER]
    score_args = (*args[8:14], strategy)
    c_req = put(class_req)
    if block_w:
        sc0, cand, thresh, scanned, pruned = solver.block_bound_prefilter(
            args[5], args[4], c_req, args[7], put(feasible), *score_args,
            n_real, k, block_w)
        scanned, pruned = int(scanned), int(pruned)
    else:
        sc0 = kernels.chunk_start_scores(args[5], args[4], c_req, args[7],
                                         *score_args)
        cand, thresh = solver.shortlist_prefilter(put(feasible), sc0, k)
        scanned = pruned = 0
    rows_t, exc_t = put(rows), put(exc)
    rl = rows_t.long()
    sl = (sc0, rows_t, cand[rl], thresh[rl], put(has_node))
    p = rows.shape[0]
    gang = (torch.zeros((p, 16), device=device),
            torch.zeros((16,), device=device))

    def host(t):
        return tuple(int(x) if torch.is_tensor(x) and x.numel() == 1
                     else (x.cpu().numpy() if torch.is_tensor(x) else x)
                     for x in t)

    out = {"cand": cand.cpu().numpy(), "thresh": thresh.cpu().numpy(),
           "sc0_at_cand": torch.gather(sc0, 1, cand.long()).cpu().numpy(),
           "scanned": scanned, "pruned": pruned}
    out["identity"] = host(solver.greedy_assign_rescoring_shortlist(
        *args, strategy, *sl, rows=rows_t, exc=exc_t))
    out["wave"] = host(solver.greedy_assign_rescoring_shortlist_wave(
        *args, strategy, wave_w, *sl, rows=rows_t, exc=exc_t))
    out["multistart"] = host(solver.multistart_greedy_assign_shortlist(
        *args, strategy, put(perms), *gang, *sl, rows=rows_t, exc=exc_t))
    out["multistart_wave"] = host(
        solver.multistart_greedy_assign_shortlist_wave(
            *args, strategy, wave_w, put(perms), *gang, *sl, rows=rows_t,
            exc=exc_t))
    return out


@contextlib.contextmanager
def no_host_sync_in_shortlist(torch):
    """Run the shortlist prefilters and scans under
    `torch.cuda.set_sync_debug_mode("error")`, except the route's host
    reads (`solver._any_flag`: the block prefilter's exactness predicate,
    one per block prefilter, and the scans' poison bits, one per scan of a
    single order and one per multistart chunk), which run in the default
    mode and are counted. Yields the count as a one-element list. Each
    guard restores the mode it found, so it nests inside
    `no_host_sync_in_device_pass`."""
    from kubernetes_tpu_torch.ops import solver

    def guard(fn, mode):
        def guarded(*args, **kw):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(mode)
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return guarded

    reads = [0]
    read = solver._any_flag

    def counted_read(bits):
        reads[0] += 1
        return read(bits)

    targets = {name: "error" for name in (
        "shortlist_prefilter", "block_bound_prefilter",
        "greedy_assign_rescoring_shortlist",
        "greedy_assign_rescoring_shortlist_wave",
        "multistart_greedy_assign_shortlist",
        "multistart_greedy_assign_shortlist_wave",
        "greedy_assign_rescoring_spread_shortlist")}
    saved = {name: getattr(solver, name) for name in targets}
    for name, mode in targets.items():
        setattr(solver, name, guard(saved[name], mode))
    solver._any_flag = guard(counted_read, "default")
    try:
        yield reads
    finally:
        for name, fn in saved.items():
            setattr(solver, name, fn)
        solver._any_flag = read


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and np.array_equal(a, b)
    return a == b


def block_kernels_on(torch, case, block_w: int, strategy: str,
                     device) -> list[np.ndarray]:
    """The five block kernels (`_block_fold`, `block_capacity_aggregates`,
    `block_feasible_stat`, `block_score_upper_bound`,
    `gathered_start_scores`) on a `shortlist_case`'s class rows on
    `device`, as numpy."""
    from kubernetes_tpu_torch.ops import kernels

    arrays, class_req, _, _, _, n_real = case
    feasible, _ = shortlist_inputs(case)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    alloc, used, static = (put(arrays[k]) for k in (
        "alloc_q", "used_nz_q", "static_scores"))
    score_args = [put(arrays[k]) for k in (
        "fit_col_w", "bal_col_mask", "shape_u", "shape_s")] + [
        float(arrays["w_fit"]), float(arrays["w_bal"]), strategy]
    n = alloc.shape[0]
    agg = kernels.block_capacity_aggregates(
        alloc, used, torch.arange(n, device=device) < n_real, block_w)
    stat = kernels.block_feasible_stat(put(feasible), static, block_w)
    ub = kernels.block_score_upper_bound(
        stat[0], stat[2], agg[0], agg[2], agg[3], agg[4], put(class_req),
        *score_args)
    cols = torch.arange(0, n, 7, device=device)[None, :].expand(
        class_req.shape[0], -1)
    gathered = kernels.gathered_start_scores(
        alloc[cols], used[cols], put(class_req),
        torch.gather(static, 1, cols), *score_args)
    fold = kernels._block_fold(alloc, block_w, kernels._BLOCK_BIG)
    return [t.cpu().numpy() for t in (fold, *agg, *stat, ub, gathered)]


#: 13(a)'s fixture shape: nodes, pods, K, block width, wave width.
SHORTLIST_SHAPE = (8257, 128, 64, 128, 32)
SHORTLIST_STRATEGIES = ("LeastAllocated", "MostAllocated",
                        "RequestedToCapacityRatio")


def shortlist_jobs() -> list[tuple]:
    """13(a)'s fixture runs: (kind, seed, strategy, block width)."""
    bw = SHORTLIST_SHAPE[3]
    return [(kind, 70 + i, SHORTLIST_STRATEGIES[i % 3], width)
            for i, kind in enumerate(SHORTLIST_CASES)
            for width in ((bw, 0) if kind == "uniform" else (bw,))]


def shortlist_cpu_run(job: tuple) -> dict:
    """One 13(a) fixture run through the port on the CPU, in a worker
    process of the phase's pool (two torch threads each)."""
    import torch

    torch.set_num_threads(2)
    kind, seed, strategy, width = job
    n, p, k, bw, w = SHORTLIST_SHAPE
    return run_shortlist(torch, shortlist_case(kind, seed, n, p, bw),
                         strategy, k, width, w, "cpu")


def shortlist_fixtures_on_card(torch, dev, cpu_runs: dict) -> int:
    """13(a)'s fixture runs on the card, each held to its CPU run (the
    futures of `cpu_runs`, by job). Returns the counted host reads."""
    n, p, k, bw, w = SHORTLIST_SHAPE
    reads = 0
    for job, future in cpu_runs.items():
        kind, seed, strategy, width = job
        case = shortlist_case(kind, seed, n, p, bw)
        with no_host_sync_in_shortlist(torch) as r:
            card = run_shortlist(torch, case, strategy, k, width, w, dev)
        reads += r[0]
        cpu = future.result()
        differ = [key for key in card if not _same(card[key], cpu[key])]
        print(f"compare shortlist route, {kind} ({strategy}, N={n}, "
              f"{p} pods, K={k}, block width {width}), card vs CPU: "
              f"{'identical' if not differ else 'DIFFER ' + str(differ)}"
              f"; blocks scanned/pruned {card['scanned']}/"
              f"{card['pruned']}, fallbacks identity "
              f"{card['identity'][1]}, waves (fallbacks, commits, "
              f"replays) {card['wave'][1:]}, multistart "
              f"{card['multistart'][1]}, multistart waves "
              f"{card['multistart_wave'][1:]}, placed "
              f"{int((card['identity'][0] >= 0).sum())}; host reads "
              f"{r[0]}")
        if differ:
            raise RuntimeError(f"the shortlist route on the card "
                               f"differs from the CPU on {kind}")
    return reads


def shortlist_scan_phase(torch, dev) -> int:
    """Phase 13(a): the shortlist route on the card against the CPU port
    on the eight `shortlist_case` fixtures (N = 8257, a ragged last block
    of 65 columns, 128 pods, K=64, block width 128, waves of 32), the
    full-width prefilter on the uniform fleet, the five block kernels, and
    the spread shortlist scan; the card's scans under sync debug "error"
    except the counted host reads. The fixtures' CPU runs go to four
    worker processes (spawned, CPU only) while the card runs its own.
    Returns the wave_solve launches (the poisoned chunks' reruns)."""
    import concurrent.futures
    import multiprocessing

    from kubernetes_tpu_torch.ops import kernels, solver, wave_kernel

    t0 = time.perf_counter()
    launches0 = wave_kernel.wave_solve.launches
    n, p, k, bw, w = SHORTLIST_SHAPE
    with concurrent.futures.ProcessPoolExecutor(
            4, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_runs = {job: pool.submit(shortlist_cpu_run, job)
                    for job in shortlist_jobs()}
        reads = shortlist_fixtures_on_card(torch, dev, cpu_runs)
    case = shortlist_case("uniform", 70 + SHORTLIST_CASES.index("uniform"),
                          n, p, bw)
    got = [block_kernels_on(torch, case, bw, s, dev)
           for s in SHORTLIST_STRATEGIES]
    want = [block_kernels_on(torch, case, bw, s, "cpu")
            for s in SHORTLIST_STRATEGIES]
    same = all(_same(tuple(g), tuple(c)) for g, c in zip(got, want))
    print(f"compare block kernels (fold, aggregates, feasible stat, upper "
          f"bound, gathered scores; 3 strategies), card vs CPU: "
          f"{'identical' if same else 'DIFFER'}")
    if not same:
        raise RuntimeError("a block kernel differs on the card")
    # The spread shortlist scan, per-pod shortlists over a spread case.
    case = spread_case(seed=13, n=600, p=256)
    arrays, table, counts, applies, contrib, rows, exc = case
    out = []
    for device in (dev, "cpu"):
        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)
        args = [float(arrays[k_]) if k_ in ("w_fit", "w_bal")
                else put(arrays[k_]) for k_ in SOLVE_ORDER]
        rl = put(rows).long()
        fits0 = torch.all(args[0][:, None, :] <= args[2][None], dim=-1) \
            & (args[3] >= 1)[None]
        sc0 = kernels.chunk_start_scores(
            args[5], args[4], args[1], args[7][rl], *args[8:14],
            "LeastAllocated")
        ctx = no_host_sync_in_shortlist(torch) if device != "cpu" \
            else contextlib.nullcontext()
        with ctx:
            cand, thresh = solver.shortlist_prefilter(
                args[6][rl] & fits0, sc0, 16)
            tab = solver.SpreadTable(*(put(table[k_]) for k_ in (
                "node_dom", "dom_cid", "max_skew", "min_ok", "has_key")))
            got = solver.greedy_assign_rescoring_spread_shortlist(
                *args, "LeastAllocated", tab, put(counts), put(applies),
                put(contrib), sc0,
                torch.arange(rows.shape[0], dtype=torch.int32,
                             device=device), cand,
                thresh, args[6][rl].any(dim=1), rows=put(rows),
                exc=put(exc))
        out.append(tuple(t.cpu().numpy() for t in got))
    same = _same(out[0], out[1])
    print(f"compare spread shortlist scan (600 nodes, 256 pods, K=16), "
          f"card vs CPU: {'identical' if same else 'DIFFER'}; placed "
          f"{int((out[0][0] >= 0).sum())}, fallbacks {int(out[0][2][0])}")
    if not same:
        raise RuntimeError("the spread shortlist scan differs on the card")
    launches = wave_kernel.wave_solve.launches - launches0
    print(f"phase 13(a) {time.perf_counter() - t0:.1f} s, host reads "
          f"{reads} (one per block prefilter, per single-order scan and "
          f"per multistart chunk), wave_solve launches {launches} (the "
          f"poisoned chunks' W=1 reruns)")
    return launches


#: bench.py's 50k preset (`PRESETS["50k"]`): nodes, warm-up pods, measured
#: pods, SchedulingBasic's node and pod templates.
LARGE_NODES, LARGE_WARMUP, LARGE_MEASURED = 50000, 500, 5000
BENCH_50K = {
    "name": "bench-50k",
    "workloadTemplate": [
        {"opcode": "createNodes", "countParam": "$nodes"},
        {"opcode": "createPods", "countParam": "$warmup"},
        {"opcode": "barrier"},
        {"opcode": "createPods", "countParam": "$measured",
         "collectMetrics": True},
        {"opcode": "barrier"},
    ],
    "workloads": [{"name": "50000Nodes", "params": {
        "nodes": LARGE_NODES, "warmup": LARGE_WARMUP,
        "measured": LARGE_MEASURED}}],
}


def large_assign(torch, backend, fwk, warm, measured, guard: bool = False,
                 profile: bool = False) -> dict:
    """bench.py's 50k preset through `backend.assign`: fresh nodes, the
    warm-up pods, then the measured pods on the snapshot they leave. Every
    pod must be placed and no node over capacity on an exact host
    re-check. Returns {"warm", "assign": the warm-up and measured
    assignments, "wall": s, "timings", "counters": over the measured
    assign, "launches": wave_solve launches of the measured assign alone,
    "reads": the solver's host reads under `guard`, "prof": the profiler
    or None}."""
    from kubernetes_tpu_torch.api.types import make_node
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.scheduler.types import NodeInfo

    nodes = [NodeInfo(make_node(f"node-{i}")) for i in range(LARGE_NODES)]
    by_name = {ni.name: ni for ni in nodes}
    warm_assign, _ = backend.assign(warm, stamped_snapshot(nodes, 1), fwk)
    for pi in warm:
        by_name[warm_assign[pi.key]].add_pod(pi)
    snap = stamped_snapshot(nodes, 2)
    torch.cuda.synchronize()
    before_t, before_c = dict(backend.timings), dict(backend.counters)
    prof = None
    with contextlib.ExitStack() as stack:
        reads = [0]
        if guard:
            stack.enter_context(no_host_sync_in_device_pass(torch))
            reads = stack.enter_context(no_host_sync_in_shortlist(torch))
        if profile:
            prof = stack.enter_context(torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]))
        launches0 = wave_kernel.wave_solve.launches
        t0 = time.perf_counter()
        assignments, _ = backend.assign(measured, snap, fwk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = wave_kernel.wave_solve.launches - launches0
    unplaced = [k for k, v in {**warm_assign, **assignments}.items()
                if v is None]
    if unplaced or len(assignments) != len(measured):
        raise RuntimeError(f"{len(unplaced)} pods unplaced at 50k nodes")
    for pi in measured:
        by_name[assignments[pi.key]].add_pod(pi)
    over = [ni.name for ni in nodes
            if ni.requested.pods > ni.allocatable.pods
            or any(v > ni.allocatable.get(r)
                   for r, v in ni.requested.res.items())]
    if over:
        raise RuntimeError(f"nodes over capacity at 50k: {over[:5]}")
    timings = {k: round(v - before_t[k], 6)
               for k, v in backend.timings.items()}
    counters = {k: v - before_c[k] for k, v in backend.counters.items()
                if k != "sinkhorn_iterations"}
    return {"warm": warm_assign, "assign": assignments, "wall": wall,
            "timings": timings, "counters": counters, "launches": launches,
            "reads": reads[0], "prof": prof}


#: The shortlist width 13(b)-(d) force on the card (the reference's K at
#: the 1024-pod chunk).
LARGE_K = 1024


def large_assign_phase(torch, dev, fwk) -> dict:
    """Phase 13(b): bench.py's 50k preset through `TorchBackend.assign`,
    flagless (every chunk greedy at that size; the card's tuner keeps the
    full-width wave_solve at W=64), then, on the first measured chunk
    alone, with the shortlist forced (KTPU_SHORTLIST_K=1024: the
    full-width prefilter and the narrow scans) and with the block
    prefilter forced too (KTPU_BLOCK_WIDTH=128: the reference's route at
    this size); the identity checks, the per-chunk times of both
    prefilters, the narrow scans and the full-width kernel, and the busy
    share of the flagless route's first chunk.
    Returns the kernels line's phase 13 entries for wave_solve."""
    from kubernetes_tpu_torch.metrics.registry import SchedulerMetrics
    from kubernetes_tpu_torch.ops import kernels, solver, wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend, chunk_planes
    from kubernetes_tpu_torch.scheduler.types import PodInfo
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.scheduler.types import NodeInfo
    from kubernetes_tpu_torch.utils import flags

    t0 = time.perf_counter()
    warm = [PodInfo(make_pod(f"warm-{i}", requests=POD_REQUESTS))
            for i in range(LARGE_WARMUP)]
    measured = [PodInfo(make_pod(f"pod-{i}", requests=POD_REQUESTS))
                for i in range(LARGE_MEASURED)]
    chunks = -(-LARGE_MEASURED // 1024)
    forced = (("KTPU_SHORTLIST_K", LARGE_K),)
    blocks = forced + (("KTPU_BLOCK_WIDTH", 128),)
    routes = (("flagless", ()),
              (f"KTPU_SHORTLIST_K={LARGE_K}", forced),
              (f"KTPU_SHORTLIST_K={LARGE_K} KTPU_BLOCK_WIDTH=128", blocks))
    runs = {}
    for label, env in routes:
        # The forced routes run the first measured chunk alone (a cut of
        # depth: the smoke's time), held to the flagless assign's.
        pods = measured if not env else measured[:1024]
        with contextlib.ExitStack() as stack:
            for flag, value in env:
                stack.enter_context(flags.scoped_set(flag, value))
            backend = TorchBackend()
            backend.metrics = SchedulerMetrics()
            t_build = time.perf_counter()
            run = large_assign(torch, backend, fwk, warm, pods,
                               guard=True)
        run["scan_width"] = backend.metrics.solver_scan_width.value()
        run["wave_width"] = backend.metrics.solver_wave_width.value()
        runs[label] = run
        c = run["counters"]
        same = run["warm"] == runs["flagless"]["warm"] and all(
            v == runs["flagless"]["assign"][k]
            for k, v in run["assign"].items())
        print(f"50k assign, {label} (bench.py preset: {LARGE_NODES} nodes, "
              f"{LARGE_WARMUP} + {LARGE_MEASURED} pods of cpu 100m / memory "
              f"250Mi): {len(pods)} measured pods in "
              f"{run['wall']:.6f} s = {len(pods) / run['wall']:.1f} "
              f"pods/s; measured phase timings {json.dumps(run['timings'])}"
              f"; counters {json.dumps(c)}; scan width {run['scan_width']}, "
              f"wave width {run['wave_width']}; wave_solve launches in the "
              f"measured assign {run['launches']}, host reads "
              f"{run['reads']}; every device pass under sync debug "
              f"\"error\" but the host reads; "
              + ("" if label == "flagless" else
                 f"{'identical' if same else 'DIFFER'} to flagless; ")
              + f"build + warm-up + measured "
              f"{time.perf_counter() - t_build:.1f} s")
        if not same:
            raise RuntimeError(f"the 50k assign differs with {label}")
        if label == "flagless":
            ok = (c["shortlist_pods"] == 0
                  and run["scan_width"] == LARGE_NODES
                  and run["launches"] >= chunks)
        else:
            ok = (c["shortlist_pods"] == len(pods)
                  and run["scan_width"] == LARGE_K + 1024
                  and ((c["blocks_scanned"] > 0 and c["blocks_pruned"] > 0)
                       if env == blocks else c["blocks_scanned"] == 0))
        if not ok or run["wave_width"] != 64:
            raise RuntimeError(f"the 50k assign, {label}, missed its route: "
                               f"{c}, scan width {run['scan_width']}, wave "
                               f"width {run['wave_width']}, launches "
                               f"{run['launches']}")
    ma = runs["flagless"]["assign"]
    # The first measured chunk on the CPU port (the reference's route
    # there: the shortlist and the block prefilter) from the same snapshot.
    nodes = [NodeInfo(make_node(f"node-{i}")) for i in range(LARGE_NODES)]
    by_name = {ni.name: ni for ni in nodes}
    for pi in warm:
        by_name[runs["flagless"]["warm"][pi.key]].add_pod(pi)
    first = measured[:1024]
    t1 = time.perf_counter()
    cpu = TorchBackend(device="cpu")
    cpu_first, _ = cpu.assign(first, stamped_snapshot(nodes, 2), fwk)
    cpu_s = time.perf_counter() - t1
    same = all(cpu_first[pi.key] == ma[pi.key] for pi in first)
    print(f"compare first measured chunk, TorchBackend(device=\"cpu\") from "
          f"the same snapshot: {'identical' if same else 'DIFFER'} "
          f"({cpu_s:.1f} s on the CPU; counters "
          f"{json.dumps(cpu.counters)})")
    if not same or cpu.counters["shortlist_pods"] != len(first):
        raise RuntimeError("the 50k first chunk differs on the CPU port or "
                           "missed the shortlist there")
    # Per-chunk device times on the first measured chunk's planes.
    with flags.scoped_set("KTPU_SHORTLIST_K", LARGE_K), \
            flags.scoped_set("KTPU_BLOCK_WIDTH", 128):
        b2 = TorchBackend()
        snap = stamped_snapshot(nodes, 3)
        ctx = b2._start(first, snap, fwk)
        prep = b2._prep_chunk(ctx.chunks[0], ctx)
    st, prm = b2.ensure_static(ctx.ct), ctx.params
    pl = chunk_planes(st["alloc_q"], b2.used.pack, st["alloc_pods"],
                      prep["dev_pack"], prep["dev_cls"], st["taint_f"],
                      st["taint_p"], prep["dev_mask"], prep["dev_scores"],
                      prm["w_taint"], prm["taint_filter_on"])
    r = st["alloc_q"].shape[1]
    score_args = (prm["fit_col_w"], prm["bal_col_mask"], prm["shape_u"],
                  prm["shape_s"], prm["w_fit"], prm["w_bal"],
                  prm["strategy"])
    feasible = pl["mask"] & pl["fit0"]
    c_req_nz = prep["dev_pack"][:, r:2 * r]
    k_sl, bw = prep["shortlist_k"], prep["block_w"]

    def prefilter():
        return solver.block_bound_prefilter(
            st["alloc_q"], pl["used_nz_q"], c_req_nz, pl["static_scores"],
            feasible, *score_args, ctx.ct.n_real, k_sl, bw)

    def plain_prefilter():
        sc = kernels.chunk_start_scores(
            st["alloc_q"], pl["used_nz_q"], c_req_nz, pl["static_scores"],
            *score_args)
        return solver.shortlist_prefilter(feasible, sc, k_sl)
    sc0, cand, thresh, scanned, pruned = prefilter()
    cand_p, thresh_p = plain_prefilter()
    if not (torch.equal(cand, cand_p) and torch.equal(thresh, thresh_p)):
        raise RuntimeError("the 50k block prefilter differs from the "
                           "full-width one")
    cls = prep["dev_cls"].long()
    has_node = pl["mask"].any(dim=1)[cls]
    solve_args = (pl["req_q"], pl["req_nz_q"], pl["free_q"],
                  pl["free_pods"], pl["used_nz_q"], st["alloc_q"],
                  pl["mask"], pl["static_scores"], *score_args)
    gang = (torch.zeros((1024, 16), device=dev),
            torch.zeros((16,), device=dev))

    def narrow():
        return solver.multistart_greedy_assign_shortlist_wave(
            *solve_args, prep["wave_w"], prep["dev_perms"], *gang, sc0,
            prep["dev_cls"], cand[cls], thresh[cls], has_node,
            rows=prep["dev_cls"], exc=prep["dev_exc"],
            n_real=prep["batch"].p_real)

    kw = dict(wave_w=prep["wave_w"], rows=prep["dev_cls"],
              exc=prep["dev_exc"], poison=True, perms=prep["dev_perms"])
    pre_ms = cuda_ms(torch, prefilter, 10)
    plain_pre_ms = cuda_ms(torch, plain_prefilter, 10)
    narrow_ms = cuda_ms(torch, narrow, 3)
    n_pois = narrow()[1]
    full_ms = cuda_ms(torch, lambda: wave_kernel.wave_solve(
        *solve_args, **kw), 5)
    p, n = pl["req_q"].shape[0], pl["free_q"].shape[0]
    fits = feasible[cls].sum(dim=1)
    evals = kw["perms"].shape[0] * int(fits.sum())
    full_bound, full_by = wave_bound_ms(
        p, n, r, pl["mask"].shape[0], kw["perms"].shape[0],
        prm["shape_u"].shape[0], evals)
    print(f"50k chunk (first measured, {p} pods, N={n}, K={k_sl}, block "
          f"width {bw}, W={prep['wave_w']}): block prefilter "
          f"{pre_ms:.5f} ms per chunk (blocks scanned/pruned "
          f"{scanned}/{pruned}, candidates and thresholds identical to the "
          f"full-width prefilter), full-width prefilter "
          f"{plain_pre_ms:.5f} ms per chunk, narrow scans (4 orders, "
          f"multistart waves) {narrow_ms:.5f} ms per chunk (fallback pods "
          f"{n_pois}); full-width wave_solve W={prep['wave_w']} over {n} "
          f"nodes {full_ms:.5f} ms per chunk, bound {full_bound:.6f} ms "
          f"({full_by})")
    # Busy and idle share: the first measured chunk's assign again under
    # the profiler, on the flagless route (a whole measured assign's trace
    # takes a minute to read; the forced routes' repeats are cut to keep
    # the smoke inside its time).
    for label, env in routes[:1]:
        with contextlib.ExitStack() as stack:
            for flag, value in env:
                stack.enter_context(flags.scoped_set(flag, value))
            again = large_assign(torch, TorchBackend(), fwk, warm, first,
                                 profile=True)
        if any(again["assign"][pi.key] != ma[pi.key] for pi in first):
            raise RuntimeError("a repeated 50k chunk placed pods "
                               "differently")
        busy_us = sum(device_us(e) for e in again["prof"].key_averages())
        pwall = again["wall"]
        print(f"profiled 50k first measured chunk, {label} (assign of "
              f"{len(first)} pods): wall {pwall:.6f} s, device busy "
              f"{busy_us / 1e6:.6f} s" + (
                  f", busy share {busy_us / 1e6 / pwall:.4f}, idle share "
                  f"{1 - busy_us / 1e6 / pwall:.4f}" if busy_us
                  else ", device time not measured by the profiler"))
    print(f"phase 13(b) {time.perf_counter() - t0:.1f} s")
    return {"large_launches": runs["flagless"]["launches"],
            "large_shortlist_launches": [runs[label]["launches"]
                                         for label, _ in routes[1:]],
            "large_full_width_ms": full_ms,
            "large_full_width_bound_ms": full_bound,
            "large_full_width_bound_by": full_by,
            "large_prefilter_ms": pre_ms,
            "large_plain_prefilter_ms": plain_pre_ms,
            "large_narrow_ms": narrow_ms}


def large_loop_phase(torch) -> int:
    """Phase 13(c): bench.py's 50k preset through the port's PerfRunner
    (`Scheduler.run`, `TorchBackend()`, batch_size 16384), flagless: the
    card's full-width route. Returns the measured window's wave_solve
    launches."""
    t0 = time.perf_counter()
    first = perf_run(torch, BENCH_50K, "50000Nodes", None)
    runner, result = first[0], first[1]
    c = runner.window["counters"]
    print(f"50k loop node staging {result.staging_seconds:.3f} s; shortlist "
          f"pods in the window {c['shortlist_pods']} (the card's tuner "
          f"keeps the full-width wave_solve), wave_solve launches "
          f"{runner.window['launches']}")
    if c["shortlist_pods"] or not runner.window["launches"]:
        raise RuntimeError("the 50k loop's window missed the card's "
                           "full-width route")
    report_perf(torch, "50k loop", BENCH_50K, "50000Nodes", first, "13(c)",
                t0, device_profile=False)
    return runner.window["launches"]


def large_spread_phase(torch) -> None:
    """Phase 13(d): one chunk of 512 hard zone-spread pods on 9000 nodes in
    three zones (above the shortlist threshold: the spread∩shortlist
    route, the W=1 spread shortlist scan) through `TorchBackend()` with
    KTPU_SHORTLIST_K=1024 and `TorchBackend(device="cpu")` flagless (the
    route is the CPU tuner's own there), and through flagless
    `TorchBackend()` (the card's spread wave scan)."""
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.scheduler import types
    from kubernetes_tpu_torch.scheduler.framework import Framework
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        DEFAULT_SCORE_WEIGHTS, build_plugins)
    from kubernetes_tpu_torch.utils import flags

    t0 = time.perf_counter()
    fwk = Framework(build_plugins(), DEFAULT_SCORE_WEIGHTS)
    nodes = [(f"node-{i}", {"labels": {ZONE_KEY: ZONES[i % 3]}})
             for i in range(9000)]
    pods = [types.PodInfo(make_pod(nm, **kw))
            for nm, kw in constraint_pods(("spread",), 512)]
    out = []
    for device, k in ((None, LARGE_K), ("cpu", None), (None, None)):
        backend = TorchBackend(device=device)
        snap = constraint_snapshot(types, make_node, make_pod, nodes, [])
        with contextlib.ExitStack() as stack:
            if k is not None:
                stack.enter_context(flags.scoped_set("KTPU_SHORTLIST_K", k))
            stack.enter_context(no_host_sync_in_shortlist(torch))
            ctx = constraint_assign(backend, snap, fwk, pods, "auto")
        out.append((ctx.assignments, ctx.spread["dev_counts"].cpu().numpy(),
                    dict(backend.counters)))
    card, cpu, flagless = out
    same = card[0] == cpu[0] and np.array_equal(card[1], cpu[1]) \
        and card[2] == cpu[2]
    same_flagless = flagless[0] == cpu[0] \
        and np.array_equal(flagless[1], cpu[1])
    c = card[2]
    print(f"compare spread chunk at 9000 nodes (512 hard zone-spread pods), "
          f"card (KTPU_SHORTLIST_K={LARGE_K}) vs CPU: "
          f"{'identical' if same else 'DIFFER'}; placed "
          f"{sum(v is not None for v in card[0].values())}, domain counts "
          f"{card[1].tolist()}, counters {json.dumps(c)}; card flagless "
          f"(spread wave scan): assignments and domain counts "
          f"{'identical' if same_flagless else 'DIFFER'}, counters "
          f"{json.dumps(flagless[2])}; phase 13(d) "
          f"{time.perf_counter() - t0:.1f} s")
    if not same or c["spread_chunks"] != 1 or c["shortlist_pods"] != 512 \
            or c["wave_commits"] + c["wave_replays"] or not same_flagless \
            or flagless[2]["shortlist_pods"]:
        raise RuntimeError("the spread chunk above the shortlist threshold "
                           "differs on the card or missed its route")


def large_sharded_phase(torch, dev) -> None:
    """Phase 13(e): the sharded route with shortlist_k and block_w (W=1:
    a wave width above 1 keeps the wave form) on 1- and 4-shard meshes of
    cuda:0 against the single-device shortlist solve (the class rows and
    exceptions of two `shortlist_case` fixtures, 8192 nodes, 256 pods,
    K=64, block width 128), each timed at 4 shards against the sharded
    serial route (no shortlist) and the wave route (W=32, the wave_eval
    kernels) on the same inputs."""
    from kubernetes_tpu_torch.parallel import build_mesh, sharded

    t0 = time.perf_counter()
    for kind in ("tight", "uniform"):
        case = shortlist_case(kind, 90, 8192, 256, 128)
        arrays, class_req, rows, exc, _, _ = case
        single = run_shortlist(torch, case, "LeastAllocated", 64, 128, 32,
                               dev)["identity"][0]

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        args = [float(arrays[k]) if k in ("w_fit", "w_bal")
                else put(arrays[k]) for k in SOLVE_ORDER]
        kw = dict(rows=put(rows), exc=put(exc), row_req_q=put(class_req),
                  row_req_nz_q=put(class_req))
        for shards in (1, 4):
            mesh = build_mesh(shards)
            routes = {"shortlist": dict(shortlist_k=64, block_w=128),
                      "serial": {}, "wave W=32": dict(wave_w=32)}
            walls = {}
            for name, opt in routes.items():
                def solve():
                    return sharded.sharded_greedy_assign(
                        mesh, *args, "LeastAllocated", **kw, **opt)
                got = solve().cpu().numpy()
                if not np.array_equal(got, single):
                    raise RuntimeError(f"the sharded {name} route differs "
                                       f"on {kind} at {shards} shard(s)")
                if shards == 4:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    solve()
                    torch.cuda.synchronize()
                    walls[name] = time.perf_counter() - t1
            print(f"compare sharded shortlist route, {kind}, {shards} "
                  f"shard(s) of cuda:0 (K=64, block width 128): identical "
                  f"to the single-device shortlist solve, as are the serial "
                  f"and W=32 wave routes; placed {int((got >= 0).sum())}"
                  + ("; wall per 256-pod solve " + ", ".join(
                      f"{name} {s:.6f} s" for name, s in walls.items())
                     if walls else ""))
    print(f"phase 13(e) {time.perf_counter() - t0:.1f} s")


# -- phase 14: device topology ----------------------------------------------

TPU = "google.com/tpu"
#: Phase 14(a)'s chunk kinds (see `device_case`), cluster size and chunk.
DEVICE_KINDS = ("nrt", "dra", "ports")
N_DEVICE_NODES, DEVICE_CHUNK = 64, 128


class StaticInformers:
    """A stand-in for an InformerFactory in direct `assign` calls: each
    informer's indexer holds the given objects, and a handler added to it
    sees every object once through its on_add, as a synced informer's
    would."""

    def __init__(self, objects: dict):
        self._informers = {r: _StaticInformer(objs)
                           for r, objs in objects.items()}

    def informer(self, resource: str) -> "_StaticInformer":
        return self._informers.setdefault(resource, _StaticInformer([]))


class _StaticInformer:
    def __init__(self, objects: list):
        self.indexer = self
        self._objects = {}
        for obj in objects:
            meta = obj["metadata"]
            ns = meta.get("namespace")
            key = f"{ns}/{meta['name']}" if ns else meta["name"]
            self._objects[key] = obj

    def get(self, key: str):
        return self._objects.get(key)

    def list(self) -> list:
        return list(self._objects.values())

    def add_event_handler(self, handler) -> None:
        if handler.on_add is not None:
            for obj in list(self._objects.values()):
                handler.on_add(obj)


def _nrt_case(rng) -> dict:
    """64 nodes in eight shapes (i % 8): 0-3 equal nodes (cpu 16, 8
    TPUs, two zones of cpu 8 / 4 TPUs) for ties; 4 three zones of 3 TPUs;
    5 an NRT whose policy is not single-NUMA; 6 no NRT; 7 four zones of 2
    TPUs, where 3 TPUs fit the node but no zone. Residents (seeded) fill
    zones first-fit. Pods: zone-fitting (cpu 2, 2 TPUs), zone-misaligned
    (3 TPUs), cpu-heavy (cpu 5, 1 TPU: three fit a node, one a zone, so
    the verify rejects), cpu-only (zone-tracked cpu) and memory-only
    (node-level only)."""
    from kubernetes_tpu_torch.api.types import (make_node,
                                                make_node_resource_topology,
                                                make_pod, split_node_topology)

    nodes, residents, nrts = [], [], []
    for i in range(N_DEVICE_NODES):
        name, shape = f"dn-{i}", i % 8
        alloc = {"cpu": "16", "memory": "64Gi", "pods": "110", TPU: "8"}
        nodes.append(make_node(name, allocatable=alloc))
        if shape <= 3:
            nrts.append(split_node_topology(name, alloc, 2,
                                            devices={TPU: 4}))
        elif shape == 4:
            nrts.append(split_node_topology(name, alloc, 3,
                                            devices={TPU: 3}))
        elif shape == 5:
            nrt = split_node_topology(name, alloc, 2, devices={TPU: 4})
            nrts.append(make_node_resource_topology(
                name, nrt["zones"], policies=["BestEffort"]))
        elif shape == 7:
            nrts.append(split_node_topology(name, alloc, 4,
                                            devices={TPU: 2}))
        for k in range(int(rng.integers(0, 3))):
            residents.append(make_pod(
                f"res-{i}-{k}", node_name=name, requests={
                    "cpu": str(int(rng.choice([1, 2, 3]))),
                    "memory": "1Gi", TPU: str(int(rng.choice([1, 2, 3])))}))
    shapes = {"fit": {"cpu": "2", "memory": "1Gi", TPU: "2"},
              "misaligned": {"cpu": "2", "memory": "1Gi", TPU: "3"},
              "cpu-heavy": {"cpu": "5", "memory": "1Gi", TPU: "1"},
              "cpu-only": {"cpu": "3", "memory": "1Gi"},
              "memory-only": {"memory": "2Gi"}}
    kinds = rng.choice(list(shapes), size=112, p=[0.4, 0.15, 0.25, 0.1,
                                                   0.1])
    pods = [make_pod(f"nrt-{j}-{k}", requests=dict(shapes[k]))
            for j, k in enumerate(kinds)]
    from kubernetes_tpu_torch.perf.scheduler_perf import DEVICE_TOPOLOGY
    return {"nodes": nodes, "residents": residents, "pods": pods,
            "objects": {"noderesourcetopologies": nrts},
            "config": DEVICE_TOPOLOGY["schedulerConfig"]}


def _dra_devices(zones: tuple, kind: str = "tpu", prefix: str = "dev"):
    return [{"name": f"{prefix}-{z}-{k}",
             "attributes": {"type": kind, "numa": str(z)}}
            for z, n in enumerate(zones) for k in range(n)]


def _dra_case(rng) -> dict:
    """64 nodes (cpu 16) in eight slice shapes (i % 8): 0-3 eight TPUs, 4
    per NUMA zone (equal nodes); 4 three and five; 5 four TPUs and two
    GPUs; 6 no slice; 7 two and two. Residents hold claims, allocated (in
    the ledger) or not (charged from their demand). Pending pods (cpu 2)
    each reference one claim: 2 TPUs on one `numa` (the counts' row); 3
    TPUs unconstrained; two requests (1 + 2 TPUs) under one `numa`
    constraint (the plugin's own row); 1 GPU; 4 TPUs on one `numa` (two
    fit a node, eight by cpu, so the verify rejects); and claims already
    allocated on a node (pinned)."""
    from kubernetes_tpu_torch.api.types import (make_device_class,
                                                make_node, make_pod,
                                                make_resource_claim,
                                                make_resource_slice)

    numa = [{"matchAttribute": "numa"}]
    shapes = [(4, 4)] * 4 + [(3, 5), (4,), None, (2, 2)]
    nodes, residents, slices, claims = [], [], [], []
    for i in range(N_DEVICE_NODES):
        name, zones = f"dn-{i}", shapes[i % 8]
        nodes.append(make_node(name, allocatable={
            "cpu": "16", "memory": "64Gi", "pods": "110"}))
        if zones is None:
            continue
        devices = _dra_devices(zones)
        if i % 8 == 5:
            devices += _dra_devices((2,), "gpu", "gpu")
        slices.append(make_resource_slice(name, "dra.ktpu", devices))
        held = int(rng.integers(0, 3))
        for k in range(held):
            c = make_resource_claim(f"res-{i}-{k}", requests=[
                {"name": "tpus", "deviceClassName": "tpu", "count": 1}])
            if rng.random() < 0.5:
                c["status"] = {"allocation": {
                    "nodeName": name, "devices": [devices[-1 - k]["name"]]}}
            claims.append(c)
            residents.append(make_pod(
                f"res-{i}-{k}", node_name=name,
                requests={"cpu": "1", "memory": "1Gi"},
                resource_claims=[{"name": "c0",
                                  "resourceClaimName": f"res-{i}-{k}"}]))
    kinds = {"aligned": ([{"name": "tpus", "deviceClassName": "tpu",
                           "count": 2}], numa),
             "loose": ([{"name": "tpus", "deviceClassName": "tpu",
                         "count": 3}], []),
             "two-requests": ([{"name": "a", "deviceClassName": "tpu",
                                "count": 1},
                               {"name": "b", "deviceClassName": "tpu",
                                "count": 2}], numa),
             "gpu": ([{"name": "g", "deviceClassName": "gpu",
                       "count": 1}], []),
             "wide": ([{"name": "tpus", "deviceClassName": "tpu",
                        "count": 4}], numa)}
    picks = rng.choice(list(kinds), size=104, p=[0.35, 0.15, 0.15, 0.1,
                                                 0.25])
    pods = []
    for j, k in enumerate(picks):
        reqs, cons = kinds[k]
        claims.append(make_resource_claim(f"dra-{j}-c0", requests=reqs,
                                          constraints=cons))
        pods.append(make_pod(f"dra-{j}", requests={"cpu": "2",
                                                   "memory": "1Gi"},
                             resource_claims=[{"name": "c0",
                                               "resourceClaimName":
                                                   f"dra-{j}-c0"}]))
    for j in range(8):
        node = f"dn-{8 * j + 1}"
        c = make_resource_claim(f"pinned-{j}-c0", requests=[
            {"name": "tpus", "deviceClassName": "tpu", "count": 1}])
        c["status"] = {"allocation": {"nodeName": node,
                                      "devices": ["dev-1-0"]}}
        claims.append(c)
        pods.append(make_pod(f"pinned-{j}", requests={"cpu": "2",
                                                      "memory": "1Gi"},
                             resource_claims=[{"name": "c0",
                                               "resourceClaimName":
                                                   f"pinned-{j}-c0"}]))
    classes = [make_device_class("tpu", {"type": "tpu"}),
               make_device_class("gpu", {"type": "gpu"})]
    return {"nodes": nodes, "residents": residents, "pods": pods,
            "objects": {"resourceslices": slices, "deviceclasses": classes,
                        "resourceclaims": claims},
            "config": None}


def _ports_case(rng) -> dict:
    """16 equal nodes; residents hold 8080/TCP on 0.0.0.0 (nodes 0-3) and
    9090/TCP on 10.0.0.1 (nodes 4-5). Pods: 8080/TCP (conflicts on 0-3),
    8080/UDP (no conflict), 9090 on 0.0.0.0 (conflicts with 10.0.0.1),
    9090 on 10.0.0.2 (none), 7070 wanted by more pods than nodes (only
    the verify sees the same-chunk conflicts), and plain pods."""
    from kubernetes_tpu_torch.api.types import make_node, make_pod

    def pod(name, ports, node_name=None):
        p = make_pod(name, node_name=node_name,
                     requests={"cpu": "500m", "memory": "1Gi"})
        if ports:
            p["spec"]["containers"][0]["ports"] = [
                {"hostPort": port, "protocol": proto, "hostIP": ip}
                for port, proto, ip in ports]
        return p

    nodes = [make_node(f"dn-{i}", allocatable={
        "cpu": "8", "memory": "32Gi", "pods": "110"}) for i in range(16)]
    residents = [pod(f"res-{i}", [(8080, "TCP", "0.0.0.0")], f"dn-{i}")
                 for i in range(4)]
    residents += [pod(f"res-{i}", [(9090, "TCP", "10.0.0.1")], f"dn-{i}")
                  for i in (4, 5)]
    shapes = {"tcp-8080": [(8080, "TCP", "0.0.0.0")],
              "udp-8080": [(8080, "UDP", "0.0.0.0")],
              "any-9090": [(9090, "TCP", "0.0.0.0")],
              "ip-9090": [(9090, "TCP", "10.0.0.2")],
              "7070": [(7070, "TCP", "0.0.0.0")],
              "plain": []}
    kinds = rng.choice(list(shapes), size=96, p=[0.15, 0.1, 0.1, 0.1, 0.25,
                                                 0.3])
    pods = [pod(f"port-{j}-{k}", shapes[k]) for j, k in enumerate(kinds)]
    return {"nodes": nodes, "residents": residents, "pods": pods,
            "objects": {}, "config": None}


def device_case(kind: str, seed: int) -> dict:
    """Phase 14(a)'s `kind` chunk ("nrt", "dra" or "ports"), seeded with
    numpy: {"nodes", "residents" (pods with spec.nodeName), "pods" (one
    chunk), "objects" ({resource: objects} the plugins' informers hold),
    "config" (a KubeSchedulerConfiguration, or None for the default
    profile)}, every object a wire dict that either package reads."""
    rng = np.random.default_rng(seed)
    return {"nrt": _nrt_case, "dra": _dra_case,
            "ports": _ports_case}[kind](rng)


def device_framework(config_mod, case: dict):
    """The case's profile as a Framework of `config_mod`'s package, with
    NodeResourceTopologyMatch's and DynamicResources' informers a
    `StaticInformers` over the case's objects."""
    cfg = config_mod.load_config(case["config"])
    fwk = cfg.profiles[0].build_framework()
    informers = StaticInformers(copy.deepcopy(case["objects"]))
    for p in fwk.plugins:
        if p.NAME in ("NodeResourceTopologyMatch", "DynamicResources"):
            p.set_informers(informers)
    return fwk


def device_chunk(api, backend, kind: str, seed: int, mode: str):
    """Phase 14(a)'s `kind` chunk through `backend` (its metrics attached)
    under KTPU_SOLVE_MODE `mode`; `api` holds the package's `types`,
    `config`, `SchedulerMetrics` and `run_chunks(backend, pods, snapshot,
    fwk)` (an assign() that returns its context). Returns (context,
    metrics)."""
    from kubernetes_tpu_torch.utils import flags

    case = device_case(kind, seed)
    fwk = device_framework(api.config, case)
    infos = {n["metadata"]["name"]: api.types.NodeInfo(copy.deepcopy(n))
             for n in case["nodes"]}
    for p in case["residents"]:
        infos[p["spec"]["nodeName"]].add_pod(
            api.types.PodInfo(copy.deepcopy(p)))
    snap = api.types.Snapshot(list(infos.values()), 1)
    pods = [api.types.PodInfo(copy.deepcopy(p)) for p in case["pods"]]
    backend.metrics = api.SchedulerMetrics()
    with flags.scoped_set("KTPU_SOLVE_MODE", mode):
        ctx = api.run_chunks(backend, pods, snap, fwk)
    return ctx, backend.metrics


def _port_run_chunks(backend, pods, snapshot, fwk):
    backend._check_supported(pods, fwk)
    ctx = backend._start(pods, snapshot, fwk)
    backend._run_chunks(ctx)
    return ctx


def port_device_api():
    """`device_chunk`'s `api` for this package."""
    from types import SimpleNamespace

    from kubernetes_tpu_torch import config
    from kubernetes_tpu_torch.metrics.registry import SchedulerMetrics
    from kubernetes_tpu_torch.scheduler import types

    return SimpleNamespace(types=types, config=config,
                           SchedulerMetrics=SchedulerMetrics,
                           run_chunks=_port_run_chunks)


def device_chunk_view(ctx, metrics) -> dict:
    """What phase 14(a) and the tests compare: `gang_chunk_view`'s
    assignments, diagnostics and solver metrics, and the host-fallback
    degradations (pods that took a plugin's own host row)."""
    view = gang_chunk_view(ctx, metrics)
    view["host_fallback"] = metrics.backend_degradations.value(
        kind="host_fallback")
    return view


def zone_violations(nodes, pods, nrts) -> list[str]:
    """Nodes whose bound pods, re-packed first-fit with the port's
    `pack_zones`, leave a pod's zone-tracked request (its TPUs among them)
    in no single zone, or a zone over its capacity."""
    from kubernetes_tpu_torch.scheduler.plugins.noderesourcetopology import (
        _zone_caps, pack_zones)
    from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo

    infos = {n["metadata"]["name"]: NodeInfo(n) for n in nodes}
    for p in pods:
        node = (p.get("spec") or {}).get("nodeName")
        if node:
            infos[node].add_pod(PodInfo(p))
    nrt_of = {n["metadata"]["name"]: n for n in nrts}
    bad = []
    for name, ni in infos.items():
        nrt = nrt_of.get(name)
        if nrt is None or not ni.pods:
            continue
        caps = [c for _, c in _zone_caps(nrt)]
        free = pack_zones(nrt, ni)
        tracked = {r for c in caps for r in c}
        charged = sum(c[r] - f[r] for c, f in zip(caps, free) for r in c)
        want = sum(v for pi in ni.pods for r, v in pi.requests.items()
                   if v > 0 and r in tracked)
        if charged != want or any(v < 0 for f in free for v in f.values()):
            bad.append(name)
    return bad


def claim_violations(pods, claims, slices) -> tuple[list[str], int]:
    """(faults, devices in use) of a DRA run read back from its store:
    every bound pod's claims allocated on its node, each claim's devices
    on one `numa` of that node's slices, no (node, device) pair allocated
    twice."""
    numa = {}
    for s in slices:
        node = s["spec"]["nodeName"]
        for d in s["spec"]["devices"]:
            numa[(node, d["name"])] = (d.get("attributes") or {}).get("numa")
    by_key = {f"{c['metadata'].get('namespace', 'default')}/"
              f"{c['metadata']['name']}": c for c in claims}
    faults, used = [], set()
    in_use = 0
    for p in pods:
        node = (p.get("spec") or {}).get("nodeName")
        ns = p["metadata"].get("namespace", "default")
        for ref in (p.get("spec") or {}).get("resourceClaims") or []:
            key = f"{ns}/{ref['resourceClaimName']}"
            alloc = ((by_key.get(key) or {}).get("status") or {}) \
                .get("allocation") or {}
            if node is None:
                if alloc:
                    faults.append(f"{key} allocated to an unbound pod")
                continue
            if alloc.get("nodeName") != node:
                faults.append(f"{key} on {alloc.get('nodeName')}, pod on "
                              f"{node}")
                continue
            devs = alloc.get("devices") or []
            zones = {numa.get((node, d)) for d in devs}
            if len(zones) != 1 or None in zones:
                faults.append(f"{key} spans numa {sorted(map(str, zones))}")
            for d in devs:
                if (node, d) in used:
                    faults.append(f"{node}/{d} allocated twice")
                used.add((node, d))
            in_use += len(devs)
    return faults, in_use


def device_chunks_phase(torch, seed: int) -> int:
    """Phase 14(a): each `device_case` chunk through `TorchBackend()` on
    the card and `TorchBackend(device="cpu")`, flagless and with greedy
    pinned: identical assignments, diagnostics, solver metrics,
    host-fallback counts and backend counters. Returns wave_solve's
    launches."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    t0 = time.perf_counter()
    api = port_device_api()
    launches = 0
    for kind in DEVICE_KINDS:
        for mode in ("auto", "greedy"):
            wave_kernel.wave_solve.launches = 0
            on_card = TorchBackend(max_batch=DEVICE_CHUNK)
            card = device_chunk_view(*device_chunk(api, on_card, kind, seed,
                                                   mode))
            launches += wave_kernel.wave_solve.launches
            on_cpu = TorchBackend(device="cpu", max_batch=DEVICE_CHUNK)
            cpu = device_chunk_view(*device_chunk(api, on_cpu, kind, seed,
                                                  mode))
            same = card == cpu and on_card.counters == on_cpu.counters
            placed = sum(v is not None for v in card["assignments"].values())
            print(f"compare device chunk {kind} ({len(card['assignments'])} "
                  f"pods on {N_DEVICE_NODES if kind != 'ports' else 16} "
                  f"nodes, KTPU_SOLVE_MODE={mode}), card vs CPU: "
                  f"{'identical' if same else 'DIFFER'}; placed {placed}, "
                  f"verify rejects {on_card.counters['verify_rejects']}, "
                  f"optimal solves {on_card.counters['optimal_solves']}, "
                  f"host_fallback {card['host_fallback']}")
            if not same:
                raise RuntimeError(f"device chunk {kind} ({mode}) differs "
                                   f"on the card from the CPU")
    if launches == 0:
        raise RuntimeError("phase 14(a): no wave_solve launch")
    print(f"phase 14(a) {time.perf_counter() - t0:.1f} s, wave_solve "
          f"launches {launches}")
    return launches


def device_loop_phase(torch, family: dict, phase: str) -> int:
    """Phase 14(b) (DeviceTopology) or 14(c) (DeviceTopologyDRA) at
    1000Nodes through the port's PerfRunner, `TorchBackend()` and the
    family's own profile: every pod bound; the store's pods re-packed into
    their nodes' zones (14(b)) or their claims' allocations checked
    (14(c)); printed as 9(b) (the profiled repeat at 100Nodes), with the
    optimal and greedy dispatches. Returns wave_solve's launches in the
    measured window."""
    t0 = time.perf_counter()
    label = f"device topology {phase}"
    first = perf_run(torch, family, "1000Nodes", None)
    runner, result, _, pods = first
    store, w = runner.store, runner.window
    nodes = asyncio.run(store.list("nodes")).items
    if "schedulerConfig" in family:
        nrts = asyncio.run(store.list("noderesourcetopologies")).items
        bad = zone_violations(nodes, pods, nrts)
        if bad or result.unschedulable_total:
            raise RuntimeError(f"{phase}: zones over capacity on {bad[:5]}, "
                               f"{result.unschedulable_total} unschedulable "
                               "attempts")
        check = (f"every pod re-packed into one zone on {len(nrts)} nodes, "
                 f"no zone over capacity")
    else:
        claims = asyncio.run(store.list("resourceclaims")).items
        slices = asyncio.run(store.list("resourceslices")).items
        faults, in_use = claim_violations(pods, claims, slices)
        if faults or in_use != 2 * len(pods):
            raise RuntimeError(f"{phase}: {in_use} devices in use for "
                               f"{len(pods)} pods; {faults[:5]}")
        check = (f"{len(claims)} claims each allocated on its pod's node "
                 f"on one numa, {in_use} devices in use, none twice")
    if w["launches"] == 0:
        raise RuntimeError(f"{phase}: no wave_solve launch in the measured "
                           f"window")
    c = w["counters"]
    print(f"{label} {family['name']}/1000Nodes: {check}; dispatches over "
          f"the measured window: optimal {c['optimal_solves']}, greedy "
          f"{c['chunks'] - c['optimal_solves'] - c['spread_chunks']}, "
          f"verify rejects {c['verify_rejects']}; wave_solve launches "
          f"{w['launches']}")
    report_perf(torch, label, family, "1000Nodes", first, phase, t0,
                device_workload="100Nodes",
                device_profile=family["name"] != "DeviceTopologyDRA")
    return w["launches"]


def device_topology_run(torch, seed: int) -> dict:
    """Phase 14 (see the module docstring), under a scoped
    KTPU_SOLVE_MODE=auto with serving on. Returns the kernels line's phase
    14 entries: wave_solve's launches in 14(a) and in the measured windows
    of 14(b) and 14(c)."""
    from kubernetes_tpu_torch.perf.scheduler_perf import (
        DEVICE_TOPOLOGY, DEVICE_TOPOLOGY_DRA)
    from kubernetes_tpu_torch.utils import flags

    t14 = time.perf_counter()
    print(f"phase 14 on {card_line()}")
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        out = {"device_chunk_launches": device_chunks_phase(torch, seed)}
        out["device_topology_launches"] = device_loop_phase(
            torch, DEVICE_TOPOLOGY, "14(b)")
        out["device_topology_dra_launches"] = device_loop_phase(
            torch, DEVICE_TOPOLOGY_DRA, "14(c)")
    print(f"phase 14 {time.perf_counter() - t14:.1f} s")
    return out


def device_topology_phases(torch, seed: int) -> int:
    """`--phase14-only`: build the kernels (phase 1), then phase 14."""
    from kubernetes_tpu_torch.ops import wave_kernel

    t0 = time.perf_counter()
    lib = wave_kernel.LIBRARY.build()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib.path.name})")
    print(json.dumps(device_topology_run(torch, seed)))
    print_card()
    return 0


# -- phase 15: the chunk stream and the volume plugins -----------------------

def drain_stream(backend, pods, snapshot, fwk) -> tuple[list, object]:
    """Drain `backend.assign_stream` in a fresh event loop: per yield, the
    chunk's pod keys and the accumulated assignments and diagnostics
    (`diagnostics_view`) at that yield; and the last context (None for no
    pods)."""
    async def drain():
        seen, last = [], None
        async for chunk_pods, ctx in backend.assign_stream(pods, snapshot,
                                                           fwk):
            seen.append(([pi.key for pi in chunk_pods],
                         dict(ctx.assignments),
                         diagnostics_view(ctx.diagnostics)))
            last = ctx
        return seen, last
    return asyncio.run(drain())


def finalize_order(backend, pods, snapshot, fwk) -> tuple[list, dict, dict]:
    """`backend.assign` with each chunk's pod keys recorded in finalize
    order: (the order, assignments, diagnostics)."""
    order = []
    fin = backend._finalize_chunk

    def recorded(run, assign_np, ctx):
        order.append([pi.key for pi in run["pods"]])
        return fin(run, assign_np, ctx)

    backend._finalize_chunk = recorded
    try:
        assignments, diagnostics = backend.assign(pods, snapshot, fwk)
    finally:
        del backend._finalize_chunk
    return order, assignments, diagnostics


def stream_case(kind: str) -> tuple[list, list, int]:
    """Phase 15(a)'s small chunks, as (node dicts, pod dicts, max_batch):
    "storm", 48 nodes of 2 CPUs under 256 pods of 300m-900m (waves that
    conflict, and more CPU asked than the nodes hold); "failures", 200
    nodes and 512 pods of which one in eight asks 64 CPUs or a zone no
    node has."""
    from kubernetes_tpu_torch.api.types import make_node, make_pod

    if kind == "storm":
        nodes = [make_node(f"storm-{i}", allocatable={
            "cpu": "2", "memory": "8Gi", "pods": "16"}) for i in range(48)]
        pods = [make_pod(f"storm-{j}", requests={
            "cpu": f"{300 + 100 * (j % 7)}m", "memory": "256Mi"})
            for j in range(256)]
        return nodes, pods, 128
    nodes = [make_node(f"fail-{i}", labels={ZONE_KEY: ZONES[i % 3]})
             for i in range(200)]
    pods = []
    for j in range(512):
        kw = {"requests": dict(POD_REQUESTS)}
        if j % 16 == 3:
            kw["requests"] = {"cpu": "64", "memory": "250Mi"}
        elif j % 16 == 11:
            kw["node_selector"] = {ZONE_KEY: "zone-x"}
        pods.append(make_pod(f"fail-{j}", **kw))
    return nodes, pods, 128


def compare_stream(torch, label: str, make_snapshot, pods, fwk,
                   max_batch: int, mode: str, need: str) -> dict:
    """One 15(a) case under KTPU_SOLVE_MODE `mode`: `assign` on the card
    (finalize order recorded), `assign_stream` on the card and `assign` on
    the CPU, each on a fresh backend and snapshot. Assignments,
    diagnostics, counters and solver metrics must be identical, the
    stream's chunk order the finalize order, each yielded chunk's keys
    final, and `need` ("replays", "failures" or "") must show. Returns
    the card's counters."""
    from kubernetes_tpu_torch.metrics.registry import SchedulerMetrics
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.utils import flags

    def fresh(device):
        b = TorchBackend(device=device, max_batch=max_batch)
        b.metrics = SchedulerMetrics()
        return b

    def metrics_view(b):
        return {m: getattr(b.metrics, m).value() for m in GANG_METRICS}

    with flags.scoped_set("KTPU_SOLVE_MODE", mode):
        a = fresh(None)
        order, assign_a, diag_a = finalize_order(a, pods, make_snapshot(),
                                                 fwk)
        s = fresh(None)
        seen, ctx = drain_stream(s, pods, make_snapshot(), fwk)
        c = fresh("cpu")
        assign_c, diag_c = c.assign(pods, make_snapshot(), fwk)
    diag_a = diagnostics_view(diag_a)
    checks = {
        "stream assignments": dict(ctx.assignments) == assign_a,
        "stream diagnostics": diagnostics_view(ctx.diagnostics) == diag_a,
        "stream counters": s.counters == a.counters
        and metrics_view(s) == metrics_view(a),
        "chunk order": [keys for keys, _, _ in seen] == order,
        "chunk keys final": all(
            acc.get(k) == assign_a[k] for keys, acc, _ in seen
            for k in keys),
        "card vs CPU": assign_c == assign_a
        and diagnostics_view(diag_c) == diag_a and c.counters == a.counters
        and metrics_view(c) == metrics_view(a),
    }
    failed = sum(v is None for v in assign_a.values())
    shown = {"replays": a.counters["wave_replays"] > 0,
             "failures": failed > 0, "": True}[need]
    print(f"compare chunk stream {label} (KTPU_SOLVE_MODE={mode}, "
          f"{len(pods)} pods in {len(order)} chunks of {max_batch}): "
          + ", ".join(f"{k} {'identical' if v else 'DIFFER'}"
                      for k, v in checks.items())
          + f"; unplaced {failed}, counters {json.dumps(a.counters)}")
    if not all(checks.values()) or not shown:
        raise RuntimeError(f"15(a) {label} ({mode}): {checks}, {need} "
                           f"shown {shown}")
    return a.counters


def stream_chunks_phase(torch) -> None:
    """Phase 15(a): SchedulingBasic/5000Nodes' first measured 1024-pod
    chunk after its 1000 init pods flagless, and its first three greedy, the
    storm chunk and the failures chunk, through `assign` and
    `assign_stream` on the card and `assign` on the CPU
    (`compare_stream`)."""
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.scheduler.framework import Framework
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        DEFAULT_SCORE_WEIGHTS, build_plugins)
    from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo
    from kubernetes_tpu_torch.utils import flags

    t0 = time.perf_counter()
    fwk = Framework(build_plugins(), DEFAULT_SCORE_WEIGHTS)
    init = [PodInfo(make_pod(f"init-{i}", requests=POD_REQUESTS))
            for i in range(N_INIT)]
    with flags.scoped_set("KTPU_SOLVE_MODE", "greedy"):
        placed, _ = TorchBackend().assign(init, stamped_snapshot(
            [NodeInfo(make_node(f"node-{i}")) for i in range(N_NODES)], 1),
            fwk)
    gen = [1]

    def basic_snapshot():
        nodes = [NodeInfo(make_node(f"node-{i}")) for i in range(N_NODES)]
        by_name = {ni.name: ni for ni in nodes}
        for pi in init:
            by_name[placed[pi.key]].add_pod(pi)
        gen[0] += 1
        return stamped_snapshot(nodes, gen[0])

    measured = [PodInfo(make_pod(f"pod-{i}", requests=POD_REQUESTS))
                for i in range(3 * 1024)]
    # Flagless, the first measured chunk alone: the CPU's plain W=1
    # rounding takes seconds a chunk.
    for mode, chunks, what in (("auto", 1, "first measured chunk"),
                               ("greedy", 3, "first three measured chunks")):
        compare_stream(torch, f"SchedulingBasic/5000Nodes {what}",
                       basic_snapshot, measured[:chunks * 1024], fwk, 1024,
                       mode, "")
    for kind, need, modes in (("storm", "replays", ("greedy",)),
                              ("failures", "failures", ("auto", "greedy"))):
        nodes, pods, batch = stream_case(kind)

        def snapshot(nodes=nodes):
            gen[0] += 1
            return stamped_snapshot([NodeInfo(copy.deepcopy(n))
                                     for n in nodes], gen[0])

        for mode in modes:
            compare_stream(torch, kind, snapshot,
                           [PodInfo(copy.deepcopy(p)) for p in pods], fwk,
                           batch, mode, need)
    print(f"phase 15(a) {time.perf_counter() - t0:.1f} s")


def stream_loop_phase(torch) -> None:
    """Phase 15(b): SchedulingBasic/5000Nodes through the loop, in one
    process: through the chunk stream and through `AssignOnly` (the
    backend's `assign` alone), each under torch.profiler for the idle
    share. Prints each run's throughput, `assign` share, idle share and the
    binds that began before their dispatch's last chunk fetch returned."""
    from kubernetes_tpu_torch.perf.scheduler_perf import SCHEDULING_BASIC

    t0 = time.perf_counter()
    for entry, profile in (("stream", "device"), ("assign", "device")):
        wrap = AssignOnly if entry == "assign" else None
        runner, result, _, _ = perf_run(torch, SCHEDULING_BASIC, "5000Nodes",
                                        profile, wrap=wrap)
        w = runner.window
        idle = None
        if profile == "device":
            busy = sum(device_us(e) for e in runner.prof.key_averages())
            idle = 1 - busy / 1e6 / w["wall"] if busy else None
        routes = w["routes"]
        if entry == "assign" and routes["early_binds"]:
            raise RuntimeError(f"15(b): {routes['early_binds']} early binds "
                               "through assign alone")
        print(f"chunk stream 15(b) SchedulingBasic/5000Nodes through "
              f"{'the stream' if entry == 'stream' else 'assign alone'}"
              f"{' (profiled)' if profile else ''}: SchedulingThroughput "
              f"{result.throughput:.2f} pods/s, window wall "
              f"{w['wall']:.6f} s, assign share "
              f"{w['timings']['assign_s'] / w['wall']:.4f} "
              f"(TorchBackend.timings {json.dumps(w['timings'])}), idle share "
              f"{'not measured' if idle is None else f'{idle:.4f}'}; backend "
              f"dispatches {routes['backend_dispatches']} with "
              f"{routes['backend_pods']} pods, chunks "
              f"{w['counters']['chunks']}, binds begun before their "
              f"dispatch's last chunk fetch returned {routes['early_binds']}")
    print(f"phase 15(b) {time.perf_counter() - t0:.1f} s")


async def precreated_loop(api, backend, n_nodes: int, n_pods: int,
                          routes: dict) -> dict:
    """`n_pods` of SchedulingBasic's pod template queued on `n_nodes`
    nodes before `Scheduler.run` opens the loop (one pop, one dispatch of
    many chunks), `routes` counting the backend's dispatches
    (`count_backend_routes`). Returns the wall from the loop's start to
    the last bind an informer sees, and the backend's `timings` over it."""
    lr = LoopRun(api, backend, LOOP_BATCH)
    await lr.start([(f"node-{i}", {}) for i in range(n_nodes)])
    try:
        count_backend_routes(lr.sched, routes)
        bound: set = set()

        def track(obj):
            if (obj.get("spec") or {}).get("nodeName"):
                bound.add(obj["metadata"]["name"])

        lr.factory.informer("pods").add_event_handler(
            api.ResourceEventHandler(
                on_add=track, on_update=lambda old, new: track(new)))
        pods = [api.make_pod(f"pod-{i}", requests=dict(POD_REQUESTS))
                for i in range(n_pods)]
        for lo in range(0, n_pods, 512):
            await asyncio.gather(*(lr.store.create("pods", p)
                                   for p in pods[lo:lo + 512]))
        await lr.wait(lambda: lr.queued() == n_pods, "pods queued")
        before = dict(backend.timings)
        t0 = time.perf_counter()
        lr.open()
        await lr.wait(lambda: len(bound) == n_pods, "pods bound")
        wall = time.perf_counter() - t0
        return {"wall": wall, "timings": {
            k: v - before[k] for k, v in backend.timings.items()}}
    finally:
        await lr.close()


def precreated_stream_phase(torch) -> None:
    """Phase 15(b), pre-created: SchedulingBasic/5000Nodes' 11000 pods
    queued before the loop starts, so one dispatch streams 11 chunks,
    through the stream, then through `AssignOnly` (two runs, not four in
    turns: cut to keep the smoke inside its time). Prints each run's wall, pods/s, `assign`
    share and the binds begun before the dispatch's last chunk fetch
    returned, which must be above 0 through the stream."""
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    api = port_loop_api()
    n_pods = N_INIT + N_MEASURED
    for entry in ("stream", "assign"):
        backend = TorchBackend()
        routes = dict.fromkeys(("backend_dispatches", "backend_pods",
                                "early_binds"), 0)
        out = asyncio.run(precreated_loop(
            api, backend if entry == "stream" else AssignOnly(backend),
            N_NODES, n_pods, routes))
        tm = out["timings"]
        print(f"chunk stream 15(b) pre-created, {n_pods} pods on {N_NODES} "
              f"nodes through "
              f"{'the stream' if entry == 'stream' else 'assign alone'}: "
              f"{n_pods / out['wall']:.2f} pods/s, wall {out['wall']:.6f} s, "
              f"assign share {tm['assign_s'] / out['wall']:.4f} "
              f"(TorchBackend.timings "
              f"{json.dumps({k: round(v, 6) for k, v in tm.items()})}); "
              f"backend dispatches {routes['backend_dispatches']} with "
              f"{routes['backend_pods']} pods, binds begun before their "
              f"dispatch's last chunk fetch returned {routes['early_binds']}")
        if (entry == "stream") != (routes["early_binds"] > 0):
            raise RuntimeError(f"15(b) pre-created through {entry}: "
                               f"{routes['early_binds']} early binds")


# -- the volume fixtures (15(c), 15(d), tests/test_torch_volumes.py) ---------

#: StorageClasses of the volume fixtures: a pre-provisioned class (no
#: dynamic provisioning, Immediate binding), a local class (no
#: provisioning, WaitForFirstConsumer) and a provisioning
#: WaitForFirstConsumer class.
STATIC_CLASS, LOCAL_CLASS, WFFC_CLASS = "zonal-static", "local", "wffc"
NO_PROVISIONER = "kubernetes.io/no-provisioner"
VOLUME_PLUGINS = ("VolumeBinding", "VolumeRestrictions", "VolumeZone",
                  "NodeVolumeLimits")
N_VOLUME_NODES, VOLUME_CHUNK = 200, 128


def volume_classes(make_storage_class) -> list:
    return [make_storage_class(STATIC_CLASS, provisioner=NO_PROVISIONER),
            make_storage_class(LOCAL_CLASS, provisioner=NO_PROVISIONER,
                               binding_mode="WaitForFirstConsumer"),
            make_storage_class(WFFC_CLASS,
                               binding_mode="WaitForFirstConsumer")]


def zonal_pv(make_pv, name: str, zone: str, claim: str | None,
             modes=("ReadWriteOnce",)) -> dict:
    """A 10Gi PV of the static class pinned to `zone` by its label and its
    node affinity; bound to `claim` (a default-namespace PVC) when given,
    else Available."""
    pv = make_pv(name, "10Gi", storage_class=STATIC_CLASS,
                 access_modes=list(modes), labels={ZONE_KEY: zone},
                 node_affinity={"nodeSelectorTerms": [{"matchExpressions": [
                     {"key": ZONE_KEY, "operator": "In", "values": [zone]}]}]})
    if claim is not None:
        pv["spec"]["claimRef"] = {"kind": "PersistentVolumeClaim",
                                  "namespace": "default", "name": claim}
        pv["status"]["phase"] = "Bound"
    return pv


def bound_pvc(make_pvc, name: str, volume: str,
              modes=("ReadWriteOnce",)) -> dict:
    """A 5Gi claim of the static class, bound to `volume` in advance."""
    pvc = make_pvc(name, request="5Gi", storage_class=STATIC_CLASS,
                   access_modes=list(modes))
    pvc["spec"]["volumeName"] = volume
    pvc["status"]["phase"] = "Bound"
    return pvc


def with_claim(pod: dict, claim: str) -> dict:
    pod["spec"]["volumes"] = [{"name": "data",
                               "persistentVolumeClaim": {"claimName": claim}}]
    return pod


def volume_case(seed: int, n_nodes: int = N_VOLUME_NODES) -> dict:
    """Phase 15(c)'s chunk, seeded with numpy, in `device_case`'s form:
    `n_nodes` nodes in three zones, every tenth with an
    `attachable-volumes-csi` limit of 1 (every twentieth at it already
    through a resident's ReadWriteOnce claim); pods whose claims are
    pre-bound to zonal PVs, WaitForFirstConsumer claims of the provisioning
    class and of the local class (six local PVs, each pinned to one node),
    pods joining a resident's ReadWriteOnce claim, two pods sharing one
    ReadWriteOncePod claim, an unbound Immediate claim, a missing claim,
    and plain pods."""
    from kubernetes_tpu_torch.api.types import (make_node, make_pod, make_pv,
                                                make_pvc, make_storage_class)

    rng = np.random.default_rng(seed)
    nodes, residents, pvs, pvcs = [], [], [], []
    for i in range(n_nodes):
        alloc = {"cpu": "8", "memory": "32Gi", "pods": "110"}
        if i % 10 == 0:
            alloc["attachable-volumes-csi"] = "1"
        nodes.append(make_node(f"vn-{i}", labels={ZONE_KEY: ZONES[i % 3]},
                               allocatable=alloc))
        if i % 20 == 0:
            claim = f"res-claim-{i}"
            pvs.append(zonal_pv(make_pv, f"pv-{claim}", ZONES[i % 3], claim))
            pvcs.append(bound_pvc(make_pvc, claim, f"pv-{claim}"))
            residents.append(with_claim(make_pod(
                f"res-{i}", node_name=f"vn-{i}",
                requests={"cpu": "500m", "memory": "1Gi"}), claim))
    for k in range(6):
        node = f"vn-{int(rng.integers(0, n_nodes))}"
        pvs.append(make_pv(f"pv-local-{k}", "20Gi", storage_class=LOCAL_CLASS,
                           node_affinity={"nodeSelectorTerms": [{
                               "matchFields": [{"key": "metadata.name",
                                                "operator": "In",
                                                "values": [node]}]}]}))
    pvs.append(zonal_pv(make_pv, "pv-rwop", ZONES[1], "rwop-shared",
                        ("ReadWriteOncePod",)))
    pvcs.append(bound_pvc(make_pvc, "rwop-shared", "pv-rwop",
                          ("ReadWriteOncePod",)))
    pvcs.append(make_pvc("immediate-0", request="5Gi",
                         storage_class=STATIC_CLASS))
    kinds = rng.choice(["zonal", "wffc", "local", "rwo-join", "plain"],
                       size=VOLUME_CHUNK - 4,
                       p=[0.35, 0.25, 0.1, 0.05, 0.25])

    def pod(name):
        return make_pod(name, requests={
            "cpu": f"{250 + 250 * int(rng.integers(0, 4))}m",
            "memory": "1Gi"})

    pods = []
    for j, kind in enumerate(kinds):
        name, claim = f"vp-{j}-{kind}", f"claim-{j}"
        if kind == "zonal":
            zone = ZONES[int(rng.integers(0, 3))]
            pvs.append(zonal_pv(make_pv, f"pv-{claim}", zone, claim))
            pvcs.append(bound_pvc(make_pvc, claim, f"pv-{claim}"))
        elif kind in ("wffc", "local"):
            pvcs.append(make_pvc(claim, request="5Gi", storage_class=(
                WFFC_CLASS if kind == "wffc" else LOCAL_CLASS)))
        elif kind == "rwo-join":
            claim = f"res-claim-{20 * int(rng.integers(0, n_nodes // 20))}"
        else:
            pods.append(pod(name))
            continue
        pods.append(with_claim(pod(name), claim))
    pods.append(with_claim(pod("vp-rwop-a"), "rwop-shared"))
    pods.append(with_claim(pod("vp-rwop-b"), "rwop-shared"))
    pods.append(with_claim(pod("vp-immediate"), "immediate-0"))
    pods.append(with_claim(pod("vp-missing"), "no-such-claim"))
    return {"nodes": nodes, "residents": residents, "pods": pods,
            "objects": {"persistentvolumes": pvs,
                        "persistentvolumeclaims": pvcs,
                        "storageclasses": volume_classes(
                            make_storage_class)}}


def volume_chunk(api, backend, seed: int, mode: str):
    """Phase 15(c)'s chunk through `backend` (its metrics attached) under
    KTPU_SOLVE_MODE `mode`, with the default profile of `api`'s package
    (`device_chunk`'s `api`, plus its plugin `registry` and `framework`
    modules) and the volume plugins' informers a `StaticInformers` over
    the case's objects. Returns (context, metrics)."""
    from kubernetes_tpu_torch.utils import flags

    case = volume_case(seed)
    reg = api.registry
    fwk = api.framework.Framework(reg.build_plugins(),
                                  reg.DEFAULT_SCORE_WEIGHTS)
    informers = StaticInformers(copy.deepcopy(case["objects"]))
    for p in fwk.plugins:
        if p.NAME in VOLUME_PLUGINS and hasattr(p, "set_informers"):
            p.set_informers(informers)
    infos = {n["metadata"]["name"]: api.types.NodeInfo(copy.deepcopy(n))
             for n in case["nodes"]}
    for p in case["residents"]:
        infos[p["spec"]["nodeName"]].add_pod(
            api.types.PodInfo(copy.deepcopy(p)))
    snap = api.types.Snapshot(list(infos.values()), 1)
    pods = [api.types.PodInfo(copy.deepcopy(p)) for p in case["pods"]]
    backend.metrics = api.SchedulerMetrics()
    with flags.scoped_set("KTPU_SOLVE_MODE", mode):
        ctx = api.run_chunks(backend, pods, snap, fwk)
    return ctx, backend.metrics


def port_volume_api():
    """`volume_chunk`'s `api` for this package."""
    from kubernetes_tpu_torch.scheduler import framework
    from kubernetes_tpu_torch.scheduler.plugins import registry

    api = port_device_api()
    api.registry, api.framework = registry, framework
    return api


def volume_chunk_view(ctx, metrics, counters: dict) -> dict:
    """What 15(c) and the tests compare: `device_chunk_view` and the verify
    rejects."""
    view = device_chunk_view(ctx, metrics)
    view["verify_rejects"] = counters["verify_rejects"]
    return view


def volume_chunks_phase(torch, seed: int) -> int:
    """Phase 15(c): `volume_case`'s chunk through `TorchBackend()` on the
    card and `TorchBackend(device="cpu")`, flagless and with greedy
    pinned: identical assignments, diagnostics, solver metrics,
    host-fallback counts, verify rejects and counters. Returns
    wave_solve's launches."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    t0 = time.perf_counter()
    api = port_volume_api()
    launches = 0
    for mode in ("auto", "greedy"):
        wave_kernel.wave_solve.launches = 0
        on_card = TorchBackend(max_batch=VOLUME_CHUNK)
        card = volume_chunk_view(*volume_chunk(api, on_card, seed, mode),
                                 on_card.counters)
        launches += wave_kernel.wave_solve.launches
        on_cpu = TorchBackend(device="cpu", max_batch=VOLUME_CHUNK)
        cpu = volume_chunk_view(*volume_chunk(api, on_cpu, seed, mode),
                                on_cpu.counters)
        same = card == cpu and on_card.counters == on_cpu.counters
        placed = sum(v is not None for v in card["assignments"].values())
        print(f"compare volume chunk ({len(card['assignments'])} pods on "
              f"{N_VOLUME_NODES} nodes in 3 zones, KTPU_SOLVE_MODE={mode}), "
              f"card vs CPU: {'identical' if same else 'DIFFER'}; placed "
              f"{placed}, verify rejects {card['verify_rejects']}, "
              f"host_fallback {card['host_fallback']}, optimal solves "
              f"{on_card.counters['optimal_solves']}")
        if not same:
            raise RuntimeError(f"volume chunk ({mode}) differs on the card "
                               f"from the CPU")
    if launches == 0:
        raise RuntimeError("phase 15(c): no wave_solve launch")
    print(f"phase 15(c) {time.perf_counter() - t0:.1f} s, wave_solve "
          f"launches {launches}")
    return launches


#: Phase 15(d)'s sizes, after upstream scheduler_perf's volume families
#: (SchedulingInTreePVs, SchedulingWaitForFirstConsumerPVs): 250 init and
#: 250 measured pods (1000 + 1000, then 500 + 500, before the cuts that
#: keep the smoke inside its time), one claim each, on SchedulingBasic's
#: 5000 nodes.
VOLUME_LOOP_INIT, VOLUME_LOOP_MEASURED = 250, 250
#: Each node's `attachable-volumes-csi` limit in 15(d): None, so that the
#: nodes keep SchedulingBasic's shape and NodeVolumeLimits its default of
#: 256 volumes (above the 110 pods a node holds).
VOLUME_LOOP_LIMIT = None
#: The simulated provisioner's delay per WaitForFirstConsumer claim (s).
PROVISION_DELAY_S = 0.005


def port_volume_loop_api():
    """`volume_loop`'s `api`: `port_loop_api` with this package's volume
    constructors, ControllerManager and PVBinderController."""
    from kubernetes_tpu_torch.api.types import (make_pv, make_pvc,
                                                make_storage_class)
    from kubernetes_tpu_torch.controllers import (ControllerManager,
                                                  PVBinderController)
    from kubernetes_tpu_torch.controllers.pvbinder import pv_node_ok

    api = port_loop_api()
    api.make_pv, api.make_pvc = make_pv, make_pvc
    api.make_storage_class = make_storage_class
    api.ControllerManager = ControllerManager
    api.PVBinderController = PVBinderController
    api.pv_node_ok = pv_node_ok
    return api


def volume_loop_pod(api, k: int) -> tuple[dict, list, list]:
    """The k-th pod of a volume loop with its claim: even k a claim bound
    in advance to a PV of zone k/2 mod 3 (static class, ReadWriteOnce),
    odd k a WaitForFirstConsumer claim of the provisioning class
    (ReadWriteOncePod). Returns (pod, PVs, PVCs)."""
    claim = f"data-{k}"
    pod = with_claim(api.make_pod(f"vol-{k}", requests=dict(POD_REQUESTS)),
                     claim)
    if k % 2 == 0:
        pv = zonal_pv(api.make_pv, f"pv-{claim}", ZONES[(k // 2) % 3], claim)
        return pod, [pv], [bound_pvc(api.make_pvc, claim, f"pv-{claim}")]
    return pod, [], [api.make_pvc(claim, request="5Gi",
                                  storage_class=WFFC_CLASS,
                                  access_modes=["ReadWriteOncePod"])]


async def volume_loop(api, backend, n_nodes: int, n_init: int,
                      n_measured: int, batch_size: int = LOOP_BATCH,
                      limit: int | None = VOLUME_LOOP_LIMIT, routes=None,
                      window_hook=None, timeout: float = 600.0) -> dict:
    """A volume workload through `api`'s `Scheduler.run` with the PV
    binder beside it: `n_nodes` nodes of SchedulingBasic's shape in three
    zones, each with an `attachable-volumes-csi` limit of `limit` (None:
    none, NodeVolumeLimits' default), the
    three volume classes, every pod's PV and claim (`volume_loop_pod`)
    created first, then `n_init` pods (bound first) and `n_measured` pods
    in 512-pod gathers into the running loop. The window runs from the
    first measured create to the last measured bind an informer sees;
    `window_hook(start)` is called at its start (True) and end (False).
    `routes` (a dict) counts the backend's dispatches
    (`count_backend_routes`). Returns the window's seconds, the
    scheduler's metrics, VolumeBinding's PreBind waits (s) and the
    store's pods, claims, PVs and nodes."""
    store = api.new_cluster_store()
    api.install_core_validation(store)
    for sc in volume_classes(api.make_storage_class):
        await store.create("storageclasses", sc)
    alloc = {"cpu": "8", "memory": "32Gi", "pods": "110"}
    if limit is not None:
        alloc["attachable-volumes-csi"] = str(limit)
    for i in range(n_nodes):
        await store.create("nodes", api.make_node(
            f"node-{i}", labels={ZONE_KEY: ZONES[i % 3]},
            allocatable=dict(alloc)))
    pods = []
    for k in range(n_init + n_measured):
        pod, pvs, pvcs = volume_loop_pod(api, k)
        pods.append(pod)
        for pv in pvs:
            await store.create("persistentvolumes", pv)
        for pvc in pvcs:
            await store.create("persistentvolumeclaims", pvc)
    mgr = api.ControllerManager(store, [api.PVBinderController(
        store, provision_delay=PROVISION_DELAY_S)])
    await mgr.start()
    lr = LoopRun(api, backend, batch_size)
    lr.store = store
    try:
        lr.sched, lr.factory = await start_scheduler(api, store,
                                                     backend=backend)
        if routes is not None:
            count_backend_routes(lr.sched, routes)
        waits: list = []
        vb = next(p for fwk in lr.sched.profiles.values()
                  for p in fwk.plugins if p.NAME == "VolumeBinding")
        pre_bind = vb.pre_bind

        async def timed(state, pod, node_name):
            t = time.perf_counter()
            st = await pre_bind(state, pod, node_name)
            waits.append(time.perf_counter() - t)
            return st

        vb.pre_bind = timed
        bound: set = set()

        def track(obj):
            if (obj.get("spec") or {}).get("nodeName"):
                bound.add(obj["metadata"]["name"])

        lr.factory.informer("pods").add_event_handler(
            api.ResourceEventHandler(
                on_add=track, on_update=lambda old, new: track(new)))

        async def create(batch):
            for lo in range(0, len(batch), 512):
                await asyncio.gather(*(store.create("pods", p)
                                       for p in batch[lo:lo + 512]))

        lr.open()
        await create(pods[:n_init])
        await lr.wait(lambda: len(bound) >= n_init, "init pods bound",
                      timeout)
        if window_hook is not None:
            window_hook(True)
        t0 = time.perf_counter()
        await create(pods[n_init:])
        await lr.wait(lambda: len(bound) >= n_init + n_measured,
                      "measured pods bound", timeout)
        window = time.perf_counter() - t0
        if window_hook is not None:
            window_hook(False)
        out = {"window": window, "metrics": lr.sched.metrics,
               "prebind_waits": waits}
        for resource in ("pods", "persistentvolumeclaims",
                         "persistentvolumes", "nodes"):
            out[resource] = (await store.list(resource)).items
        return out
    finally:
        await mgr.stop()
        await lr.close()


def volume_violations(api, out: dict) -> list[str]:
    """15(d)'s gates on a `volume_loop` result: every pod bound; its claim
    bound to a PV whose node affinity and zone label admit the pod's node;
    no node over its `attachable-volumes-csi` limit; no ReadWriteOncePod
    claim used by two pods."""
    nodes = {n["metadata"]["name"]: n for n in out["nodes"]}
    pvcs = {p["metadata"]["name"]: p for p in out["persistentvolumeclaims"]}
    pvs = {p["metadata"]["name"]: p for p in out["persistentvolumes"]}
    faults, per_node, users = [], {}, {}
    for pod in out["pods"]:
        name = pod["metadata"]["name"]
        node = (pod.get("spec") or {}).get("nodeName")
        claim = pod["spec"]["volumes"][0]["persistentVolumeClaim"][
            "claimName"]
        if not node:
            faults.append(f"{name} unbound")
            continue
        pvc = pvcs.get(claim)
        pv = pvs.get((pvc or {}).get("spec", {}).get("volumeName") or "")
        if pvc is None or pv is None \
                or (pvc.get("status") or {}).get("phase") != "Bound":
            faults.append(f"{name}: claim {claim} not bound to a PV")
            continue
        zone = (pv["metadata"].get("labels") or {}).get(ZONE_KEY)
        labels = nodes[node]["metadata"].get("labels") or {}
        if not api.pv_node_ok(pv, nodes[node]) \
                or (zone is not None and labels.get(ZONE_KEY) != zone):
            faults.append(f"{name}: PV {pv['metadata']['name']} does not "
                          f"admit {node}")
        per_node.setdefault(node, set()).add(claim)
        if "ReadWriteOncePod" in (pvc["spec"].get("accessModes") or []):
            users.setdefault(claim, []).append(name)
    for node, claims in per_node.items():
        cap = int(nodes[node]["status"]["allocatable"].get(
            "attachable-volumes-csi", 256))
        if len(claims) > cap:
            faults.append(f"{node}: {len(claims)} volumes over {cap}")
    faults += [f"RWOP claim {c} used by {u}" for c, u in users.items()
               if len(u) > 1]
    return faults


def volume_loop_phase(torch) -> int:
    """Phase 15(d): `volume_loop` at SchedulingBasic's 5000 nodes, 250
    init and 250 measured pods, through `TorchBackend()`; the gates of
    `volume_violations`; throughput, the `assign` share, prep and verify,
    the PreBind waits (no profiled repeat: cut to keep the smoke inside
    its time). Returns wave_solve's launches in the measured window."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    t0 = time.perf_counter()
    api = port_volume_loop_api()
    backend = TorchBackend()
    routes = dict.fromkeys(("backend_dispatches", "backend_pods",
                            "early_binds"), 0)
    window: dict = {}

    def hook(start):
        torch.cuda.synchronize()
        if start:
            routes.update(dict.fromkeys(routes, 0))
            wave_kernel.wave_solve.launches = 0
            window["timings"] = dict(backend.timings)
            window["counters"] = dict(backend.counters)
        else:
            window["launches"] = wave_kernel.wave_solve.launches
            window["routes"] = dict(routes)
            window["timings"] = {k: round(v - window["timings"][k], 6)
                                 for k, v in backend.timings.items()}
            window["counters"] = {
                k: v - window["counters"][k]
                for k, v in backend.counters.items()
                if k != "sinkhorn_iterations"}

    out = asyncio.run(volume_loop(api, backend, N_NODES, VOLUME_LOOP_INIT,
                                  VOLUME_LOOP_MEASURED, routes=routes,
                                  window_hook=hook))
    faults = volume_violations(api, out)
    if faults:
        raise RuntimeError(f"15(d): {len(faults)} faults: {faults[:5]}")
    if window["launches"] == 0:
        raise RuntimeError("15(d): no wave_solve launch in the measured "
                           "window")
    tm, waits = window["timings"], out["prebind_waits"]
    per_node = max(
        sum(1 for p in out["pods"]
            if (p.get("spec") or {}).get("nodeName") == n["metadata"]["name"])
        for n in out["nodes"])
    print(f"volume loop 15(d) {N_NODES} nodes in 3 zones, "
          f"{VOLUME_LOOP_INIT} + {VOLUME_LOOP_MEASURED} pods with one claim "
          f"each (half bound in advance to zonal PVs, half "
          f"WaitForFirstConsumer provisioned by the PV binder): every pod "
          f"bound, every claim bound to a PV admitting its pod's node, no "
          f"node over its volume limit (most pods on a node {per_node}), no "
          f"ReadWriteOncePod claim used twice; "
          f"SchedulingThroughput {VOLUME_LOOP_MEASURED / out['window']:.2f} "
          f"pods/s, window {out['window']:.6f} s, assign share "
          f"{tm['assign_s'] / out['window']:.4f}, TorchBackend.timings "
          f"{json.dumps(tm)}, counters {json.dumps(window['counters'])}, "
          f"backend dispatches {window['routes']['backend_dispatches']} "
          f"with {window['routes']['backend_pods']} pods, wave_solve "
          f"launches {window['launches']}; PreBind waits: {len(waits)} "
          f"pods, mean {sum(waits) / max(1, len(waits)) * 1e3:.3f} ms, max "
          f"{max(waits, default=0.0) * 1e3:.3f} ms; phase 15(d) "
          f"{time.perf_counter() - t0:.1f} s")
    return window["launches"]


def stream_volume_run(torch, seed: int) -> dict:
    """Phase 15 (see the module docstring), under a scoped
    KTPU_SOLVE_MODE=auto with serving on. Returns the kernels line's phase
    15 entries: wave_solve's launches in 15(c) and in 15(d)'s measured
    window."""
    from kubernetes_tpu_torch.utils import flags

    t15 = time.perf_counter()
    print(f"phase 15 on {card_line()}")
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        stream_chunks_phase(torch)
        stream_loop_phase(torch)
        precreated_stream_phase(torch)
        out = {"volume_chunk_launches": volume_chunks_phase(torch, seed)}
        out["volume_loop_launches"] = volume_loop_phase(torch)
    print(f"phase 15 {time.perf_counter() - t15:.1f} s")
    return out


def stream_volume_phases(torch, seed: int) -> int:
    """`--phase15-only`: build the kernels (phase 1), then phase 15."""
    from kubernetes_tpu_torch.ops import wave_kernel

    t0 = time.perf_counter()
    lib = wave_kernel.LIBRARY.build()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib.path.name})")
    print(json.dumps(stream_volume_run(torch, seed)))
    print_card()
    return 0


# -- phase 16: slice topology, the node agents and the churn harness --------

#: Phase 16(a)'s meshes (KTPU_MESH_SHAPE, node count) and slice shapes; each
#: mesh also scans its own dims (the full-span case).
SCAN_MESHES = (("4x4", 16), ("4x8:mesh", 32), ("3x5x2", 30), ("auto", 5000),
               ("8x8x16", 1024))
SCAN_SHAPES = ((2, 2), (1, 3), (2, 4), (4, 4), (8, 8), (2, 2, 2), (2, 2, 8),
               (4, 4, 4))
#: Phase 16(a)'s timed (mesh, shape) pairs: the churn cells' 8x8 and 16x16
#: auto tori, the 5000-node torus and the 3D torus.
SCAN_TIMED = ((("auto", 64), (2, 2)), (("auto", 256), (4, 4)),
              (("auto", 5000), (8, 8)), (("8x8x16", 1024), (4, 4, 4)))


def mesh_spec(raw: str, n: int):
    from kubernetes_tpu_torch.topology.mesh import parse_mesh_shape
    return parse_mesh_shape(raw, n)


def scan_masks(spec, seed: int) -> list:
    """Seeded free masks of one mesh, as (name, (cells,) bool): fully free
    (every anchor ties), random at densities 0.9 and 0.6, symmetric holes
    (a random hole set united with its mirror through the mesh's centre,
    so mirrored placements tie) and the wrap band (only the first and last
    index of each axis longer than 2 free: on a torus a slice of at most 2
    per axis exists there only through the wrap; on a walled mesh none)."""
    rng = np.random.default_rng(seed)
    dims = spec.dims
    coords = np.indices(dims).reshape(3, -1).T
    holes = rng.random(spec.cells) < 0.15
    mirror = [spec.index_of(tuple(d - 1 - c for c, d in zip(xyz, dims)))
              for xyz in coords]
    band = np.ones(spec.cells, dtype=np.bool_)
    for axis, d in enumerate(dims):
        if d > 2:
            band &= (coords[:, axis] == 0) | (coords[:, axis] == d - 1)
    return [("free", np.ones(spec.cells, dtype=np.bool_)),
            ("p0.9", rng.random(spec.cells) < 0.9),
            ("p0.6", rng.random(spec.cells) < 0.6),
            ("symmetric", ~(holes | holes[mirror])),
            ("wrap-band", band)]


def scan_shapes(spec) -> list:
    """SCAN_SHAPES plus the mesh's own dims (trailing 1s dropped)."""
    full = tuple(spec.dims)
    while len(full) > 1 and full[-1] == 1:
        full = full[:-1]
    return list(SCAN_SHAPES) + [full]


def scan_view(scan) -> tuple | None:
    """A device_scan result as comparable lists (None stays None)."""
    if scan is None:
        return None
    return tuple(np.asarray(a).tolist() for a in scan)


def scan_phase(torch, seed: int) -> dict:
    """Phase 16(a): `device_scan` on the card against the port's scan on
    the CPU on every (mesh, shape, mask) of SCAN_MESHES x scan_shapes x
    scan_masks: keys, feasibility, frag and coverage identical (None where
    the size contract declines, on both), and `best_key` identical at 1,
    4 and 8 shards on the card and to the CPU's plain max; then the ms per
    scan (CUDA events) and the device kernels per scan (torch.profiler) of
    the SCAN_TIMED pairs. Returns the ms per scan by pair."""
    from kubernetes_tpu_torch.topology import device as topo

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    scans = declined = feasible = 0
    for raw, n in SCAN_MESHES:
        spec = mesh_spec(raw, n)
        for shape in scan_shapes(spec):
            for name, mask in scan_masks(spec, seed):
                card = topo.device_scan(mask, spec, shape, dev)
                cpu = topo.device_scan(mask, spec, shape, "cpu")
                if scan_view(card) != scan_view(cpu):
                    raise RuntimeError(f"16(a): device_scan differs on the "
                                       f"card, mesh {raw} ({n} nodes), "
                                       f"shape {shape}, mask {name}")
                scans += 1
                if card is None:
                    declined += 1
                    continue
                want = topo.best_key(cpu[0])
                got = [topo.best_key(card[0], s, dev) for s in (1, 4, 8)]
                if got != [want] * 3:
                    raise RuntimeError(f"16(a): best_key {got} at 1/4/8 "
                                       f"shards against {want}, mesh {raw}, "
                                       f"shape {shape}, mask {name}")
                feasible += want >= 0
    print(f"compare slice scan, card vs CPU: {scans} (mesh, shape, mask) "
          f"scans identical (keys, feasibility, frag, coverage), "
          f"{declined} declined by the size contract on both, best_key "
          f"identical at 1, 4 and 8 shards ({feasible} with a feasible "
          f"placement)")
    timed = {}
    for (raw, n), shape in SCAN_TIMED:
        spec = mesh_spec(raw, n)
        mask = scan_masks(spec, seed)[1][1]
        ms = cuda_ms(torch, lambda: topo.device_scan(mask, spec, shape, dev),
                     20)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                topo.device_scan(mask, spec, shape, dev)
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages()
                      if device_us(e) > 0) / 5
        busy_ms = sum(device_us(e) for e in prof.key_averages()) / 5e3
        key = f"{spec.dims[0]}x{spec.dims[1]}x{spec.dims[2]} {shape}"
        timed[key] = ms
        print(f"slice scan {key} ({'torus' if spec.wrap else 'mesh'}, "
              f"{spec.cells} cells, p0.9 mask): {ms:.4f} ms per scan (CUDA "
              f"events, the host read included); {kernels:.0f} device "
              f"kernels and {busy_ms:.4f} ms of device time per scan "
              f"(profiler)")
    print(f"phase 16(a) {time.perf_counter() - t0:.1f} s")
    return timed


#: Phase 16(b)'s fixtures.
SLICE_CASES = ("torus-2x2", "mesh-2x2x2", "impossible-1x3")
SLICE_NODE = {"allocatable": {"cpu": "4", "memory": "16Gi", "pods": "110"}}


def slice_case(kind: str) -> dict:
    """One phase 16(b) fixture: KTPU_MESH_SHAPE, nodes and residents as
    (name, make_node / make_pod kwargs), PodGroups [(name, sliceShape)] and
    pods (gang members of cpu 1 among lone pods of cpu 500m). A resident
    of cpu 4 makes its node a busy cell. `torus-2x2`: two 2x2 gangs and 6
    lone pods on the 4x4 auto torus of 16 nodes with node-5 busy (the two
    plans must not claim one node); `mesh-2x2x2`: a 2x2x2 gang and 4 lone
    pods on the 4x4x2 torus with node-0 busy; `impossible-1x3`: a 1x3 gang
    and 4 lone pods on the 4x4 auto torus with a checkerboard of busy
    cells, so no three free cells line up and the gang stays pending
    whole while the lone pods place."""
    if kind == "torus-2x2":
        mesh, n, busy, lone = "auto", 16, (5,), 6
        groups = [("g1", (2, 2)), ("g2", (2, 2))]
    elif kind == "mesh-2x2x2":
        mesh, n, busy, lone = "4x4x2", 32, (0,), 4
        groups = [("g3", (2, 2, 2))]
    elif kind == "impossible-1x3":
        mesh, n, lone = "auto", 16, 4
        busy = tuple(i for i in range(n) if (i // 4 + i % 4) % 2 == 0)
        groups = [("g4", (1, 3))]
    else:
        raise ValueError(kind)
    nodes = [(f"node-{i}", copy.deepcopy(SLICE_NODE)) for i in range(n)]
    residents = [(f"busy-{i}", {"node_name": f"node-{i}", "requests": {
        "cpu": "4", "memory": "1Gi"}}) for i in busy]
    pods = []
    for g, shape in groups:
        pods += [(f"{g}-{k}", {"requests": {"cpu": "1", "memory": "1Gi"},
                               "labels": {GANG_LABEL: g}})
                 for k in range(math.prod(shape))]
    pods += [(f"solo-{k}", {"requests": {"cpu": "500m", "memory": "1Gi"}})
             for k in range(lone)]
    return {"mesh": mesh, "nodes": nodes, "residents": residents,
            "groups": groups, "pods": pods}


def port_slice_api():
    """This package's modules phase 16(b) and the tests drive (the tests
    build the JAX package's counterpart)."""
    from kubernetes_tpu_torch.metrics.registry import SchedulerMetrics
    from kubernetes_tpu_torch.scheduler import framework, types
    from kubernetes_tpu_torch.scheduler.plugins import coscheduling, registry
    from kubernetes_tpu_torch.topology import mesh

    api = port_loop_api()
    api.types, api.framework, api.registry = types, framework, registry
    api.coscheduling, api.mesh = coscheduling, mesh
    api.SchedulerMetrics = SchedulerMetrics
    return api


def slice_profile(api, store=None, groups=None, device=None):
    """The default profile plus Coscheduling and TopologySlice of `api`'s
    package. With `groups` ([(name, sliceShape)]) both plugins read a
    `PodGroupIndex` over them (direct `assign`) and TopologySlice's scan
    runs on `device` where the plugin has one; without, the scheduler
    wires informers and the device."""
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        DEFAULT_PLUGINS)

    plugins = api.registry.build_plugins(
        list(DEFAULT_PLUGINS) + ["Coscheduling", "TopologySlice"],
        store=store)
    if groups is not None:
        index = PodGroupIndex({
            f"default/{g}": api.coscheduling.make_pod_group(
                g, math.prod(shape), slice_shape=shape)
            for g, shape in groups})
        for p in plugins[-2:]:
            p.pg_informer = index
        if hasattr(plugins[-1], "device"):
            plugins[-1].device = device
    return api.framework.Framework(plugins,
                                   api.registry.DEFAULT_SCORE_WEIGHTS)


def slice_chunk(api, backend, kind: str, mode: str) -> dict:
    """Phase 16(b)'s `kind` fixture as one chunk through `backend`'s
    assign() under KTPU_SOLVE_MODE `mode` and the fixture's mesh:
    assignments, diagnostics, the slice fragmentation gauge and the
    TopologySlice plan routes (the port's; None for the reference)."""
    from types import SimpleNamespace

    from kubernetes_tpu_torch.utils import flags

    case = slice_case(kind)
    fwk = slice_profile(api, groups=case["groups"],
                        device=getattr(backend, "device", None))
    ts = fwk.plugins[-1]
    ts.scheduler = SimpleNamespace(metrics=api.SchedulerMetrics())
    snap = constraint_snapshot(api.types, api.make_node, api.make_pod,
                               case["nodes"], case["residents"])
    pods = [api.types.PodInfo(api.make_pod(n, **kw))
            for n, kw in case["pods"]]
    with flags.scoped_set("KTPU_MESH_SHAPE", case["mesh"]), \
            flags.scoped_set("KTPU_SOLVE_MODE", mode):
        assignments, diagnostics = backend.assign(pods, snap, fwk)
    return {"assignments": dict(assignments),
            "diagnostics": diagnostics_view(diagnostics),
            "slice_fragmentation_pct":
                ts.scheduler.metrics.slice_fragmentation_pct.value(),
            "paths": dict(getattr(ts, "paths", {})) or None}


def slice_violations(api, case: dict, assignments: dict) -> list[str]:
    """What phase 16(b) and the tests require of a fixture's placements
    ({pod name or key: node}): each gang bound whole on a contiguous
    sub-mesh of its shape or not at all, the impossible gang not at all,
    and no node over capacity."""
    from kubernetes_tpu_torch.topology.slices import is_contiguous_slice

    bad = []
    spec = api.mesh.parse_mesh_shape(case["mesh"], len(case["nodes"]))
    for g, shape in case["groups"]:
        got = [assignments.get(f"default/{g}-{k}",
                               assignments.get(f"{g}-{k}"))
               for k in range(math.prod(shape))]
        placed = [n for n in got if n is not None]
        if not placed:
            continue
        cells = [api.mesh.node_cell(n, {}, spec) for n in placed]
        if len(placed) < len(got) or len(set(placed)) < len(placed) \
                or not is_contiguous_slice(cells, spec, shape):
            bad.append(f"gang {g} bent or partial: {got}")
        if shape == (1, 3):
            bad.append(f"the impossible gang {g} placed: {got}")
    used: dict = {}
    for name, kw in case["residents"]:
        used[kw["node_name"]] = used.get(kw["node_name"], 0) + 4000
    for name, kw in case["pods"]:
        node = assignments.get(f"default/{name}", assignments.get(name))
        if node is not None:
            cpu = kw["requests"]["cpu"]
            used[node] = used.get(node, 0) + (
                int(cpu[:-1]) if cpu.endswith("m") else 1000 * int(cpu))
    bad += [f"{n} over capacity" for n, v in used.items() if v > 4000]
    return bad


async def slice_loop(api, backend, kind: str, batch_size: int) -> dict:
    """Phase 16(b)'s `kind` fixture through `api`'s `Scheduler.run` with
    the slice profile (the caller sets the fixture's mesh): residents
    first (cached), the PodGroups, then every pod pre-created before the
    loop opens; the loop runs until every pod is bound or parked
    unschedulable. Returns the assignments by pod name and the slice
    gangs Permit released."""
    lr = LoopRun(api, backend, batch_size)
    case = slice_case(kind)
    names = [n for n, _ in case["pods"]]
    await lr.start(case["nodes"], profiles=lambda store: {
        "default-scheduler": slice_profile(api, store)})
    try:
        await lr.create(case["residents"])
        await lr.wait(lambda: sum(
            len(ni.pods) for ni in lr.sched.cache.update_snapshot().nodes)
            == len(case["residents"]), "residents cached")
        for g, shape in case["groups"]:
            await lr.store.create("podgroups", api.coscheduling.make_pod_group(
                g, math.prod(shape), slice_shape=shape))
        await lr.create(case["pods"])
        await lr.wait(lambda: lr.queued() == len(names), "pods queued")
        lr.open()
        await lr.wait(lambda: lr.settled(names), "pods placed")
        assignments, _, _, _ = await lr.results()
        return {"assignments": {n: assignments[n] for n in names},
                "slice_gangs_bound":
                    lr.sched.metrics.slice_gangs_bound.value()}
    finally:
        await lr.close()


def slice_fixtures_phase(torch) -> int:
    """Phase 16(b): each SLICE_CASES fixture through `TorchBackend()` on
    the card and `TorchBackend(device="cpu")`, as one chunk (flagless and
    with greedy pinned) and through `Scheduler.run`: identical placements
    (and, for the chunk, diagnostics, fragmentation gauge and plan
    routes), every gang whole on a contiguous sub-mesh, the impossible
    gang pending whole, no node over capacity. Returns wave_solve's
    launches on the card."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.utils import flags

    t0 = time.perf_counter()
    api = port_slice_api()
    launches = 0
    for kind in SLICE_CASES:
        case = slice_case(kind)
        for mode in ("auto", "greedy"):
            wave_kernel.wave_solve.launches = 0
            card = slice_chunk(api, TorchBackend(max_batch=64), kind, mode)
            launches += wave_kernel.wave_solve.launches
            cpu = slice_chunk(api, TorchBackend(device="cpu", max_batch=64),
                              kind, mode)
            bad = slice_violations(api, case, card["assignments"])
            placed = sum(v is not None for v in card["assignments"].values())
            print(f"compare slice chunk {kind} (KTPU_SOLVE_MODE={mode}), "
                  f"card vs CPU: {'identical' if card == cpu else 'DIFFER'}"
                  f"; placed {placed}/{len(case['pods'])}, plans "
                  f"{card['paths']}, slice fragmentation "
                  f"{card['slice_fragmentation_pct']:.2f}%")
            if card != cpu or bad:
                raise RuntimeError(f"16(b): slice chunk {kind} ({mode}): "
                                   f"card vs CPU {card == cpu}, {bad}")
        wave_kernel.wave_solve.launches = 0
        with flags.scoped_set("KTPU_MESH_SHAPE", case["mesh"]):
            card = asyncio.run(slice_loop(api, TorchBackend(), kind,
                                          LOOP_BATCH))
            launches += wave_kernel.wave_solve.launches
            cpu = asyncio.run(slice_loop(api, TorchBackend(device="cpu"),
                                         kind, LOOP_BATCH))
        bad = slice_violations(api, case, card["assignments"])
        bound = sum(v is not None for v in card["assignments"].values())
        print(f"compare slice loop {kind}, card vs CPU: "
              f"{'identical' if card == cpu else 'DIFFER'}; bound "
              f"{bound}/{len(case['pods'])}, slice gangs released "
              f"{card['slice_gangs_bound']}")
        if card != cpu or bad:
            raise RuntimeError(f"16(b): slice loop {kind}: card vs CPU "
                               f"{card == cpu}, {bad}")
    print(f"phase 16(b) {time.perf_counter() - t0:.1f} s, wave_solve "
          f"launches {launches}")
    return launches


def slice_runner_cls(base):
    """`base` (the port's PerfRunner or a subclass of it) that keeps the
    run's store and scheduler and records, through a pods informer
    handler, the node of every slice-gang member as it binds — a gang the
    sliceDeath fault deletes later included — for the 16(c) gates."""
    from kubernetes_tpu_torch.client import ResourceEventHandler

    class SliceRunner(base):
        async def _drive(self, template_ops, params, timeout, backing,
                         store, metrics, sched, factory, *boundary):
            self.store, self.sched = backing, sched
            self.gang_nodes: dict = {}

            def track(obj):
                group = (obj["metadata"].get("labels") or {}).get(GANG_LABEL)
                node = (obj.get("spec") or {}).get("nodeName")
                if group and node:
                    self.gang_nodes.setdefault(group, {})[
                        obj["metadata"]["name"]] = node

            factory.informer("pods").add_event_handler(ResourceEventHandler(
                on_add=track, on_update=lambda old, new: track(new)))
            return await super()._drive(template_ops, params, timeout,
                                        backing, store, metrics, sched,
                                        factory, *boundary)

    return SliceRunner


def slice_plugin(sched):
    """The TopologySlice plugin of the scheduler's default profile."""
    return next(p for p in sched.profiles["default-scheduler"].plugins
                if p.NAME == "TopologySlice")


def churn_slice_violations(runner, result, params: dict) -> list[str]:
    """Phase 16(c)'s gates on a ChurnSlicePacking run (`runner` from
    `slice_runner_cls`): both faults recovered; each slice gang (the
    first and its replacement) bound whole, one node per member, on a
    contiguous sub-mesh of the auto torus; the replacement clear of the
    dead member's node; no node over capacity in the store."""
    from kubernetes_tpu_torch.topology.mesh import node_cell
    from kubernetes_tpu_torch.topology.slices import is_contiguous_slice
    from kubernetes_tpu_torch.utils import flags

    shape = tuple(params["shape"])
    size = math.prod(shape)
    pods = asyncio.run(runner.store.list("pods")).items
    nodes = asyncio.run(runner.store.list("nodes")).items
    labels = {n["metadata"]["name"]: n["metadata"].get("labels") or {}
              for n in nodes}
    spec = mesh_spec(flags.get("KTPU_MESH_SHAPE"), len(nodes))
    bad = [f"fault {r['kind']} not recovered: {r}"
           for r in result.churn_faults if not r.get("recovered")]
    if [r["kind"] for r in result.churn_faults] != ["gangArrival",
                                                    "sliceDeath"]:
        bad.append(f"fault records {result.churn_faults}")
    dead = next((r.get("node") for r in result.churn_faults
                 if r["kind"] == "sliceDeath"), None)
    if sorted(runner.gang_nodes) != ["slice-1000", "slice-1000-r3500"]:
        bad.append(f"slice gangs bound: {sorted(runner.gang_nodes)}")
    for group, members in runner.gang_nodes.items():
        placed = list(members.values())
        cells = [node_cell(n, labels.get(n), spec) for n in placed]
        if len(placed) != size or len(set(placed)) != size \
                or None in cells \
                or not is_contiguous_slice(cells, spec, shape):
            bad.append(f"gang {group} not one contiguous {shape} slice: "
                       f"{members}")
        if group.endswith("-r3500") and dead in placed:
            bad.append(f"replacement gang {group} on the dead node {dead}")
    bad += [f"{n} over capacity" for n in over_capacity(nodes, pods)]
    return bad


def churn_view(result, sched, window: dict | None = None) -> str:
    """The numbers phase 16(c) and 16(d) print of a churn run."""
    r = result.as_dict()
    ts = next((p for p in sched.profiles["default-scheduler"].plugins
               if p.NAME == "TopologySlice"), None)
    text = (f"attempt ms p50 {r['attempt_p50_ms']} p99 {r['attempt_p99_ms']}"
            f" p999 {r['attempt_p999_ms']} (exact "
            f"{r['attempt_percentiles_exact']}); arrivals "
            f"{r['churn_arrivals_total']} at {r['churn_achieved_rate']}/s "
            f"(offered {r['churn_offered_rate']}, late "
            f"{r['churn_late_arrivals']}), backlog peak "
            f"{r['churn_backlog_peak']}, final {r['churn_backlog_final']}, "
            f"saturated {r['churn_saturated']}; fast-path pods "
            f"{r['serving_fast_path_pods_total']}, agent boot "
            f"{r['agent_start_seconds']} s")
    if ts is not None:
        text += (f"; churn_recovery_seconds_max "
                 f"{r['churn_recovery_seconds_max']}, faults "
                 f"{json.dumps(r['churn_faults'])}, slice gangs released "
                 f"{r['slice_gangs_bound_total']}, slice_fragmentation_pct "
                 f"{r['slice_fragmentation_pct']}, plans made "
                 f"{ts.paths['device'] + ts.paths['oracle']} (oracle "
                 f"{ts.paths['oracle']}), coordinate-plane rebuilds "
                 f"{r['topology_plane_rebuilds_total']}")
    if window is not None:
        text += (f"; in the window: wave_solve launches "
                 f"{window['launches']}, solve_one calls "
                 f"{window['solve_one']}, backend dispatches "
                 f"{window['routes']['backend_dispatches']} with "
                 f"{window['routes']['backend_pods']} pods, host-path pods "
                 f"{window['routes']['host_path_pods']}, wall "
                 f"{window['wall']:.6f} s, assign share "
                 f"{window['timings']['assign_s'] / window['wall']:.4f}")
    return text


def churn_run(torch, family: dict, workload: str, profile: str | None,
              wrap=None) -> tuple:
    """One run of a churn family's workload through the port's
    `PerfRunner` (`Scheduler.run`, `TorchBackend()`, batch_size 16384),
    counting the routes, wave_solve's launches and the fast path's
    solve_one calls over the measured window (and profiling it when
    asked, as `counting_runner_cls`); `wrap` (a runner class to its
    subclass) adds a phase's own records. Returns (runner, result)."""
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    params = next(w["params"] for w in family["workloads"]
                  if w["name"] == workload)
    base = slice_runner_cls(counting_runner_cls(torch))
    if wrap is not None:
        base = wrap(base)

    with counted_solves(torch, False) as solves:
        class ChurnRunner(base):
            def _begin_measure(self, metrics, backing):
                out = super()._begin_measure(metrics, backing)
                self.window["solves"] = dict(solves)
                return out

            def _end_measure(self, result, metrics, backing, base, count):
                super()._end_measure(result, metrics, backing, base, count)
                self.window["solve_one"] = {
                    k: v - self.window["solves"][k]
                    for k, v in solves.items()}

        runner = ChurnRunner(TorchBackend(), profile,
                             family.get("schedulerConfig"))
        result = asyncio.run(runner.run(family["workloadTemplate"], params,
                                        timeout=600.0))
    return runner, result


def churn_slice_phase(torch) -> dict:
    """Phase 16(c): ChurnSlicePacking's two cells through `churn_run`, each
    held to `churn_slice_violations` (no profiled repeat: cut to keep the
    smoke inside its time). Returns wave_solve's launches in each cell's
    window."""
    from kubernetes_tpu_torch.perf.scheduler_perf import CHURN_SLICE_PACKING

    t0 = time.perf_counter()
    launches = {}
    for workload in ("64Agents-2x2", "256Agents-4x4"):
        params = next(w["params"] for w in CHURN_SLICE_PACKING["workloads"]
                      if w["name"] == workload)
        runner, result = churn_run(torch, CHURN_SLICE_PACKING, workload,
                                   None)
        bad = churn_slice_violations(runner, result, params)
        print(f"churn slice packing ChurnSlicePacking/{workload} "
              f"(PerfRunner, TorchBackend(), {params['initNodes']} agents, "
              f"rate {params['rate']}/s for {params['duration']} s, shape "
              f"{params['shape']}): "
              + churn_view(result, runner.sched, runner.window)
              + f"; gangs {json.dumps(runner.gang_nodes)}")
        if bad:
            raise RuntimeError(f"16(c) {workload}: {bad}")
        launches[workload] = runner.window["launches"]
    print(f"phase 16(c) {time.perf_counter() - t0:.1f} s")
    return launches


def churn_day_phase(torch) -> int:
    """Phase 16(d): ChurnDay/5000Nodes-trickle (5000 nodes, 300 warm-up
    pods, then Poisson arrivals at 250/s for 10 s; not cut) through
    `churn_run`: no node over capacity, no create error, every warm-up pod
    bound (the barrier). Returns wave_solve's launches in the window."""
    from kubernetes_tpu_torch.perf.scheduler_perf import CHURN_DAY

    t0 = time.perf_counter()
    runner, result = churn_run(torch, CHURN_DAY, "5000Nodes-trickle", None)
    pods = asyncio.run(runner.store.list("pods")).items
    nodes = asyncio.run(runner.store.list("nodes")).items
    bound = sum(bool((p.get("spec") or {}).get("nodeName")) for p in pods)
    r = result.as_dict()
    share = r["serving_fast_path_pods_total"] / max(
        1, r["churn_arrivals_total"])
    print(f"churn day ChurnDay/5000Nodes-trickle (PerfRunner, "
          f"TorchBackend()): " + churn_view(result, runner.sched,
                                            runner.window)
          + f"; fast-path share {share:.4f}; bound at the end {bound}/"
          f"{len(pods)}; phase 16(d) {time.perf_counter() - t0:.1f} s")
    bad = over_capacity(nodes, pods)
    if bad or result.churn_create_errors or not result.churn_arrivals_total:
        raise RuntimeError(f"16(d): over capacity {bad[:5]}, create errors "
                           f"{result.churn_create_errors}, arrivals "
                           f"{result.churn_arrivals_total}")
    return runner.window["launches"]


def slice_topology_run(torch, seed: int) -> dict:
    """Phase 16 (see the module docstring), under a scoped
    KTPU_SOLVE_MODE=auto with serving on. Returns the kernels line's phase
    16 entries: wave_solve's launches in 16(b) on the card and in the
    measured windows of 16(c) and 16(d)."""
    from kubernetes_tpu_torch.utils import flags

    t16 = time.perf_counter()
    print(f"phase 16 on {card_line()}")
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        scan_phase(torch, seed)
        out = {"slice_fixture_launches": slice_fixtures_phase(torch)}
        churn = churn_slice_phase(torch)
        out["churn_slice_64_launches"] = churn["64Agents-2x2"]
        out["churn_slice_256_launches"] = churn["256Agents-4x4"]
        out["churn_day_launches"] = churn_day_phase(torch)
    print(f"phase 16 {time.perf_counter() - t16:.1f} s")
    return out


def slice_topology_phases(torch, seed: int) -> int:
    """`--phase16-only`: build the kernels (phase 1), then phase 16."""
    from kubernetes_tpu_torch.ops import wave_kernel

    t0 = time.perf_counter()
    lib = wave_kernel.LIBRARY.build()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib.path.name})")
    print(json.dumps(slice_topology_run(torch, seed)))
    print_card()
    return 0



# ---------------------------------------------------------------------------
# phase 17: the runner's last in-process families
# ---------------------------------------------------------------------------

#: The `consolidation_case` fixtures: ties everywhere (uniform nodes), a
#: node exactly at the threshold, a resource column with zero allocatable
#: on some nodes, empty nodes, invalid rows, and random free planes.
CONSOLIDATION_CASES = ("uniform", "at-threshold", "zero-alloc", "empty",
                       "invalid", "random")


def consolidation_case(kind: str, seed: int = 0, n: int = 96) -> tuple:
    """Inputs of `solver.consolidation_scores` as numpy arrays: free_q and
    alloc_q (n, 3) f32 in the descheduler's units (cpu millicores, memory
    bytes, an extended resource), used_pods (n,) i32, valid (n,) bool and
    the f32 threshold."""
    rng = np.random.default_rng(seed)
    gib = float(1 << 30)
    alloc = np.tile(np.array([4000.0, 16 * gib, 8.0], np.float32), (n, 1))
    req = np.array([500.0, gib, 1.0], np.float32)
    used = rng.integers(0, 9, size=n).astype(np.int32)
    valid = np.ones(n, bool)
    thr = np.float32(0.4)
    if kind == "uniform":
        used[:] = 2
    elif kind == "at-threshold":
        # Pods of a quarter of each resource: 1 - 3/4 = 0.25 exactly;
        # 4000/16Gi/8 at two such pods leaves one half of each.
        thr = np.float32(0.5)
        used = np.where(np.arange(n) % 2 == 0, 2, 3).astype(np.int32)
        req = alloc[0] / np.float32(4.0)
    elif kind == "zero-alloc":
        alloc[::3, 2] = 0.0
    elif kind == "empty":
        used[::2] = 0
    elif kind == "invalid":
        valid = rng.random(n) < 0.7
    elif kind != "random":
        raise ValueError(kind)
    free = alloc - used[:, None].astype(np.float32) * req[None, :]
    if kind == "random":
        alloc[:, 0] = rng.choice([2000.0, 4000.0, 8000.0], size=n)
        free = (alloc * rng.random((n, 3))).astype(np.float32)
        free[rng.random(n) < 0.1] *= np.float32(-0.5)
        thr = np.float32(rng.choice([0.25, 0.4, 0.5]))
    free = np.where(alloc > 0, free, 0.0).astype(np.float32)
    return free, alloc.astype(np.float32), used, valid, thr


def gated_runner_cls(base):
    """`base` that records, through a pods informer handler, the pods seen
    bound, and how many of them there were when the first measured window
    (SchedulingGated's ungatePods) began."""
    from kubernetes_tpu_torch.client import ResourceEventHandler

    class GatedRunner(base):
        async def _drive(self, template_ops, params, timeout, backing,
                         store, metrics, sched, factory, *boundary):
            self.bound_names: set = set()
            self.bound_at_measure = None

            def track(obj):
                if (obj.get("spec") or {}).get("nodeName"):
                    self.bound_names.add(obj["metadata"]["name"])

            factory.informer("pods").add_event_handler(ResourceEventHandler(
                on_add=track, on_update=lambda old, new: track(new)))
            return await super()._drive(template_ops, params, timeout,
                                        backing, store, metrics, sched,
                                        factory, *boundary)

        def _begin_measure(self, metrics, backing):
            if self.bound_at_measure is None:
                self.bound_at_measure = len(self.bound_names)
            return super()._begin_measure(metrics, backing)

    return GatedRunner


def storm_runner_cls(base):
    """`base` that snapshots the store's direct LIST scans at every
    watch-cache total it reads: in AgentRelistStorm the first two are the
    relistStorm op's, before and after the storm."""

    class StormRunner(base):
        def _cache_totals(self, backing):
            if not hasattr(self, "direct_scans"):
                self.direct_scans = []
            self.direct_scans.append(dict(backing.list_direct_total))
            return super()._cache_totals(backing)

    return StormRunner


def storm_violations(runner, result, agents: int) -> list[str]:
    """AgentRelistStorm's promise (the watch cache's): every agent
    relisted, the storm cost the store no direct LIST scan, and at least
    one watch-cache hit per agent."""
    bad = []
    if result.relist_storm_agents != agents:
        bad.append(f"relist_storm_agents {result.relist_storm_agents}")
    before, after = runner.direct_scans[0], runner.direct_scans[1]
    if after != before:
        bad.append(f"direct scans during the storm: {before} -> {after}")
    if result.relist_storm_cache_hits < agents:
        bad.append(f"cache hits {result.relist_storm_cache_hits} < {agents}")
    return bad


def node_death_violations(runner, result) -> list[str]:
    """ChurnDayFaults' gates on a run whose only fault is one nodeDeath:
    the fault recovered; the dead node, and no other, carries the
    unreachable taint; every displaced pod evicted, and one replacement
    per displaced pod, each bound; no node over capacity. The dead node
    is the seed's pick, so it may hold no pod at the kill (the open loop
    decides); the phase prints the count. A replacement may bind back to
    the dead node, in both packages: the taint is NoExecute only,
    admission gives every pod a 300 s toleration of it, and the emptied
    node scores best (`replacements_on_dead_node` counts them)."""
    from kubernetes_tpu_torch.api.types import TAINT_UNREACHABLE

    recs = result.churn_faults
    if [r["kind"] for r in recs] != ["nodeDeath"]:
        return [f"fault records {recs}"]
    rec = recs[0]
    bad = [] if rec.get("recovered") else [f"not recovered: {rec}"]
    dead = rec["node"]
    pods = asyncio.run(runner.store.list("pods")).items
    nodes = asyncio.run(runner.store.list("nodes")).items
    tainted = sorted(n["metadata"]["name"] for n in nodes if any(
        t.get("key") == TAINT_UNREACHABLE
        for t in (n.get("spec") or {}).get("taints") or []))
    if tainted != [dead]:
        bad.append(f"unreachable taints on {tainted[:5]} ({len(tainted)}), "
                   f"dead node {dead}")
    suffix = f"-r{round(rec['at'] * 1e3)}"
    repl = {p["metadata"]["name"]: (p.get("spec") or {}).get("nodeName")
            for p in pods if p["metadata"]["name"].endswith(suffix)}
    if len(repl) != rec["displaced_pods"] \
            or rec["replacements"] != rec["displaced_pods"]:
        bad.append(f"{rec['displaced_pods']} displaced, "
                   f"{rec['replacements']} replacements, {len(repl)} found")
    names = {p["metadata"]["name"] for p in pods}
    kept = [n[:-len(suffix)] for n in repl if n[:-len(suffix)] in names]
    if kept:
        bad.append(f"displaced pods not evicted: {kept[:5]}")
    if not all(repl.values()):
        bad.append(f"replacements unbound: {repl}")
    runner.replacements_on_dead_node = sum(v == dead for v in repl.values())
    bad += [f"{n} over capacity" for n in over_capacity(nodes, pods)]
    return bad


@contextlib.contextmanager
def counted_descheduler(torch):
    """Count the runner's descheduler cycles (each `rebalance_once`'s
    evictions, in order) and keep, as CPU tensors, the inputs of the last
    `solver.consolidation_scores` call."""
    from kubernetes_tpu_torch.ops import solver
    from kubernetes_tpu_torch.perf import scheduler_perf

    base, scores = scheduler_perf.DeschedulerController, \
        solver.consolidation_scores
    log = {"cycles": [], "last_inputs": None}

    class CountedDescheduler(base):
        async def rebalance_once(self) -> int:
            n = await super().rebalance_once()
            log["cycles"].append(n)
            return n

    def recorded(*args):
        log["last_inputs"] = tuple(
            a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
        return scores(*args)

    scheduler_perf.DeschedulerController = CountedDescheduler
    solver.consolidation_scores = recorded
    try:
        yield log
    finally:
        scheduler_perf.DeschedulerController = base
        solver.consolidation_scores = scores


def rebalance_violations(result, cycles: list, budget: int,
                         enabled: bool) -> list[str]:
    """ChurnRebalance's gates: the descheduler's evictions are the sum of
    its cycles', none over the budget (so no more than budget x cycles),
    none with it off; the fragmentation curve sampled."""
    bad = []
    ev = result.churn_descheduler_evictions
    if ev != sum(cycles) or any(c > budget for c in cycles) \
            or ev > budget * len(cycles):
        bad.append(f"{ev} evictions over cycles {cycles} (budget {budget})")
    if enabled != bool(cycles):
        bad.append(f"descheduler enabled {enabled}, cycles {len(cycles)}")
    if len(result.churn_fragmentation_curve) < 2:
        bad.append(f"curve {result.churn_fragmentation_curve}")
    return bad


def curve_view(curve: list) -> str:
    """A fragmentation curve's final occupied point and its mean after the
    first wave (t >= 1 s)."""
    late = [p[2] for p in curve if p[0] >= 1.0] or [p[2] for p in curve]
    return (f"final {curve[-1][2]}%, mean after 1 s "
            f"{sum(late) / len(late):.3f}%")


def gated_phase(torch) -> int:
    """Phase 17(a): SchedulingGated/100Nodes. Returns wave_solve's
    launches in the measured window."""
    from kubernetes_tpu_torch.perf.scheduler_perf import SCHEDULING_GATED

    t0 = time.perf_counter()
    runner, result = churn_run(torch, SCHEDULING_GATED, "100Nodes", None,
                               gated_runner_cls)
    pods = asyncio.run(runner.store.list("pods")).items
    nodes = asyncio.run(runner.store.list("nodes")).items
    bound = sum(bool((p.get("spec") or {}).get("nodeName")) for p in pods)
    w = runner.window
    print(f"gated SchedulingGated/100Nodes (PerfRunner, TorchBackend()): "
          f"{result.throughput:.2f} pods/s from gate removal to all bound, "
          f"measured_pods {result.measured_pods}, bound before ungatePods "
          f"{runner.bound_at_measure}, bound at the end {bound}/{len(pods)};"
          f" in the window: wave_solve launches {w['launches']}, backend "
          f"dispatches {w['routes']['backend_dispatches']} with "
          f"{w['routes']['backend_pods']} pods, fast-path pods "
          f"{result.serving_fast_path_pods_total}; phase 17(a) "
          f"{time.perf_counter() - t0:.1f} s")
    bad = over_capacity(nodes, pods)
    if result.measured_pods != 1000 or bound != 1000 \
            or runner.bound_at_measure != 0 or bad or not w["launches"]:
        raise RuntimeError(f"17(a): measured {result.measured_pods}, bound "
                           f"{bound}, bound before the ungate "
                           f"{runner.bound_at_measure}, launches "
                           f"{w['launches']}, over capacity {bad[:5]}")
    return w["launches"]


def relist_storm_phase(torch) -> dict:
    """Phase 17(b): AgentRelistStorm/2000Agents and /5000Agents. Returns
    wave_solve's launches in each measured window."""
    from kubernetes_tpu_torch.perf.scheduler_perf import AGENT_RELIST_STORM

    out = {}
    for workload, agents in (("2000Agents", 2000), ("5000Agents", 5000)):
        t0 = time.perf_counter()
        runner, result = churn_run(torch, AGENT_RELIST_STORM, workload, None,
                                   storm_runner_cls)
        pods = asyncio.run(runner.store.list("pods")).items
        bound = sum(bool((p.get("spec") or {}).get("nodeName")) for p in pods)
        bad = storm_violations(runner, result, agents)
        if bound != len(pods) or len(pods) != 1300:
            bad.append(f"{bound}/{len(pods)} pods bound")
        w = runner.window
        print(f"relist storm AgentRelistStorm/{workload} (PerfRunner, "
              f"TorchBackend()): storm {result.relist_storm_seconds:.6f} s "
              f"over {result.relist_storm_agents} agents, cache hits "
              f"{result.relist_storm_cache_hits}, misses "
              f"{result.relist_storm_cache_misses}, direct scans "
              f"{runner.direct_scans[1]}; agent boot "
              f"{result.agent_start_seconds:.6f} s; measured "
              f"{result.throughput:.2f} pods/s ({result.measured_pods} pods,"
              f" attempt p99 {result.attempt_p99 * 1e3:.3f} ms); wave_solve "
              f"launches in the window {w['launches']}; phase 17(b) "
              f"{time.perf_counter() - t0:.1f} s")
        if bad:
            raise RuntimeError(f"17(b) {workload}: {bad}")
        out[workload] = w["launches"]
    return out


def node_death_phase(torch) -> int:
    """Phase 17(c): ChurnDayFaults/500Agents-nodeDeath. Returns wave_solve's
    launches in the measured window."""
    from kubernetes_tpu_torch.perf.scheduler_perf import CHURN_DAY_FAULTS

    t0 = time.perf_counter()
    runner, result = churn_run(torch, CHURN_DAY_FAULTS,
                               "500Agents-nodeDeath", None)
    rec = (result.churn_faults or [{}])[0]
    bad = node_death_violations(runner, result)
    print(f"node death ChurnDayFaults/500Agents-nodeDeath (PerfRunner, "
          f"TorchBackend()): recovery_s {rec.get('recovery_s')} (node "
          f"{rec.get('node')}, {rec.get('displaced_pods')} displaced pods, "
          f"replacements bound back to it "
          f"{getattr(runner, 'replacements_on_dead_node', None)}), "
          + churn_view(result, runner.sched, runner.window)
          + f"; phase 17(c) {time.perf_counter() - t0:.1f} s")
    if bad or result.churn_create_errors:
        raise RuntimeError(f"17(c): {bad}, create errors "
                           f"{result.churn_create_errors}")
    return runner.window["launches"]


def rebalance_phase(torch) -> tuple:
    """Phase 17(d): ChurnRebalance/200Nodes-deschedulerOff and -On.
    Returns (wave_solve's launches in each window, the inputs of the -On
    run's last `consolidation_scores` call)."""
    from kubernetes_tpu_torch.perf.scheduler_perf import CHURN_REBALANCE

    launches, curves, captured = {}, {}, None
    for workload in ("200Nodes-deschedulerOff", "200Nodes-deschedulerOn"):
        t0 = time.perf_counter()
        params = next(w["params"] for w in CHURN_REBALANCE["workloads"]
                      if w["name"] == workload)
        with counted_descheduler(torch) as log:
            runner, result = churn_run(torch, CHURN_REBALANCE, workload, None)
        pods = asyncio.run(runner.store.list("pods")).items
        nodes = asyncio.run(runner.store.list("nodes")).items
        curve = result.churn_fragmentation_curve
        print(f"rebalance ChurnRebalance/{workload} (PerfRunner, "
              f"TorchBackend()): descheduler evictions "
              f"{result.churn_descheduler_evictions} over "
              f"{len(log['cycles'])} cycles (budget {params['budget']}), "
              f"rebalance recovery {result.churn_rebalance_recovery_s} s, "
              f"occupied fragmentation {curve_view(curve)}; curve "
              f"{json.dumps(curve)}; "
              + churn_view(result, runner.sched, runner.window)
              + f"; phase 17(d) {time.perf_counter() - t0:.1f} s")
        bad = rebalance_violations(result, log["cycles"], params["budget"],
                                   params["descheduler"])
        bad += [f"{n} over capacity" for n in over_capacity(nodes, pods)]
        if bad or result.churn_create_errors:
            raise RuntimeError(f"17(d) {workload}: {bad}, create errors "
                               f"{result.churn_create_errors}")
        launches[workload] = runner.window["launches"]
        curves[workload] = curve
        if params["descheduler"]:
            captured = log["last_inputs"]
    off = curves["200Nodes-deschedulerOff"]
    on = curves["200Nodes-deschedulerOn"]
    print(f"rebalance on below off (occupied fragmentation, printed, not "
          f"gated): final {on[-1][2] < off[-1][2]} ({on[-1][2]} against "
          f"{off[-1][2]}); {curve_view(on)} on, {curve_view(off)} off")
    if captured is None:
        raise RuntimeError("17(d): the descheduler scored no cycle")
    return launches, captured


def consolidation_phase(torch, captured: tuple, seed: int) -> None:
    """Phase 17(e): `consolidation_scores` on the card against the same
    call on the CPU, bitwise, on 17(d)'s last rebalance state and on a
    random 50,000-node state; CUDA-event ms per call."""
    from kubernetes_tpu_torch.ops import solver

    t0 = time.perf_counter()
    rand = consolidation_case("random", seed, 50000)
    cases = (("17(d) rebalance state", captured[:4], captured[4]),
             ("random 50000 nodes", tuple(map(torch.from_numpy, rand[:4])),
              rand[4]))
    for label, args, thr in cases:
        want = solver.consolidation_scores(*args, thr)
        on_card = tuple(a.to("cuda:0") for a in args)
        got = solver.consolidation_scores(*on_card, thr)
        same = torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
        ms = cuda_ms(torch, lambda: solver.consolidation_scores(
            *on_card, thr), 200)
        n = int(args[0].shape[0])
        print(f"compare consolidation_scores {label} ({n} nodes), card vs "
              f"CPU: {'identical bits' if same else 'DIFFER'}; candidates "
              f"{int(torch.isfinite(want).sum())}; {ms:.5f} ms per call "
              f"(CUDA events)")
        if not same:
            raise RuntimeError(f"17(e): consolidation_scores {label} differs")
    print(f"phase 17(e) {time.perf_counter() - t0:.1f} s")


def provenance_trace_phase(torch) -> None:
    """Phase 17(f): `solve_provenance()`, then SchedulingGated/100Nodes
    through a `PerfRunner` with a `profile_dir`: one trace file, naming
    the wave_solve kernel."""
    import glob
    import shutil

    from kubernetes_tpu_torch.ops.backend import TorchBackend, solve_provenance
    from kubernetes_tpu_torch.perf.scheduler_perf import (PerfRunner,
                                                          SCHEDULING_GATED)

    t0 = time.perf_counter()
    prov = solve_provenance()
    print(f"solve_provenance(): {json.dumps(prov)}")
    if prov["solve_kernel"] != "cuda" or not prov.get("power_limit"):
        raise RuntimeError(f"17(f): provenance {prov}")
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "traces", "phase17f")
    shutil.rmtree(trace_dir, ignore_errors=True)
    runner = PerfRunner(backend=TorchBackend(), batch_size=LOOP_BATCH,
                        profile_dir=trace_dir)
    result = asyncio.run(runner.run(
        SCHEDULING_GATED["workloadTemplate"],
        SCHEDULING_GATED["workloads"][0]["params"], timeout=600.0))
    files = sorted(glob.glob(os.path.join(trace_dir, "*.json")))
    events = []
    if len(files) == 1:
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    kernels = sum("wave_solve_kernel" in n for n in names)
    print(f"profiled SchedulingGated/100Nodes (profile_dir): "
          f"{result.throughput:.2f} pods/s, trace {files} "
          f"({os.path.getsize(files[0]) if files else 0} bytes), "
          f"{len(events)} events, {len(names)} device kernels of "
          f"{len(set(names))} names, wave_solve_kernel events {kernels}; "
          f"the result's provenance "
          f"{'equals' if result.solve_provenance == prov else 'DIFFERS from'}"
          f" the call's; phase 17(f) {time.perf_counter() - t0:.1f} s")
    if not kernels or result.solve_provenance != prov \
            or result.measured_pods != 1000:
        raise RuntimeError(f"17(f): traces {files}, kernel events {kernels}, "
                           f"provenance {result.solve_provenance}")


def runner_families_run(torch, seed: int) -> dict:
    """Phase 17 (see the module docstring), under a scoped
    KTPU_SOLVE_MODE=auto with serving on. Returns the kernels line's phase
    17 entries: wave_solve's launches in the measured windows of 17(a)-(d)."""
    from kubernetes_tpu_torch.utils import flags

    t17 = time.perf_counter()
    print(f"phase 17 on {card_line()}")
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        out = {"gated_launches": gated_phase(torch)}
        storm = relist_storm_phase(torch)
        out["relist_storm_2000_launches"] = storm["2000Agents"]
        out["relist_storm_5000_launches"] = storm["5000Agents"]
        out["node_death_launches"] = node_death_phase(torch)
        rebalance, captured = rebalance_phase(torch)
        out["rebalance_off_launches"] = rebalance["200Nodes-deschedulerOff"]
        out["rebalance_on_launches"] = rebalance["200Nodes-deschedulerOn"]
        consolidation_phase(torch, captured, seed)
        provenance_trace_phase(torch)
    print(f"phase 17 {time.perf_counter() - t17:.1f} s")
    return out


def runner_families_phases(torch, seed: int) -> int:
    """`--phase17-only`: build the kernels (phase 1), then phase 17."""
    from kubernetes_tpu_torch.ops import wave_kernel

    t0 = time.perf_counter()
    lib = wave_kernel.LIBRARY.build()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib.path.name})")
    print(json.dumps(runner_families_run(torch, seed)))
    print_card()
    return 0


# -- phase 18: the apiserver boundary and the policy chain -----------------

#: Policy evaluations per pod create under PolicyScale's 1000/100 tenant
#: layout: the measured pods ride "default", labeled tenant t0, whose
#: shard holds 10 pod policies, one of them with a second, paramRef
#: binding and a matchConditions prefilter (tests/test_torch_policy.py
#: pins it against the JAX runner).
POLICY_SCALE_EVALS_PER_POD = 12
#: 18(c)'s HTTP cell: SchedulingBasic's template at 500 nodes, 100 + 1000
#: pods, 10 uniform policies (each matches every pod create once).
HTTP_CELL = {"initNodes": 500, "initPods": 100, "measurePods": 1000}
HTTP_CELL_POLICIES = 10


def policy_violations(runner, result, pods: list, want_pods: int,
                      evals_per_pod: int) -> list[str]:
    """Phase 18's gates on a boundary-crossing run: every pod bound, no
    policy denial, the measured window's evaluations equal to its pods
    times `evals_per_pod`, and the O(matching) index serving them (hits
    when there are policies)."""
    bad = []
    bound = sum(bool((p.get("spec") or {}).get("nodeName")) for p in pods)
    if bound != want_pods or len(pods) != want_pods:
        bad.append(f"{bound}/{len(pods)} pods bound of {want_pods}")
    engine = runner._policy_engine
    if engine is None:
        return bad + ["no PolicyEngine: the run did not cross the boundary"]
    denied = sum(engine.rejections._values.values())
    if denied:
        bad.append(f"{denied} policy denials")
    want = result.measured_pods * evals_per_pod
    if result.policy_evaluations_total != want:
        bad.append(f"policy_evaluations_total "
                   f"{result.policy_evaluations_total} != {want}")
    if evals_per_pod and result.policy_index_hits_total <= 0:
        bad.append("no policy index hit in the window")
    return bad


def wire_codec(client) -> str:
    """The frame codec a WireStore speaks ("msgpack" or "json"), or the
    client's transport name for another store."""
    from kubernetes_tpu_torch.apiserver import wire

    if isinstance(client, wire.WireStore):
        return "msgpack" if client._encode is wire._packb else "json"
    return type(client).__name__


def boundary_run(torch, family: dict, workload: str, params: dict | None,
                 **boundary) -> tuple:
    """One run of `family`'s workload through `counting_runner_cls`'s
    PerfRunner with `TorchBackend()` across the apiserver boundary
    (`through_apiserver`, `policy_count`, `policy_tenants`). Returns
    (runner, result, the store's pods after the run)."""
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    if params is None:
        params = next(w["params"] for w in family["workloads"]
                      if w["name"] == workload)
    runner = counting_runner_cls(torch)(TorchBackend(), None, **boundary)
    result = asyncio.run(runner.run(family["workloadTemplate"], params,
                                    timeout=900.0))
    pods = asyncio.run(runner.store.list("pods")).items
    return runner, result, pods


def boundary_line(label: str, runner, result) -> str:
    r, w = result.as_dict(), runner.window
    return (f"{label} (PerfRunner, Scheduler.run, TorchBackend(), "
            f"batch_size {LOOP_BATCH}, {wire_codec(runner.client)}): "
            f"SchedulingThroughput {r['throughput_pods_per_sec']} pods/s, "
            f"measured_seconds {result.measured_seconds:.6f}, attempt ms "
            f"p50 {r['attempt_p50_ms']} p99 {r['attempt_p99_ms']} p999 "
            f"{r['attempt_p999_ms']}, staging_seconds "
            f"{result.staging_seconds:.6f}; policy evaluations "
            f"{result.policy_evaluations_total}, index hits "
            f"{result.policy_index_hits_total}, residue scans "
            f"{result.policy_index_residue_scans_total}, rebuilds "
            f"{result.policy_index_rebuilds_total}, audit events "
            f"{result.audit_events_total}; wave_solve launches in the "
            f"window {w['launches']}, backend dispatches "
            f"{w['routes']['backend_dispatches']} with "
            f"{w['routes']['backend_pods']} pods, fast-path pods "
            f"{r['serving_fast_path_pods_total']}")


def policy_scale_phase(torch) -> tuple:
    """Phase 18(a): PolicyScale/5000Nodes-1kPolicies at the YAML's
    parameters over the KTPU wire. Returns (wave_solve's launches in the
    window, the pods/s)."""
    from kubernetes_tpu_torch.perf.scheduler_perf import POLICY_SCALE

    t0 = time.perf_counter()
    fam = POLICY_SCALE
    runner, result, pods = boundary_run(
        torch, fam, "5000Nodes-1kPolicies", None,
        through_apiserver=fam["throughApiserver"],
        policy_count=fam["policyCount"], policy_tenants=fam["policyTenants"])
    params = fam["workloads"][0]["params"]
    bad = policy_violations(runner, result, pods,
                            params["initPods"] + params["measurePods"],
                            POLICY_SCALE_EVALS_PER_POD)
    prov = result.solve_provenance
    if not (prov.get("card_name") and prov.get("power_limit")):
        bad.append(f"solve_provenance {prov}")
    if not runner.window["launches"]:
        bad.append("no wave_solve launch in the measured window")
    if wire_codec(runner.client) not in ("msgpack", "json"):
        bad.append(f"the run's store is {wire_codec(runner.client)}, "
                   "not the KTPU wire")
    print(boundary_line("policy scale PolicyScale/5000Nodes-1kPolicies",
                        runner, result)
          + f"; solve_provenance {json.dumps(prov)}; phase 18(a) "
          f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise RuntimeError(f"18(a): {bad}")
    return runner.window["launches"], result.throughput


def wire_basic_phase(torch, policy_rate: float) -> tuple:
    """Phase 18(b): SchedulingBasic/5000Nodes over the same wire with no
    policies: every pod bound; prints 18(a)'s throughput over it (a
    number, not a gate). Returns (wave_solve's launches in the window, the
    pods/s)."""
    from kubernetes_tpu_torch.perf.scheduler_perf import SCHEDULING_BASIC

    t0 = time.perf_counter()
    runner, result, pods = boundary_run(
        torch, SCHEDULING_BASIC, "5000Nodes", None,
        through_apiserver="wire")
    bad = policy_violations(runner, result, pods, 11000, 0)
    print(boundary_line("wire SchedulingBasic/5000Nodes, no policies",
                        runner, result)
          + f"; PolicyScale over it {policy_rate / result.throughput:.4f} "
          f"(printed, not gated); phase 18(b) "
          f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise RuntimeError(f"18(b): {bad}")
    return runner.window["launches"], result.throughput


def http_phase(torch) -> int:
    """Phase 18(c): SchedulingBasic at HTTP_CELL through `RemoteStore`
    with 10 uniform policies: every pod bound, 10 evaluations per
    measured pod. Pods cross HTTP one request at a time, so the serving
    fast path may take all of them. Returns wave_solve's launches in the
    window."""
    from kubernetes_tpu_torch.perf.scheduler_perf import SCHEDULING_BASIC

    t0 = time.perf_counter()
    runner, result, pods = boundary_run(
        torch, SCHEDULING_BASIC, "", HTTP_CELL, through_apiserver="http",
        policy_count=HTTP_CELL_POLICIES)
    bad = policy_violations(runner, result, pods,
                            HTTP_CELL["initPods"] + HTTP_CELL["measurePods"],
                            HTTP_CELL_POLICIES)
    print(boundary_line("http SchedulingBasic/500Nodes, 10 policies",
                        runner, result)
          + f"; phase 18(c) "
          f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise RuntimeError(f"18(c): {bad}")
    return runner.window["launches"]


def boundary_run_phases(torch) -> tuple:
    """Phase 18 (see the module docstring), under a scoped
    KTPU_SOLVE_MODE=auto with serving on. Returns the kernels line's phase
    18 entries (wave_solve's launches in the measured windows of
    18(a)-(c)) and 18(b)'s pods/s."""
    from kubernetes_tpu_torch.utils import flags

    t18 = time.perf_counter()
    print(f"phase 18 on {card_line()}")
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        launches, rate = policy_scale_phase(torch)
        wire_launches, wire_rate = wire_basic_phase(torch, rate)
        out = {"policy_scale_launches": launches,
               "wire_basic_launches": wire_launches,
               "http_basic_launches": http_phase(torch)}
    print(f"phase 18 {time.perf_counter() - t18:.1f} s")
    return out, wire_rate


def boundary_phases(torch) -> int:
    """`--phase18-only`: build the kernels (phase 1), then phase 18."""
    from kubernetes_tpu_torch.ops import wave_kernel

    t0 = time.perf_counter()
    lib = wave_kernel.LIBRARY.build()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib.path.name})")
    print(json.dumps(boundary_run_phases(torch)[0]))
    print_card()
    return 0


REPO = os.path.dirname(os.path.abspath(__file__))
#: Phase 19's KubeSchedulerConfiguration: leader election on a 6 s lease
#: (the lease of the reference's r22 failover row), the renew deadline and
#: retry period in the reference's 15/10/2 proportions.
CONTROL_PLANE_CONFIG = """\
apiVersion: kubescheduler.config.k8s.io/v1
kind: KubeSchedulerConfiguration
leaderElection:
  leaderElect: true
  leaseDuration: 6s
  renewDeadline: 4s
  retryPeriod: 0.8s
"""
#: Audit only the schedulers' pod updates (their bindings), so 19(b) can
#: name the process that bound each canary.
CONTROL_PLANE_AUDIT = """\
apiVersion: audit.k8s.io/v1
kind: Policy
rules:
- level: Metadata
  users: [sched-a, sched-b, sched-c]
  verbs: [update]
  resources: [pods]
  omitStages: [RequestReceived]
"""
N_AGENTS = 4
N_CANARIES = 100
AGENT_ALLOCATABLE = "cpu=8,memory=32Gi,pods=110"
LEASE_KEY = "kube-system/kube-scheduler"
#: the apiserver's group-commit tick (DurabilityManager's flush interval).
FLUSH_INTERVAL_S = 0.05
LEADING = r"scheduler (\S+) started leading; solve_provenance (.*)"
STOPPING = r"scheduler stopping on SIGTERM; kernel launches (\{.*\})"


class Child:
    """A control-plane process started as a fresh interpreter (`python -m
    <module> <args>` from the repository root; never a fork of a parent
    that holds a CUDA context). Its stdout and stderr go to one log file,
    which `line` scans. A child that exits early is reported with its exit
    code and the tail of its log."""

    def __init__(self, name: str, module: str, args, log_dir: str,
                 env: dict | None = None):
        self.name = name
        self.log_path = os.path.join(log_dir, f"{name}.log")
        self._log = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *map(str, args)], cwd=REPO,
            stdin=subprocess.DEVNULL, stdout=self._log,
            stderr=subprocess.STDOUT, env={**os.environ, **(env or {})})

    def text(self) -> str:
        with open(self.log_path, errors="replace") as f:
            return f.read()

    def failure(self, what: str) -> RuntimeError:
        tail = "\n".join(self.text().splitlines()[-30:])
        return RuntimeError(f"{self.name} (pid {self.proc.pid}, exit code "
                            f"{self.proc.poll()}): {what}; log tail:\n{tail}")

    async def line(self, pattern: str, timeout: float) -> re.Match:
        """The first match of `pattern` in the log, waiting up to
        `timeout` s; raises if the child exits or the time runs out."""
        rx = re.compile(pattern)
        deadline = time.monotonic() + timeout
        while True:
            m = rx.search(self.text())
            if m:
                return m
            if self.proc.poll() is not None:
                raise self.failure(f"exited before logging {pattern!r}")
            if time.monotonic() > deadline:
                raise self.failure(f"no {pattern!r} within {timeout} s")
            await asyncio.sleep(0.05)

    def check_alive(self) -> None:
        if self.proc.poll() is not None:
            raise self.failure("exited")

    async def exit_code(self, timeout: float) -> int:
        deadline = time.monotonic() + timeout
        while self.proc.poll() is None:
            if time.monotonic() > deadline:
                self.proc.kill()
                self.proc.wait(10)
                raise self.failure(f"still running {timeout} s after a signal")
            await asyncio.sleep(0.05)
        return self.proc.returncode

    async def stop(self, timeout: float = 60.0) -> int:
        """SIGTERM and the exit code (the entry points exit 0 on it)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        return await self.exit_code(timeout)

    async def kill(self) -> int:
        self.proc.send_signal(signal.SIGKILL)
        return await self.exit_code(30.0)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10)
        self._log.close()


def apiserver_child(log_dir: str, name: str, *args) -> Child:
    return Child(name, "kubernetes_tpu_torch.apiserver", args, log_dir)


async def apiserver_addresses(child: Child, timeout: float) -> tuple:
    """(HTTP port, wire target) from the child's "listening" lines."""
    http = await child.line(r"root:apiserver listening on "
                            r"http://127\.0\.0\.1:(\d+)", timeout)
    wire = await child.line(r"root:wire listening on (\S+)", timeout)
    return int(http.group(1)), wire.group(1)


def scheduler_child(log_dir: str, name: str, wire: str, config: str,
                    token: str | None = None, gates: str = "TPUScorer=true",
                    env: dict | None = None) -> Child:
    args = ["--wire", wire, "--config", config, "--batch-size", LOOP_BATCH,
            "--feature-gates", gates]
    if token:
        args += ["--token", token]
    return Child(name, "kubernetes_tpu_torch.scheduler", args, log_dir,
                 env=env)


def agent_child(log_dir: str, node: str, wire: str) -> Child:
    return Child(node, "kubernetes_tpu_torch.agent", [
        "--node", node, "--server", wire,
        "--checkpoint-dir", os.path.join(log_dir, node),
        "--allocatable", AGENT_ALLOCATABLE], log_dir)


class BindLog:
    """What the parent's pod informer saw: per pod, every distinct
    nodeName in order and the host time of the first."""

    def __init__(self):
        self.nodes: dict[str, list[str]] = {}
        self.bound_at: dict[str, float] = {}

    def see(self, pod: dict) -> None:
        name = pod["metadata"]["name"]
        node = (pod.get("spec") or {}).get("nodeName")
        seq = self.nodes.setdefault(name, [])
        if node and (not seq or seq[-1] != node):
            seq.append(node)
            self.bound_at.setdefault(name, time.perf_counter())

    def handler(self):
        from kubernetes_tpu_torch.client import ResourceEventHandler

        return ResourceEventHandler(on_add=self.see,
                                    on_update=lambda _old, new: self.see(new))

    def unbound(self, names) -> list[str]:
        return [n for n in names if not self.nodes.get(n)]

    def rebound(self) -> list[str]:
        return [n for n, seq in self.nodes.items() if len(seq) > 1]


async def create_all(store, resource: str, objs: list,
                     window: int = 512) -> None:
    for i in range(0, len(objs), window):
        await asyncio.gather(*(store.create(resource, o)
                               for o in objs[i:i + window]))


async def wait_bound(log: BindLog, names, children, timeout: float) -> None:
    """Until the informer saw every pod of `names` bound; every child must
    stay alive meanwhile."""
    deadline = time.monotonic() + timeout
    while True:
        left = log.unbound(names)
        if not left:
            return
        for c in children:
            c.check_alive()
        if time.monotonic() > deadline:
            raise RuntimeError(f"{len(left)} pods unbound after {timeout} s, "
                               f"e.g. {left[:5]}")
        await asyncio.sleep(0.05)


async def first_leader(scheds: dict, timeout: float) -> tuple:
    """(name, identity, solve_provenance) of the scheduler child that logs
    that it started leading first."""
    deadline = time.monotonic() + timeout
    while True:
        for name, child in scheds.items():
            m = re.search(LEADING, child.text())
            if m:
                return name, m.group(1), json.loads(m.group(2))
            child.check_alive()
        if time.monotonic() > deadline:
            raise RuntimeError(f"no scheduler started leading in {timeout} s")
        await asyncio.sleep(0.05)


async def stop_launches(child: Child) -> dict:
    """SIGTERM a scheduler child; its launch counts from its stop line."""
    rc = await child.stop()
    m = re.search(STOPPING, child.text())
    if rc != 0 or m is None:
        raise child.failure(f"exit code {rc} on SIGTERM, stop line "
                            f"{'found' if m else 'missing'}")
    return json.loads(m.group(1))


def audit_events(path: str, verb: str) -> list[dict]:
    """The ResponseComplete events of `verb` in an apiserver's audit log."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            ev = json.loads(line)
            if ev.get("stage") == "ResponseComplete" and \
                    ev.get("verb") == verb:
                out.append(ev)
    return out


def binding_users(audit_path: str) -> dict[str, list[str]]:
    """{pod name: the users of its successful binding updates}, from an
    apiserver's audit log (its policy audits the schedulers' updates)."""
    out: dict[str, list[str]] = {}
    for ev in audit_events(audit_path, "update"):
        if ev["responseStatus"]["code"] < 300:
            out.setdefault(ev["objectRef"]["name"], []).append(
                ev["user"]["username"])
    return out


def newest_snapshot_rv(data_dir: str) -> int:
    rvs = [int(fn[len("snapshot-"):-len(".json")])
           for fn in os.listdir(data_dir)
           if fn.startswith("snapshot-") and fn.endswith(".json")]
    return max(rvs, default=0)


def pod_view(pods) -> dict:
    return {p["metadata"]["name"]: ((p.get("spec") or {}).get("nodeName"),
                                    int(p["metadata"]["resourceVersion"]))
            for p in pods}


async def control_plane(torch, log_dir: str) -> dict:
    """Phase 19 (see the module docstring). Returns its numbers and the
    schedulers' launch counts; raises on a failed gate or child."""
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.apiserver.wire import WireStore
    from kubernetes_tpu_torch.client import InformerFactory
    from kubernetes_tpu_torch.store import Expired

    data_dir = os.path.join(log_dir, "data")
    os.makedirs(data_dir)
    config = os.path.join(log_dir, "scheduler-config.yaml")
    audit_policy = os.path.join(log_dir, "audit-policy.yaml")
    for path, text in ((config, CONTROL_PLANE_CONFIG),
                       (audit_policy, CONTROL_PLANE_AUDIT)):
        with open(path, "w") as f:
            f.write(text)
    tokens = ["--token", "admin-token=admin"]
    for s in "abc":
        tokens += ["--token", f"sched-{s}-token=sched-{s}"]

    def apiserver_args(audit_log: str, port: int, wire_port: int) -> list:
        return ["--port", port, "--wire-port", wire_port, "--data-dir",
                data_dir, "--fsync", "batch", *tokens, "--audit-policy",
                audit_policy, "--audit-log-path",
                os.path.join(log_dir, audit_log), "--audit-log-maxsize-mb",
                1024]

    out: dict = {}
    children: list[Child] = []
    store = factory = None
    try:
        # -- the apiserver, the agents, the cluster, two schedulers ---------
        t0 = time.perf_counter()
        api = apiserver_child(log_dir, "apiserver",
                              *apiserver_args("audit.log", 0, 0))
        children.append(api)
        http_port, wire = await apiserver_addresses(api, 120.0)
        # The schedulers boot (torch, the card, the probe) while the
        # cluster is staged; their informers see the nodes arrive.
        scheds = {s: scheduler_child(log_dir, f"scheduler-{s}", wire, config,
                                     f"sched-{s}-token") for s in "ab"}
        children += scheds.values()
        agents = [agent_child(log_dir, f"agent-node-{i}", wire)
                  for i in range(N_AGENTS)]
        children += agents
        store = WireStore(wire, token="admin-token", user_agent="chip-smoke")
        await create_all(store, "nodes", [
            make_node(f"node-{i}") for i in range(N_NODES - N_AGENTS)])
        for a in agents:
            await a.line(r"agent \S+ running against", 120.0)
        log = BindLog()
        factory = InformerFactory(store)
        factory.informer("pods").add_event_handler(log.handler())
        factory.start()
        await factory.wait_for_sync(60.0)
        for c in scheds.values():
            await c.line(r"scheduler running \(batch=", 300.0)
        lead, lead_id, prov = await first_leader(scheds, 60.0)
        standby = "b" if lead == "a" else "a"
        out["staging_s"] = time.perf_counter() - t0

        # -- 19(a) ------------------------------------------------------------
        init = [make_pod(f"init-{i}", requests=POD_REQUESTS)
                for i in range(N_INIT)]
        await create_all(store, "pods", init)
        await wait_bound(log, [p["metadata"]["name"] for p in init],
                         children, 300.0)
        measured = [make_pod(f"pod-{i}", requests=POD_REQUESTS)
                    for i in range(N_MEASURED)]
        names = [p["metadata"]["name"] for p in measured]
        t1 = time.perf_counter()
        await create_all(store, "pods", measured)
        await wait_bound(log, names, children, 300.0)
        window = max(log.bound_at[n] for n in names) - t1
        pods = (await store.list("pods")).items
        nodes = (await store.list("nodes")).items
        lease = await store.get("leases", LEASE_KEY)
        bad = []
        if len(pods) != N_INIT + N_MEASURED or log.rebound():
            bad.append(f"{len(pods)} pods, rebound {log.rebound()[:5]}")
        bad += [f"{p['metadata']['name']} on {p['spec'].get('nodeName')}, "
                f"informer saw {log.nodes.get(p['metadata']['name'])}"
                for p in pods
                if [p["spec"].get("nodeName")]
                != log.nodes.get(p["metadata"]["name"])][:5]
        over = over_capacity(nodes, pods)
        if over:
            bad.append(f"nodes over capacity {over[:5]}")
        holder = lease["spec"]["holderIdentity"]
        if holder != lead_id or re.search(LEADING, scheds[standby].text()):
            bad.append(f"lease holder {holder}, leader {lead_id}, the "
                       f"standby's log names itself leader too")
        if prov is None or prov.get("solve_kernel") != "cuda":
            bad.append(f"the leader's solve_provenance {prov}")
        # The leader's launch counts come from its stop line: a SIGTERM
        # hands the lease to the standby on expiry.
        t_term = time.perf_counter()
        launches = await stop_launches(scheds[lead])
        if launches["wave_solve"] <= 0:
            bad.append(f"the leader launched no wave_solve: {launches}")
        out.update(rate=N_MEASURED / window, window_s=window,
                   leader_launches=launches)
        print(f"control plane 19(a) SchedulingBasic/5000Nodes through "
              f"processes (apiserver --data-dir, fsync batch; scheduler-a "
              f"and -b leader-elected on a 6 s lease, TorchBackend() on "
              f"cuda:0, batch_size {LOOP_BATCH}; {N_AGENTS} agents; the "
              f"parent creates over the KTPU wire): {out['rate']:.2f} pods/s "
              f"({N_MEASURED} measured pods, {window:.6f} s from the first "
              f"measured create to the last bind the parent's informer saw);"
              f" staging {out['staging_s']:.3f} s; leader scheduler-{lead} "
              f"({lead_id}), lease holder {holder}; every pod bound once "
              f"({len(pods)}), nodes over capacity {len(over)}; leader "
              f"solve_provenance {json.dumps(prov)}; leader kernel launches "
              f"{json.dumps(launches)}")
        if bad:
            raise RuntimeError(f"19(a): {bad}")

        # -- a third scheduler; the standby or it takes the lease ------------
        # Whichever of the two leads next is 19(b)'s victim; the other must
        # take over from it.
        scheds["c"] = scheduler_child(log_dir, "scheduler-c", wire, config,
                                      "sched-c-token")
        children.append(scheds["c"])
        pair = {s: scheds[s] for s in (standby, "c")}
        victim, dead_id, _ = await first_leader(pair, 60.0)
        out["handover_s"] = time.perf_counter() - t_term
        survivor = standby if victim == "c" else "c"
        live = scheds[survivor]
        await live.line(r"scheduler running \(batch=", 300.0)

        # -- 19(b) ------------------------------------------------------------
        t_kill = time.perf_counter()
        rc = await scheds[victim].kill()
        canaries = [make_pod(f"canary-{i}", requests=POD_REQUESTS)
                    for i in range(N_CANARIES)]
        cnames = [p["metadata"]["name"] for p in canaries]
        await create_all(store, "pods", canaries)
        await wait_bound(log, cnames, [api, live, *agents], 120.0)
        out["failover_s"] = max(log.bound_at[n] for n in cnames) - t_kill
        m = await live.line(LEADING, 10.0)
        holder = (await store.get("leases", LEASE_KEY))["spec"][
            "holderIdentity"]
        deadline = time.monotonic() + 30.0
        while True:
            users = binding_users(os.path.join(log_dir, "audit.log"))
            if all(n in users for n in cnames) or \
                    time.monotonic() > deadline:
                break
            await asyncio.sleep(0.2)
        bad = []
        if rc != -9:
            bad.append(f"scheduler-{victim} exit code {rc} on SIGKILL")
        if holder != m.group(1):
            bad.append(f"lease holder {holder}, scheduler-{survivor} is "
                       f"{m.group(1)}")
        wrong = {n: users.get(n) for n in cnames
                 if users.get(n) != [f"sched-{survivor}"]}
        if wrong:
            bad.append(f"canary bindings not by sched-{survivor} alone: "
                       f"{dict(list(wrong.items())[:5])}")
        if log.rebound():
            bad.append(f"rebound after the kill: {log.rebound()[:5]}")
        print(f"control plane 19(b) failover: SIGKILL of scheduler-{victim} "
              f"({dead_id}, the lease holder {out['handover_s']:.3f} s after "
              f"the SIGTERM of scheduler-{lead}), {N_CANARIES} canary pods "
              f"created after its exit: {out['failover_s']:.3f} s from the "
              f"kill to the last canary bound; lease holder {holder} "
              f"(scheduler-{survivor}); every canary bound once, by "
              f"sched-{survivor} (audit log), no pod rebound")
        if bad:
            raise RuntimeError(f"19(b): {bad}")

        # -- 19(d) ------------------------------------------------------------
        # No requests: the flagless route packs 80 pods of cpu 100m onto
        # a node, and the agents' nodes sort first.
        agent_nodes = [f"agent-node-{i}" for i in range(N_AGENTS)]
        pinned = [make_pod(f"agent-pod-{i}",
                           node_selector={"kubernetes.io/hostname": n})
                  for i, n in enumerate(agent_nodes)]
        t_pin = time.perf_counter()
        await create_all(store, "pods", pinned)
        deadline = time.monotonic() + 60.0
        while True:
            pods = (await store.list("pods")).items
            on_agents = [p for p in pods
                         if p["spec"].get("nodeName") in agent_nodes]
            waiting = [p["metadata"]["name"] for p in on_agents
                       if (p.get("status") or {}).get("phase") != "Running"]
            pinned_on = {p["metadata"]["name"]: p["spec"].get("nodeName")
                         for p in pods
                         if p["metadata"]["name"].startswith("agent-pod-")}
            if not waiting and all(pinned_on.values()):
                break
            for c in (api, live, *agents):
                c.check_alive()
            if time.monotonic() > deadline:
                raise RuntimeError(f"19(d): not Running {waiting[:5]}, "
                                   f"pinned {pinned_on}")
            await asyncio.sleep(0.1)
        registered = {n["metadata"]["name"]
                      for n in (await store.list("nodes")).items}
        bad = [n for n in agent_nodes if n not in registered]
        bad += [f"agent-pod-{i} on {pinned_on[f'agent-pod-{i}']}"
                for i, n in enumerate(agent_nodes)
                if pinned_on[f"agent-pod-{i}"] != n]
        print(f"control plane 19(d) agents: {len(agent_nodes)} nodes "
              f"registered by agent processes, {len(on_agents)} pods bound "
              f"to them all marked Running (the {N_AGENTS} pinned pods "
              f"{time.perf_counter() - t_pin:.3f} s from create)")
        if bad:
            raise RuntimeError(f"19(d): {bad}")

        # -- 19(c) ------------------------------------------------------------
        # Quiescent pods; the last RV read after the newest snapshot on
        # disk, then two flush intervals and more before the kill.
        while True:
            before = await store.list("pods")
            await asyncio.sleep(3 * FLUSH_INTERVAL_S)
            if newest_snapshot_rv(data_dir) <= before.resource_version:
                break
        t_down = time.perf_counter()
        rc = await api.kill()
        api2 = apiserver_child(log_dir, "apiserver-2", *apiserver_args(
            "audit-2.log", http_port, int(wire.rpartition(":")[2])))
        children.append(api2)
        await apiserver_addresses(api2, 120.0)
        out["restart_s"] = time.perf_counter() - t_down
        after = await store.list("pods")
        want, got = pod_view(before.items), pod_view(after.items)
        bad = []
        if rc != -9:
            bad.append(f"apiserver exit code {rc} on SIGKILL")
        if got != want:
            diff = sorted(n for n in set(want) | set(got)
                          if want.get(n) != got.get(n))
            bad.append(f"{len(diff)} pods differ after the restart, e.g. "
                       f"{[(n, want.get(n), got.get(n)) for n in diff[:3]]}")
        top = max(rv for _, rv in want.values())
        if max(rv for _, rv in got.values()) != top or \
                after.resource_version < before.resource_version:
            bad.append(f"highest pod RV {top} -> "
                       f"{max(rv for _, rv in got.values())}, list RV "
                       f"{before.resource_version} -> "
                       f"{after.resource_version}")
        watch = await store.watch("pods",
                                  resource_version=before.resource_version)
        await store.create("pods", make_pod("after-restart",
                                            requests=POD_REQUESTS))
        seen: list = []
        try:
            async with asyncio.timeout(30.0):
                async for ev in watch:
                    if ev.type == "BOOKMARK":
                        continue
                    seen.append((ev.type, ev.object["metadata"]["name"],
                                 ev.rv))
                    if ev.object["metadata"]["name"] == "after-restart":
                        break
        except Expired as e:
            bad.append(f"the watch from RV {before.resource_version} "
                       f"expired: {e}")
        rvs = [rv for *_, rv in seen]
        if not seen or seen[-1][:2] != ("ADDED", "after-restart") or \
                rvs != sorted(rvs) or rvs[0] <= before.resource_version:
            bad.append(f"resumed watch saw {seen[:5]}")
        print(f"control plane 19(c) apiserver SIGKILL "
              f"{FLUSH_INTERVAL_S * 3:.2f} s after the last read, restart on the same data dir: "
              f"{out['restart_s']:.3f} s from the kill to listening again; "
              f"{len(got)} pods back with their nodeName and RV (highest "
              f"{top}), list RV {before.resource_version} -> "
              f"{after.resource_version}; the watch resumed from RV "
              f"{before.resource_version} saw {len(seen)} events, the first "
              f"{seen[:1]}")
        if bad:
            raise RuntimeError(f"19(c): {bad}")

        # -- stop every process; the survivor's launch counts -----------------
        out["failover_launches"] = await stop_launches(live)
        factory.stop()
        factory = None
        await store.close()
        store = None
        rcs = {a.name: await a.stop() for a in agents}
        rcs[api2.name] = await api2.stop()
        if any(rcs.values()):
            raise RuntimeError(f"19: exit codes on SIGTERM {rcs}")
        print(f"control plane stop: scheduler-{survivor} kernel launches "
              f"{json.dumps(out['failover_launches'])}; agents and "
              f"apiserver exit codes {rcs}")
        return out
    finally:
        if factory is not None:
            factory.stop()
        if store is not None:
            await store.close()
        for c in children:
            c.close()


def control_plane_run(torch) -> dict:
    """Phase 19 (see the module docstring), under a scoped
    KTPU_SOLVE_MODE=auto with serving on (the children inherit both).
    Returns the kernels line's phase 19 entries."""
    import shutil

    from kubernetes_tpu_torch.utils import flags

    t19 = time.perf_counter()
    print(f"phase 19 on {card_line()}")
    log_dir = os.path.join(REPO, "build", "phase19")
    shutil.rmtree(log_dir, ignore_errors=True)
    os.makedirs(log_dir)
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        out = asyncio.run(control_plane(torch, log_dir))
    print(f"phase 19 {time.perf_counter() - t19:.1f} s")
    lead, fail = out["leader_launches"], out["failover_launches"]
    return {"wave_solve": {"control_plane_launches": lead["wave_solve"],
                           "control_plane_failover_launches":
                               fail["wave_solve"]},
            "probe": {"control_plane_launches": lead["probe"],
                      "control_plane_failover_launches": fail["probe"]}}


def control_plane_phases(torch) -> int:
    """`--phase19-only`: build the kernels (phase 1), then phase 19."""
    from kubernetes_tpu_torch.ops import wave_kernel

    t0 = time.perf_counter()
    lib = wave_kernel.LIBRARY.build()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib.path.name})")
    print(json.dumps(control_plane_run(torch)))
    print_card()
    return 0


# -- phase 20: the sharded and the multi-process control plane ---------------

#: bench.py's 200k preset (`PRESETS["200k"]`): nodes, warm-up pods, measured
#: pods, SchedulingBasic's node and pod templates.
HUGE_NODES, HUGE_WARMUP, HUGE_MEASURED = 200000, 500, 5000
#: Phase 20(c)'s lease (r22's failover row) and its fault.
KILL_LEADER_LEASE_S = 6.0
KILL_LEADER_AT_S = 3.0


def bench_preset(nodes: int, warmup: int, measured: int) -> dict:
    """A bench.py preset as a workload family (BENCH_50K's template)."""
    return {"name": "bench", "workloadTemplate":
            copy.deepcopy(BENCH_50K["workloadTemplate"]),
            "workloads": [{"name": f"{nodes}Nodes", "params": {
                "nodes": nodes, "warmup": warmup, "measured": measured}}]}


def huge_chunk_compare(torch, b, snapshot, fwk) -> dict:
    """20(a)'s kernel check at the loop's own launch shape: one full chunk
    (backend `b`'s `max_batch` pods) over the snapshot's nodes (the
    loop's 200,000 after its run), on the class planes, wave width and
    multistart orders (`dev_perms`, K of them) that the port's prep builds
    in `b`, through wave_solve and wave_solve_reference with the loop's
    poison contract: assignments and counters identical. Returns the
    kernel's and the plain version's ms per chunk, the bound and what
    bounds it."""
    from kubernetes_tpu_torch.api.types import make_pod
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import chunk_planes
    from kubernetes_tpu_torch.scheduler.types import PodInfo

    t0 = time.perf_counter()
    pods = [PodInfo(make_pod(f"chunk-{i}", requests=POD_REQUESTS))
            for i in range(b.max_batch)]
    ctx = b._start(pods, snapshot, fwk)
    prep = b._prep_chunk(ctx.chunks[0], ctx)
    st, prm = b.ensure_static(ctx.ct), ctx.params
    pl = chunk_planes(st["alloc_q"], b.used.pack, st["alloc_pods"],
                      prep["dev_pack"], prep["dev_cls"], st["taint_f"],
                      st["taint_p"], prep["dev_mask"], prep["dev_scores"],
                      prm["w_taint"], prm["taint_filter_on"])
    args = (pl["req_q"], pl["req_nz_q"], pl["free_q"], pl["free_pods"],
            pl["used_nz_q"], st["alloc_q"], pl["mask"], pl["static_scores"],
            prm["fit_col_w"], prm["bal_col_mask"], prm["shape_u"],
            prm["shape_s"], prm["w_fit"], prm["w_bal"], prm["strategy"])
    kw = dict(wave_w=prep["wave_w"], rows=prep["dev_cls"],
              exc=prep["dev_exc"], poison=True, perms=prep["dev_perms"])
    (p, r), n = pl["req_q"].shape, pl["free_q"].shape[0]
    k = kw["perms"].shape[0]
    plan = wave_kernel.wave_launch_plan(n, r, max(1, min(kw["wave_w"], p)))
    got = wave_kernel.wave_solve(*args, plan=plan, **kw)
    ref = wave_kernel.wave_solve_reference(*args, **kw)
    torch.cuda.synchronize()
    diff = int((got[0] - ref[0]).abs().max())
    same = all(torch.equal(g, w) for g, w in zip(got[1:], ref[1:]))
    clean = ~got[3]
    placed = int((got[0][clean] >= 0).sum())
    if p != len(pods) or diff or not same \
            or placed != int(clean.sum()) * len(pods):
        raise RuntimeError(f"20(a): wave_solve at N={n} differs from its "
                           f"plain version (max |assign diff| {diff}, "
                           f"counters identical {same}, placed {placed} "
                           f"by the orders not poisoned "
                           f"{clean.tolist()}, rows {p})")
    kernel_ms = cuda_ms(torch, lambda: wave_kernel.wave_solve(
        *args, plan=plan, **kw), 5)
    plain_ms = cuda_ms(torch, lambda: wave_kernel.wave_solve_reference(
        *args, **kw), 1)
    class_req = prep["dev_pack"][:, :r]
    feasible = pl["mask"] & (pl["free_pods"] >= 1)[None, :] & torch.all(
        class_req[:, None, :] <= pl["free_q"][None, :, :], dim=-1)
    evals = k * int(feasible.sum(dim=1)[prep["dev_cls"].long()].sum())
    bound_ms, bound_by = wave_bound_ms(p, n, r, pl["mask"].shape[0], k,
                                       prm["shape_u"].shape[0], evals)
    print(f"compare wave_solve 20(a) chunk ({p} pods, N={n} nodes, K={k} "
          f"multistart orders, W={kw['wave_w']}, poison on: the loop's "
          f"launch shape from the port's prep): max |assign diff| {diff}, "
          f"counters identical (commits {got[1].tolist()}, replays "
          f"{got[2].tolist()}, poisoned {got[3].tolist()}); plan {plan}; "
          f"kernel {kernel_ms:.5f} ms per "
          f"chunk, plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by}); {time.perf_counter() - t0:.1f} s")
    return {"huge_chunk_ms": kernel_ms, "huge_chunk_plain_ms": plain_ms,
            "huge_chunk_bound_ms": bound_ms, "huge_chunk_bound_by": bound_by}


def shard_runner_cls(torch):
    """PerfRunner that counts, over the measured window, wave_solve's
    launches (set to 0 just before the measured createPods, read just
    after), the backend's ClusterTensors builds, and those of them that
    took the delta path (`ClusterTensors.delta_build`: the static arrays
    shared with the build before, only the changed nodes' rows
    rewritten)."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.perf.scheduler_perf import PerfRunner

    class ShardRunner(PerfRunner):
        def __init__(self, backend, **kw):
            super().__init__(backend=backend, batch_size=LOOP_BATCH, **kw)
            self.window: dict = {}
            self.builds = self.delta_builds = 0
            tensors = backend._tensors

            def counted(snapshot):
                before = backend._ct
                ct = tensors(snapshot)
                if ct is not before:
                    self.builds += 1
                    self.delta_builds += ct.delta_build
                return ct

            backend._tensors = counted

        async def _drive(self, template_ops, params, timeout, backing,
                         store, metrics, sched, *rest):
            self.store, self.sched = backing, sched
            return await super()._drive(template_ops, params, timeout,
                                        backing, store, metrics, sched,
                                        *rest)

        def _begin_measure(self, metrics, backing):
            torch.cuda.synchronize()
            wave_kernel.wave_solve.launches = 0
            self.window = {"builds": self.builds,
                           "delta_builds": self.delta_builds}
            return super()._begin_measure(metrics, backing)

        def _end_measure(self, result, metrics, backing, base, count):
            super()._end_measure(result, metrics, backing, base, count)
            torch.cuda.synchronize()
            self.window["launches"] = wave_kernel.wave_solve.launches
            self.window["builds"] = self.builds - self.window["builds"]
            self.window["delta_builds"] = \
                self.delta_builds - self.window["delta_builds"]

    return ShardRunner


def sharded_200k_phase(torch, backend_factory, nodes: int = HUGE_NODES,
                       warmup: int = HUGE_WARMUP,
                       measured: int = HUGE_MEASURED) -> dict:
    """Phase 20(a): bench.py's 200k preset through the port's PerfRunner
    in process, flagless: `control_plane_shards` picks the shard count
    (8 above KTPU_SHARD_THRESHOLD) as bench.py does, and the runner builds
    the ShardedNodeStore; then `huge_chunk_compare` over the run's nodes,
    on its backend. Returns the kernels line's 20(a) entries."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.store import control_plane_shards

    t0 = time.perf_counter()
    shards = control_plane_shards(nodes)
    if shards != 8:
        raise RuntimeError(f"20(a): control_plane_shards({nodes}) = "
                           f"{shards}, not 8")
    family = bench_preset(nodes, warmup, measured)
    wave_kernel.probe.launches = 0
    backend = backend_factory()
    runner = shard_runner_cls(torch)(backend, shards=shards)
    result = asyncio.run(runner.run(
        family["workloadTemplate"], family["workloads"][0]["params"],
        timeout=900.0))
    pods = asyncio.run(runner.store.list("pods")).items
    used = {(p.get("spec") or {}).get("nodeName") for p in pods}
    node_objs = [n for n in asyncio.run(runner.store.list("nodes")).items
                 if n["metadata"]["name"] in used]
    bound = sum(bool((p.get("spec") or {}).get("nodeName")) for p in pods)
    over = over_capacity(node_objs, pods)
    r, w = result.as_dict(), runner.window
    prov = result.solve_provenance
    print(f"sharded 200k 20(a) bench.py's 200k preset ({nodes} nodes, "
          f"{warmup} + {measured} pods of cpu 100m / memory 250Mi; "
          f"PerfRunner, Scheduler.run, TorchBackend(), batch_size "
          f"{LOOP_BATCH}, in process, {shards} store shards flagless): "
          f"SchedulingThroughput {r['throughput_pods_per_sec']} pods/s, "
          f"measured_seconds {result.measured_seconds:.6f}, attempt ms p50 "
          f"{r['attempt_p50_ms']} p99 {r['attempt_p99_ms']} p999 "
          f"{r['attempt_p999_ms']} (exact {r['attempt_percentiles_exact']}); "
          f"staging {result.staging_seconds:.3f} s; shard_count "
          f"{r['shard_count']}, shard_tensor_rebuilds_total "
          f"{r['shard_tensor_rebuilds_total']} over {w['builds']} "
          f"ClusterTensors builds in the window ({w['delta_builds']} of "
          f"them delta builds), shard_solve_seconds "
          f"{r['shard_solve_seconds']}, cross_shard_reductions_total "
          f"{r['cross_shard_reductions_total']}; solve route "
          f"{prov.get('solve_kernel')} on {prov.get('card_name')}, "
          f"wave_solve launches in the window {w['launches']}, probe "
          f"launches over the run {wave_kernel.probe.launches}; bound "
          f"{bound}/{warmup + measured}, nodes over capacity {len(over)}; "
          f"phase 20(a) {time.perf_counter() - t0:.1f} s")
    bad = []
    if bound != warmup + measured or len(pods) != warmup + measured:
        bad.append(f"{bound}/{warmup + measured} bound")
    if over:
        bad.append(f"nodes over capacity {over[:5]}")
    if result.shard_count != 8:
        bad.append(f"shard_count {result.shard_count}")
    # The delta build's witness: a full build rewrites all 8 shards, a
    # delta build only the shards of the nodes whose pods changed (all 8
    # when a dispatch's binds spread over every shard), and at least one
    # build of the window took the delta path.
    if not 0 < result.shard_tensor_rebuilds_total <= 8 * w["builds"] \
            or not w["delta_builds"]:
        bad.append(f"shard_tensor_rebuilds_total "
                   f"{result.shard_tensor_rebuilds_total} over "
                   f"{w['builds']} builds, {w['delta_builds']} delta")
    if not w["launches"]:
        bad.append("no wave_solve launch in the window")
    if prov.get("solve_kernel") != "cuda" \
            or prov.get("card_name") != torch.cuda.get_device_name(0):
        bad.append(f"solve_provenance {prov}")
    if bad:
        raise RuntimeError(f"20(a): {bad}")
    return {"sharded_200k_launches": w["launches"],
            "sharded_200k_probe_launches": wave_kernel.probe.launches,
            **huge_chunk_compare(
                torch, backend, runner.sched.cache.update_snapshot(),
                runner.sched.profiles["default-scheduler"])}


def process_runner_cls(base):
    """`base` (a PerfRunner) that records, for a multi-process run, every
    pod's first node and any later change of it (a rebind) from the
    parent's informer, and before the processes stop: the merged LISTs of
    nodes and pods, each shard's, the Lease holder and the live scheduler
    processes."""
    from kubernetes_tpu_torch.client import ResourceEventHandler

    class ProcessRunner(base):
        async def _drive(self, template_ops, params, timeout, backing,
                         store, metrics, sched, factory, *rest):
            self.binds: dict[str, str] = {}
            self.rebinds: list[str] = []

            def track(obj):
                node = (obj.get("spec") or {}).get("nodeName")
                if not node:
                    return
                key = f"{obj['metadata'].get('namespace')}/" \
                      f"{obj['metadata']['name']}"
                first = self.binds.setdefault(key, node)
                if first != node:
                    self.rebinds.append(key)

            factory.informer("pods").add_event_handler(ResourceEventHandler(
                on_add=track, on_update=lambda old, new: track(new)))
            return await super()._drive(template_ops, params, timeout,
                                        backing, store, metrics, sched,
                                        factory, *rest)

        async def _finalize_multiproc(self, result, backing):
            await super()._finalize_multiproc(result, backing)
            shards = backing.node_shards
            self.final = {
                "nodes": (await backing.list("nodes")).items,
                "pods": (await backing.list("pods")).items,
                "shard_nodes": [(await backing.list(
                    "nodes", shard=i)).items for i in range(shards)],
                "meta_pods": (await backing.wires[0].list("pods")).items,
                "leader": await self._cp.leader_identity(),
                "live": sorted(self._cp.sched_procs),
            }

    return ProcessRunner


def process_violations(runner, result, want_pods: int, want_nodes: int,
                       processes: int) -> list[str]:
    """20(b)'s and 20(c)'s gates on a ProcessRunner's run: every pod bound
    once, no node over capacity, the merged LISTs equal to what the
    shards hold key by key and RV by RV (each node on its crc32 shard),
    `process_count`, one live Lease holder."""
    from kubernetes_tpu_torch.store import shard_of

    f = runner.final

    def rvs(objs):
        return {o["metadata"]["name"]: o["metadata"]["resourceVersion"]
                for o in objs}

    bad = []
    pods, nodes = f["pods"], f["nodes"]
    bound = [p for p in pods if (p.get("spec") or {}).get("nodeName")]
    if len(pods) != want_pods or len(bound) != want_pods:
        bad.append(f"{len(bound)}/{want_pods} pods bound ({len(pods)} "
                   "listed)")
    if len(runner.binds) != want_pods or runner.rebinds:
        bad.append(f"binds seen {len(runner.binds)}, rebinds "
                   f"{runner.rebinds[:5]}")
    over = over_capacity(nodes, pods)
    if over:
        bad.append(f"nodes over capacity {over[:5]}")
    held = {}
    for i, objs in enumerate(f["shard_nodes"]):
        misplaced = [o["metadata"]["name"] for o in objs
                     if shard_of(o["metadata"]["name"], processes) != i]
        if misplaced:
            bad.append(f"shard {i} holds {misplaced[:3]}")
        held.update(rvs(objs))
    if len(nodes) != want_nodes or rvs(nodes) != held:
        bad.append(f"merged node LIST ({len(nodes)}) differs from the "
                   f"shards' ({len(held)})")
    if rvs(pods) != rvs(f["meta_pods"]):
        bad.append("merged pod LIST differs from the meta shard's")
    if result.process_count != processes:
        bad.append(f"process_count {result.process_count}")
    if f["leader"] is None or f["leader"] not in f["live"]:
        bad.append(f"lease holder {f['leader']}, live {f['live']}")
    return bad


def multiproc_phase(torch, backend_factory, data_dir: str,
                    workload: str = "5000Nodes", processes: int = 4) -> dict:
    """Phase 20(b): SchedulingBasic/5000Nodes through
    `PerfRunner(processes=4)`: 4 shard apiserver processes with their WALs
    under `data_dir`, a leader-elected scheduler pair with TorchBackend on
    the backend's device, the parent through ProcessShardedStore. Returns
    the leader's kernel launches."""
    from kubernetes_tpu_torch.perf.scheduler_perf import (
        SCHEDULING_BASIC, PerfRunner)

    t0 = time.perf_counter()
    params = next(w["params"] for w in SCHEDULING_BASIC["workloads"]
                  if w["name"] == workload)
    runner = process_runner_cls(PerfRunner)(
        backend=backend_factory(), batch_size=LOOP_BATCH,
        processes=processes, data_dir=data_dir)
    result = asyncio.run(runner.run(SCHEDULING_BASIC["workloadTemplate"],
                                    params, timeout=900.0))
    r = result.as_dict()
    launches = result.leader_kernel_launches
    want = params["initPods"] + params["measurePods"]
    bad = process_violations(runner, result, want, params["initNodes"],
                             processes)
    print(f"multiproc 20(b) SchedulingBasic/{workload} through "
          f"PerfRunner(processes={processes}) ({processes} shard apiserver "
          f"processes with WALs, a leader-elected scheduler pair with "
          f"TorchBackend, batch_size {LOOP_BATCH}; the parent through "
          f"ProcessShardedStore): SchedulingThroughput "
          f"{r['throughput_pods_per_sec']} pods/s, measured_seconds "
          f"{result.measured_seconds:.6f}, attempt ms p50 "
          f"{r['attempt_p50_ms']} p99 {r['attempt_p99_ms']} p999 "
          f"{r['attempt_p999_ms']} (exact {r['attempt_percentiles_exact']}, "
          f"the leader's); staging {result.staging_seconds:.3f} s; "
          f"process_count {r['process_count']}, leader_elections_total "
          f"{r['leader_elections_total']}, leader {runner.final['leader']}, "
          f"WAL appends {r['wal_appends_total']}, fsync seconds "
          f"{r['wal_fsync_seconds_total']}; the leader's kernel launches "
          f"{launches}, solve route "
          f"{result.solve_provenance.get('solve_kernel')}; merged LISTs "
          f"equal to the shards' key by key and RV by RV: "
          f"{'yes' if not bad else 'see below'}; phase 20(b) "
          f"{time.perf_counter() - t0:.1f} s")
    if result.leader_elections_total < 1:
        bad.append(f"leader_elections_total {result.leader_elections_total}")
    if not launches.get("wave_solve"):
        bad.append(f"no wave_solve launch in the leader: {launches}")
    if bad:
        raise RuntimeError(f"20(b): {bad}")
    return launches


def kill_leader_phase(torch, backend_factory, data_dir: str,
                      workload: str = "1000Nodes-r100",
                      processes: int = 2) -> dict:
    """Phase 20(c): ChurnDay/1000Nodes-r100's template and params with a
    killLeader fault at 3 s, processes=2 and KTPU_LEASE_DURATION=6, then a
    barrier. Returns the surviving leader's kernel launches."""
    from kubernetes_tpu_torch.perf.scheduler_perf import CHURN_DAY, PerfRunner
    from kubernetes_tpu_torch.utils import flags

    t0 = time.perf_counter()
    params = next(w["params"] for w in CHURN_DAY["workloads"]
                  if w["name"] == workload)
    template = copy.deepcopy(CHURN_DAY["workloadTemplate"])
    template[-1]["faults"] = [{"at": KILL_LEADER_AT_S, "kind": "killLeader"}]
    template.append({"opcode": "barrier"})
    with flags.scoped_set("KTPU_LEASE_DURATION", KILL_LEADER_LEASE_S):
        runner = process_runner_cls(PerfRunner)(
            backend=backend_factory(), batch_size=LOOP_BATCH,
            processes=processes, data_dir=data_dir)
        result = asyncio.run(runner.run(template, params, timeout=900.0))
    r = result.as_dict()
    faults = r["churn_faults"]
    rec = faults[0] if faults else {}
    want = params["warmupPods"] + r["churn_arrivals_total"] + \
        rec.get("replacements", 0)
    bad = process_violations(runner, result, want, params["initNodes"],
                             processes)
    print(f"kill leader 20(c) ChurnDay/{workload} (Poisson "
          f"{params['rate']}/s for {params['duration']} s, seed 17) with "
          f"killLeader at {KILL_LEADER_AT_S} s, processes={processes}, "
          f"KTPU_LEASE_DURATION={KILL_LEADER_LEASE_S}: fault {rec}; time to "
          f"recovery {rec.get('recovery_s')} s (the kill to the last of "
          f"{rec.get('replacements')} canaries bound with the backlog "
          f"under {10}); leader_elections_total "
          f"{r['leader_elections_total']}, lease holder "
          f"{runner.final['leader']}, live schedulers "
          f"{runner.final['live']}; arrivals {r['churn_arrivals_total']}, "
          f"attempt ms p50 {r['attempt_p50_ms']} p99 {r['attempt_p99_ms']} "
          f"p999 {r['attempt_p999_ms']} (the new leader's window); the "
          f"survivor's kernel launches {result.leader_kernel_launches}; "
          f"every pod bound once: {not bad}; phase 20(c) "
          f"{time.perf_counter() - t0:.1f} s")
    others = {f"ktpu-sched-{i}" for i in range(2)}
    if rec.get("kind") != "killLeader" or rec.get("leader") not in others \
            or rec.get("recovered") is not True:
        bad.append(f"fault record {rec}")
    if runner.final["live"] != [runner.final["leader"]] \
            or runner.final["leader"] == rec.get("leader"):
        bad.append(f"lease holder {runner.final['leader']}, live "
                   f"{runner.final['live']}")
    if result.leader_elections_total < 2:
        bad.append(f"leader_elections_total {result.leader_elections_total}")
    if bad:
        raise RuntimeError(f"20(c): {bad}")
    return result.leader_kernel_launches


def sharded_processes_run(torch) -> dict:
    """Phase 20 (see the module docstring), under a scoped
    KTPU_SOLVE_MODE=auto with serving on (the children inherit both).
    Returns the kernels line's phase 20 entries."""
    import shutil

    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.utils import flags

    t20 = time.perf_counter()
    print(f"phase 20 on {card_line()}")
    data = os.path.join(REPO, "build", "phase20")
    shutil.rmtree(data, ignore_errors=True)
    os.makedirs(data)
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        huge = sharded_200k_phase(torch, TorchBackend)
        multi = multiproc_phase(torch, TorchBackend,
                                os.path.join(data, "shards-b"))
        kill = kill_leader_phase(torch, TorchBackend,
                                 os.path.join(data, "shards-c"))
    print(f"phase 20 {time.perf_counter() - t20:.1f} s")
    chunk = {k: v for k, v in huge.items() if k.startswith("huge_")}
    return {"wave_solve": {"sharded_200k_launches":
                           huge["sharded_200k_launches"],
                           "multiproc_launches": multi["wave_solve"],
                           "kill_leader_launches": kill["wave_solve"],
                           **chunk},
            "probe": {"sharded_200k_launches":
                      huge["sharded_200k_probe_launches"],
                      "multiproc_launches": multi["probe"],
                      "kill_leader_launches": kill["probe"]}}


def sharded_processes_phases(torch) -> int:
    """`--phase20-only`: build the kernels (phase 1), then phase 20."""
    from kubernetes_tpu_torch.ops import wave_kernel

    t0 = time.perf_counter()
    lib = wave_kernel.LIBRARY.build()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib.path.name})")
    print(json.dumps(sharded_processes_run(torch)))
    print_card()
    return 0


# -- phase 21: the controller manager ---------------------------------------

#: The controllers phase 21's controller managers run (hazard: the default
#: set's node lifecycle controller, with its 4 s grace, would taint KWOK's
#: 5,000 nodes on any lease lag).
CM_CONTROLLERS = "deployment,replicaset,job,gc,podgc"
#: 20 Deployments of 250 (clusterloader2's load test gives its big
#: Deployments 250 replicas; 40 before the cut that keeps the smoke
#: inside its time), SchedulingBasic's pod template.
CM_DEPLOYMENTS, CM_REPLICAS = 20, 250
CM_NODES = 5000
#: KWOK's node-lease renew period: the kubelet's 10 s for a 40 s lease.
CM_KWOK_LEASE_S = 10.0
#: The controller managers' own lease (KTPU_LEASE_DURATION in their
#: environment; renew deadline and retry period scale with it).
CM_LEASE_S = 6.0
CM_LEASE_KEY = "kube-system/kube-controller-manager"
CM_JOB_COMPLETIONS, CM_JOB_PARALLELISM = 1024, 256
CM_IDENTITY = r"controller-manager (\S+) \(leader-elected\)"
#: Audit every pod create and delete, whoever makes it.
CM_AUDIT = """\
apiVersion: audit.k8s.io/v1
kind: Policy
rules:
- level: Metadata
  verbs: [create, delete]
  resources: [pods]
  omitStages: [RequestReceived]
"""


def controller_manager_child(log_dir: str, name: str, wire: str, token: str,
                             controllers: str = CM_CONTROLLERS,
                             lease_s: float = CM_LEASE_S) -> Child:
    """`python -m kubernetes_tpu_torch.controllers --wire ... --leader-elect`
    with its own bearer token and KTPU_LEASE_DURATION=`lease_s`."""
    return Child(name, "kubernetes_tpu_torch.controllers", [
        "--wire", wire, "--token", token, "--controllers", controllers,
        "--leader-elect"], log_dir,
        env={"KTPU_LEASE_DURATION": str(lease_s)})


async def lease_holder(store, key: str) -> str | None:
    from kubernetes_tpu_torch.store.mvcc import NotFound

    try:
        return (await store.get("leases", key))["spec"].get("holderIdentity")
    except NotFound:
        return None


async def until(pred, children, timeout: float, what: str) -> float:
    """Poll the coroutine function `pred` until it is true; every child
    must stay alive meanwhile. Returns the host time it first held."""
    deadline = time.monotonic() + timeout
    while True:
        if await pred():
            return time.perf_counter()
        for c in children:
            c.check_alive()
        if time.monotonic() > deadline:
            raise RuntimeError(f"no {what} within {timeout} s")
        await asyncio.sleep(0.05)


class RolloutLog:
    """What the parent's pod informer saw of phase 21's pods: each pod's
    nodes (a `BindLog`), the host time it was first Running, each live
    pod's `app` and `pod-template-hash` labels, and per `app` the live and
    the bound pods, with each one's peak and low since `track_extremes`."""

    def __init__(self):
        self.binds = BindLog()
        self.running_at: dict[str, float] = {}
        self._live: dict[str, tuple] = {}
        self.live: dict[str, int] = {}
        self.bound: dict[str, int] = {}
        self.peak: dict[str, int] | None = None
        self.low: dict[str, int] | None = None

    def _set(self, pod: dict, present: bool) -> None:
        name = pod["metadata"]["name"]
        old = self._live.pop(name, None)
        if old is not None:
            self.live[old[0]] -= 1
            self.bound[old[0]] -= old[1]
        labels = pod["metadata"].get("labels") or {}
        app = labels.get("app")
        if present:
            on = int(bool((pod.get("spec") or {}).get("nodeName")))
            self._live[name] = (app, on, labels.get("pod-template-hash"))
            self.live[app] = self.live.get(app, 0) + 1
            self.bound[app] = self.bound.get(app, 0) + on
        for a in {app, old[0] if old else app}:
            if self.peak is not None:
                self.peak[a] = max(self.peak.get(a, 0), self.live.get(a, 0))
                self.low[a] = min(self.low.get(a, 1 << 30),
                                  self.bound.get(a, 0))

    def see(self, pod: dict) -> None:
        self.binds.see(pod)
        if (pod.get("status") or {}).get("phase") == "Running":
            self.running_at.setdefault(pod["metadata"]["name"],
                                       time.perf_counter())
        self._set(pod, True)

    def gone(self, pod: dict) -> None:
        self._set(pod, False)

    def handler(self):
        from kubernetes_tpu_torch.client import ResourceEventHandler

        return ResourceEventHandler(
            on_add=self.see, on_update=lambda _old, new: self.see(new),
            on_delete=self.gone)

    def track_extremes(self) -> None:
        self.peak, self.low = dict(self.live), dict(self.bound)


def cm_template(app: str, image: str) -> dict:
    """SchedulingBasic's pod (cpu 100m, memory 250Mi) as a Deployment's
    template."""
    return {"metadata": {"labels": {"app": app}},
            "spec": {"containers": [{
                "name": "main", "image": image,
                "resources": {"requests": dict(POD_REQUESTS)}}]}}


def cm_deployments(image: str) -> list[dict]:
    from kubernetes_tpu_torch.controllers import make_deployment

    return [make_deployment(
        f"web-{i:02d}", CM_REPLICAS, {"matchLabels": {"app": f"web-{i:02d}"}},
        cm_template(f"web-{i:02d}", image),
        strategy={"type": "RollingUpdate", "rollingUpdate": {
            "maxSurge": "25%", "maxUnavailable": "25%"}})
        for i in range(CM_DEPLOYMENTS)]


def rollout_violations(deps, rses, pods, nodes) -> list[str]:
    """The end state of a rollout: each Deployment with one ReplicaSet of
    its current template's hash at `CM_REPLICAS` replicas and as many ready,
    every other ReplicaSet of it at 0 with no pod left, each live pod owned
    by its Deployment's current ReplicaSet (uid and all) and Running, no
    node over capacity."""
    from kubernetes_tpu_torch.controllers.deployment import pod_template_hash

    bad = []
    by_uid = {r["metadata"]["uid"]: r for r in rses}
    current = {}
    for d in deps:
        name = d["metadata"]["name"]
        thash = pod_template_hash(d["spec"]["template"])
        owned = [r for r in rses
                 if any(ref.get("uid") == d["metadata"]["uid"]
                        for ref in r["metadata"].get("ownerReferences") or [])]
        new = [r for r in owned
               if r["metadata"]["labels"].get("pod-template-hash") == thash]
        if len(new) != 1:
            bad.append(f"{name}: {len(new)} ReplicaSets of hash {thash}")
            continue
        rs = new[0]
        current[rs["metadata"]["uid"]] = name
        if rs["spec"]["replicas"] != CM_REPLICAS or \
                rs["status"].get("readyReplicas") != CM_REPLICAS:
            bad.append(f"{rs['metadata']['name']}: spec.replicas "
                       f"{rs['spec']['replicas']}, readyReplicas "
                       f"{rs['status'].get('readyReplicas')}")
        for r in owned:
            if r is not rs and (r["spec"]["replicas"] or
                                r["status"].get("replicas")):
                bad.append(f"old {r['metadata']['name']}: spec.replicas "
                           f"{r['spec']['replicas']}, status.replicas "
                           f"{r['status'].get('replicas')}")
    apps = {d["metadata"]["name"] for d in deps}
    mine = [p for p in pods if p["metadata"]["labels"].get("app") in apps]
    if len(mine) != CM_REPLICAS * len(deps):
        bad.append(f"{len(mine)} live pods, want {CM_REPLICAS * len(deps)}")
    for p in mine:
        refs = p["metadata"].get("ownerReferences") or []
        owner = by_uid.get(refs[0].get("uid")) if len(refs) == 1 else None
        app = p["metadata"]["labels"]["app"]
        if owner is None or not refs[0].get("controller") or \
                current.get(owner["metadata"]["uid"]) != app:
            bad.append(f"{p['metadata']['name']} owned by {refs}")
        elif p["status"].get("phase") != "Running" or \
                not p["spec"].get("nodeName"):
            bad.append(f"{p['metadata']['name']} {p['status'].get('phase')} "
                       f"on {p['spec'].get('nodeName')}")
    over = over_capacity(nodes, pods)
    if over:
        bad.append(f"nodes over capacity {over[:5]}")
    return bad


async def controller_manager(torch, log_dir: str, card: bool = True) -> dict:
    """Phase 21 (see the module docstring). Returns its numbers and the
    scheduler process's launch counts; raises on a failed gate or child.
    `card=False` runs the scheduler process on the host path (TPUScorer
    off) and drops the gates on the card's solve, for a run at a small
    size (the `CM_*` constants) without one."""
    from kubernetes_tpu_torch.apiserver.wire import WireStore
    from kubernetes_tpu_torch.controllers import (ControllerManager,
                                                  KwokController, make_job)
    from kubernetes_tpu_torch.controllers.deployment import (
        _resolve_bound, pod_template_hash)

    data_dir = os.path.join(log_dir, "data")
    os.makedirs(data_dir)
    config = os.path.join(log_dir, "scheduler-config.yaml")
    audit_policy = os.path.join(log_dir, "audit-policy.yaml")
    audit_log = os.path.join(log_dir, "audit.log")
    for path, text in ((config, CONTROL_PLANE_CONFIG),
                       (audit_policy, CM_AUDIT)):
        with open(path, "w") as f:
            f.write(text)
    tokens = ["--token", "admin-token=admin", "--token", "sched-token=sched"]
    for s in "ab":
        tokens += ["--token", f"cm-{s}-token=cm-{s}"]
    print(f"phase 21 controllers: {CM_CONTROLLERS}")
    out: dict = {}
    children: list[Child] = []
    store = kwok_mgr = None
    try:
        # -- the apiserver, the scheduler, two controller managers, KWOK ----
        t0 = time.perf_counter()
        api = apiserver_child(
            log_dir, "apiserver", "--port", 0, "--wire-port", 0,
            "--data-dir", data_dir, "--fsync", "batch", *tokens,
            "--audit-policy", audit_policy, "--audit-log-path", audit_log,
            "--audit-log-maxsize-mb", 4096)
        children.append(api)
        _, wire = await apiserver_addresses(api, 120.0)
        sched = scheduler_child(
            log_dir, "scheduler", wire, config, "sched-token",
            gates="TPUScorer=true" if card else "TPUScorer=false")
        cms = {s: controller_manager_child(log_dir, f"cm-{s}", wire,
                                           f"cm-{s}-token") for s in "ab"}
        children += [sched, *cms.values()]
        store = WireStore(wire, token="admin-token", user_agent="chip-smoke")
        kwok = KwokController(
            store, node_count=CM_NODES, lease_period=CM_KWOK_LEASE_S,
            node_template={"allocatable": {"cpu": "8", "memory": "32Gi",
                                           "pods": "110"}})
        await kwok.register_nodes()
        log = RolloutLog()
        kwok_mgr = ControllerManager(store, [kwok])
        kwok_mgr.factory.informer("pods").add_event_handler(log.handler())
        await kwok_mgr.start()
        ids = {s: (await c.line(CM_IDENTITY, 120.0)).group(1)
               for s, c in cms.items()}
        await sched.line(r"scheduler running \(batch=", 300.0)
        prov = json.loads((await sched.line(LEADING, 60.0)).group(2))

        async def held() -> bool:
            return await lease_holder(store, CM_LEASE_KEY) in ids.values()
        await until(held, children, 60.0, "controller-manager lease holder")
        out["staging_s"] = time.perf_counter() - t0

        # -- 21(a) rollout ---------------------------------------------------
        deps = cm_deployments("web:v1")
        want = CM_DEPLOYMENTS * CM_REPLICAS
        apps = [d["metadata"]["name"] for d in deps]

        def running_total() -> int:
            return sum(1 for name, (app, *_) in log._live.items()
                       if app in apps and name in log.running_at)

        async def rolled_out() -> bool:
            return sum(log.live.get(a, 0) for a in apps) == want and \
                running_total() == want and all(
                    log.bound.get(a, 0) == CM_REPLICAS for a in apps)

        t1 = time.perf_counter()
        await create_all(store, "deployments", deps)
        await until(rolled_out, children, 600.0, "rollout of 10,000 pods")

        async def statuses_settled() -> bool:
            rses = (await store.list("replicasets")).items
            return len(rses) == CM_DEPLOYMENTS and all(
                r["status"].get("readyReplicas") == CM_REPLICAS
                for r in rses)
        await until(statuses_settled, children, 120.0,
                    "ReplicaSet statuses at readyReplicas 250")
        names = [n for n, (app, *_) in log._live.items() if app in apps]
        window = max(log.running_at[n] for n in names) - t1
        deps = (await store.list("deployments")).items
        rses = (await store.list("replicasets")).items
        pods = (await store.list("pods")).items
        nodes = (await store.list("nodes")).items
        bad = rollout_violations(deps, rses, pods, nodes)
        if log.binds.rebound():
            bad.append(f"rebound {log.binds.rebound()[:5]}")
        creates = audit_events(audit_log, "create")
        deletes = audit_events(audit_log, "delete")
        by_user = {}
        for ev in creates:
            by_user.setdefault(ev["user"]["username"], 0)
            by_user[ev["user"]["username"]] += 1
        made = {ev["objectRef"]["name"] for ev in creates
                if ev["responseStatus"]["code"] < 300}
        if set(by_user) - {"cm-a", "cm-b"}:
            bad.append(f"pod creates by {by_user}")
        missing = [p["metadata"]["name"] for p in pods
                   if p["metadata"]["name"] not in made]
        if missing:
            bad.append(f"{len(missing)} live pods with no create in the "
                       f"audit log, e.g. {missing[:3]}")
        if card and (prov is None or prov.get("solve_kernel") != "cuda"):
            bad.append(f"the scheduler's solve_provenance {prov}")
        ok_creates = sum(1 for ev in creates
                         if ev["responseStatus"]["code"] < 300)
        ok_deletes = sum(1 for ev in deletes
                         if ev["responseStatus"]["code"] < 300)
        out.update(rollout_rate=want / window, rollout_s=window,
                   rollout_creates=ok_creates, rollout_deletes=ok_deletes)
        print(f"controller manager 21(a) rollout: {CM_DEPLOYMENTS} "
              f"Deployments x {CM_REPLICAS} replicas (RollingUpdate 25%/25%,"
              f" cpu 100m memory 250Mi) over {CM_NODES} KWOK nodes; "
              f"{out['rollout_rate']:.2f} pods/s ({want} pods, {window:.6f} "
              f"s from the first Deployment create to the last pod Running "
              f"the parent's informer saw); staging {out['staging_s']:.3f} "
              f"s; the ReplicaSets created {ok_creates} pods and deleted "
              f"{ok_deletes} in all (pod creates by user {by_user}); "
              f"{len(rses)} ReplicaSets; every pod bound once, nodes over "
              f"capacity {len(over_capacity(nodes, pods))}; the scheduler's "
              f"solve_provenance {json.dumps(prov)}")
        if bad:
            raise RuntimeError(f"21(a): {bad[:10]}")

        # -- 21(b) failover --------------------------------------------------
        holder = await lease_holder(store, CM_LEASE_KEY)
        lead = next(s for s, i in ids.items() if i == holder)
        standby = "b" if lead == "a" else "a"
        t_kill = time.perf_counter()
        rc = await cms[lead].kill()
        live = [api, sched, cms[standby]]

        async def moved() -> bool:
            return await lease_holder(store, CM_LEASE_KEY) == ids[standby]
        out["failover_s"] = await until(moved, live, 120.0,
                                        "lease handover") - t_kill
        holder = await lease_holder(store, CM_LEASE_KEY)
        print(f"controller manager 21(b) failover: SIGKILL of cm-{lead} "
              f"({ids[lead]}, the lease holder; KTPU_LEASE_DURATION="
              f"{CM_LEASE_S}): {out['failover_s']:.3f} s until cm-{standby} "
              f"({ids[standby]}) held the lease; exit code {rc}")
        if rc != -9 or holder != ids[standby]:
            raise RuntimeError(f"21(b): exit code {rc}, holder {holder}")

        # -- 21(c) roll over -------------------------------------------------
        old_hash = {d["metadata"]["name"]:
                    pod_template_hash(d["spec"]["template"]) for d in deps}

        def bump(dep):
            dep["spec"]["template"]["spec"]["containers"][0]["image"] = \
                "web:v2"
            return dep
        log.track_extremes()
        t2 = time.perf_counter()
        await asyncio.gather(*(store.guaranteed_update(
            "deployments", f"default/{a}", bump) for a in apps))

        async def rolled_over() -> bool:
            rses = (await store.list("replicasets")).items
            done = 0
            for r in rses:
                app = r["metadata"]["labels"].get("app")
                h = r["metadata"]["labels"].get("pod-template-hash")
                if h == old_hash.get(app):
                    continue
                if r["spec"]["replicas"] == CM_REPLICAS and \
                        r["status"].get("readyReplicas") == CM_REPLICAS:
                    done += 1
            if done != CM_DEPLOYMENTS:
                return False
            old = [r for r in rses if r["metadata"]["labels"].get(
                "pod-template-hash") == old_hash.get(
                r["metadata"]["labels"].get("app"))]
            if any(r["spec"]["replicas"] or r["status"].get("replicas")
                   for r in old):
                return False
            return not any(h == old_hash.get(app)
                           for app, _on, h in log._live.values())
        t_over = await until(rolled_over, live, 600.0, "rollover")
        out["rollover_s"] = t_over - t2
        await until(rolled_out, live, 120.0, "the new pods Running")
        deps = (await store.list("deployments")).items
        rses = (await store.list("replicasets")).items
        pods = (await store.list("pods")).items
        bad = rollout_violations(deps, rses, pods, nodes)
        if log.binds.rebound():
            bad.append(f"rebound {log.binds.rebound()[:5]}")
        surge = _resolve_bound("25%", CM_REPLICAS)
        unavail = _resolve_bound("25%", CM_REPLICAS)
        made = sum(1 for ev in audit_events(audit_log, "create")
                   if ev["responseStatus"]["code"] < 300) - ok_creates
        gone_ = sum(1 for ev in audit_events(audit_log, "delete")
                    if ev["responseStatus"]["code"] < 300) - ok_deletes
        peaks = [log.peak.get(a, 0) for a in apps]
        lows = [log.low.get(a, 0) for a in apps]
        print(f"controller manager 21(c) rollover (all {CM_DEPLOYMENTS} "
              f"templates to web:v2 at once, led by cm-{standby}): "
              f"{out['rollover_s']:.6f} s until every new ReplicaSet had "
              f"{CM_REPLICAS} ready, every old one 0 and no old pod left; "
              f"live pods per Deployment peak {max(peaks)} (min of the "
              f"peaks {min(peaks)}) against {CM_REPLICAS} + 63 = "
              f"{CM_REPLICAS + 63}, bound low {min(lows)} (max of the lows "
              f"{max(lows)}) against {CM_REPLICAS} - 62 = {CM_REPLICAS - 62}"
              f" (the controller resolves maxSurge {surge}, maxUnavailable "
              f"{unavail}); the ReplicaSets created {made} pods and "
              f"deleted {gone_}; Deployments over the surge "
              f"{sum(p > CM_REPLICAS + surge for p in peaks)}, under the "
              f"availability floor "
              f"{sum(lo < CM_REPLICAS - unavail for lo in lows)}; every new "
              f"pod bound once, nodes over capacity "
              f"{len(over_capacity(nodes, pods))}")
        if bad:
            raise RuntimeError(f"21(c): {bad[:10]}")

        # -- 21(d) cascade ---------------------------------------------------
        gone, kept = apps[:CM_DEPLOYMENTS // 2], apps[CM_DEPLOYMENTS // 2:]
        before = pod_view(p for p in pods
                          if p["metadata"]["labels"]["app"] in kept)
        t3 = time.perf_counter()
        for a in gone:
            await store.delete("deployments", f"default/{a}")

        async def collected() -> bool:
            if any(log.live.get(a, 0) for a in gone):
                return False
            rses = (await store.list("replicasets")).items
            return not any(r["metadata"]["labels"].get("app") in gone
                           for r in rses)
        out["cascade_s"] = await until(collected, live, 600.0,
                                       "cascade") - t3
        pods = (await store.list("pods")).items
        rses = (await store.list("replicasets")).items
        after = pod_view(p for p in pods
                         if p["metadata"]["labels"].get("app") in kept)
        bad = [p["metadata"]["name"] for p in pods
               if p["metadata"]["labels"].get("app") in gone]
        bad += [r["metadata"]["name"] for r in rses
                if r["metadata"]["labels"].get("app") in gone]
        if after != before:
            diff = sorted(n for n in set(before) | set(after)
                          if before.get(n) != after.get(n))
            bad.append(f"{len(diff)} kept pods changed, e.g. " + str(
                [(n, before.get(n), after.get(n)) for n in diff[:3]]))
        print(f"controller manager 21(d) cascade: delete {len(gone)} "
              f"Deployments; {out['cascade_s']:.6f} s until the garbage "
              f"collector had removed their ReplicaSets and "
              f"{len(gone) * CM_REPLICAS} pods; the other {len(kept)} "
              f"Deployments' {len(after)} pods kept their names, nodes and "
              f"RVs")
        if bad:
            raise RuntimeError(f"21(d): {bad[:10]}")

        # -- 21(e) Indexed Job -----------------------------------------------
        tmpl = cm_template("indexed", "batch:v1")
        tmpl["metadata"]["annotations"] = {
            "kwok.x-k8s.io/complete-after": "1"}
        t4 = time.perf_counter()
        await store.create("jobs", make_job(
            "indexed", parallelism=CM_JOB_PARALLELISM,
            completions=CM_JOB_COMPLETIONS, template=tmpl,
            completion_mode="Indexed"))

        async def complete() -> bool:
            job = await store.get("jobs", "default/indexed")
            return any(c.get("type") == "Complete" and c.get("status") ==
                       "True" for c in job["status"].get("conditions") or [])
        out["job_s"] = await until(complete, live, 600.0,
                                   "the Job's Complete condition") - t4
        job = await store.get("jobs", "default/indexed")
        pods = (await store.list("pods")).items
        done: dict[str, int] = {}
        for p in pods:
            if p["metadata"]["labels"].get("job-name") == "indexed" and \
                    p["status"].get("phase") == "Succeeded":
                i = p["metadata"]["annotations"][
                    "batch.kubernetes.io/job-completion-index"]
                done[i] = done.get(i, 0) + 1
        want_idx = {str(i) for i in range(CM_JOB_COMPLETIONS)}
        bad = []
        if job["status"].get("succeeded") != CM_JOB_COMPLETIONS:
            bad.append(f"succeeded {job['status'].get('succeeded')}")
        if set(job["status"].get("completedIndexes") or []) != want_idx:
            bad.append(f"completedIndexes "
                       f"{len(job['status'].get('completedIndexes') or [])}")
        if set(done) != want_idx or any(v != 1 for v in done.values()):
            bad.append(f"{len(done)} indexes Succeeded, "
                       f"{sum(v > 1 for v in done.values())} more than once")
        print(f"controller manager 21(e) Indexed Job (completions "
              f"{CM_JOB_COMPLETIONS}, parallelism {CM_JOB_PARALLELISM}, "
              f"complete-after 1 s): {out['job_s']:.6f} s from the create "
              f"to the Complete condition; succeeded "
              f"{job['status'].get('succeeded')}, indexes 0-"
              f"{CM_JOB_COMPLETIONS - 1} each Succeeded once: {not bad}")
        if bad:
            raise RuntimeError(f"21(e): {bad}")

        # -- stop every process ----------------------------------------------
        await kwok_mgr.stop()
        kwok_mgr = None
        await store.close()
        store = None
        launches = await stop_launches(sched)
        rcs = {c.name: await c.stop() for c in (cms[standby], api)}
        if any(rcs.values()) or (card and launches["wave_solve"] <= 0):
            raise RuntimeError(f"21: exit codes on SIGTERM {rcs}, the "
                               f"scheduler's launches {launches}")
        out["launches"] = launches
        print(f"controller manager stop: the scheduler's kernel launches "
              f"{json.dumps(launches)}; cm-{standby} and apiserver exit "
              f"codes {rcs}")
        return out
    finally:
        if kwok_mgr is not None:
            await kwok_mgr.stop()
        if store is not None:
            await store.close()
        for c in children:
            c.close()


def controller_manager_run(torch) -> dict:
    """Phase 21 (see the module docstring), under a scoped
    KTPU_SOLVE_MODE=auto with serving on (the children inherit both).
    Returns the kernels line's phase 21 entries."""
    import shutil

    from kubernetes_tpu_torch.utils import flags

    t21 = time.perf_counter()
    print(f"phase 21 on {card_line()}")
    log_dir = os.path.join(REPO, "build", "phase21")
    shutil.rmtree(log_dir, ignore_errors=True)
    os.makedirs(log_dir)
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        out = asyncio.run(controller_manager(torch, log_dir))
    print(f"phase 21 {time.perf_counter() - t21:.1f} s")
    return {"wave_solve": {"controller_manager_launches":
                           out["launches"]["wave_solve"]},
            "probe": {"controller_manager_launches":
                      out["launches"]["probe"]}}


def controller_manager_phases(torch) -> int:
    """`--phase21-only`: build the kernels (phase 1), then phase 21."""
    from kubernetes_tpu_torch.ops import wave_kernel

    t0 = time.perf_counter()
    lib = wave_kernel.LIBRARY.build()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib.path.name})")
    print(json.dumps(controller_manager_run(torch)))
    print_card()
    return 0


# -- phase 22: the gRPC service, protobuf over HTTP and the CLI --------------

#: 22(a)'s admission window (KTPU_ADMISSION_WINDOW, ms). Flagless, the
#: policy coalesces nothing below 300 pods/s; over gRPC every message costs
#: the shared event loop several iterations, so single-pod pops take the
#: 25 ms host path, the loop blocks, arrivals slow and the rate stays
#: below 300 (31.36 pods/s on an H100, every pop one pod). At the
#: policy's own largest window, 16 ms, each dispatch of ~10 pods held the
#: loop ~72 ms (114.08 pods/s); 64 ms, about that hold, leaves the
#: transport the loop for half of each cycle.
GRPC_ADMISSION_WINDOW_MS = 64.0


def transport_runner_cls(base, transport: str, before_stop=None):
    """`base` (the port's PerfRunner or a subclass of it) whose workload
    crosses the apiserver boundary on `transport`: "grpc" puts a
    `GRPCAPIServer` over the backing store and drives every write, the
    informers' lists and watches and every bind through one
    `GRPCRemoteStore`; "protobuf" puts an `APIServer` there and drives it
    through `RemoteStore(url, protobuf=True)`. Either server carries the
    run's `WebhookAdmission` (its PolicyEngine) and `AuditPipeline`, as the
    runner's own boundary does, and the run's policies are installed
    first. `self.server` is the run's server, `self.protobuf_responses`
    counts the responses whose body came back as protobuf, and
    `before_stop(runner, server, backing)`, when given, runs after the
    workload and before the server stops (its exception fails the run).
    The runner itself keeps refusing a transport it does not have."""
    from kubernetes_tpu_torch.apiserver.admission import WebhookAdmission
    from kubernetes_tpu_torch.apiserver.client import RemoteStore
    from kubernetes_tpu_torch.apiserver.grpc_server import (
        GRPCAPIServer, GRPCRemoteStore)
    from kubernetes_tpu_torch.apiserver.server import PROTOBUF_CT, APIServer
    from kubernetes_tpu_torch.client import InformerFactory
    from kubernetes_tpu_torch.metrics.registry import SchedulerMetrics
    from kubernetes_tpu_torch.policy import (
        AuditPipeline, AuditPolicy, PolicyEngine)
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.store import (
        install_core_validation, new_cluster_store)

    if transport not in ("grpc", "protobuf"):
        raise ValueError(f"transport {transport!r}")

    class StopHook:
        """The run's server; `stop` runs `before_stop` first."""

        def __init__(self, runner, server, backing):
            self.runner, self.server, self.backing = runner, server, backing

        async def stop(self):
            try:
                if before_stop is not None:
                    await before_stop(self.runner, self.server, self.backing)
            finally:
                await self.server.stop()

    class TransportRunner(base):
        async def _run_inner(self, template_ops, params, timeout):
            backing = new_cluster_store(shards=self.shards)
            install_core_validation(backing)
            self._policy_engine = PolicyEngine(backing)
            self._audit = AuditPipeline(AuditPolicy(self.audit_rules))
            admission = WebhookAdmission(backing,
                                         policy_engine=self._policy_engine)
            self.protobuf_responses = 0
            self.server = client = None
            try:
                await self._install_policies(backing)
                if transport == "grpc":
                    self.server = GRPCAPIServer(backing, admission=admission,
                                                audit=self._audit)
                    await self.server.start()
                    client = GRPCRemoteStore(self.server.target)
                else:
                    self.server = APIServer(backing, admission=admission,
                                            audit=self._audit)
                    await self.server.start()
                    client = RemoteStore(self.server.url, protobuf=True)
                    decode = client._json

                    async def counted(resp):
                        if resp.content_type == PROTOBUF_CT:
                            self.protobuf_responses += 1
                        return await decode(resp)

                    client._json = counted
                #: the backing store and the workload's client
                self.store, self.client = backing, client
                metrics = SchedulerMetrics()
                sched = Scheduler(client, seed=42, backend=self.backend,
                                  metrics=metrics, **self.scheduler_kwargs)
                factory = InformerFactory(client)
                await sched.setup_informers(factory)
            except BaseException:
                if client is not None:
                    await client.close()
                if self.server is not None:
                    await self.server.stop()
                backing.stop()
                raise
            return await self._drive(
                template_ops, params, timeout, backing, client, metrics,
                sched, factory, StopHook(self, self.server, backing), client)

    return TransportRunner


def transport_violations(runner, result, pods, nodes, want_pods: int,
                         evals_per_pod: int, store_cls) -> list[str]:
    """Phase 22's gates on a run: phase 18's (`policy_violations`), no
    node over capacity, and the workload's store a `store_cls`."""
    bad = policy_violations(runner, result, pods, want_pods, evals_per_pod)
    over = over_capacity(nodes, pods)
    if over:
        bad.append(f"nodes over capacity: {over[:5]}")
    if type(runner.client).__name__ != store_cls:
        bad.append(f"the run's store is {type(runner.client).__name__}, "
                   f"not {store_cls}")
    return bad


async def cli(url: str, *argv) -> tuple:
    """`python -m kubernetes_tpu_torch.cli --server url argv...` as a fresh
    interpreter from the repository root: (exit code, stdout, stderr)."""
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "kubernetes_tpu_torch.cli", "--server", url,
        *argv, cwd=REPO, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.PIPE)
    try:
        out, err = await asyncio.wait_for(proc.communicate(), 120)
    except asyncio.TimeoutError:
        proc.kill()
        await proc.wait()
        raise
    return proc.returncode, out.decode(), err.decode()


async def cli_phase(url: str, backing) -> dict:
    """Phase 22(c): the CLI against a live `APIServer` over `backing`,
    each command a `python -m kubernetes_tpu_torch.cli` subprocess that
    must exit 0: `get nodes` (a row per node), `get pods -o json` (the
    store's names and nodeNames), `describe nodes` of the busiest node (its
    object), `cordon` then `uncordon` (the store's `spec.unschedulable`
    flips), `top nodes` (each node's CPU and memory requests the sum of
    `pod_requests` of its pods). Returns the commands' seconds; raises on
    a failed check."""
    from kubernetes_tpu_torch.api.resource import format_quantity
    from kubernetes_tpu_torch.api.types import pod_is_terminal, pod_requests

    nodes = (await backing.list("nodes")).items
    pods = (await backing.list("pods")).items
    times, bad = {}, []
    per_node: dict = {}
    for p in pods:
        node = p["spec"].get("nodeName")
        if node and not pod_is_terminal(p):
            agg = per_node.setdefault(node, {"cpu": 0, "memory": 0})
            for r, v in pod_requests(p).items():
                if r in agg:
                    agg[r] += v

    async def run(*argv):
        t0 = time.perf_counter()
        rc, out, err = await cli(url, *argv)
        times[" ".join(argv)] = round(time.perf_counter() - t0, 3)
        if rc != 0:
            raise RuntimeError(f"22(c): `{' '.join(argv)}` exited {rc}: "
                               f"{err.strip()[-500:]}")
        return out

    # The reads at once (the checks compare each with the store), then the
    # cordon and the uncordon in turn.
    busiest = max(sorted(per_node), key=lambda n: (
        per_node[n]["cpu"], per_node[n]["memory"]))
    nodes_out, pods_out, described, top_out = await asyncio.gather(
        run("get", "nodes"), run("get", "pods", "-o", "json"),
        run("describe", "nodes", busiest), run("top", "nodes"))
    rows = nodes_out.splitlines()
    if rows[0].split()[:2] != ["NAME", "STATUS"] \
            or sorted(r.split()[0] for r in rows[1:]) != \
            sorted(n["metadata"]["name"] for n in nodes):
        bad.append(f"get nodes: {len(rows) - 1} rows for {len(nodes)} nodes")
    listed = json.loads(pods_out)["items"]
    view = sorted((p["metadata"]["name"], p["spec"].get("nodeName"))
                  for p in listed)
    want = sorted((p["metadata"]["name"], p["spec"].get("nodeName"))
                  for p in pods)
    if view != want:
        bad.append(f"get pods -o json: {len(view)} pods, "
                   f"{sum(a != b for a, b in zip(view, want))} differ")
    import yaml

    got = yaml.safe_load(described.split("\nEvents:")[0])
    live = next(n for n in nodes if n["metadata"]["name"] == busiest)
    if got["metadata"]["name"] != busiest or got["status"]["allocatable"] \
            != live["status"]["allocatable"]:
        bad.append(f"describe nodes {busiest}: {got['metadata']}")
    flips = []
    for verb in ("cordon", "uncordon"):
        await run(verb, busiest)
        node = await backing.get("nodes", busiest)
        flips.append(bool(node["spec"].get("unschedulable")))
    if flips != [True, False]:
        bad.append(f"cordon, uncordon: spec.unschedulable {flips}")
    top = top_out.splitlines()
    seen = 0
    for row in top[1:]:
        name, cpu, _, mem, _ = row.split()
        use = per_node.get(name, {"cpu": 0, "memory": 0})
        if cpu.split("/")[0] != format_quantity(use["cpu"]) \
                or mem.split("/")[0] != format_quantity(use["memory"]):
            bad.append(f"top nodes {name}: {cpu} {mem}, want {use}")
        seen += 1
    if seen != len(nodes):
        bad.append(f"top nodes: {seen} rows for {len(nodes)} nodes")
    if bad:
        raise RuntimeError(f"22(c): {bad[:5]}")
    return {"seconds": times, "nodes": len(nodes), "pods": len(pods),
            "busiest": busiest, "busiest_pods": sum(
                p["spec"].get("nodeName") == busiest for p in pods)}


def grpc_phase(torch, wire_rate: float | None) -> tuple:
    """Phase 22(a): SchedulingBasic/5000Nodes (not cut) over the gRPC
    service with the admission chain and the audit pipeline: every pod
    bound, no node over capacity, a wave_solve launch in the window,
    `solve_provenance` naming the card, the store a `GRPCRemoteStore`.
    Printed: 18(b)'s wire rate over this one when phase 18 ran. The
    admission window is pinned to GRPC_ADMISSION_WINDOW_MS. Returns
    (wave_solve's launches in the window, probe launches over the run)."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.perf.scheduler_perf import SCHEDULING_BASIC
    from kubernetes_tpu_torch.utils import flags

    t0 = time.perf_counter()
    params = next(w["params"] for w in SCHEDULING_BASIC["workloads"]
                  if w["name"] == "5000Nodes")
    wave_kernel.probe.launches = 0
    runner = transport_runner_cls(counting_runner_cls(torch), "grpc")(
        TorchBackend(), None)
    with flags.scoped_set("KTPU_ADMISSION_WINDOW", GRPC_ADMISSION_WINDOW_MS):
        result = asyncio.run(runner.run(
            SCHEDULING_BASIC["workloadTemplate"], params, timeout=900.0))
    probe_launches = wave_kernel.probe.launches
    pods = asyncio.run(runner.store.list("pods")).items
    nodes = asyncio.run(runner.store.list("nodes")).items
    bad = transport_violations(runner, result, pods, nodes, 11000, 0,
                               "GRPCRemoteStore")
    prov = result.solve_provenance
    if not (prov.get("card_name") and prov.get("power_limit")):
        bad.append(f"solve_provenance {prov}")
    if not runner.window["launches"]:
        bad.append("no wave_solve launch in the measured window")
    ratio = ("18(b) not run" if wire_rate is None
             else f"{wire_rate / result.throughput:.4f}")
    print(boundary_line("grpc SchedulingBasic/5000Nodes, no policies",
                        runner, result)
          + f"; admission window {GRPC_ADMISSION_WINDOW_MS} ms, host-path "
          f"pods {runner.window['routes']['host_path_pods']}, "
          f"TorchBackend.timings over the window "
          f"{json.dumps(runner.window['timings'])}; window wall {runner.window['wall']:.6f} s, probe launches "
          f"over the run {probe_launches}; 18(b)'s wire rate over this "
          f"{ratio} (printed, not gated); solve_provenance "
          f"{json.dumps(prov)}; phase 22(a) "
          f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise RuntimeError(f"22(a): {bad}")
    return runner.window["launches"], probe_launches


def protobuf_phase(torch) -> tuple:
    """Phase 22(b): SchedulingBasic at HTTP_CELL with 10 uniform policies
    through `RemoteStore(url, protobuf=True)`: 18(c)'s gates, no node over
    capacity and protobuf responses above 0; then (22(c)) the CLI against
    the run's `APIServer` before it stops. Returns (wave_solve's launches
    in the window, probe launches over the run)."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.perf.scheduler_perf import SCHEDULING_BASIC

    t0 = time.perf_counter()
    cli_out = {}

    async def before_stop(runner, server, backing):
        t_cli = time.perf_counter()
        cli_out.update(await cli_phase(server.url, backing))
        cli_out["wall"] = time.perf_counter() - t_cli

    wave_kernel.probe.launches = 0
    runner = transport_runner_cls(counting_runner_cls(torch), "protobuf",
                                  before_stop)(
        TorchBackend(), None, policy_count=HTTP_CELL_POLICIES)
    result = asyncio.run(runner.run(SCHEDULING_BASIC["workloadTemplate"],
                                    HTTP_CELL, timeout=900.0))
    probe_launches = wave_kernel.probe.launches
    pods = asyncio.run(runner.store.list("pods")).items
    nodes = asyncio.run(runner.store.list("nodes")).items
    want = HTTP_CELL["initPods"] + HTTP_CELL["measurePods"]
    bad = transport_violations(runner, result, pods, nodes, want,
                               HTTP_CELL_POLICIES, "RemoteStore")
    if not runner.client.protobuf or runner.protobuf_responses <= 0:
        bad.append(f"protobuf responses {runner.protobuf_responses}")
    print(boundary_line("protobuf SchedulingBasic/500Nodes, 10 policies",
                        runner, result)
          + f"; protobuf responses {runner.protobuf_responses}; phase "
          f"22(b) {time.perf_counter() - t0 - cli_out.get('wall', 0):.1f} s")
    if bad:
        raise RuntimeError(f"22(b): {bad}")
    print(f"cli 22(c) against 22(b)'s APIServer ({cli_out['nodes']} nodes, "
          f"{cli_out['pods']} pods; busiest node {cli_out['busiest']} with "
          f"{cli_out['busiest_pods']} pods): get nodes, get pods -o json, "
          f"describe nodes, cordon, uncordon and top nodes all exit 0 and "
          f"agree with the store; seconds per command "
          f"{json.dumps(cli_out['seconds'])}; phase 22(c) "
          f"{cli_out['wall']:.1f} s")
    return runner.window["launches"], probe_launches


def transport_run(torch, wire_rate: float | None = None) -> dict:
    """Phase 22 (see the module docstring), under a scoped
    KTPU_SOLVE_MODE=auto with serving on. Returns the kernels line's phase
    22 entries: wave_solve's launches in the measured windows of 22(a) and
    22(b), the probe's over each run."""
    from kubernetes_tpu_torch.utils import flags

    t22 = time.perf_counter()
    print(f"phase 22 on {card_line()}")
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        grpc_launches, grpc_probe = grpc_phase(torch, wire_rate)
        pb_launches, pb_probe = protobuf_phase(torch)
    print(f"phase 22 {time.perf_counter() - t22:.1f} s")
    return {"wave_solve": {"grpc_launches": grpc_launches,
                           "protobuf_launches": pb_launches},
            "probe": {"grpc_launches": grpc_probe,
                      "protobuf_launches": pb_probe}}


def transport_phases(torch) -> int:
    """`--phase22-only`: build the kernels (phase 1), then phase 22."""
    from kubernetes_tpu_torch.ops import wave_kernel

    t0 = time.perf_counter()
    lib = wave_kernel.LIBRARY.build()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib.path.name})")
    print(json.dumps(transport_run(torch)))
    print_card()
    return 0


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=8,
                        help="seed of phase 8(a)'s cluster and lone pods, "
                        "of phase 16(a)'s free masks, of phase 17(e)'s "
                        "random state and of phase 14(a)'s chunks")
    parser.add_argument("--phase13-only", action="store_true",
                        help="build the kernels and run phase 13 alone "
                        "(prints no result lines)")
    parser.add_argument("--phase14-only", action="store_true",
                        help="build the kernels and run phase 14 alone "
                        "(prints no result lines)")
    parser.add_argument("--phase15-only", action="store_true",
                        help="build the kernels and run phase 15 alone "
                        "(prints no result lines)")
    parser.add_argument("--phase16-only", action="store_true",
                        help="build the kernels and run phase 16 alone "
                        "(prints no result lines)")
    parser.add_argument("--phase17-only", action="store_true",
                        help="build the kernels and run phase 17 alone "
                        "(prints no result lines)")
    parser.add_argument("--phase18-only", action="store_true",
                        help="build the kernels and run phase 18 alone "
                        "(prints no result lines)")
    parser.add_argument("--phase19-only", action="store_true",
                        help="build the kernels and run phase 19 alone "
                        "(prints no result lines)")
    parser.add_argument("--phase20-only", action="store_true",
                        help="build the kernels and run phase 20 alone "
                        "(prints no result lines)")
    parser.add_argument("--phase21-only", action="store_true",
                        help="build the kernels and run phase 21 alone "
                        "(prints no result lines)")
    parser.add_argument("--phase22-only", action="store_true",
                        help="build the kernels and run phase 22 alone "
                        "(prints no result lines)")
    cli = parser.parse_args()
    seed = cli.seed
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubernetes_tpu_torch.utils import flags

    # Phases 1-6 run the reference's documented greedy configuration,
    # pinned: with no flag the solve-mode policy sends every chunk of 64
    # or more pods to the Sinkhorn route, which phase 7 drives.
    if cli.phase13_only:
        return large_cluster_phases(torch)
    if cli.phase14_only:
        return device_topology_phases(torch, seed)
    if cli.phase15_only:
        return stream_volume_phases(torch, seed)
    if cli.phase16_only:
        return slice_topology_phases(torch, seed)
    if cli.phase17_only:
        return runner_families_phases(torch, seed)
    if cli.phase18_only:
        return boundary_phases(torch)
    if cli.phase19_only:
        return control_plane_phases(torch)
    if cli.phase20_only:
        return sharded_processes_phases(torch)
    if cli.phase21_only:
        return controller_manager_phases(torch)
    if cli.phase22_only:
        return transport_phases(torch)
    with flags.scoped_set("KTPU_SOLVE_MODE", "greedy"):
        return smoke(torch, seed)


def large_cluster_run(torch, dev, fwk) -> dict:
    """Phase 13 (see the module docstring), under a scoped
    KTPU_SOLVE_MODE=auto with serving on. Returns the kernels line's phase
    13 entries: wave_solve's launches in 13(a) (the poisoned chunks'
    reruns), in 13(b)'s flagless and forced-shortlist measured assigns,
    and in 13(c)'s measured window, with the timings of 13(b)'s first
    chunk."""
    from kubernetes_tpu_torch.utils import flags

    t13 = time.perf_counter()
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        scan_launches = shortlist_scan_phase(torch, dev)
        out = large_assign_phase(torch, dev, fwk)
        out["large_scan_launches"] = scan_launches
        out["large_loop_launches"] = large_loop_phase(torch)
        large_spread_phase(torch)
        large_sharded_phase(torch, dev)
    print(f"phase 13 {time.perf_counter() - t13:.1f} s")
    return out


def large_cluster_phases(torch) -> int:
    """`--phase13-only`: build the kernels (phase 1), then phase 13."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.scheduler.framework import Framework
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        DEFAULT_SCORE_WEIGHTS, build_plugins)

    t0 = time.perf_counter()
    lib = wave_kernel.LIBRARY.build()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib.path.name})")
    out = large_cluster_run(torch, torch.device("cuda:0"),
                            Framework(build_plugins(), DEFAULT_SCORE_WEIGHTS))
    print(json.dumps(out))
    print_card()
    return 0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def print_card() -> None:
    print(card_line())


def smoke(torch, seed: int) -> int:
    """Phases 1-23 (see the module docstring)."""
    t_start = time.perf_counter()
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.ops import solver, wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend, chunk_planes
    from kubernetes_tpu_torch.scheduler.framework import Framework
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        DEFAULT_SCORE_WEIGHTS, build_plugins)
    from kubernetes_tpu_torch.scheduler.types import (
        NodeInfo, PodInfo, Snapshot)
    from kubernetes_tpu_torch.utils import flags

    dev = torch.device("cuda:0")
    fwk = Framework(build_plugins(), DEFAULT_SCORE_WEIGHTS)

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = wave_kernel.LIBRARY.build()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib.path.name})")
    for line in lib.ptxas_info.splitlines():
        if "ptxas info" in line:
            print(line.strip())

    # -- 2. probe ---------------------------------------------------------
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    probe_err = float((wave_kernel.probe(x) - (x + 1)).abs().max())
    # The scalar forms: a length that is not a multiple of 4, and a view
    # whose pointer is not 16-byte aligned.
    odd = torch.randn(1001, device=dev)
    for what, t in (("n=1001", odd), ("unaligned view", odd[1:])):
        if not torch.equal(wave_kernel.probe(t), t + 1):
            raise RuntimeError(f"probe kernel wrong on {what}")
    if probe_err != 0.0:
        raise RuntimeError(f"probe kernel off by {probe_err}")
    # Back to back in turns: probe, x + 1, x + 1, probe.
    turns = [cuda_ms(torch, fn, 1000) for fn in (
        lambda: wave_kernel.probe(x), lambda: x + 1, lambda: x + 1,
        lambda: wave_kernel.probe(x))]
    probe_ms = (turns[0] + turns[3]) / 2
    probe_plain_ms = (turns[1] + turns[2]) / 2
    probe_dev_ms = profiled_kernel_ms(
        torch, lambda: wave_kernel.probe(x), 50, "probe_kernel")
    plus_dev_ms = profiled_kernel_ms(torch, lambda: x + 1, 50, "elementwise")
    print(f"probe per launch, (8,128) f32, back to back in turns (probe, "
          f"x+1, x+1, probe): {turns} ms; device time per launch "
          f"(profiler): probe {fmt_ms(probe_dev_ms)}, x + 1 "
          f"{fmt_ms(plus_dev_ms)}; probe "
          f"{'no slower than' if probe_ms <= probe_plain_ms else 'SLOWER than'}"
          f" x + 1 back to back")

    # -- 3. kernel vs plain -------------------------------------------------
    def node_infos():
        return [NodeInfo(make_node(f"node-{i}")) for i in range(N_NODES)]

    init_pods = [PodInfo(make_pod(f"init-{i}", requests=POD_REQUESTS))
                 for i in range(N_INIT)]
    measured = [PodInfo(make_pod(f"pod-{i}", requests=POD_REQUESTS))
                for i in range(N_MEASURED)]

    mismatches = 0
    max_err = 0.0

    def compare(what, args, plan=None, **kw):
        nonlocal mismatches, max_err
        (p, r), n = args[0].shape, args[2].shape[0]
        if plan is None:
            plan = wave_kernel.wave_launch_plan(
                n, r, max(1, min(kw["wave_w"], p)))
        got = wave_kernel.wave_solve(*args, plan=plan, **kw)
        ref = wave_kernel.wave_solve_reference(*args, **kw)
        torch.cuda.synchronize()
        diff = int((got[0] - ref[0]).abs().max())
        max_err = max(max_err, float(diff))
        same = all(torch.equal(g, r) for g, r in zip(got[1:], ref[1:]))
        print(f"compare {what}: max |assign diff| {diff}, counters "
              f"{'identical' if same else 'DIFFER'} (commits "
              f"{got[1].tolist()}, replays {got[2].tolist()}, poisoned "
              f"{got[3].tolist()}); plan {plan}")
        if diff or not same:
            mismatches += 1
        return got

    def chunk_on_card(arrays, rows, exc, perms, strategy):
        t = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        args = (t["req_q"], t["req_nz_q"], t["free_q"], t["free_pods"],
                t["used_nz_q"], t["alloc_q"], t["mask"], t["static_scores"],
                t["fit_col_w"], t["bal_col_mask"], t["shape_u"],
                t["shape_s"], 1.0, 1.0, strategy)
        return args, *(torch.from_numpy(a).to(dev) for a in (rows, exc,
                                                             perms))

    b = TorchBackend(device=dev)
    snap0 = Snapshot(node_infos(), 1)
    ctx = b._start(measured[:1024], snap0, fwk)
    prep = b._prep_chunk(ctx.chunks[0], ctx)
    st, prm = b.ensure_static(ctx.ct), ctx.params
    pl = chunk_planes(st["alloc_q"], b.used.pack, st["alloc_pods"],
                      prep["dev_pack"], prep["dev_cls"], st["taint_f"],
                      st["taint_p"], prep["dev_mask"], prep["dev_scores"],
                      prm["w_taint"], prm["taint_filter_on"])
    chunk_args = (pl["req_q"], pl["req_nz_q"], pl["free_q"],
                  pl["free_pods"], pl["used_nz_q"], st["alloc_q"],
                  pl["mask"], pl["static_scores"], prm["fit_col_w"],
                  prm["bal_col_mask"], prm["shape_u"], prm["shape_s"],
                  prm["w_fit"], prm["w_bal"], prm["strategy"])
    main_kw = dict(wave_w=prep["wave_w"], rows=prep["dev_cls"],
                   exc=prep["dev_exc"], poison=True, perms=prep["dev_perms"])
    compare("5k chunk K=4 poison", chunk_args, **main_kw)
    compare("5k chunk K=1 replay", chunk_args, wave_w=prep["wave_w"],
            rows=prep["dev_cls"], exc=prep["dev_exc"], poison=False)

    # Heterogeneous chunks: several node shapes, near-ties, exceptions and
    # an exhausted resource, at N divisible by the cluster and at a prime N
    # (short last slice), every strategy; then the global-carry form.
    poisoned = replayed = 0
    for n in (5000, 4093):
        for strategy in wave_kernel.STRATEGIES:
            args, rows_t, exc_t, perms_t = chunk_on_card(
                *hetero_chunk(seed=n, n=n), strategy)
            got = compare(f"hetero N={n} {strategy} K=4 poison", args,
                          wave_w=32, rows=rows_t, exc=exc_t, poison=True,
                          perms=perms_t)
            poisoned += int(got[3].sum())
            got = compare(f"hetero N={n} {strategy} K=1 replay", args,
                          wave_w=32, rows=rows_t, exc=exc_t, poison=False)
            replayed += int(got[2].sum())
    if not (poisoned and replayed):
        raise RuntimeError(f"the heterogeneous chunks poisoned {poisoned} "
                           f"orders and replayed {replayed} pods; both "
                           "paths must run")
    big = hetero_chunk(seed=3, n=20000, p=256, r=16, k=1)
    args, rows_t, exc_t, _ = chunk_on_card(*big, "MostAllocated")
    plan = wave_kernel.wave_launch_plan(20000, 16, 32)
    if plan.carry != "global":
        raise RuntimeError(f"R=16 at N=20000 did not take the global-carry "
                           f"form: {plan}")
    compare("hetero N=20000 R=16 P=256 K=1 replay (global carry)", args,
            wave_w=32, rows=rows_t, exc=exc_t, poison=False)

    # Default shared-form plans whose dynamic shared memory needs the
    # opt-in above the kernel's default limit (48 KB less its static
    # shared memory) yet stays at or below 48 KB.
    for n, r in ((320, 11), (5120, 10)):
        plan = wave_kernel.wave_launch_plan(n, r, 32)
        if not (plan.carry == "shared"
                and 48 * 1024 - wave_kernel.STATIC_SMEM_BUDGET
                < plan.smem_bytes <= 48 * 1024):
            raise RuntimeError(f"N={n} R={r} is outside the opt-in "
                               f"window: {plan}")
        args, rows_t, exc_t, perms_t = chunk_on_card(
            *hetero_chunk(seed=n, n=n, p=256, r=r), "LeastAllocated")
        compare(f"hetero N={n} R={r} P=256 K=4 poison (opt-in window)",
                args, wave_w=32, rows=rows_t, exc=exc_t, poison=True,
                perms=perms_t)

    storm_args, rows_t, exc_t, perms_t = chunk_on_card(*storm(seed=1),
                                                 "LeastAllocated")
    got = compare("storm K=4 poison", storm_args, wave_w=32, rows=rows_t,
                  exc=exc_t, poison=True, perms=perms_t)
    if not bool(got[3].any()):
        raise RuntimeError("the storm did not poison any order")
    got = compare("storm K=1 replay", storm_args, wave_w=32, rows=rows_t,
                  exc=exc_t, poison=False)
    if int(got[2].sum()) == 0:
        raise RuntimeError("the storm did not replay any wave")
    compare("storm K=4 W=1 rerun", storm_args, wave_w=1, rows=rows_t,
            exc=exc_t, poison=False, perms=perms_t)
    gang = (torch.zeros((256, 16), device=dev),
            torch.zeros((16,), device=dev))
    kern = solver.multistart_greedy_assign_wave_kernel(
        *storm_args, 32, perms_t, *gang, rows=rows_t, exc=exc_t)
    plain = solver.multistart_greedy_assign_wave(
        *storm_args, 32, perms_t, *gang, rows=rows_t, exc=exc_t)
    same = torch.equal(kern[0], plain[0]) and kern[1:] == plain[1:]
    print(f"compare storm multistart wrapper: {'identical' if same else 'DIFFER'}"
          f" (commits, replays {kern[1:]})")
    mismatches += 0 if same else 1

    small = [NodeInfo(make_node(
        f"small-{i}", allocatable={"cpu": str(2 + i % 5), "memory": "16Gi",
                                   "pods": str(4 + i % 3)}))
             for i in range(64)]
    small_pods = [PodInfo(make_pod(
        f"sp-{i}", requests={"cpu": f"{300 + 100 * (i % 7)}m",
                             "memory": "1Gi"})) for i in range(200)]
    with flags.scoped_set("KTPU_WAVE_WIDTH", 8):
        on_card, _ = TorchBackend(device=dev, max_batch=64).assign(
            small_pods, Snapshot(small, 1), fwk)
        on_cpu, _ = TorchBackend(device="cpu", max_batch=64).assign(
            small_pods, Snapshot(small, 1), fwk)
    print(f"compare small cluster, CUDA vs CPU backend: "
          f"{'identical' if on_card == on_cpu else 'DIFFER'} "
          f"({sum(v is not None for v in on_card.values())}/200 placed)")
    mismatches += 0 if on_card == on_cpu else 1
    if mismatches:
        raise RuntimeError(f"{mismatches} kernel/plain comparisons differ")

    # -- 4. the main path -----------------------------------------------------
    nodes = node_infos()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wave_kernel.wave_solve.launches = 0
    wave_kernel.probe.launches = 0
    backend = TorchBackend()
    init_assign, _ = backend.assign(init_pods, stamped_snapshot(nodes, 1), fwk)
    if any(v is None for v in init_assign.values()):
        raise RuntimeError("init pods unplaced")
    by_name = {ni.name: ni for ni in nodes}
    for pi in init_pods:
        by_name[init_assign[pi.key]].add_pod(pi)
    torch.cuda.synchronize()
    before = dict(backend.timings)
    t1 = time.perf_counter()
    assignments, _ = backend.assign(measured, stamped_snapshot(nodes, 2), fwk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    phases = {k: round(v - before[k], 6) for k, v in backend.timings.items()}
    launches = {"wave_solve": wave_kernel.wave_solve.launches,
                "probe": wave_kernel.probe.launches}
    peak_bytes = torch.cuda.max_memory_allocated()

    unplaced = [k for k, v in assignments.items() if v is None]
    if len(assignments) != N_MEASURED or unplaced:
        raise RuntimeError(f"{len(unplaced)} measured pods unplaced")
    for pi in measured:
        by_name[assignments[pi.key]].add_pod(pi)
    for ni in nodes:
        over = [r for r, v in ni.requested.res.items()
                if v > ni.allocatable.get(r)]
        if over or ni.requested.pods > ni.allocatable.pods:
            raise RuntimeError(f"{ni.name} over capacity: {over}")
    chunks = backend.counters["chunks"]
    if launches["wave_solve"] < chunks or launches["probe"] < 1:
        raise RuntimeError(f"kernels not on the main path: {launches}, "
                           f"{chunks} chunks")
    print(f"main path: {N_MEASURED} measured pods in {wall:.3f} s = "
          f"{N_MEASURED / wall:.1f} pods/s; {chunks} chunks (init "
          f"included), {backend.counters['wave_commits']} commits, "
          f"{backend.counters['wave_replays']} replays; launches {launches}; "
          f"max_memory_allocated {peak_bytes} bytes")
    print(f"measured phase host-clock seconds: {json.dumps(phases)}")
    greedy_frag = occupied_fragmentation(torch, backend)

    # -- 5. timings ---------------------------------------------------------
    # Device busy share of the measured phase: the same assign() again on a
    # fresh copy of the post-init cluster, under torch.profiler.
    nodes2 = node_infos()
    by_name2 = {ni.name: ni for ni in nodes2}
    for pi in init_pods:
        by_name2[init_assign[pi.key]].add_pod(pi)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t2 = time.perf_counter()
        again, _ = backend.assign(measured, stamped_snapshot(nodes2, 3), fwk)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t2
    if again != assignments:
        raise RuntimeError("a repeated measured phase placed pods differently")
    busy_us = sum(device_us(e) for e in prof.key_averages())
    solve_dev_ms = kernel_ms_from(prof, "wave_solve_kernel")
    print(f"profiled measured phase: wall {prof_wall:.3f} s, device busy "
          f"{busy_us / 1e6:.4f} s" + (
              f", idle share {1 - busy_us / 1e6 / prof_wall:.4f}"
              if busy_us else ", device time not measured by the profiler")
          + f"; wave_solve device time per launch {fmt_ms(solve_dev_ms)}")
    kernel_ms = cuda_ms(
        torch, lambda: wave_kernel.wave_solve(*chunk_args, **main_kw), 20)
    # The launch-plan sweep at the main path's chunk: clusters of 4, 8 and
    # 16 blocks x 128 and 256 threads, in two rounds (forward, reversed),
    # each plan's output identical to the default plan's.
    p, r = pl["req_q"].shape
    n = pl["free_q"].shape[0]
    default_plan = wave_kernel.wave_launch_plan(n, r, prep["wave_w"])
    want = wave_kernel.wave_solve(*chunk_args, **main_kw)
    sweep_plans = [wave_kernel.WavePlan(
        cs, -(-n // cs), threads, wave_kernel.carry_bytes(-(-n // cs), r),
        "shared") for cs in (4, 8, 16) for threads in (128, 256)]
    sweep = {plan: [] for plan in sweep_plans}
    for order in (sweep_plans, sweep_plans[::-1]):
        for plan in order:
            got = wave_kernel.wave_solve(*chunk_args, plan=plan, **main_kw)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"wave_solve under {plan} differs from "
                                   f"{default_plan}")
            sweep[plan].append(cuda_ms(torch, lambda: wave_kernel.wave_solve(
                *chunk_args, plan=plan, **main_kw), 10))
    for plan, times in sweep.items():
        print(f"sweep wave_solve 1024-pod chunk, cluster {plan.cluster} x "
              f"{plan.threads} threads ({plan.nodes_per_block} nodes, "
              f"{plan.smem_bytes} B per block): {times} ms")
    # The exchange's floor: the same chunk with an empty class mask, so a
    # pick reads one mask byte per node and scores nothing; what is left is
    # the block argmax, the cluster barrier and the slot reads.
    empty_args = list(chunk_args)
    empty_args[6] = torch.zeros_like(pl["mask"])
    floor_ms = cuda_ms(torch, lambda: wave_kernel.wave_solve(
        *empty_args, **main_kw), 20)
    print(f"wave_solve floor, empty mask, plan {default_plan}: {floor_ms:.4f}"
          f" ms per chunk ({floor_ms / p * 1e3:.3f} us per pick)")
    plain_ms = cuda_ms(
        torch, lambda: wave_kernel.wave_solve_reference(*chunk_args,
                                                        **main_kw), 2)
    # Score evaluations the chunk needs: each pod against every node
    # feasible for its class at chunk start, in each of the k orders.
    k = main_kw["perms"].shape[0]
    class_req = prep["dev_pack"][:, :r]
    feasible = pl["mask"] & (pl["free_pods"] >= 1)[None, :] & torch.all(
        class_req[:, None, :] <= pl["free_q"][None, :, :], dim=-1)
    evals = k * int(feasible.sum(dim=1)[prep["dev_cls"].long()].sum())
    bound_ms, bound_by = wave_bound_ms(
        p, pl["free_q"].shape[0], r, pl["mask"].shape[0], k,
        prm["shape_u"].shape[0], evals)
    print(f"wave_solve per 1024-pod chunk: kernel {kernel_ms:.4f} ms "
          f"({kernel_ms / p * 1e3:.3f} us per pick, {p} picks per order), "
          f"plan {default_plan}, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}); probe {probe_ms:.4f} ms, plain "
          f"{probe_plain_ms:.4f} ms")

    # -- 6. the sharded path ------------------------------------------------
    sharded_entries = sharded_phase(torch, dev, fwk, init_pods, init_assign,
                                    measured, assignments, node_infos)

    # -- 7. the flagless route ------------------------------------------------
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"):
        flagless = optimal_phase(torch, dev, fwk, init_pods, measured,
                                 node_infos, greedy_frag)

    # -- 8. the serving fast path ---------------------------------------------
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"):
        serving_phase(torch, fwk, init_pods, seed)

    # -- 9. the scheduler loop --------------------------------------------------
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        loop_equality_phase(torch, seed)
        loop = scheduler_perf_phase(torch)

    # -- 10. the constraint families ---------------------------------------
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        t10 = time.perf_counter()
        spread_scan_phase(torch, dev, seed)
        constraint_chunks_phase(torch, seed)
        constraint_loop_phase(torch, seed)
        print(f"phase 10(a) {time.perf_counter() - t10:.1f} s")
        anti = anti_affinity_phase(torch)
        topology_spreading_phase(torch)
        affinity_launches = pod_affinity_phase(torch)

    # -- 12. gangs and preemption ------------------------------------------
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        t12 = time.perf_counter()
        gang_chunk_launches = gang_chunks_phase(torch)
        victim_scan_phase(torch)
        gang_launches = gang_loop_phase(torch)
        preemption_phase(torch)
        print(f"phase 12 {time.perf_counter() - t12:.1f} s")

    # -- 13. large clusters -------------------------------------------------
    large = large_cluster_run(torch, dev, fwk)

    # -- 14. device topology -------------------------------------------------
    device = device_topology_run(torch, seed)

    # -- 15. the chunk stream and the volume plugins ------------------------
    stream_volume = stream_volume_run(torch, seed)

    # -- 16. slice topology, the node agents and the churn harness ---------
    slice_topology = slice_topology_run(torch, seed)

    # -- 17. the runner's last in-process families ------------------------
    families = runner_families_run(torch, seed)

    # -- 18. the apiserver boundary and the policy chain -------------------
    boundary, wire_rate = boundary_run_phases(torch)

    # -- 19. the control plane as processes ---------------------------------
    processes = control_plane_run(torch)

    # -- 20. the sharded and the multi-process control plane ----------------
    sharded_cp = sharded_processes_run(torch)

    # -- 21. the controller manager -----------------------------------------
    cm = controller_manager_run(torch)

    # -- 22. the gRPC service, protobuf over HTTP and the CLI ----------------
    transports = transport_run(torch, wire_rate)

    # -- 23. result --------------------------------------------------------
    print(f"smoke wall {time.perf_counter() - t_start:.1f} s (phases 1-22)")
    src = "kubernetes_tpu_torch/csrc/wave_solve.cu"
    probe_bound = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
    print(json.dumps({"kernels": [
        {"name": "wave_solve", "route": "cuda", "source": src,
         "replaces": "kubernetes_tpu/ops/pallas_kernel.py:134",
         "launches": launches["wave_solve"], "max_abs_err": max_err,
         "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None, **flagless,
         "loop_launches": loop["loop_launches"],
         "constraint_launches": anti["launches"] + affinity_launches,
         "gang_launches": gang_launches,
         "gang_chunk_launches": gang_chunk_launches, **large, **device,
         **stream_volume, **slice_topology, **families, **boundary,
         **processes["wave_solve"], **sharded_cp["wave_solve"],
         **cm["wave_solve"], **transports["wave_solve"]},
        {"name": "probe", "route": "cuda", "source": src,
         "replaces": "kubernetes_tpu/ops/pallas_kernel.py:111",
         "launches": launches["probe"], "max_abs_err": probe_err,
         "ms": probe_ms, "plain_ms": probe_plain_ms, "bound_ms": probe_bound,
         "bound_by": "bytes", "library_ms": probe_plain_ms,
         "loop_launches": loop["loop_probe_launches"],
         "constraint_launches": anti["probe_launches"],
         **processes["probe"], **sharded_cp["probe"], **cm["probe"],
         **transports["probe"]},
        *sharded_entries,
    ]}))
    print_card()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
