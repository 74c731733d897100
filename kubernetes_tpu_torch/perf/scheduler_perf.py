"""scheduler_perf: the reference's scale benchmark harness, in process.

Parity target: test/integration/scheduler_perf/ (scheduler_perf.go,
config/performance-config.yaml — SURVEY §3.5). Same trick: in-process
control plane, **no kubelets** — Node objects are data, pods "run" because
nothing contradicts Bind. Same workload shape:

    - name: SchedulingBasic
      workloadTemplate:
      - opcode: createNodes
        countParam: $initNodes
        nodeTemplate: {...}            # make_node kwargs
      - opcode: createPods
        countParam: $initPods
        podTemplate: {...}             # make_pod kwargs
      - opcode: createPods
        countParam: $measurePods
        collectMetrics: true           # the measured phase
      - opcode: barrier                # wait until all created pods scheduled
      workloads:
      - name: 5000Nodes
        params: {initNodes: 5000, initPods: 1000, measurePods: 10000}

Copy of `kubernetes_tpu/perf/scheduler_perf.py`, with the opcodes
createNodes (with `topologyTemplate`, a NodeResourceTopology per
node, and `draTemplate`, the DeviceClass once and a ResourceSlice per
node), startAgents (N in-process hollow-kubelet NodeAgents, agent/, which
register their own Nodes, watch their pods through a field selector, mark
them Running and renew their leases), createPods (with `podTemplate.claim`,
one ResourceClaim `{pod}-c0` per pod, created before its pod),
ungatePods (strips every pod's schedulingGates; measured: gate removal to
all bound), relistStorm (every agent tears down its watch, relists and
re-watches at once: `NodeAgent.force_relist`), churn (delete and recreate
a slice of pods), churnOpenLoop (perf/churn: a timed open-loop arrival
window with an optional fault timeline; a `nodeDeath` fault runs the node
lifecycle controller beside it, a `descheduler` block, or the
KTPU_DESCHEDULER flag, runs the rebalance descheduler with its scores on
the backend's device, and `sampleInterval` samples the fragmentation
curve; `killLeader` SIGKILLs the leader scheduler process of a
multi-process run), barrier and sleep. A workload's `schedulerConfig` builds the
scheduler's profiles through the port's `config.load_config`.

A run may cross the apiserver boundary as the reference's does
(`through_apiserver`, a family's `throughApiserver`): `True`/`"http"`
puts an `apiserver.APIServer` over the store and drives every write, the
scheduler's informers and binds, and the agents through
`apiserver.RemoteStore`; `"wire"` keeps the HTTP server up (the policy
chain lives there) and drives all traffic over
`apiserver.wire.WireStore` on a per-run unix socket
(`WireServer.for_apiserver(host="unix:")`). Such a run always builds a
`policy.PolicyEngine`, an `AuditPipeline` and the `WebhookAdmission`
that carries the engine, installs `policy_count` ValidatingAdmissionPolicies
(`policyCount`; sharded over `policy_tenants` tenant namespaces with
`policyTenants`, the 1000/100 PolicyScale layout) and audits at
`auditLevel`; the measured window's policy evaluations, index hits,
residue scans, rebuilds and audit events land in `WorkloadResult`. A
server that fails to start, or a request the chain refuses, fails the
run.
`WorkloadResult` keeps the fields this path fills, under the reference's
names, with `solve_provenance` (`ops/backend.solve_provenance` of the
backend's device) in every result of a run with a backend. With
`profile_dir` the backend writes a torch.profiler trace of each measured
window (createPods, ungatePods and churnOpenLoop alike; the reference
brackets createPods). A barrier raises the scheduler loop's own exception
as soon as `Scheduler.run` ends with one (the port has no backend
fallback), where the reference's would wait out its deadline.
SchedulingBasic's workload is a constant here (`SCHEDULING_BASIC`, equal
to the reference's YAML entry), so the harness needs no YAML parser unless
`load_config` is given a path; so are the constraint families'
SchedulingPodAntiAffinity, SchedulingPodAffinity and TopologySpreading
(`SCHEDULING_POD_ANTI_AFFINITY`, `SCHEDULING_POD_AFFINITY`,
`TOPOLOGY_SPREADING`), so is Preemption (`PREEMPTION`), whose preemptors
wait on their own binds only: victims being deleted shrink the global
bound count, so neither the warm-up nor the measured window can end on a
global barrier, and so are the device-topology families
(`DEVICE_TOPOLOGY`, `DEVICE_TOPOLOGY_DRA`), the churn families
`CHURN_DAY`, `CHURN_SLICE_PACKING`, `CHURN_DAY_FAULTS` and
`CHURN_REBALANCE`, `SCHEDULING_GATED`, `AGENT_RELIST_STORM` and
`POLICY_SCALE`.

The control plane may be sharded (`shards`, or KTPU_SHARDS: a
`store.ShardedNodeStore` of that many node shards, whose per-shard
tensor rebuilds, solve wall and cross-shard reductions land in the
result) or split into processes (`processes` >= 2, or KTPU_PROCESSES: one
apiserver process per shard with its WAL under `data_dir`, a
leader-elected scheduler pair with the backend's `TorchBackend` on the
same device, and the parent driving the workload through
`multiproc.ProcessShardedStore`; `process_count`, `leader_elections_total`,
the WAL counters and the leader's kernel launches land in the result).
A multi-process run refuses `scheduler_config`, `through_apiserver`,
`profile_dir` and policies (the reference ignores them there), and fails
when a child process the run did not kill exits.

Metrics over the measured phase: SchedulingThroughput (pods/s),
scheduling_attempt_duration percentiles (exact order statistics of the
measured window, p50/p90/p99/p999), node fragmentation % (all nodes and
occupied nodes), the event broadcaster's emitted/dropped counts, and the
backend's and serving tier's counters.

Run: `python -m kubernetes_tpu_torch.perf.scheduler_perf [config.yaml]
--filter SchedulingBasic/5000Nodes` runs TorchBackend on cuda:0 with
16384-pod pops (the reference bench's); `--device cpu` runs the kernels'
plain versions and `--backend host` the host path alone; `--profile-dir
DIR` writes each measured window's trace there; `--through-apiserver
{http,wire}` runs every family through that boundary (a family's own
`throughApiserver` wins). KTPU_SHARDS and KTPU_PROCESSES shape the
control plane of every run.
"""

from __future__ import annotations

import asyncio
import copy
import json
import math
import shutil
import tempfile
import time
from typing import Any, Mapping

from kubernetes_tpu_torch.agent import NodeAgent
from kubernetes_tpu_torch.api.meta import namespaced_name
from kubernetes_tpu_torch.api.types import (
    make_config_map,
    make_device_class,
    make_namespace,
    make_node,
    make_pod,
    make_resource_claim,
    make_resource_slice,
    make_validating_admission_policy,
    make_vap_binding,
    split_node_topology,
)
from kubernetes_tpu_torch.apiserver.admission import WebhookAdmission
from kubernetes_tpu_torch.apiserver.client import RemoteStore
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.apiserver.wire import WireServer, WireStore
from kubernetes_tpu_torch.client import InformerFactory, ResourceEventHandler
from kubernetes_tpu_torch.config import load_config as load_scheduler_config
from kubernetes_tpu_torch.controllers import (
    DeschedulerController,
    NodeLifecycleController,
)
from kubernetes_tpu_torch.metrics.registry import ChurnMetrics, SchedulerMetrics
from kubernetes_tpu_torch.ops.backend import solve_provenance
from kubernetes_tpu_torch.perf.churn import (
    ChurnDriver,
    FaultInjector,
    build_fault_timeline,
    is_saturated,
    make_arrival_process,
)
from kubernetes_tpu_torch.policy import (
    AuditPipeline,
    AuditPolicy,
    PolicyEngine,
)
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.store import (
    AlreadyExists, install_core_validation, new_cluster_store)
from kubernetes_tpu_torch.utils import flags

#: SchedulingBasic of the reference's performance-config.yaml.
SCHEDULING_BASIC = {
    "name": "SchedulingBasic",
    "workloadTemplate": [
        {"opcode": "createNodes", "countParam": "$initNodes"},
        {"opcode": "createPods", "countParam": "$initPods"},
        {"opcode": "createPods", "countParam": "$measurePods",
         "collectMetrics": True},
        {"opcode": "barrier"},
    ],
    "workloads": [
        {"name": "100Nodes",
         "params": {"initNodes": 100, "initPods": 500, "measurePods": 1000}},
        {"name": "1000Nodes",
         "params": {"initNodes": 1000, "initPods": 1000,
                    "measurePods": 3000}},
        {"name": "5000Nodes",
         "params": {"initNodes": 5000, "initPods": 1000,
                    "measurePods": 10000}},
    ],
}

_ZONE = "topology.kubernetes.io/zone"
_ANTI_POD = {
    "labels": {"app": "anti", "color": "blue"},
    "requests": {"cpu": "100m", "memory": "250Mi"},
    "affinity": {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "labelSelector": {"matchLabels": {"color": "blue"}},
            "topologyKey": "kubernetes.io/hostname"}]}},
}
_SPREAD_POD = {
    "labels": {"app": "spread-me"},
    "topology_spread_constraints": [
        {"maxSkew": 1, "topologyKey": _ZONE,
         "whenUnsatisfiable": "DoNotSchedule",
         "labelSelector": {"matchLabels": {"app": "spread-me"}}},
        {"maxSkew": 5, "topologyKey": "kubernetes.io/hostname",
         "whenUnsatisfiable": "ScheduleAnyway",
         "labelSelector": {"matchLabels": {"app": "spread-me"}}}],
}


def _zone_nodes(zone: str) -> dict:
    return {"opcode": "createNodes", "countParam": "$initNodes",
            "nodeTemplate": {"labels": {_ZONE: zone}}}


#: SchedulingPodAntiAffinity of the reference's performance-config.yaml:
#: hostname anti-affinity among the pods themselves (one per node).
SCHEDULING_POD_ANTI_AFFINITY = {
    "name": "SchedulingPodAntiAffinity",
    "workloadTemplate": [
        _zone_nodes("zone-a"),
        {"opcode": "createPods", "countParam": "$warmupPods",
         "podTemplate": _ANTI_POD},
        {"opcode": "barrier"},
        {"opcode": "createPods", "countParam": "$measurePods",
         "collectMetrics": True, "podTemplate": _ANTI_POD},
        {"opcode": "barrier"},
    ],
    "workloads": [
        {"name": "500Nodes",
         "params": {"initNodes": 500, "warmupPods": 50, "measurePods": 450}},
        {"name": "5000Nodes",
         "params": {"initNodes": 5000, "warmupPods": 200,
                    "measurePods": 4800}},
    ],
}

#: SchedulingPodAffinity of the reference's performance-config.yaml:
#: workers require a hub in their zone and prefer one on their node.
SCHEDULING_POD_AFFINITY = {
    "name": "SchedulingPodAffinity",
    "workloadTemplate": [
        _zone_nodes("zone-a"),
        _zone_nodes("zone-b"),
        {"opcode": "createPods", "countParam": "$hubPods",
         "podTemplate": {"labels": {"tier": "hub"}}},
        {"opcode": "barrier"},
        {"opcode": "createPods", "countParam": "$measurePods",
         "collectMetrics": True,
         "podTemplate": {
             "labels": {"tier": "worker"},
             "affinity": {"podAffinity": {
                 "requiredDuringSchedulingIgnoredDuringExecution": [{
                     "labelSelector": {"matchLabels": {"tier": "hub"}},
                     "topologyKey": _ZONE}],
                 "preferredDuringSchedulingIgnoredDuringExecution": [{
                     "weight": 50, "podAffinityTerm": {
                         "labelSelector": {"matchLabels": {"tier": "hub"}},
                         "topologyKey": "kubernetes.io/hostname"}}]}}}},
        {"opcode": "barrier"},
    ],
    "workloads": [
        {"name": "500Nodes",
         "params": {"initNodes": 250, "hubPods": 50, "measurePods": 1000}},
        {"name": "5000Nodes",
         "params": {"initNodes": 2500, "hubPods": 200,
                    "measurePods": 5000}},
    ],
}

#: TopologySpreading of the reference's performance-config.yaml: a hard
#: maxSkew 1 over three zones and a soft maxSkew 5 over hostnames.
TOPOLOGY_SPREADING = {
    "name": "TopologySpreading",
    "workloadTemplate": [
        _zone_nodes("zone-a"),
        _zone_nodes("zone-b"),
        _zone_nodes("zone-c"),
        {"opcode": "createPods", "countParam": "$warmupPods",
         "podTemplate": _SPREAD_POD},
        {"opcode": "barrier"},
        {"opcode": "createPods", "countParam": "$measurePods",
         "collectMetrics": True, "podTemplate": _SPREAD_POD},
        {"opcode": "barrier"},
    ],
    "workloads": [
        {"name": "300Nodes",
         "params": {"initNodes": 100, "warmupPods": 150,
                    "measurePods": 1000}},
        {"name": "3000Nodes",
         "params": {"initNodes": 1000, "warmupPods": 300,
                    "measurePods": 5000}},
    ],
}

#: Preemption of the reference's performance-config.yaml: a cluster filled
#: with priority-0 pods, then priority-1000 preemptors that must evict
#: victims (scoped barriers: see the module docstring).
PREEMPTION = {
    "name": "Preemption",
    "workloadTemplate": [
        {"opcode": "createNodes", "countParam": "$initNodes",
         "nodeTemplate": {"allocatable": {
             "cpu": "4", "memory": "16Gi", "pods": "32"}}},
        {"opcode": "createPods", "countParam": "$fillerPods",
         "podTemplate": {"priority": 0,
                         "requests": {"cpu": "1", "memory": "1Gi"}}},
        {"opcode": "barrier"},
        {"opcode": "createPods", "countParam": "$warmupPreemptors",
         "scopedBarrier": True,
         "podTemplate": {"priority": 1000,
                         "requests": {"cpu": "1", "memory": "1Gi"}}},
        {"opcode": "createPods", "countParam": "$measurePods",
         "collectMetrics": True,
         "podTemplate": {"priority": 1000,
                         "requests": {"cpu": "1", "memory": "1Gi"}}},
    ],
    "workloads": [
        {"name": "100Nodes",
         "params": {"initNodes": 100, "fillerPods": 400,
                    "warmupPreemptors": 40, "measurePods": 100}},
        {"name": "1000Nodes",
         "params": {"initNodes": 1000, "fillerPods": 4000,
                    "warmupPreemptors": 100, "measurePods": 1000}},
    ],
}

_TPU_POD = {"requests": {"cpu": "2", "memory": "1Gi", "google.com/tpu": "2"}}
_DRA_POD = {
    "requests": {"cpu": "2", "memory": "1Gi"},
    "claim": {
        "requests": [{"name": "tpus", "deviceClassName": "tpu", "count": 2}],
        "constraints": [{"matchAttribute": "numa"}]},
}


def _device_family(name: str, nodes_op: dict, pod: dict,
                   scheduler_config: dict | None = None) -> dict:
    family = {"name": name} if scheduler_config is None else {
        "name": name, "schedulerConfig": scheduler_config}
    family["workloadTemplate"] = [
        nodes_op,
        {"opcode": "createPods", "countParam": "$warmupPods",
         "podTemplate": pod},
        {"opcode": "barrier"},
        {"opcode": "createPods", "countParam": "$measurePods",
         "collectMetrics": True, "podTemplate": pod},
        {"opcode": "barrier"},
    ]
    family["workloads"] = [
        {"name": "100Nodes",
         "params": {"initNodes": 100, "warmupPods": 50, "measurePods": 300}},
        {"name": "1000Nodes",
         "params": {"initNodes": 1000, "warmupPods": 100,
                    "measurePods": 3000}},
    ]
    return family


#: DeviceTopology of the reference's performance-config.yaml: nodes with
#: 8 google.com/tpu split over 2 NUMA zones (a NodeResourceTopology each),
#: pods asking for 2 that must align in one zone; NodeResourceTopologyMatch
#: enabled by the workload's own profile.
DEVICE_TOPOLOGY = _device_family(
    "DeviceTopology",
    {"opcode": "createNodes", "countParam": "$initNodes",
     "nodeTemplate": {"allocatable": {
         "cpu": "16", "memory": "64Gi", "pods": "110",
         "google.com/tpu": "8"}},
     "topologyTemplate": {"zones": 2, "devices": {"google.com/tpu": 4}}},
    _TPU_POD,
    {"apiVersion": "kubescheduler.config.k8s.io/v1",
     "kind": "KubeSchedulerConfiguration",
     "profiles": [{"schedulerName": "default-scheduler", "plugins": {
         "multiPoint": {"enabled": [
             {"name": "NodeResourceTopologyMatch", "weight": 2}]}}}]})

#: DeviceTopologyDRA of the reference's performance-config.yaml: the same
#: workload as per-pod ResourceClaims for 2 devices of class "tpu" that
#: match on "numa", against a ResourceSlice of 8 devices per node.
DEVICE_TOPOLOGY_DRA = _device_family(
    "DeviceTopologyDRA",
    {"opcode": "createNodes", "countParam": "$initNodes",
     "nodeTemplate": {"allocatable": {
         "cpu": "16", "memory": "64Gi", "pods": "110"}},
     "draTemplate": {"className": "tpu", "zones": 2, "devicesPerZone": 4}},
    _DRA_POD)

#: ChurnDay of the reference's performance-config.yaml: open-loop Poisson
#: arrivals after a drained warm-up; no trailing barrier.
CHURN_DAY = {
    "name": "ChurnDay",
    "workloadTemplate": [
        {"opcode": "createNodes", "countParam": "$initNodes"},
        {"opcode": "createPods", "countParam": "$warmupPods"},
        {"opcode": "barrier"},
        {"opcode": "churnOpenLoop", "collectMetrics": True,
         "arrival": {"model": "poisson", "rate": "$rate"},
         "duration": "$duration", "seed": 17},
    ],
    "workloads": [
        {"name": "1000Nodes-r100",
         "params": {"initNodes": 1000, "warmupPods": 300, "rate": 100,
                    "duration": 10.0}},
        {"name": "1000Nodes-r400",
         "params": {"initNodes": 1000, "warmupPods": 300, "rate": 400,
                    "duration": 10.0}},
        {"name": "1000Nodes-r1600",
         "params": {"initNodes": 1000, "warmupPods": 300, "rate": 1600,
                    "duration": 10.0}},
        {"name": "5000Nodes-trickle",
         "params": {"initNodes": 5000, "warmupPods": 300, "rate": 250,
                    "duration": 10.0}},
    ],
}

#: ChurnSlicePacking of the reference's performance-config.yaml:
#: agent-backed nodes (node-i on the auto torus's cell i), a slice-shaped
#: gang mid-wave and the death of one of its nodes; the fault's recovery
#: is the time to re-coalesce the gang around the dead cell.
CHURN_SLICE_PACKING = {
    "name": "ChurnSlicePacking",
    "schedulerConfig": {
        "apiVersion": "kubescheduler.config.k8s.io/v1",
        "kind": "KubeSchedulerConfiguration",
        "profiles": [{"schedulerName": "default-scheduler", "plugins": {
            "multiPoint": {"enabled": [
                {"name": "Coscheduling"}, {"name": "TopologySlice"}]}}}]},
    "workloadTemplate": [
        {"opcode": "startAgents", "countParam": "$initNodes",
         "leasePeriod": 5.0},
        {"opcode": "createPods", "countParam": "$warmupPods"},
        {"opcode": "barrier"},
        {"opcode": "churnOpenLoop", "collectMetrics": True,
         "arrival": {"model": "poisson", "rate": "$rate"},
         "duration": "$duration", "seed": 17, "recoveryThreshold": 10,
         "recoveryTimeout": 20.0,
         "faults": [
             {"at": 1.0, "kind": "gangArrival", "sliceShape": "$shape"},
             {"at": "$deathAt", "kind": "sliceDeath", "group": "slice-1000",
              "sliceShape": "$shape"}]},
    ],
    "workloads": [
        {"name": "64Agents-2x2",
         "params": {"initNodes": 64, "warmupPods": 100, "rate": 20,
                    "duration": 6.0, "shape": [2, 2], "deathAt": 3.5}},
        {"name": "256Agents-4x4",
         "params": {"initNodes": 256, "warmupPods": 150, "rate": 40,
                    "duration": 6.0, "shape": [4, 4], "deathAt": 3.5}},
    ],
}

#: SchedulingGated of the reference's performance-config.yaml: pods enter
#: with a scheduling gate and become schedulable only when the gate is
#: removed (PreEnqueue -> gated tier -> gate-removal re-enqueue).
SCHEDULING_GATED = {
    "name": "SchedulingGated",
    "workloadTemplate": [
        {"opcode": "createNodes", "countParam": "$initNodes"},
        {"opcode": "createPods", "countParam": "$gatedPods",
         "podTemplate": {"scheduling_gates": ["wait-for-quota"]}},
        {"opcode": "sleep", "duration": 0.3},
        {"opcode": "ungatePods", "collectMetrics": True},
        {"opcode": "barrier"},
    ],
    "workloads": [
        {"name": "100Nodes", "params": {"initNodes": 100, "gatedPods": 1000}},
    ],
}

#: AgentRelistStorm of the reference's performance-config.yaml: after the
#: warm-up binds settle, every agent reconnects at once (watch torn down,
#: cold LIST, re-watch), then a measured wave.
AGENT_RELIST_STORM = {
    "name": "AgentRelistStorm",
    "workloadTemplate": [
        {"opcode": "startAgents", "countParam": "$initNodes",
         "leasePeriod": 10.0},
        {"opcode": "createPods", "countParam": "$warmupPods"},
        {"opcode": "barrier"},
        {"opcode": "relistStorm"},
        {"opcode": "createPods", "countParam": "$measurePods",
         "collectMetrics": True},
        {"opcode": "barrier"},
    ],
    "workloads": [
        {"name": "2000Agents",
         "params": {"initNodes": 2000, "warmupPods": 300,
                    "measurePods": 1000}},
        {"name": "5000Agents",
         "params": {"initNodes": 5000, "warmupPods": 300,
                    "measurePods": 1000}},
    ],
}

#: ChurnDayFaults of the reference's performance-config.yaml: the open-loop
#: wave with one agent killed mid-wave; the node lifecycle controller
#: taints it unreachable after the grace period and evicts its pods, and
#: the injector recreates and times their replacements.
CHURN_DAY_FAULTS = {
    "name": "ChurnDayFaults",
    "workloadTemplate": [
        {"opcode": "startAgents", "countParam": "$initNodes",
         "leasePeriod": 0.5},
        {"opcode": "createPods", "countParam": "$warmupPods"},
        {"opcode": "barrier"},
        {"opcode": "churnOpenLoop", "collectMetrics": True,
         "arrival": {"model": "poisson", "rate": "$rate"},
         "duration": "$duration", "seed": 17,
         "nodeGracePeriod": "$grace", "tolerationSeconds": 0.25,
         "recoveryThreshold": 10,
         "faults": [{"at": "$faultAt", "kind": "nodeDeath"}]},
    ],
    "workloads": [
        {"name": "500Agents-nodeDeath",
         "params": {"initNodes": 500, "warmupPods": 300, "rate": 200,
                    "duration": 10.0, "faultAt": 3.0, "grace": 2.0}},
    ],
}

_REBALANCE_POD = {"requests": {"cpu": "500m", "memory": "1Gi"}}

#: ChurnRebalance of the reference's performance-config.yaml: MostAllocated
#: packing, strided delete-only rollout waves that strand survivors on
#: half-empty nodes, and the descheduler off or on; the curve of occupied
#: fragmentation over the window is the on/off comparison.
CHURN_REBALANCE = {
    "name": "ChurnRebalance",
    "schedulerConfig": {
        "apiVersion": "kubescheduler.config.k8s.io/v1",
        "kind": "KubeSchedulerConfiguration",
        "profiles": [{"schedulerName": "default-scheduler", "pluginConfig": [
            {"name": "NodeResourcesFit", "args": {
                "scoringStrategy": {"type": "MostAllocated"}}}]}]},
    "workloadTemplate": [
        {"opcode": "createNodes", "countParam": "$initNodes",
         "nodeTemplate": {"allocatable": {"cpu": "4", "memory": "16Gi",
                                          "pods": "16"}}},
        {"opcode": "createPods", "countParam": "$warmupPods",
         "podTemplate": _REBALANCE_POD},
        {"opcode": "barrier"},
        {"opcode": "churnOpenLoop", "collectMetrics": True,
         "arrival": {"model": "poisson", "rate": "$rate"},
         "duration": "$duration", "seed": 17,
         "podTemplate": _REBALANCE_POD, "sampleInterval": 0.5,
         "recoveryThreshold": 10, "recoveryTimeout": 15.0,
         "descheduler": {"enabled": "$descheduler", "period": 0.25,
                         "budget": "$budget", "threshold": 0.4},
         "faults": [
             {"at": 1.0, "kind": "rolloutWave", "count": "$waveCount",
              "stride": 7, "replace": False},
             {"at": 2.5, "kind": "rolloutWave", "count": "$waveCount",
              "stride": 5, "replace": False}]},
    ],
    "workloads": [
        {"name": "200Nodes-deschedulerOff",
         "params": {"initNodes": 200, "warmupPods": 400, "rate": 8,
                    "duration": 6.0, "descheduler": False, "budget": 8,
                    "waveCount": 90}},
        {"name": "200Nodes-deschedulerOn",
         "params": {"initNodes": 200, "warmupPods": 400, "rate": 8,
                    "duration": 6.0, "descheduler": True, "budget": 8,
                    "waveCount": 90}},
    ],
}

#: PolicyScale of the reference's performance-config.yaml: SchedulingBasic's
#: 5000Nodes shape through the KTPU wire with 1000 ValidatingAdmissionPolicies
#: sharded over 100 tenant namespaces (~1% of them match a pod CREATE).
POLICY_SCALE = {
    "name": "PolicyScale",
    "throughApiserver": "wire",
    "policyCount": 1000,
    "policyTenants": 100,
    "workloadTemplate": [
        {"opcode": "createNodes", "countParam": "$initNodes"},
        {"opcode": "createPods", "countParam": "$initPods"},
        {"opcode": "barrier"},
        {"opcode": "createPods", "countParam": "$measurePods",
         "collectMetrics": True},
        {"opcode": "barrier"},
    ],
    "workloads": [
        {"name": "5000Nodes-1kPolicies",
         "params": {"initNodes": 5000, "initPods": 1000,
                    "measurePods": 10000}},
    ],
}


def _subst(value: Any, params: Mapping[str, Any]) -> Any:
    """$param substitution (countParam etc.)."""
    if isinstance(value, str) and value.startswith("$"):
        return params[value[1:]]
    return value


def _resolve_count(op: Mapping, params: Mapping[str, Any]) -> int:
    if "countParam" in op:
        return int(_subst(op["countParam"], params))
    return int(op.get("count", 0))


class WorkloadResult:
    """One workload's result: the reference's fields that this path fills."""

    def __init__(self):
        self.throughput = 0.0          # pods/s over the measured phase
        self.measured_pods = 0
        self.measured_seconds = 0.0
        self.attempt_p50 = 0.0
        self.attempt_p90 = 0.0
        self.attempt_p99 = 0.0
        #: exact-only (the 16-bucket histogram cannot resolve it): true
        #: p999 attempt latency over the measured window.
        self.attempt_p999 = float("nan")
        #: True when p50/p90/p99/p999 came from the exact windowed
        #: recorder (raw order statistics) rather than bucket edges.
        self.attempt_percentiles_exact = False
        self.fragmentation_pct = 0.0
        #: mean free fraction over OCCUPIED nodes (the packing metric the
        #: optimal mode lowers; the all-nodes figure above is
        #: placement-invariant once every pod places).
        self.fragmentation_occupied_pct = 0.0
        self.scheduled_total = 0
        self.unschedulable_total = 0
        #: DropIfChannelFull accounting (bounded event broadcaster).
        self.events_emitted_total = 0
        self.events_dropped_total = 0
        #: watch dispatch and watch-cache counters over the measured phase.
        self.watch_events_dispatched_total = 0
        self.watch_predicate_checks_total = 0
        self.watch_cache_hits_total = 0
        self.watch_cache_misses_total = 0
        #: relistStorm opcode results: wall time for every agent to tear
        #: down its watch, LIST (off the shared snapshot) and re-watch at
        #: once, plus the storm's own cache hit/miss deltas.
        self.relist_storm_agents = 0
        self.relist_storm_seconds = 0.0
        self.relist_storm_cache_hits = 0
        self.relist_storm_cache_misses = 0
        #: policy-chain accounting over the measured phase (policy/vap.py
        #: and policy/audit.py, boundary-crossing runs only): expression
        #: evaluations and audit stage events. The index triple is the
        #: O(matching) dispatch witness: hits = candidates served from
        #: the (resource, operation) exact map, residue = wildcard
        #: entries still scanned linearly, rebuilds = invalidations that
        #: cost a rebuild.
        self.policy_evaluations_total = 0
        self.audit_events_total = 0
        self.audit_events_dropped_total = 0
        self.policy_index_hits_total = 0
        self.policy_index_residue_scans_total = 0
        self.policy_index_rebuilds_total = 0
        #: solve-side accounting over the measured phase: chunk count and
        #: total solve wall (scheduler_tpu_solve_seconds), the latest
        #: chunk's scan and wave widths, commits and replays, and the
        #: optimal-mode solves and fallbacks.
        self.solver_solve_chunks = 0
        self.solver_solve_seconds_total = 0.0
        self.solver_scan_width = 0
        self.solver_wave_width = 0
        self.solver_wave_commits_total = 0
        self.solver_wave_replays_total = 0
        self.solver_optimal_solves_total = 0
        self.solver_optimal_fallbacks_total = 0
        #: ops/backend.solve_provenance() of the backend's device (empty
        #: without a backend): the card, the versions and the solve route
        #: that produced these numbers.
        self.solve_provenance: dict = {}
        #: serving-tier accounting over the measured phase (zeros under
        #: KTPU_SERVING=0).
        self.serving_fast_path_pods_total = 0
        self.serving_coalesced_batches_total = 0
        self.resident_plane_refreshes_total = 0
        self.resident_plane_refresh_seconds_total = 0.0
        self.admission_window_ms = 0.0
        #: createNodes opcode wall (data staging).
        self.staging_seconds = 0.0
        #: startAgents opcode wall (the fleet's cold start; 0.0 when no
        #: agents started).
        self.agent_start_seconds = 0.0
        #: churnOpenLoop (perf/churn): the measured phase is a TIMED
        #: arrival-process window, not a drained bulk — offered vs
        #: achieved rate proves the loop stayed open, backlog growth is
        #: the saturation witness, and the exact attempt percentiles
        #: above are the headline.
        self.churn_offered_rate = 0.0
        self.churn_achieved_rate = 0.0
        self.churn_arrival_model = ""
        self.churn_arrivals_total = 0
        self.churn_duration_s = 0.0
        self.churn_backlog_peak = 0
        self.churn_backlog_final = 0
        self.churn_pending_final: dict[str, int] = {}
        #: None = no churn phase ran; else the is_saturated verdict.
        self.churn_saturated: bool | None = None
        #: open-loop honesty counters: arrivals fired >50ms late, and
        #: creates the transport backstop forced to serialize.
        self.churn_late_arrivals = 0
        self.churn_throttled_creates = 0
        self.churn_create_errors = 0
        self.churn_create_drain_s = 0.0
        #: fault-injection records (timeline order) + per-kind counts +
        #: the worst measured time-to-recovery.
        self.churn_faults: list[dict] = []
        self.churn_faults_injected: dict[str, int] = {}
        self.churn_recovery_seconds_max: float | None = None
        #: the ChurnRebalance family's outputs: a [t_s, frag_pct,
        #: frag_occupied_pct] curve sampled through the churn window
        #: (`sampleInterval`), the descheduler's evict-and-replace moves,
        #: and the post-churn backlog-drain recovery wall (descheduler
        #: runs only).
        self.churn_fragmentation_curve: list[list[float]] = []
        self.churn_descheduler_evictions = 0
        self.churn_rebalance_recovery_s: float | None = None
        #: topology-slice accounting over the measured phase: slice gangs
        #: Permit released as one contiguous sub-mesh, the slice
        #: fragmentation gauge after the last plan, and coordinate-plane
        #: rebuilds (reuse does not count).
        self.slice_gangs_bound_total = 0
        self.slice_fragmentation_pct = 0.0
        self.topology_plane_rebuilds_total = 0
        #: sharded-control-plane accounting: the run's shard count (1 =
        #: the classic single store), per-shard host-prep rebuilds over
        #: the measured phase (the incremental path keeps this at
        #: dirty-shards-only), the solve wall attributed to the sharded
        #: path, and the top-level cross-shard argmax steps.
        self.shard_count = 1
        self.shard_tensor_rebuilds_total = 0
        self.shard_solve_seconds = 0.0
        self.cross_shard_reductions_total = 0
        #: multi-process control plane accounting: OS processes behind
        #: the run (1 = the classic in-process tree), WAL appends /
        #: replayed entries / fsync wall summed across the shard
        #: apiserver processes, scheduler leader elections observed (1 =
        #: the initial acquisition; >1 means a failover happened
        #: mid-run), and the leader's kernel launches over its life
        #: (empty for an in-process run; an attribute only, so the
        #: detail dict keeps the reference's keys).
        self.process_count = 1
        self.wal_appends_total = 0
        self.wal_replay_entries_total = 0
        self.wal_fsync_seconds_total = 0.0
        self.leader_elections_total = 0
        self.leader_kernel_launches: dict[str, int] = {}

    def as_dict(self) -> dict:
        def ms(v: float):
            return None if math.isnan(v) else round(v * 1e3, 3)

        return {
            "throughput_pods_per_sec": round(self.throughput, 2),
            "measured_pods": self.measured_pods,
            "measured_seconds": round(self.measured_seconds, 3),
            "attempt_p50_ms": ms(self.attempt_p50),
            "attempt_p90_ms": ms(self.attempt_p90),
            "attempt_p99_ms": ms(self.attempt_p99),
            "attempt_p999_ms": ms(self.attempt_p999),
            "attempt_percentiles_exact": self.attempt_percentiles_exact,
            "fragmentation_pct": round(self.fragmentation_pct, 2),
            "fragmentation_occupied_pct": round(
                self.fragmentation_occupied_pct, 2),
            "scheduled_total": self.scheduled_total,
            "unschedulable_total": self.unschedulable_total,
            "events_dropped_total": self.events_dropped_total,
            "events_dropped_pct": round(
                100.0 * self.events_dropped_total
                / self.events_emitted_total, 2)
            if self.events_emitted_total else 0.0,
            "watch_events_dispatched_total":
                self.watch_events_dispatched_total,
            "watch_predicate_checks_total":
                self.watch_predicate_checks_total,
            "watch_cache_hits_total": self.watch_cache_hits_total,
            "watch_cache_misses_total": self.watch_cache_misses_total,
            "relist_storm_agents": self.relist_storm_agents,
            "relist_storm_seconds": round(self.relist_storm_seconds, 3),
            "relist_storm_cache_hits": self.relist_storm_cache_hits,
            "relist_storm_cache_misses": self.relist_storm_cache_misses,
            "policy_evaluations_total": self.policy_evaluations_total,
            "audit_events_total": self.audit_events_total,
            "audit_events_dropped_total":
                self.audit_events_dropped_total,
            "policy_index_hits_total": self.policy_index_hits_total,
            "policy_index_residue_scans_total":
                self.policy_index_residue_scans_total,
            "policy_index_rebuilds_total":
                self.policy_index_rebuilds_total,
            "solver_solve_chunks": self.solver_solve_chunks,
            "solver_solve_seconds_total": round(
                self.solver_solve_seconds_total, 3),
            "solver_scan_width": self.solver_scan_width,
            "solver_wave_width": self.solver_wave_width,
            "solver_wave_commits_total": self.solver_wave_commits_total,
            "solver_wave_replays_total": self.solver_wave_replays_total,
            "solver_wave_replay_pct": round(
                100.0 * self.solver_wave_replays_total
                / (self.solver_wave_commits_total
                   + self.solver_wave_replays_total), 2)
            if (self.solver_wave_commits_total
                + self.solver_wave_replays_total) else None,
            "solver_optimal_solves_total": self.solver_optimal_solves_total,
            "solver_optimal_fallbacks_total":
                self.solver_optimal_fallbacks_total,
            "solve_provenance": self.solve_provenance,
            "serving_fast_path_pods_total": self.serving_fast_path_pods_total,
            "serving_coalesced_batches_total":
                self.serving_coalesced_batches_total,
            "resident_plane_refreshes_total":
                self.resident_plane_refreshes_total,
            "resident_plane_refresh_seconds_total": round(
                self.resident_plane_refresh_seconds_total, 4),
            "admission_window_ms": self.admission_window_ms,
            "staging_seconds": round(self.staging_seconds, 3),
            "agent_start_seconds": round(self.agent_start_seconds, 3),
            "churn_offered_rate": round(self.churn_offered_rate, 2),
            "churn_achieved_rate": round(self.churn_achieved_rate, 2),
            "churn_arrival_model": self.churn_arrival_model,
            "churn_arrivals_total": self.churn_arrivals_total,
            "churn_duration_s": round(self.churn_duration_s, 3),
            "churn_backlog_peak": self.churn_backlog_peak,
            "churn_backlog_final": self.churn_backlog_final,
            "churn_pending_final": dict(self.churn_pending_final),
            "churn_saturated": self.churn_saturated,
            "churn_late_arrivals": self.churn_late_arrivals,
            "churn_throttled_creates": self.churn_throttled_creates,
            "churn_create_errors": self.churn_create_errors,
            "churn_create_drain_s": round(self.churn_create_drain_s, 3),
            "churn_faults": list(self.churn_faults),
            "churn_faults_injected": dict(self.churn_faults_injected),
            "churn_recovery_seconds_max": self.churn_recovery_seconds_max,
            "churn_fragmentation_curve": [
                list(s) for s in self.churn_fragmentation_curve],
            "churn_descheduler_evictions": self.churn_descheduler_evictions,
            "churn_rebalance_recovery_s": self.churn_rebalance_recovery_s,
            "slice_gangs_bound_total": self.slice_gangs_bound_total,
            "slice_fragmentation_pct": round(
                self.slice_fragmentation_pct, 2),
            "topology_plane_rebuilds_total":
                self.topology_plane_rebuilds_total,
            "shard_count": self.shard_count,
            "shard_tensor_rebuilds_total": self.shard_tensor_rebuilds_total,
            "shard_solve_seconds": round(self.shard_solve_seconds, 6),
            "cross_shard_reductions_total":
                self.cross_shard_reductions_total,
            "process_count": self.process_count,
            "wal_appends_total": self.wal_appends_total,
            "wal_replay_entries_total": self.wal_replay_entries_total,
            "wal_fsync_seconds_total": round(
                self.wal_fsync_seconds_total, 4),
            "leader_elections_total": self.leader_elections_total,
        }


DEFAULT_NODE_TEMPLATE = {
    "allocatable": {"cpu": "8", "memory": "32Gi", "pods": "110"}}
DEFAULT_POD_TEMPLATE = {
    "requests": {"cpu": "100m", "memory": "250Mi"}}


class _ServerPair:
    """The apiserver processes backing a boundary-crossing run: the HTTP
    server (policy owner) and, in wire mode, the framed-wire listener."""

    def __init__(self, api, wire):
        self.api = api
        self.wire = wire

    async def stop(self) -> None:
        if self.wire is not None:
            await self.wire.stop()
        await self.api.stop()


class _SchedulerProxy:
    """Stands in for the in-process Scheduler when scheduling happens
    in child processes (processes >= 2): the harness keeps reading the
    same seams — queue depth, event-recorder counters, the cache
    snapshot — but the answers come from the parent's own pod informer
    (backlog = pods without a nodeName) or are structurally empty (the
    assume-cache lives in the leader replica; fragmentation over it is
    reported as 0 here and the exact attempt percentiles come over the
    measure-marker protocol instead). Its `run` ends with an exception
    when a child process the run did not kill exits."""

    class _Recorder:
        emitted = 0
        dropped = 0

        async def flush(self) -> None:
            pass

    class _Cache:
        @staticmethod
        def update_snapshot() -> list:
            return []

    def __init__(self, cp):
        self.cp = cp
        self.queue = self
        self.recorder = self._Recorder()
        self.cache = self._Cache()
        self._unbound: set[str] = set()

    async def setup_informers(self, factory) -> None:
        def _upd(obj):
            key = namespaced_name(obj)
            if obj.get("spec", {}).get("nodeName"):
                self._unbound.discard(key)
            else:
                self._unbound.add(key)

        factory.informer("pods").add_event_handler(ResourceEventHandler(
            on_add=_upd, on_update=lambda old, new: _upd(new),
            on_delete=lambda obj: self._unbound.discard(
                namespaced_name(obj))))

    # -- queue surface (self.queue is self) --------------------------------

    def stats(self) -> dict:
        return {"active": len(self._unbound), "backoff": 0,
                "unschedulable": 0, "gated": 0, "in_flight": 0}

    def backlog_depth(self) -> int:
        return len(self._unbound)

    # -- lifecycle ---------------------------------------------------------

    async def run(self, batch_size: int = 1) -> None:
        # The replicas schedule; the proxy holds the task slot the
        # harness cancels on teardown, and ends with the exception of a
        # child that died on its own.
        while True:
            self.cp.check_alive()
            await asyncio.sleep(0.1)

    async def stop(self) -> None:
        pass


class PerfRunner:
    """Executes one workload (template ops + params) against an in-process
    store + scheduler, mirroring mustSetupCluster → runWorkload."""

    def __init__(self, backend=None, batch_size: int = 1,
                 scheduler_kwargs: Mapping | None = None,
                 scheduler_config: Mapping | None = None,
                 through_apiserver: bool | str = False,
                 profile_dir: str | None = None,
                 policy_count: int = 0,
                 policy_tenants: int = 0,
                 audit_rules: list | None = None,
                 shards: int | None = None,
                 processes: int | None = None,
                 data_dir: str | None = None):
        if profile_dir and backend is None:
            raise ValueError("profile_dir needs a backend to profile "
                             "(TorchBackend.start_profile)")
        if through_apiserver not in (False, True, "http", "wire"):
            raise ValueError(
                f"through_apiserver={through_apiserver!r}: expected "
                "False, True, 'http' or 'wire'")
        self.backend = backend
        self.batch_size = batch_size
        self.scheduler_kwargs = dict(scheduler_kwargs or {})
        #: the workload's KubeSchedulerConfiguration (its
        #: `schedulerConfig`), or None for the default profile.
        self.scheduler_config = scheduler_config
        #: Cross the process boundary like the reference's scheduler_perf
        #: (in-process apiserver + a real wire): workload writes, the
        #: scheduler's informers, binding POSTs and the agents go over the
        #: apiserver instead of direct store calls. True/"http" = the
        #: HTTP/1.1+JSON wire; "wire" = the KTPU multiplexed framed wire.
        self.through_apiserver = through_apiserver
        #: ValidatingAdmissionPolicies (+bindings) installed before the
        #: run, evaluated on the servers (boundary-crossing runs only).
        self.policy_count = policy_count
        #: >0 shards the policy set across N tenant namespaces with
        #: per-namespace selectors and disjoint resourceRules, so ~1% of
        #: stored policies match a pod create at 1000/100; 0 keeps the
        #: uniform all-matching set.
        self.policy_tenants = policy_tenants
        #: audit policy rules for the run's AuditPipeline ([] = level
        #: None for everything).
        self.audit_rules = list(audit_rules or [])
        self._policy_engine = None
        self._audit = None
        #: where the backend writes a torch.profiler trace of each
        #: MEASURED window (not the warm-up), or None for no trace.
        self.profile_dir = profile_dir
        #: control-plane shard count for the backing store (>1 builds a
        #: ShardedNodeStore; None resolves KTPU_SHARDS, default 1).
        self.shards = shards
        #: OS-process count for the control plane. >1 spawns one
        #: apiserver process per shard plus a leader-elected scheduler
        #: pair and drives them through the cross-process facade; None
        #: resolves KTPU_PROCESSES; <=1 builds the in-process tree
        #: exactly (nothing multiproc is constructed).
        self.processes = processes
        #: KTPU_DATA_DIR override for the shard processes (per-shard
        #: snapshot + WAL directories live under it).
        self.data_dir = data_dir
        #: measure-marker protocol client and control plane, live only
        #: during a multi-process run (see multiproc/controlplane.py).
        self._mp = None
        self._cp = None

    async def run(self, template_ops: list, params: Mapping[str, Any],
                  timeout: float = 600.0) -> WorkloadResult:
        if self.shards is None:
            return await self._run_inner(template_ops, params, timeout)
        # The host prep's per-shard accounting resolves the same
        # flagless policy (control_plane_shards); an explicit shard
        # request must reach it too — scoped to this run.
        with flags.scoped_set("KTPU_SHARDS", self.shards):
            return await self._run_inner(template_ops, params, timeout)

    async def _run_inner(self, template_ops: list,
                         params: Mapping[str, Any],
                         timeout: float) -> WorkloadResult:
        nproc = self.processes
        if nproc is None:
            nproc = int(flags.get("KTPU_PROCESSES") or 1)
        if int(nproc) > 1:
            return await self._run_processes(template_ops, params,
                                             timeout, int(nproc))
        backing = new_cluster_store(shards=self.shards)
        install_core_validation(backing)
        server = None
        client = None
        try:
            api_kw = {}
            if self.through_apiserver:
                # The policy chain rides the servers: admission (webhooks
                # + expression policies) and the audit pipeline are
                # always built for a boundary-crossing run, so its policy
                # and audit counters are measurements (zero when no
                # policies or rules exist).
                self._policy_engine = PolicyEngine(backing)
                self._audit = AuditPipeline(AuditPolicy(self.audit_rules))
                api_kw = {"admission": WebhookAdmission(
                    backing, policy_engine=self._policy_engine),
                    "audit": self._audit}
                await self._install_policies(backing)
                server = _ServerPair(APIServer(backing, **api_kw), None)
                await server.api.start()
            if self.through_apiserver == "wire":
                # The core-component transport: the HTTP server stays up
                # (policy lives there), store traffic rides the
                # multiplexed wire on a per-run unix socket.
                server.wire = WireServer.for_apiserver(
                    server.api, host="unix:")
                await server.wire.start()
                client = WireStore(server.wire.target)
            elif self.through_apiserver:
                client = RemoteStore(server.api.url)
            store = client if client is not None else backing
            metrics = SchedulerMetrics()
            profiles = None
            if self.scheduler_config is not None:
                cfg = load_scheduler_config(self.scheduler_config)
                profiles = {p.scheduler_name: p.build_framework(
                    store=store, metrics=metrics) for p in cfg.profiles}
            sched = Scheduler(store, seed=42, backend=self.backend,
                              metrics=metrics, profiles=profiles,
                              **self.scheduler_kwargs)
            factory = InformerFactory(store)
            await sched.setup_informers(factory)
        except BaseException:
            # Setup failed after the server or client came up: release
            # the socket and the background tasks before raising.
            if client is not None:
                await client.close()
            if server is not None:
                await server.stop()
            backing.stop()
            raise
        return await self._drive(template_ops, params, timeout, backing,
                                 store, metrics, sched, factory, server,
                                 client)

    async def _run_processes(self, template_ops: list,
                             params: Mapping[str, Any], timeout: float,
                             nproc: int) -> WorkloadResult:
        """One apiserver OS process per shard plus a leader-elected
        scheduler pair; the parent only stages the workload and reads
        results through the cross-process facade."""
        from kubernetes_tpu_torch.multiproc import (
            MeasureProtocol,
            MultiProcessControlPlane,
        )
        if self.scheduler_config is not None or self.through_apiserver \
                or self.profile_dir or self.policy_count:
            raise ValueError(
                "a multi-process run takes no scheduler_config, "
                "through_apiserver, profile_dir or policies")
        backend_spec = None
        if self.backend is not None:
            backend_spec = {"kind": "torch",
                            "chunk": int(self.backend.max_batch),
                            "device": str(self.backend.device)}
        cp = MultiProcessControlPlane(
            nproc, data_dir=self.data_dir or flags.get("KTPU_DATA_DIR"),
            backend_spec=backend_spec, batch_size=self.batch_size,
            scheduler_kwargs=self.scheduler_kwargs)
        try:
            await cp.start()
            await cp.start_schedulers(2)
            backing = cp.client()
            metrics = SchedulerMetrics()
            sched = _SchedulerProxy(cp)
            factory = InformerFactory(backing)
            await sched.setup_informers(factory)
            self._mp = MeasureProtocol(backing)
            self._cp = cp
        except BaseException:
            await cp.stop()
            raise
        return await self._drive(template_ops, params, timeout, backing,
                                 backing, metrics, sched, factory, None,
                                 None, cp)

    async def _drive(self, template_ops: list, params: Mapping[str, Any],
                     timeout: float, backing, store,
                     metrics: SchedulerMetrics, sched: Scheduler, factory,
                     server, client, cp=None) -> WorkloadResult:
        """The opcode loop. `store` carries the workload's traffic (the
        backing store, or the boundary's client); the counters read
        `backing`. `cp` is the MultiProcessControlPlane of a
        multi-process run (`sched` is then a `_SchedulerProxy`), else
        None."""
        # Bound-pod accounting via watch events, not store LISTs: a LIST
        # deep-copies every object and was the harness's own hot spot.
        bound_keys: set[str] = set()

        def _track(obj):
            if obj.get("spec", {}).get("nodeName"):
                bound_keys.add(namespaced_name(obj))

        factory.informer("pods").add_event_handler(ResourceEventHandler(
            on_add=_track, on_update=lambda old, new: _track(new),
            on_delete=lambda obj: bound_keys.discard(namespaced_name(obj))))

        factory.start()
        await factory.wait_for_sync()
        run_task = asyncio.ensure_future(
            sched.run(batch_size=self.batch_size))

        result = WorkloadResult()
        node_count = 0
        pod_seq = 0
        created_total = 0
        device_classes: set[str] = set()
        agents: list = []
        agent_dir: str | None = None
        deadline = time.monotonic() + timeout
        finalize_error = None
        try:
            for op in template_ops:
                opcode = op["opcode"]
                if opcode == "startAgents":
                    # Agent-backed staging: N hollow-kubelet NodeAgents
                    # register their own Nodes and consume
                    # field-selector-filtered pod watches instead of
                    # createNodes' bare data staging. Their mark-Running
                    # writes and lease renewals ride the same store and
                    # loop as the workload.
                    count = _resolve_count(op, params)
                    tmpl = {**DEFAULT_NODE_TEMPLATE,
                            **(op.get("nodeTemplate") or {})}
                    if agent_dir is None:
                        agent_dir = tempfile.mkdtemp(prefix="ktpu-agents-")
                    new_agents = [
                        NodeAgent(store, f"node-{node_count + i}",
                                  checkpoint_dir=agent_dir,
                                  node_template=copy.deepcopy(tmpl),
                                  lease_period=float(_subst(
                                      op.get("leasePeriod", 5.0), params)))
                        for i in range(count)]
                    # Tracked before starting, so a mid-boot failure still
                    # stops every booted agent in the finally block.
                    agents.extend(new_agents)
                    t0 = time.monotonic()
                    await NodeAgent.start_many(new_agents)
                    result.agent_start_seconds += time.monotonic() - t0
                    node_count += count

                elif opcode == "churnOpenLoop":
                    # A TIMED open-loop arrival window with an optional
                    # deterministic fault timeline. No trailing barrier
                    # belongs after this op: a saturated run ends with
                    # unbound pods (that backlog IS the measurement).
                    created_total += await self._run_churn_phase(
                        op, params, result, metrics, backing, store,
                        sched, factory, agents, bound_keys, pod_seq)
                    pod_seq += result.churn_arrivals_total

                elif opcode == "createNodes":
                    count = _resolve_count(op, params)
                    tmpl = {**DEFAULT_NODE_TEMPLATE,
                            **(op.get("nodeTemplate") or {})}
                    # NUMA topology: a NodeResourceTopology per node,
                    # allocatable split across zones as a device-manager
                    # agent reports it. DRA: the DeviceClass once, then a
                    # ResourceSlice per node listing devices with their
                    # NUMA attribute.
                    topo = op.get("topologyTemplate")
                    dra = op.get("draTemplate")
                    t0 = time.monotonic()
                    if dra:
                        cls = dra.get("className", "tpu")
                        if cls not in device_classes:
                            await store.create(
                                "deviceclasses",
                                make_device_class(cls, {"type": cls}))
                            device_classes.add(cls)

                    async def stage_node(i):
                        name = f"node-{node_count + i}"
                        await store.create("nodes", make_node(
                            name, **copy.deepcopy(tmpl)))
                        if topo:
                            await store.create(
                                "noderesourcetopologies",
                                split_node_topology(
                                    name, tmpl.get("allocatable") or {},
                                    num_zones=int(topo.get("zones", 2)),
                                    devices=topo.get("devices")))
                        if dra:
                            zones = int(dra.get("zones", 2))
                            per = int(dra.get("devicesPerZone", 4))
                            devices = [
                                {"name": f"dev-{z}-{k}",
                                 "attributes": {"type": cls,
                                                "numa": str(z)}}
                                for z in range(zones) for k in range(per)]
                            await store.create(
                                "resourceslices",
                                make_resource_slice(
                                    name, dra.get("driver", "dra.ktpu"),
                                    devices))

                    for lo in range(0, count, 512):
                        await asyncio.gather(*(
                            stage_node(i)
                            for i in range(lo, min(lo + 512, count))))
                    result.staging_seconds += time.monotonic() - t0
                    node_count += count

                elif opcode == "createPods":
                    count = _resolve_count(op, params)
                    tmpl = {**DEFAULT_POD_TEMPLATE,
                            **(op.get("podTemplate") or {})}
                    # DRA pods: one ResourceClaim per pod (the
                    # resourceclaim controller's output shape), created
                    # before the pod that references it.
                    claim_tmpl = tmpl.pop("claim", None)
                    measured = bool(op.get("collectMetrics"))
                    if measured:
                        window = self._begin_measure(metrics, backing)
                        await self._mp_begin()
                        self._start_profile()
                    names = [f"pod-{pod_seq + i}" for i in range(count)]

                    async def create_pod(name):
                        if not claim_tmpl:
                            await store.create("pods", make_pod(
                                name, **copy.deepcopy(tmpl)))
                            return
                        await store.create(
                            "resourceclaims", make_resource_claim(
                                f"{name}-c0",
                                requests=copy.deepcopy(
                                    claim_tmpl.get("requests") or []),
                                constraints=copy.deepcopy(
                                    claim_tmpl.get("constraints") or [])))
                        await store.create("pods", make_pod(
                            name, resource_claims=[{
                                "name": "c0",
                                "resourceClaimName": f"{name}-c0"}],
                            **copy.deepcopy(tmpl)))

                    for lo in range(0, count, 512):
                        await asyncio.gather(*(
                            create_pod(name)
                            for name in names[lo:lo + 512]))
                    pod_seq += count
                    created_total += count
                    if op.get("scopedBarrier") or measured:
                        pod_ns = tmpl.get("namespace", "default")
                        want = {f"{pod_ns}/{n}" for n in names}
                        await self._wait_keys(bound_keys, want, deadline,
                                              run_task)
                    if measured:
                        self._end_measure(result, metrics, backing, window,
                                          count)
                        await self._mp_end(result)
                        self._stop_profile()

                elif opcode == "ungatePods":
                    # Strip schedulingGates from every gated pod (the
                    # reference's gated-pods workload: a controller lifts
                    # the gate; PreEnqueue re-admits). The measured
                    # variant times gate removal -> all bound.
                    measured = bool(op.get("collectMetrics"))
                    if measured:
                        window = self._begin_measure(metrics, backing)
                        await self._mp_begin()
                        self._start_profile()
                    gated = [p for p in (await store.list("pods")).items
                             if p["spec"].get("schedulingGates")]

                    def strip(obj):
                        obj["spec"].pop("schedulingGates", None)
                        return obj
                    for p in gated:
                        await store.guaranteed_update(
                            "pods", namespaced_name(p), strip)
                    if measured:
                        await self._wait_bound(bound_keys, created_total,
                                               deadline, run_task)
                        self._end_measure(result, metrics, backing, window,
                                          len(gated))
                        await self._mp_end(result)
                        self._stop_profile()

                elif opcode == "relistStorm":
                    # Every agent reconnects AT ONCE: tear down its
                    # watch, full LIST, re-watch (NodeAgent.force_relist).
                    # With the watch cache active the N LISTs are reads of
                    # one shared snapshot (hit/miss deltas recorded); the
                    # direct-mvcc path pays N table scans.
                    h0, m0 = self._cache_totals(backing)
                    t0 = time.monotonic()
                    await asyncio.gather(
                        *(a.force_relist() for a in agents))
                    result.relist_storm_seconds = time.monotonic() - t0
                    result.relist_storm_agents = len(agents)
                    h1, m1 = self._cache_totals(backing)
                    result.relist_storm_cache_hits = int(h1 - h0)
                    result.relist_storm_cache_misses = int(m1 - m0)

                elif opcode == "barrier":
                    await self._wait_bound(bound_keys, created_total,
                                           deadline, run_task)

                elif opcode == "sleep":
                    await asyncio.sleep(float(
                        _subst(op.get("duration", 0), params)))

                elif opcode == "churn":
                    # Delete + recreate a slice of pods: queue pressure
                    # and cache-update load (the reference's churnOp).
                    count = _resolve_count(op, params)
                    pods = (await store.list("pods")).items[:count]
                    for p in pods:
                        await store.delete("pods", namespaced_name(p))
                    created_total -= len(pods)
                    # Wait for the deletions to reach the informer before
                    # recreating, or the next barrier reads stale bound
                    # keys.
                    while len(bound_keys) > created_total \
                            and time.monotonic() < deadline:
                        await asyncio.sleep(0.01)
                    tmpl = {**DEFAULT_POD_TEMPLATE,
                            **(op.get("podTemplate") or {})}
                    for i in range(len(pods)):
                        await store.create("pods", make_pod(
                            f"pod-{pod_seq + i}", **copy.deepcopy(tmpl)))
                    pod_seq += len(pods)
                    created_total += len(pods)

                else:
                    raise ValueError(f"unknown opcode {opcode!r}")
        finally:
            # A window an exception cut short still writes its trace.
            self._stop_profile()
            if agents:
                await asyncio.gather(
                    *(a.stop() for a in agents), return_exceptions=True)
            if agent_dir is not None:
                shutil.rmtree(agent_dir, ignore_errors=True)
            await sched.stop()
            run_task.cancel()
            factory.stop()
            # The recorder's last event writes go out before the client
            # that carries them closes.
            await sched.recorder.flush()
            if cp is not None:
                # WAL/HA counters live in the children: pull them while
                # the shard sockets still answer (best effort on an
                # exception path — the primary failure must surface).
                try:
                    await self._finalize_multiproc(result, backing)
                except Exception as e:
                    finalize_error = e
            if client is not None:
                await client.close()
            if server is not None:
                await server.stop()
            if cp is not None:
                await backing.close()
                await cp.stop()
                self._cp = None
                self._mp = None
            else:
                backing.stop()
        if run_task.done() and not run_task.cancelled() \
                and run_task.exception() is not None:
            raise run_task.exception()
        if finalize_error is not None:
            raise finalize_error

        result.shard_count = int(getattr(backing, "node_shards", 1))
        if cp is not None:
            # The leader's status row gave the counts; its assume-cache,
            # which fragmentation reads, stays in its process.
            return result
        if result.measured_pods == 0:
            h = metrics.attempt_duration
            labels = {"result": "scheduled",
                      "profile": "default-scheduler"}
            result.attempt_p50 = h.percentile(0.50, **labels)
            result.attempt_p90 = h.percentile(0.90, **labels)
            result.attempt_p99 = h.percentile(0.99, **labels)
        result.scheduled_total = _result_count(metrics, "scheduled")
        result.unschedulable_total = _result_count(metrics, "unschedulable")
        result.fragmentation_pct = self._fragmentation(sched)
        result.fragmentation_occupied_pct = \
            self._fragmentation_occupied(sched)
        metrics.fragmentation_pct.set(result.fragmentation_occupied_pct)
        result.events_emitted_total = sched.recorder.emitted
        result.events_dropped_total = sched.recorder.dropped
        if self.backend is not None:
            result.solve_provenance = solve_provenance(self.backend.device)
        return result

    def _start_profile(self) -> None:
        if self.profile_dir:
            self.backend.start_profile(self.profile_dir)

    def _stop_profile(self) -> None:
        if self.profile_dir:
            self.backend.stop_profile()

    async def _run_churn_phase(self, op: Mapping, params: Mapping[str, Any],
                               result: WorkloadResult, metrics, backing,
                               store, sched: Scheduler, factory,
                               agents: list,
                               bound_keys: set, pod_seq: int) -> int:
        """Execute one churnOpenLoop op; returns the net pod-count delta
        (arrivals + fault creates − fault deletes) for created_total."""
        duration = float(_subst(op.get("duration", 5.0), params))
        seed = int(_subst(op.get("seed", 0), params))
        arrival = {k: _subst(v, params)
                   for k, v in (op.get("arrival")
                                or {"model": "poisson", "rate": 100}).items()}
        process = make_arrival_process(arrival, seed=seed)
        churn_metrics = ChurnMetrics(metrics.registry)
        measured = bool(op.get("collectMetrics"))
        tmpl = {**DEFAULT_POD_TEMPLATE, **(op.get("podTemplate") or {})}
        pod_ns = tmpl.get("namespace", "default")

        async def create_arrival(name: str, template: dict | None = None):
            await store.create("pods", make_pod(
                name, **(template if template is not None
                         else copy.deepcopy(tmpl))))

        driver = ChurnDriver(
            process, duration,
            create_pod=create_arrival,
            backlog_stats=sched.queue.stats,
            # Keep scheduler_pending_pods{queue} fresh under saturation
            # (the scheduler only refreshes it per popped batch).
            on_backlog=metrics.set_pending,
            metrics=churn_metrics,
            name_prefix=f"churn{pod_seq}")

        injector = None
        timeline = []
        nlc = None
        fault_specs = op.get("faults") or []
        if fault_specs:
            timeline = build_fault_timeline(
                [{k: _subst(v, params) for k, v in f.items()}
                 for f in fault_specs],
                seed=seed,
                node_names=[a.node_name for a in agents])
            injector = FaultInjector(
                store=store, agents=agents, bound_keys=bound_keys,
                create_pod=create_arrival,
                backlog_fn=sched.queue.backlog_depth,
                control_plane=self._cp,
                metrics=churn_metrics, pod_template=tmpl,
                recovery_threshold=int(_subst(
                    op.get("recoveryThreshold", 10), params)),
                recovery_timeout=float(_subst(
                    op.get("recoveryTimeout", 60.0), params)),
                namespace=pod_ns)
            if any(ev.kind == "nodeDeath" for ev in timeline):
                # Node death needs the lease-expiry machinery live: a
                # killed agent's Lease goes stale, the controller taints
                # unreachable after the grace period, and the NoExecute
                # manager evicts.
                tol = float(_subst(op.get("tolerationSeconds", 0.25),
                                   params))
                nlc = NodeLifecycleController(
                    store,
                    node_monitor_period=0.1,
                    node_monitor_grace_period=float(_subst(
                        op.get("nodeGracePeriod", 1.0), params)),
                    default_toleration_seconds=tol,
                    # The admission default stamps 300s on every pod; the
                    # scenario's toleration knob caps it so the eviction
                    # clock runs at bench speed.
                    toleration_seconds_cap=tol)
                nlc.setup(factory)
                factory.informer("leases").start()
                await factory.informer("leases").wait_for_sync()
                nlc.start()

        # Rebalance family: an optional descheduler closes the
        # consolidation loop DURING the churn window, and a fragmentation
        # sampler records the over-time curve the on/off pair compares.
        # `descheduler: {enabled, period, budget, threshold}` on the op
        # pins it per workload; absent, the KTPU_DESCHEDULER flag rules.
        desch = None
        dcfg = op.get("descheduler")
        if dcfg is None:
            d_on = bool(flags.get("KTPU_DESCHEDULER"))
            dcfg = {}
        else:
            dcfg = {k: _subst(v, params) for k, v in dcfg.items()}
            d_on = bool(dcfg.get("enabled", True))
        if d_on:
            desch = DeschedulerController(
                store,
                period=float(dcfg.get("period", 0.25)),
                budget=int(dcfg["budget"]) if "budget" in dcfg else None,
                threshold=float(dcfg.get("threshold", 0.5)),
                device=getattr(self.backend, "device", None))
            desch.setup(factory)
            for res in ("pods", "nodes"):
                factory.informer(res).start()
                await factory.informer(res).wait_for_sync()
            desch.start()

        curve: list[list[float]] = []
        sample_every = float(_subst(op.get("sampleInterval", 0.0), params))

        def _point(t0: float) -> list[float]:
            return [round(time.monotonic() - t0, 3),
                    round(self._fragmentation(sched), 2),
                    round(self._fragmentation_occupied(sched), 2)]

        async def _sample(t0: float) -> None:
            while True:
                curve.append(_point(t0))
                await asyncio.sleep(sample_every)

        window = self._begin_measure(metrics, backing) if measured \
            else None
        if measured:
            await self._mp_begin()
            self._start_profile()
        inj_task = None
        sampler = None
        t0 = time.monotonic()
        try:
            if sample_every > 0:
                sampler = asyncio.ensure_future(_sample(t0))
            if injector is not None:
                inj_task = asyncio.ensure_future(injector.run(timeline, t0))
            phase = await driver.run(t0)
            if inj_task is not None:
                await inj_task
                await injector.drain()
            if desch is not None:
                # Recovery: stop proposing moves, then the bounded wait
                # for the backlog (evicted replacements included) to
                # drain back under the threshold.
                await desch.stop()
                r0 = time.monotonic()
                r_deadline = r0 + float(_subst(
                    op.get("recoveryTimeout", 30.0), params))
                thresh = int(_subst(op.get("recoveryThreshold", 10),
                                    params))
                while time.monotonic() < r_deadline \
                        and sched.queue.backlog_depth() > thresh:
                    await asyncio.sleep(0.05)
                result.churn_rebalance_recovery_s = round(
                    time.monotonic() - r0, 3)
        finally:
            # On an exception, stop the timeline and its handlers (a
            # no-op after a clean drain).
            if inj_task is not None and not inj_task.done():
                inj_task.cancel()
                await asyncio.gather(inj_task, return_exceptions=True)
            if injector is not None:
                await injector.cancel()
            if sampler is not None:
                sampler.cancel()
                await asyncio.gather(sampler, return_exceptions=True)
                # one last point so the curve shows the recovered state
                curve.append(_point(t0))
            if desch is not None:
                if not desch._stopped:
                    await desch.stop()
                result.churn_descheduler_evictions = desch.evictions
            if nlc is not None:
                await nlc.stop()
        result.churn_fragmentation_curve = curve
        if measured:
            self._end_measure(result, metrics, backing, window,
                              phase.arrivals_total)
            await self._mp_end(result)
            self._stop_profile()
        result.churn_offered_rate = phase.offered_rate
        result.churn_achieved_rate = phase.achieved_rate
        result.churn_arrival_model = phase.arrival_model
        result.churn_arrivals_total = phase.arrivals_total
        result.churn_duration_s = phase.duration
        result.churn_backlog_peak = phase.backlog_peak
        result.churn_backlog_final = phase.backlog_final
        result.churn_pending_final = dict(phase.pending_final)
        result.churn_saturated = is_saturated(
            phase.arrivals_total, phase.backlog_final,
            float(_subst(op.get("saturationFrac", 0.2), params)),
            offered_rate=phase.offered_rate,
            achieved_rate=phase.achieved_rate)
        result.churn_late_arrivals = phase.late_arrivals
        result.churn_throttled_creates = phase.throttled_creates
        result.churn_create_errors = phase.create_errors
        result.churn_create_drain_s = phase.create_drain_s
        net = phase.arrivals_total
        if injector is not None:
            result.churn_faults = list(injector.results)
            counts: dict[str, int] = {}
            for rec in injector.results:
                counts[rec["kind"]] = counts.get(rec["kind"], 0) + 1
            result.churn_faults_injected = counts
            recoveries = [rec["recovery_s"] for rec in injector.results
                          if rec.get("recovery_s") is not None]
            if recoveries:
                result.churn_recovery_seconds_max = max(recoveries)
            net += injector.net_created
        return net

    async def _install_policies(self, backing) -> None:
        """The overhead knob: N pass-through pod policies + bindings.
        With policy_tenants > 0 the set is tenant-sharded instead:
        realistic multi-tenant matching for the O(matching) index."""
        if not self.policy_count:
            return
        if self.policy_tenants:
            await self._install_tenant_policies(backing)
            return
        for i in range(self.policy_count):
            name = f"bench-policy-{i}"
            await backing.create(
                "validatingadmissionpolicies",
                make_validating_admission_policy(name, [
                    {"expression": "size(object.spec.containers) >= 1"
                                   " and not has(object.spec.paused)",
                     "message": "bench policy"}],
                    match_constraints={"resourceRules": [
                        {"resources": ["pods"],
                         "operations": ["CREATE"]}]}))
            await backing.create("validatingadmissionpolicybindings",
                                 make_vap_binding(f"{name}-b", name))

    async def _install_tenant_policies(self, backing) -> None:
        """Realistic tenant shards (PolicyScale's shape): N policies
        across T tenant namespaces — 4 of 5 are pod-CREATE policies
        scoped by a per-tenant namespaceSelector (the bench's pods land
        in "default", labeled tenant t0, so only ~N·0.8/T of them
        match: ~1% at 1000/100), 1 of 5 carries disjoint non-pod
        resourceRules the exact-key index never surfaces for a pod
        create. A ~1% slice of pod policies (stride 97, coprime with
        the tenant stride so breadth never correlates with one tenant's
        whole shard) adds a matchConditions prefilter + a variables
        entry (the breadth surface rides the measured path) and a
        second, paramRef-carrying binding against a shared per-tenant
        ConfigMap (prebuilt param closures exercised)."""
        tenants = self.policy_tenants
        other_rules = ["configmaps", "secrets", "services",
                       "deployments", "leases", "replicasets",
                       "statefulsets", "daemonsets"]
        for t in range(tenants):
            ns = make_namespace(f"tenant-{t}")
            ns["metadata"]["labels"] = {"ktpu.io/tenant": f"t{t}"}
            await backing.create("namespaces", ns)
        # The measured pods ride the "default" namespace: label it as
        # tenant t0 so exactly that tenant's shard applies.
        default_ns = make_namespace("default")
        default_ns["metadata"]["labels"] = {"ktpu.io/tenant": "t0"}
        try:
            await backing.create("namespaces", default_ns)
        except AlreadyExists:
            cur = await backing.get("namespaces", "default")
            cur.setdefault("metadata", {})["labels"] = {
                "ktpu.io/tenant": "t0"}
            await backing.update("namespaces", cur)
        for t in range(tenants):
            await backing.create(
                "configmaps",
                make_config_map(f"tenant-caps-{t}",
                                data={"maxPriority": "1000000"}))
        for i in range(self.policy_count):
            t = i % tenants
            name = f"tenant-policy-{i}"
            if i % 5 == 4:
                # Disjoint non-pod rules: a pod CREATE never surfaces
                # these from the exact-key index (and the linear scan
                # pays for skipping them — the comparison's point).
                constraints = {"resourceRules": [
                    {"resources": [other_rules[i % len(other_rules)]],
                     "operations": ["CREATE", "UPDATE"]}]}
            else:
                constraints = {
                    "resourceRules": [{"resources": ["pods"],
                                       "operations": ["CREATE"]}],
                    "namespaceSelector": {
                        "matchLabels": {"ktpu.io/tenant": f"t{t}"}},
                }
            kwargs = {}
            validations = [
                {"expression": "size(object.spec.containers) >= 1"
                               " and not has(object.spec.paused)",
                 "message": f"tenant t{t} policy"}]
            spec_extra = {}
            if i % 97 == 0 and i % 5 != 4:
                spec_extra = {
                    "matchConditions": [
                        {"name": "has-spec",
                         "expression": "has(object.spec)"}],
                    "variables": [
                        {"name": "cset",
                         "expression": "object.spec.containers"}],
                }
                validations = [
                    {"expression": "size(variables.cset) >= 1",
                     "message": f"tenant t{t} policy"}]
                kwargs["param_kind"] = "ConfigMap"
            policy = make_validating_admission_policy(
                name, validations, match_constraints=constraints,
                **kwargs)
            policy["spec"].update(spec_extra)
            await backing.create("validatingadmissionpolicies", policy)
            await backing.create("validatingadmissionpolicybindings",
                                 make_vap_binding(f"{name}-b", name))
            if kwargs:
                await backing.create(
                    "validatingadmissionpolicybindings",
                    make_vap_binding(f"{name}-pb", name, param_ref={
                        "name": f"tenant-caps-{t}",
                        "namespace": "default"}))

    def _policy_totals(self) -> tuple[float, ...]:
        """(evals, index hits, residue scans, rebuilds, audit events,
        audit drops) — the policy/audit counter snapshot the measured
        window differences."""
        evals = hits = residue = rebuilds = audits = dropped = 0.0
        if self._policy_engine is not None:
            eng = self._policy_engine
            evals = sum(eng.evaluations._values.values())
            hits = eng.index_hits.value()
            residue = eng.index_residue_scans.value()
            rebuilds = eng.index_rebuilds.value()
        if self._audit is not None:
            audits = sum(
                self._audit.sink.events_total._values.values())
            dropped = self._audit.sink.events_dropped.value()
        return evals, hits, residue, rebuilds, audits, dropped

    @staticmethod
    def _cache_totals(backing) -> tuple[float, float]:
        """(hits, misses) of the store's watch-cache tier (0s when the
        KTPU_WATCH_CACHE=0 kill switch disabled it)."""
        cacher = getattr(backing, "cacher", None)
        if cacher is None:
            return 0.0, 0.0
        return cacher.metrics.hits.value(), cacher.metrics.misses.value()

    async def _mp_begin(self) -> None:
        """Open the child-side measured window (multi-process runs
        only): the leader marks its exact attempt recorder."""
        if self._mp is not None:
            await self._mp.begin()

    async def _mp_end(self, result: WorkloadResult) -> None:
        """Close the child-side window: the leader's exact attempt
        percentiles override the parent's recorder (which never saw an
        attempt — scheduling happened in another process). A failover
        mid-window can eat the marker; the parent-side wall-clock
        throughput from _end_measure then stands alone."""
        if self._mp is None:
            return
        row = await self._mp.end()
        try:
            pcts = {q: float(row[k]) for q, k in (
                (0.50, "p50"), (0.90, "p90"),
                (0.99, "p99"), (0.999, "p999"))}
        except (KeyError, TypeError, ValueError):
            return
        if math.isnan(pcts[0.50]):
            return
        result.attempt_p50 = pcts[0.50]
        result.attempt_p90 = pcts[0.90]
        result.attempt_p99 = pcts[0.99]
        result.attempt_p999 = pcts[0.999]
        result.attempt_percentiles_exact = True

    async def _finalize_multiproc(self, result: WorkloadResult,
                                  backing) -> None:
        """Pull the run's child-process counters (leader status row +
        per-shard WAL stats) — must run BEFORE the control plane stops:
        the sums live in the children, not the parent."""

        def _i(v) -> int:
            try:
                return int(v)
            except (TypeError, ValueError):
                return 0

        row = await self._mp.status()
        result.process_count = int(backing.node_shards)
        result.scheduled_total = _i(row.get("scheduledTotal"))
        result.leader_elections_total = _i(row.get("elections"))
        if row.get("launches"):
            result.leader_kernel_launches = json.loads(row["launches"])
        if row.get("solveProvenance"):
            result.solve_provenance = json.loads(row["solveProvenance"])
        total = (await backing.control_stats()).get("total") or {}
        result.wal_appends_total = _i(total.get("walAppends"))
        result.wal_replay_entries_total = _i(total.get("walReplayed"))
        result.wal_fsync_seconds_total = float(
            total.get("walFsyncSeconds") or 0.0)

    def _begin_measure(self, metrics: SchedulerMetrics, backing) -> dict:
        wm = backing.watch_metrics
        hits, misses = self._cache_totals(backing)
        return {
            "hist": metrics.attempt_duration.snapshot(
                result="scheduled", profile="default-scheduler"),
            "t0": time.monotonic(),
            "dispatched": wm.events_dispatched.value(),
            "checks": wm.predicate_checks.value(),
            "cache_hits": hits, "cache_misses": misses,
            "policy": self._policy_totals(),
            "solve_chunks": metrics.solve_duration.count(),
            "solve_s": metrics.solve_duration.sum(),
            "wave_commits": metrics.solver_wave_commits.value(),
            "wave_replays": metrics.solver_wave_replays.value(),
            "optimal": metrics.solver_optimal_solves.value(),
            "optimal_fallbacks": metrics.solver_optimal_fallbacks.value(),
            "fast": metrics.serving_fast_path_pods.value(),
            "coalesced": metrics.serving_coalesced_batches.value(),
            "refreshes": metrics.resident_plane_refreshes.value(),
            "refresh_s": metrics.resident_plane_refresh.sum(),
            "slice_gangs": metrics.slice_gangs_bound.value(),
            "topo_rebuilds": metrics.topology_plane_rebuilds.value(),
            "shard_rebuilds": sum(
                metrics.shard_tensor_rebuilds._values.values()),
            "shard_solve_s": sum(
                metrics.shard_solve_seconds._values.values()),
            "cross_shard": metrics.cross_shard_reductions.value(),
            "window": metrics.attempt_window().mark(),
        }

    def _end_measure(self, result: WorkloadResult,
                     metrics: SchedulerMetrics,
                     backing, base: dict, count: int) -> None:
        dt = time.monotonic() - base["t0"]
        result.measured_pods = count
        result.measured_seconds = dt
        result.throughput = count / dt if dt > 0 else 0.0
        h = metrics.attempt_duration
        labels = {"result": "scheduled", "profile": "default-scheduler"}
        result.attempt_p50 = h.percentile_since(0.50, base["hist"], **labels)
        result.attempt_p90 = h.percentile_since(0.90, base["hist"], **labels)
        result.attempt_p99 = h.percentile_since(0.99, base["hist"], **labels)
        # TRUE order-statistic percentiles over the measured window (the
        # exact recorder riding attempt_duration's observe path); the
        # bucket-edge values above remain only as the fallback when no
        # scheduled attempt landed in the window.
        exact = metrics.attempt_window().percentiles_since(
            base["window"], (0.50, 0.90, 0.99, 0.999))
        if not math.isnan(exact[0.50]):
            result.attempt_p50 = exact[0.50]
            result.attempt_p90 = exact[0.90]
            result.attempt_p99 = exact[0.99]
            result.attempt_p999 = exact[0.999]
            result.attempt_percentiles_exact = True
        wm = backing.watch_metrics
        result.watch_events_dispatched_total = int(
            wm.events_dispatched.value() - base["dispatched"])
        result.watch_predicate_checks_total = int(
            wm.predicate_checks.value() - base["checks"])
        hits, misses = self._cache_totals(backing)
        result.watch_cache_hits_total = int(hits - base["cache_hits"])
        result.watch_cache_misses_total = int(misses - base["cache_misses"])
        (result.policy_evaluations_total, result.policy_index_hits_total,
         result.policy_index_residue_scans_total,
         result.policy_index_rebuilds_total, result.audit_events_total,
         result.audit_events_dropped_total) = (
            int(now - then) for now, then in zip(
                self._policy_totals(), base["policy"]))
        result.solver_solve_chunks = int(
            metrics.solve_duration.count() - base["solve_chunks"])
        result.solver_solve_seconds_total = \
            metrics.solve_duration.sum() - base["solve_s"]
        result.solver_scan_width = int(metrics.solver_scan_width.value())
        result.solver_wave_width = int(metrics.solver_wave_width.value())
        result.solver_wave_commits_total = int(
            metrics.solver_wave_commits.value() - base["wave_commits"])
        result.solver_wave_replays_total = int(
            metrics.solver_wave_replays.value() - base["wave_replays"])
        result.solver_optimal_solves_total = int(
            metrics.solver_optimal_solves.value() - base["optimal"])
        result.solver_optimal_fallbacks_total = int(
            metrics.solver_optimal_fallbacks.value()
            - base["optimal_fallbacks"])
        result.serving_fast_path_pods_total = int(
            metrics.serving_fast_path_pods.value() - base["fast"])
        result.serving_coalesced_batches_total = int(
            metrics.serving_coalesced_batches.value() - base["coalesced"])
        result.resident_plane_refreshes_total = int(
            metrics.resident_plane_refreshes.value() - base["refreshes"])
        result.resident_plane_refresh_seconds_total = \
            metrics.resident_plane_refresh.sum() - base["refresh_s"]
        result.slice_gangs_bound_total = int(
            metrics.slice_gangs_bound.value() - base["slice_gangs"])
        result.topology_plane_rebuilds_total = int(
            metrics.topology_plane_rebuilds.value() - base["topo_rebuilds"])
        result.slice_fragmentation_pct = \
            metrics.slice_fragmentation_pct.value()
        # Gauge is base-unit seconds; the field keeps its ms name.
        result.admission_window_ms = 1e3 * metrics.admission_window.value()
        result.shard_tensor_rebuilds_total = int(
            sum(metrics.shard_tensor_rebuilds._values.values())
            - base["shard_rebuilds"])
        result.shard_solve_seconds = sum(
            metrics.shard_solve_seconds._values.values()) \
            - base["shard_solve_s"]
        result.cross_shard_reductions_total = int(
            metrics.cross_shard_reductions.value() - base["cross_shard"])

    @staticmethod
    async def _wait_bound(bound_keys: set, want: int, deadline: float,
                          run_task: asyncio.Task) -> None:
        """barrierOp: block until every created pod has a nodeName."""
        while time.monotonic() < deadline:
            if len(bound_keys) >= want:
                return
            _raise_if_loop_died(run_task)
            await asyncio.sleep(0.01)
        raise TimeoutError(
            f"barrier: {len(bound_keys)}/{want} pods bound at timeout")

    @staticmethod
    async def _wait_keys(bound_keys: set, want: set, deadline: float,
                         run_task: asyncio.Task) -> None:
        """Scoped barrier: block until a specific key set is bound."""
        while time.monotonic() < deadline:
            if want <= bound_keys:
                return
            _raise_if_loop_died(run_task)
            await asyncio.sleep(0.01)
        missing = len(want - bound_keys)
        raise TimeoutError(
            f"scoped barrier: {missing} pods unbound at timeout")

    @staticmethod
    def _fragmentation(sched: Scheduler) -> float:
        """Mean free-capacity fraction across nodes (%, lower = tighter)."""
        snapshot = sched.cache.update_snapshot()
        if not len(snapshot):
            return 0.0
        total = 0.0
        for ni in snapshot:
            fracs = []
            for r, alloc in ni.allocatable.res.items():
                if alloc > 0:
                    fracs.append(
                        max(0.0, (alloc - ni.requested.get(r)) / alloc))
            total += sum(fracs) / len(fracs) if fracs else 1.0
        return 100.0 * total / len(snapshot)

    @staticmethod
    def _fragmentation_occupied(sched: Scheduler) -> float:
        """Mean free-capacity fraction across OCCUPIED nodes (%, the
        packing metric — ops/solver.fragmentation_occupied's host twin).
        Empty cluster → 0.0."""
        snapshot = sched.cache.update_snapshot()
        total = 0.0
        occupied = 0
        for ni in snapshot:
            if not ni.pods:
                continue
            occupied += 1
            fracs = []
            for r, alloc in ni.allocatable.res.items():
                if alloc > 0:
                    fracs.append(
                        max(0.0, (alloc - ni.requested.get(r)) / alloc))
            total += sum(fracs) / len(fracs) if fracs else 1.0
        return 100.0 * total / occupied if occupied else 0.0


def _raise_if_loop_died(run_task: asyncio.Task) -> None:
    """A barrier must not wait out its deadline on a scheduler loop that
    already raised (a backend or fast-path exception ends `run`)."""
    if run_task.done() and not run_task.cancelled() \
            and run_task.exception() is not None:
        raise run_task.exception()


def _result_count(metrics: SchedulerMetrics, result: str) -> int:
    return int(metrics.schedule_attempts.value(
        result=result, profile="default-scheduler"))


def load_config(path: str | None = None) -> list[dict]:
    """The workload suite: a YAML file in the reference's format, or, with
    no path, SchedulingBasic alone (no YAML parser needed)."""
    if path is None:
        return [copy.deepcopy(SCHEDULING_BASIC)]
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def run_suite(config: list[dict], backend_factory=None, batch_size: int = 1,
              filter_name: str | None = None, timeout: float = 600.0,
              profile_dir: str | None = None,
              through_apiserver: bool | str = False) -> dict[str, dict]:
    """Run every (testcase × workload) pair, like BenchmarkPerfScheduling.
    A family's `throughApiserver`, `policyCount`, `policyTenants` and
    `auditLevel` pin its boundary and its policy and audit load, so a
    headline row is reproducible from the config alone;
    `through_apiserver` is the boundary of families that name none."""
    out: dict[str, dict] = {}
    for case in config:
        for wl in case.get("workloads") or [{"name": "default", "params": {}}]:
            full = f"{case['name']}/{wl['name']}"
            if filter_name and filter_name not in full:
                continue
            backend = backend_factory() if backend_factory else None
            runner = PerfRunner(backend=backend, batch_size=batch_size,
                                scheduler_config=case.get("schedulerConfig"),
                                through_apiserver=case.get(
                                    "throughApiserver", through_apiserver),
                                profile_dir=profile_dir,
                                policy_count=case.get("policyCount", 0),
                                policy_tenants=case.get(
                                    "policyTenants", 0),
                                audit_rules=[{"level": case["auditLevel"]}]
                                if case.get("auditLevel") else None)
            res = asyncio.run(runner.run(
                case["workloadTemplate"], wl.get("params") or {},
                timeout=timeout))
            out[full] = res.as_dict()
    return out


DEFAULT_BATCH_SIZE = 16384  # the reference bench's --batch-size


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config", nargs="?", default=None,
                    help="workload YAML (default: SchedulingBasic)")
    ap.add_argument("--backend", choices=["host", "torch"], default="torch",
                    help="torch (default): TorchBackend on the card; host: "
                         "the pure-Python host path only")
    ap.add_argument("--device", default=None,
                    help="TorchBackend device (default cuda:0; `cpu` runs "
                         "the kernels' plain versions)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help=f"pods per pop (default {DEFAULT_BATCH_SIZE} with "
                         "--backend torch, 1 with --backend host)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="OVERRIDE the backend solve chunk")
    ap.add_argument("--filter", default=None)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="per-workload deadline in seconds")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace of each "
                         "measured window here (--backend torch only)")
    ap.add_argument("--through-apiserver", choices=["", "http", "wire"],
                    default="",
                    help="cross the process boundary: all traffic (agent "
                         "watches included) rides the chosen apiserver "
                         "wire instead of direct store calls")
    args = ap.parse_args(argv)

    factory = None
    batch = args.batch_size
    if batch is None:
        batch = DEFAULT_BATCH_SIZE if args.backend == "torch" else 1
    if args.backend == "torch":
        from kubernetes_tpu_torch.ops.backend import TorchBackend
        batch = max(batch, 128)
        chunk = None if args.chunk is None \
            else max(min(args.chunk, batch), 2)
        factory = lambda: TorchBackend(  # noqa: E731
            device=args.device, max_batch=chunk)
    boundary = {"": False, "http": True, "wire": "wire"}[
        args.through_apiserver]
    results = run_suite(load_config(args.config), backend_factory=factory,
                        batch_size=batch, filter_name=args.filter,
                        timeout=args.timeout, profile_dir=args.profile_dir,
                        through_apiserver=boundary)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
