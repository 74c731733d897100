"""The device-topology workloads through both packages' scheduler_perf
runners on the CPU.

- `DEVICE_TOPOLOGY` and `DEVICE_TOPOLOGY_DRA` equal their entries in the
  reference's `performance-config.yaml`.
- DeviceTopology/100Nodes (100 nodes of cpu 16 / 64Gi / 8 TPUs in two
  NUMA zones, 50 + 300 pods of cpu 2 / 1Gi / 2 TPUs; the workload's own
  profile with NodeResourceTopologyMatch) through the port's `PerfRunner`
  on `TorchBackend(device="cpu")` and the JAX one on `TPUBackend`: both
  bind all 350 pods with no unschedulable attempt and the same
  all-nodes fragmentation; re-packed from each store with the port's
  `pack_zones`, every pod's TPUs sit in one zone and no zone is over its
  capacity.
- DeviceTopologyDRA/100Nodes (a ResourceSlice of 8 devices per node, 4 per
  `numa`; each pod one claim for 2 devices matching on `numa`): both bind
  all 350; every claim in each store is allocated on its pod's node, on
  one `numa`, no (node, device) pair twice, 700 devices in use. Both
  runners also count unschedulable attempts here: the solve has no device
  column, so a dispatch can stack more claims on a node than its devices
  hold, and the verify rejects the excess, which requeues (ROADMAP queue
  3); their number depends on how pods meet the loop's pops, so it is not
  compared.

The barriers wait on the runners' own deadline (120 s).

Tolerance: none.
"""

import asyncio
from pathlib import Path

import pytest
import torch

from chip_smoke import claim_violations, over_capacity, zone_violations
from kubernetes_tpu.ops.backend import TPUBackend
from kubernetes_tpu.perf import scheduler_perf as jperf
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.perf import scheduler_perf as tperf

YAML = Path(__file__).resolve().parent.parent / "kubernetes_tpu" / "perf" \
    / "config" / "performance-config.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_device_constants_equal_the_yaml_entries():
    entries = {c["name"]: c for c in jperf.load_config(str(YAML))}
    for const in (tperf.DEVICE_TOPOLOGY, tperf.DEVICE_TOPOLOGY_DRA):
        assert const == entries[const["name"]], const["name"]


def run_cell(perf_mod, family, backend):
    """(result dict, {resource: objects}) of `family`/100Nodes through
    `perf_mod`'s PerfRunner, the store read back after the run."""
    seen = {}

    class Runner(perf_mod.PerfRunner):
        async def _drive(self, *args):
            seen["store"] = args[3]
            return await super()._drive(*args)

    params = next(w["params"] for w in family["workloads"]
                  if w["name"] == "100Nodes")
    runner = Runner(backend=backend, batch_size=16384,
                    scheduler_config=family.get("schedulerConfig"))
    result = asyncio.run(runner.run(family["workloadTemplate"], params,
                                    timeout=120.0))
    objects = {r: asyncio.run(seen["store"].list(r)).items
               for r in ("nodes", "pods", "noderesourcetopologies",
                         "resourceclaims", "resourceslices")}
    return result.as_dict(), objects


def families(name):
    jfam = next(c for c in jperf.load_config(str(YAML)) if c["name"] == name)
    tfam = {"DeviceTopology": tperf.DEVICE_TOPOLOGY,
            "DeviceTopologyDRA": tperf.DEVICE_TOPOLOGY_DRA}[name]
    return tfam, jfam


def test_device_topology_cell_matches_reference():
    tfam, jfam = families("DeviceTopology")
    got, tobj = run_cell(tperf, tfam, TorchBackend(device="cpu"))
    want, jobj = run_cell(jperf, jfam, TPUBackend(mesh=None))
    for key in ("measured_pods", "scheduled_total", "unschedulable_total",
                "fragmentation_pct"):
        assert got[key] == want[key], key
    assert got["scheduled_total"] == 350 and got["unschedulable_total"] == 0
    for obj in (tobj, jobj):
        assert len(obj["noderesourcetopologies"]) == 100
        assert sum(bool(p["spec"].get("nodeName"))
                   for p in obj["pods"]) == 350
        assert not zone_violations(obj["nodes"], obj["pods"],
                                   obj["noderesourcetopologies"])
        assert not over_capacity(obj["nodes"], obj["pods"])


def test_device_topology_dra_cell_matches_reference():
    tfam, jfam = families("DeviceTopologyDRA")
    got, tobj = run_cell(tperf, tfam, TorchBackend(device="cpu"))
    want, jobj = run_cell(jperf, jfam, TPUBackend(mesh=None))
    for key in ("measured_pods", "scheduled_total"):
        assert got[key] == want[key], key
    assert got["scheduled_total"] == 350
    for obj in (tobj, jobj):
        assert len(obj["resourceslices"]) == 100
        assert len(obj["resourceclaims"]) == 350
        faults, in_use = claim_violations(obj["pods"], obj["resourceclaims"],
                                          obj["resourceslices"])
        assert not faults and in_use == 700
        assert not over_capacity(obj["nodes"], obj["pods"])
