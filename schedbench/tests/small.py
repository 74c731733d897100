"""Cells of the benchmark cut to a size a CPU test run holds: the same
configuration and traffic files, fewer nodes and pods, the port's kernels
in their plain versions on the CPU."""

from __future__ import annotations

from schedbench import harness


def small_spec(cell: str, nodes: int, init: int, round_pods: int) -> dict:
    spec = harness.cell_spec(harness.load_benchmark(), cell)
    groups = spec["config"]["nodeGroups"]
    for g in groups:
        g["count"] = nodes // len(groups)
    spec["config"]["initPods"] = init
    spec["traffic"]["round_pods"] = round_pods
    return spec


def basic_spec() -> dict:
    return small_spec("basic-5000n-burst", 200, 300, 300)
