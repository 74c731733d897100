"""Device meshes for the node-sharded solver.

Counterpart of `kubernetes_tpu/parallel/mesh.py`. There a mesh is a
`jax.sharding.Mesh` of devices; here it is a small `Mesh`: axis names,
their sizes, and one `torch.device` per shard, in flattened order with the
first axis major. A device may repeat: S shards can sit on one card (the
default is `cuda:0`, repeated), which is how this package runs the sharded
solver on one GPU and, with `device="cpu"`, on the CPU — where the JAX
package uses its virtual host devices.

The axes keep the reference's meaning: `nodes` shards the node axis (the
solver's per-step argmax reduces across it), `pods` shards the pod axis of
the mask/score phase, and `slice` is the outer axis of a multislice mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_tpu_torch.ops.tensorize import NODE_PAD

NODES_AXIS = "nodes"
PODS_AXIS = "pods"
SLICE_AXIS = "slice"


@dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes, and one device per shard (flattened, first
    axis major)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) \
                or math.prod(self.sizes) != len(self.devices):
            raise ValueError(
                f"mesh axes {self.axis_names} of sizes {self.sizes} do not "
                f"match {len(self.devices)} devices")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size, as `jax.sharding.Mesh.shape` reads."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every shard sits on. A mesh over several devices
        needs a transport between them, which this package does not have
        yet (ROADMAP, "Blocked on hardware: multi-GPU")."""
        devs = sorted(map(str, set(self.devices)))
        if len(devs) != 1:
            raise NotImplementedError(
                f"a mesh over several devices {devs} needs a transport "
                "across cards (ROADMAP, \"Blocked on hardware: multi-GPU\"); "
                "put every shard on one device")
        return self.devices[0]


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh defaults to the CUDA device cuda:0, and there is "
                "none; pass device='cpu' to run the shards on the CPU")
        return torch.device("cuda:0")
    return torch.device(device)


def _shards(n: int, what: str) -> int:
    if n < 1:
        raise ValueError(f"{what} must be at least 1, got {n}")
    return n


def build_mesh(n_shards: int = 1, device=None) -> Mesh:
    """1-D mesh over the node axis (the solver's axis): `n_shards` shards,
    all on `device` (default cuda:0)."""
    dev = _device(device)
    n = _shards(n_shards, "n_shards")
    return Mesh((NODES_AXIS,), (n,), (dev,) * n)


def build_multislice_mesh(n_slices: int, chips_per_slice: int = 1,
                          device=None) -> Mesh:
    """(slice × nodes) mesh: the node dimension shards over both axes,
    flattened slice-major, and the solver's reductions run over `nodes`
    first, then `slice`. The shard count must divide NODE_PAD, the
    multiple the node axis is padded to."""
    dev = _device(device)
    total = _shards(n_slices, "n_slices") * _shards(chips_per_slice,
                                                     "chips_per_slice")
    if NODE_PAD % total:
        raise ValueError(
            f"{n_slices}x{chips_per_slice}={total} shards must divide "
            f"NODE_PAD={NODE_PAD} (use a power-of-two shard count)")
    return Mesh((SLICE_AXIS, NODES_AXIS), (n_slices, chips_per_slice),
                (dev,) * total)


def build_mesh_2d(n_devices: int = 1, pods_parallelism: int | None = None,
                  device=None) -> Mesh:
    """(pods × nodes) mesh for the mask/score phase. The factorization
    favours the nodes axis (N ≫ P in every configuration)."""
    dev = _device(device)
    n = _shards(n_devices, "n_devices")
    if pods_parallelism is None:
        pods_parallelism = 1
        for f in range(int(math.isqrt(n)), 0, -1):
            if n % f == 0:
                pods_parallelism = f
                break
    if pods_parallelism < 1 or n % pods_parallelism:
        raise ValueError(
            f"pods_parallelism {pods_parallelism} does not divide {n}")
    return Mesh((PODS_AXIS, NODES_AXIS), (pods_parallelism,
                                          n // pods_parallelism), (dev,) * n)


def pad_axis(x: np.ndarray, multiple: int, axis: int,
             fill=0) -> np.ndarray:
    """Pad one axis up to a multiple so it divides the mesh axis evenly."""
    size = x.shape[axis]
    target = math.ceil(size / multiple) * multiple
    if target == size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - size)
    return np.pad(x, widths, constant_values=fill)
