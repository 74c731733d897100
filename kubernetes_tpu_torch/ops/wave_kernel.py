"""The wavefront batch solve as one hand-written CUDA kernel launch.

Counterpart of `kubernetes_tpu/ops/pallas_kernel.py`: `wave_solve` there
is a Pallas kernel for the TPU (grid = K multistart orders × waves); here
it is `csrc/wave_solve.cu`, built for `sm_90a` with `nvcc` at first use
into `build/torch_kernels/` under the checkout (one library with every
kernel of `csrc/`, see `KernelLibrary`), loaded with `ctypes`, and launched
on PyTorch's current stream. The same source holds the trivial
probe kernel (x + 1), the counterpart of `lowering_supported`'s probe: the
loader launches it once after the build and raises if its output is wrong.

`wave_solve` runs the kernel for CUDA tensors and its plain PyTorch
version, `wave_solve_reference`, for CPU tensors. On the card there is no
fallback: a build, load or launch failure raises, and so does a shape the
kernel does not take.

Each wrapper counts its kernel launches in a plain integer attribute
(`wave_solve.launches`, `probe.launches`), so a run can show that the main
path went through the kernel.

`wave_launch_plan` is the pure function that shapes a `wave_solve` launch
(one thread-block cluster per order, its carry in shared memory where a
block's slice fits, else in global scratch); see `csrc/wave_solve.cu`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

import torch

from kubernetes_tpu_torch.ops import solver

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
#: The CUDA sources built into the one kernel library; every header beside
#: them (*.cuh, *.h) is an input of the build too.
SOURCES = (CSRC / "wave_solve.cu", CSRC / "wave_eval.cu")
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"

#: nvcc flags: Hopper with its architecture-specific features, and IEEE
#: float arithmetic (no FMA contraction; division and square root stay
#: correctly rounded because fast math is off).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

STRATEGIES = {"LeastAllocated": 0, "MostAllocated": 1,
              "RequestedToCapacityRatio": 2}

#: Shape limits of csrc/wave_solve.cu (kMaxW, kMaxR, kMaxThreads) and of
#: the card's clusters (16 blocks with the non-portable size allowed).
MAX_WAVE_W = 64
MAX_R = 16
MAX_CLUSTER = 16
MAX_THREADS = 256
#: Shared memory one block may use on an H100 (227 KB), and room left in it
#: for the kernel's static shared arrays (nvcc's report in PERF.md gives
#: their size; a plan that overflows fails at launch and raises).
SMEM_PER_BLOCK = 232_448
STATIC_SMEM_BUDGET = 10_240
#: The launch shape chosen by a sweep on the card (chip_smoke.py phase 5):
#: a block scans at most this many nodes, with this many threads.
NODES_PER_BLOCK = 320
THREADS = 256

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@dataclass(frozen=True)
class WavePlan:
    """The shape of one `wave_solve` launch: K clusters of `cluster` blocks
    of `threads` threads; block r owns nodes [r*nodes_per_block,
    (r+1)*nodes_per_block) ∩ [0, N); `carry` "shared" keeps the order's
    carry of that slice in `smem_bytes` of dynamic shared memory per
    block, "global" in per-order global scratch (smem_bytes 0)."""

    cluster: int
    nodes_per_block: int
    threads: int
    smem_bytes: int
    carry: str


def carry_bytes(nodes: int, r: int) -> int:
    """Dynamic shared memory of a block whose slice has `nodes` nodes of R
    resources: free_q, used_nz and alloc_q (R ints each), free_pods (an
    int) and the "taken" byte per node (csrc/wave_solve.cu carry_bytes)."""
    return 4 * nodes * (3 * r + 1) + nodes


def _slice_fits(nodes: int, r: int) -> bool:
    return carry_bytes(nodes, r) + STATIC_SMEM_BUDGET <= SMEM_PER_BLOCK


def wave_launch_plan(n: int, r: int, w: int) -> WavePlan:
    """The launch plan of `wave_solve` over N nodes of R resources at wave
    width W. The cluster grows in powers of two until each block's slice
    is at most NODES_PER_BLOCK nodes (1 block for small N) and its carry
    fits in shared memory, up to MAX_CLUSTER blocks; a slice that still
    does not fit keeps its carry in global memory. Raises on a shape
    neither form takes."""
    if not (n >= 1 and 1 <= r <= MAX_R and 1 <= w <= MAX_WAVE_W):
        raise ValueError(
            f"wave_solve kernel does not take this chunk shape: N={n}, R={r} "
            f"(max {MAX_R}), W={w} (max {MAX_WAVE_W})")
    cs = 1
    while cs < MAX_CLUSTER and (-(-n // cs) > NODES_PER_BLOCK
                                or not _slice_fits(-(-n // cs), r)):
        cs *= 2
    per = -(-n // cs)
    if _slice_fits(per, r):
        return WavePlan(cs, per, THREADS, carry_bytes(per, r), "shared")
    return WavePlan(cs, per, THREADS, 0, "global")


def _check_plan_shape(plan: WavePlan, n: int, r: int) -> None:
    """Raise unless `plan` covers N nodes in a shape the kernel takes."""
    ok = (1 <= plan.cluster <= MAX_CLUSTER and plan.nodes_per_block >= 1
          and plan.cluster * plan.nodes_per_block >= n
          and 32 <= plan.threads <= MAX_THREADS and plan.threads % 32 == 0
          and (plan.carry == "global" and plan.smem_bytes == 0
               or plan.carry == "shared"
               and plan.smem_bytes == carry_bytes(plan.nodes_per_block, r)
               and _slice_fits(plan.nodes_per_block, r)))
    if not ok:
        raise ValueError(f"wave_solve launch plan {plan} does not take "
                         f"N={n}, R={r}")


class KernelLibrary:
    """The built and loaded shared library of the CUDA sources in csrc/.

    `build()` compiles each source with its own nvcc, all started together,
    links the objects into one library, loads it, declares the C
    signatures, and launches the probe kernel once, raising if its output
    is wrong. The library's file name carries a hash of every source and
    header it is built from and of the flags (`library_path`), so a change
    to any of them builds a new library. `ptxas_info` keeps nvcc's register
    and shared-memory report.
    """

    def __init__(self, sources=SOURCES, build_dir: Path = BUILD_DIR):
        self.sources = tuple(Path(s) for s in sources)
        self.build_dir = build_dir
        self.lib = None
        self.path: Path | None = None
        self.ptxas_info = ""
        #: The bound C entry points, kept for the launch paths.
        self.probe_fn = None
        self.wave_solve_fn = None
        self.wave_eval_fn = None
        self.wave_topk_fn = None
        self.wave_resolve_fn = None

    def inputs(self) -> list[Path]:
        """The sources and every header in their directories."""
        headers = {h for d in {s.parent for s in self.sources}
                   for pattern in ("*.cuh", "*.h") for h in d.glob(pattern)}
        return [*self.sources, *sorted(headers)]

    def library_path(self) -> Path:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in self.inputs():
            digest.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
        return self.build_dir / f"libktpu_kernels_{digest.hexdigest()[:16]}.so"

    def _compile(self, path: Path) -> None:
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        with tempfile.TemporaryDirectory(dir=self.build_dir) as tmp_dir, \
                contextlib.ExitStack() as logs:
            tmp = Path(tmp_dir)
            jobs = []
            for i, src in enumerate(self.sources):
                obj = tmp / f"{i}_{src.stem}.o"
                log = logs.enter_context(open(tmp / f"{i}.log", "w+"))
                jobs.append((src, obj, log, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=log, stderr=subprocess.STDOUT)))
            # Every nvcc ends before any failure is raised.
            rcs = [proc.wait() for _, _, _, proc in jobs]
            reports = []
            for (src, _, log, _), rc in zip(jobs, rcs):
                log.seek(0)
                reports.append(log.read())
                if rc != 0:
                    raise RuntimeError(
                        f"nvcc failed ({rc}) on {src}:\n{reports[-1]}")
            lib_tmp = tmp / path.name
            proc = subprocess.run(
                [nvcc, "-shared", "-o", str(lib_tmp),
                 *(str(obj) for _, obj, _, _ in jobs)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) linking {path.name}:\n"
                    f"{proc.stderr}")
            self.ptxas_info = "".join(reports)
            lib_tmp.replace(path)

    def build(self) -> "KernelLibrary":
        if self.lib is not None:
            return self
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        self.build_dir.mkdir(parents=True, exist_ok=True)
        path = self.library_path()
        if not path.exists():
            self._compile(path)
        lib = ctypes.CDLL(str(path))
        lib.ktpu_error_string.argtypes = [_I]
        lib.ktpu_error_string.restype = ctypes.c_char_p
        for name in ("ktpu_max_wave_width", "ktpu_max_resources",
                     "ktpu_max_shape_points", "ktpu_wave_eval_max_members",
                     "ktpu_wave_eval_max_shards", "ktpu_wave_step_max_w",
                     "ktpu_wave_resolve_static_smem"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = _I
        lib.ktpu_probe.argtypes = [_VP, _VP, _I, _VP]
        lib.ktpu_probe.restype = _I
        lib.ktpu_wave_solve.argtypes = (
            [_VP] * 15 + [_I, _F, _F, _I] + [_I] * 12 + [_VP] * 7)
        lib.ktpu_wave_solve.restype = _I
        lib.ktpu_wave_eval.argtypes = (
            [_VP] * 16 + [_I, _F, _F, _I] + [_I] * 5 + [_VP] * 3)
        lib.ktpu_wave_eval.restype = _I
        lib.ktpu_wave_topk.argtypes = [_VP] * 7
        lib.ktpu_wave_topk.restype = _I
        lib.ktpu_wave_resolve.argtypes = [_VP] * 9
        lib.ktpu_wave_resolve.restype = _I
        if lib.ktpu_wave_resolve_static_smem() < 0:
            raise RuntimeError("cannot read wave_resolve_kernel's attributes")
        self.lib = lib
        self.path = path
        self.max_w = lib.ktpu_max_wave_width()
        self.max_r = lib.ktpu_max_resources()
        self.max_s = lib.ktpu_max_shape_points()
        self.max_eval_w = lib.ktpu_wave_eval_max_members()
        self.max_eval_shards = lib.ktpu_wave_eval_max_shards()
        self.max_step_w = lib.ktpu_wave_step_max_w()
        self.resolve_static_smem = lib.ktpu_wave_resolve_static_smem()
        self.probe_fn = lib.ktpu_probe
        self.wave_solve_fn = lib.ktpu_wave_solve
        self.wave_eval_fn = lib.ktpu_wave_eval
        self.wave_topk_fn = lib.ktpu_wave_topk
        self.wave_resolve_fn = lib.ktpu_wave_resolve
        try:
            probe_check(self)
        except RuntimeError:
            self.lib = self.probe_fn = None
            self.wave_solve_fn = self.wave_eval_fn = None
            self.wave_topk_fn = self.wave_resolve_fn = None
            raise
        return self

    def check(self, rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(
                f"{what} launch failed: {self.lib.ktpu_error_string(rc)!r}")


#: The process's kernel library; built at the first CUDA launch.
LIBRARY = KernelLibrary()

_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_F32 = torch.float32


def _stream(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on t's device, without
    building a `torch.cuda.Stream` object where this PyTorch can."""
    if _raw_stream is not None:
        return _raw_stream(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def probe(x: torch.Tensor, lib: KernelLibrary | None = None) -> torch.Tensor:
    """x + 1 through the probe kernel (f32, contiguous, on the card)."""
    lib = lib or LIBRARY
    fn = lib.probe_fn or lib.build().probe_fn
    if not (x.is_cuda and x.dtype is _F32 and x.is_contiguous()):
        raise ValueError("probe takes a contiguous float32 CUDA tensor")
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        rc = fn(x.data_ptr(), out.data_ptr(), n, _stream(x))
        probe.launches += 1
        if rc:
            lib.check(rc, "probe")
    return out


probe.launches = 0


def probe_check(lib: KernelLibrary | None = None) -> None:
    """Launch the probe kernel on one (8, 128) f32 tile and raise unless it
    returns x + 1 — the once-per-build gate in front of the real kernel,
    which every CUDA backend also runs when it is created."""
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device="cuda").reshape(8, 128)
    got = probe(x, lib)
    torch.cuda.synchronize()
    if not torch.equal(got, x + 1):
        raise RuntimeError("probe kernel returned a wrong result")


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(C, N) bool → (C, ceil(N/8)) uint8, big-endian bit order
    (np.packbits' layout, the reference's wire format)."""
    c, n = mask.shape
    m = torch.nn.functional.pad(mask.to(torch.uint8), (0, (-n) % 8))
    # The bit weights 128 ... 1, made on the device (a host list would be
    # a copy that waits for the card).
    weights = torch.bitwise_left_shift(
        1, torch.arange(7, -1, -1, device=mask.device)).to(torch.uint8)
    return (m.reshape(c, -1, 8) * weights).sum(dim=-1).to(torch.uint8)


def wave_solve(req_q, req_nz_q, free_q, free_pods, used_nz_q, alloc_q,
               mask, static_scores, fit_col_w, bal_col_mask, shape_u,
               shape_s, w_fit, w_bal, strategy: str, wave_w: int,
               rows, exc, *, poison: bool, perms=None,
               plan: WavePlan | None = None):
    """The full wavefront solve of one chunk, every order in one launch.

    Argument contract of the reference's `pallas_kernel.wave_solve`: class
    planes `mask` (C, N) bool and `static_scores` (C, N) f32 addressed
    through `rows`, exception column `exc` (None = none), `perms` (K, P)
    pod orders (None = the identity order alone). Returns (assign (K, P)
    int32 in PERMUTED pod coordinates, commits (K,), replays (K,),
    poisoned (K,) bool). CUDA tensors launch the kernel; CPU tensors run
    `wave_solve_reference`. `plan` (default `wave_launch_plan(N, R, W)`)
    shapes the launch.
    """
    if free_q.device.type == "cpu":
        return wave_solve_reference(
            req_q, req_nz_q, free_q, free_pods, used_nz_q, alloc_q, mask,
            static_scores, fit_col_w, bal_col_mask, shape_u, shape_s,
            w_fit, w_bal, strategy, wave_w, rows, exc, poison=poison,
            perms=perms)
    lib = LIBRARY.build()
    dev = free_q.device
    p, r = req_q.shape
    n = free_q.shape[0]
    c = mask.shape[0]
    s = shape_u.shape[0]
    W = max(1, min(wave_w, p))
    if exc is None:
        exc = torch.full((p,), -1, dtype=torch.int32, device=dev)
    if perms is None:
        perms = torch.arange(p, dtype=torch.int32, device=dev)[None]
    k = perms.shape[0]
    _check(dev, torch.int32, (p, r), req_q=req_q, req_nz_q=req_nz_q)
    _check(dev, torch.int32, (n, r), free_q=free_q, used_nz_q=used_nz_q,
           alloc_q=alloc_q)
    _check(dev, torch.int32, (n,), free_pods=free_pods)
    _check(dev, torch.int32, (p,), rows=rows, exc=exc)
    _check(dev, torch.int32, (k, p), perms=perms)
    _check(dev, torch.bool, (c, n), mask=mask)
    _check(dev, torch.float32, (c, n), static_scores=static_scores)
    _check(dev, torch.float32, (r,), fit_col_w=fit_col_w)
    _check(dev, torch.bool, (r,), bal_col_mask=bal_col_mask)
    _check(dev, torch.float32, (s,), shape_u=shape_u, shape_s=shape_s)
    if not (1 <= W <= lib.max_w and 1 <= r <= lib.max_r
            and 1 <= s <= lib.max_s and n >= 1 and c >= 1 and k >= 1):
        raise ValueError(
            f"wave_solve kernel does not take this chunk shape: W={W} "
            f"(max {lib.max_w}), R={r} (max {lib.max_r}), shape points="
            f"{s} (max {lib.max_s}), N={n}, C={c}, K={k}")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown scoring strategy {strategy!r}")
    if plan is None:
        plan = wave_launch_plan(n, r, W)
    else:
        _check_plan_shape(plan, n, r)
    bits = pack_bits(mask)
    assign = torch.empty((k, p), dtype=torch.int32, device=dev)
    stats = torch.empty((k, 4), dtype=torch.int32, device=dev)
    # The global form's per-order carry: free_q, free_pods, used_nz, taken.
    scratch = [torch.empty(shape, dtype=dtype, device=dev)
               for shape, dtype in (((k, n, r), torch.int32),
                                    ((k, n), torch.int32),
                                    ((k, n, r), torch.int32),
                                    ((k, n), torch.uint8))] \
        if plan.carry == "global" else []
    scratch_ptrs = [t.data_ptr() for t in scratch] or [None] * 4
    rc = lib.wave_solve_fn(
        req_q.data_ptr(), req_nz_q.data_ptr(), rows.data_ptr(),
        exc.data_ptr(), perms.data_ptr(), free_q.data_ptr(),
        free_pods.data_ptr(), used_nz_q.data_ptr(), alloc_q.data_ptr(),
        bits.data_ptr(), static_scores.data_ptr(), fit_col_w.data_ptr(),
        bal_col_mask.data_ptr(), shape_u.data_ptr(), shape_s.data_ptr(),
        s, float(w_fit), float(w_bal), STRATEGIES[strategy],
        k, p, n, r, bits.shape[1], W, int(poison), plan.cluster,
        plan.nodes_per_block, plan.threads, plan.smem_bytes,
        int(plan.carry == "shared"), assign.data_ptr(), stats.data_ptr(),
        *scratch_ptrs, _stream(free_q))
    wave_solve.launches += 1
    lib.check(rc, "wave_solve")
    return assign, stats[:, 0], stats[:, 1], stats[:, 2] > 0


wave_solve.launches = 0


def _check(device, dtype, shape, **tensors) -> None:
    """Raise unless every tensor lies on `device` with `dtype`, `shape`
    and a contiguous layout."""
    shape = tuple(shape)
    for name, t in tensors.items():
        if t.dtype is not dtype or t.shape != shape or t.device != device \
                or not t.is_contiguous():
            raise ValueError(
                f"kernel input {name} must be a contiguous {dtype} tensor of "
                f"shape {tuple(shape)} on {device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def wave_solve_reference(req_q, req_nz_q, free_q, free_pods, used_nz_q,
                         alloc_q, mask, static_scores, fit_col_w,
                         bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                         strategy: str, wave_w: int, rows, exc, *,
                         poison: bool, perms=None):
    """Plain PyTorch version of `wave_solve`: the reference's wavefront scan
    (`solver._rescoring_wave_scan`) run once per order, with the pod
    vectors permuted and the class planes addressed through rows[perm]."""
    p = req_q.shape[0]
    if perms is None:
        perms = torch.arange(p, dtype=torch.int32, device=req_q.device)[None]
    assigns, commits, replays, poisoned = [], [], [], []
    for perm in perms.long():
        a, ncom, nrep, pois = solver._rescoring_wave_scan(
            req_q[perm], req_nz_q[perm], free_q, free_pods, used_nz_q,
            alloc_q, mask, static_scores, fit_col_w, bal_col_mask, shape_u,
            shape_s, w_fit, w_bal, strategy, wave_w, rows[perm],
            None if exc is None else exc[perm], poison=poison)
        assigns.append(a)
        commits.append(ncom)
        replays.append(nrep)
        poisoned.append(pois)
    dev = req_q.device
    return (torch.stack(assigns),
            torch.tensor(commits, dtype=torch.int32, device=dev),
            torch.tensor(replays, dtype=torch.int32, device=dev),
            torch.tensor(poisoned, dtype=torch.bool, device=dev))
