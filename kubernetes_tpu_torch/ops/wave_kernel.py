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
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import shutil
import subprocess
import tempfile
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

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


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
                     "ktpu_wave_eval_max_shards"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = _I
        lib.ktpu_probe.argtypes = [_VP, _VP, _I, _VP]
        lib.ktpu_probe.restype = _I
        lib.ktpu_wave_solve.argtypes = (
            [_VP] * 15 + [_I, _F, _F, _I] + [_I] * 7 + [_VP] * 6)
        lib.ktpu_wave_solve.restype = _I
        lib.ktpu_wave_eval.argtypes = (
            [_VP] * 16 + [_I, _F, _F, _I] + [_I] * 5 + [_VP] * 3)
        lib.ktpu_wave_eval.restype = _I
        self.lib = lib
        self.path = path
        self.max_w = lib.ktpu_max_wave_width()
        self.max_r = lib.ktpu_max_resources()
        self.max_s = lib.ktpu_max_shape_points()
        self.max_eval_w = lib.ktpu_wave_eval_max_members()
        self.max_eval_shards = lib.ktpu_wave_eval_max_shards()
        try:
            probe_check(self)
        except RuntimeError:
            self.lib = None
            raise
        return self

    def check(self, rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(
                f"{what} launch failed: {self.lib.ktpu_error_string(rc)!r}")


#: The process's kernel library; built at the first CUDA launch.
LIBRARY = KernelLibrary()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def probe(x: torch.Tensor, lib: KernelLibrary | None = None) -> torch.Tensor:
    """x + 1 through the probe kernel (f32, contiguous, on the card)."""
    lib = lib or LIBRARY.build()
    if not (x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()):
        raise ValueError("probe takes a contiguous float32 CUDA tensor")
    out = torch.empty_like(x)
    rc = lib.lib.ktpu_probe(x.data_ptr(), out.data_ptr(), x.numel(),
                            _stream(x))
    probe.launches += 1
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
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=mask.device)
    return (m.reshape(c, -1, 8) * weights).sum(dim=-1).to(torch.uint8)


def wave_solve(req_q, req_nz_q, free_q, free_pods, used_nz_q, alloc_q,
               mask, static_scores, fit_col_w, bal_col_mask, shape_u,
               shape_s, w_fit, w_bal, strategy: str, wave_w: int,
               rows, exc, *, poison: bool, perms=None):
    """The full wavefront solve of one chunk, every order in one launch.

    Argument contract of the reference's `pallas_kernel.wave_solve`: class
    planes `mask` (C, N) bool and `static_scores` (C, N) f32 addressed
    through `rows`, exception column `exc` (None = none), `perms` (K, P)
    pod orders (None = the identity order alone). Returns (assign (K, P)
    int32 in PERMUTED pod coordinates, commits (K,), replays (K,),
    poisoned (K,) bool). CUDA tensors launch the kernel; CPU tensors run
    `wave_solve_reference`.
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
    bits = pack_bits(mask)
    assign = torch.empty((k, p), dtype=torch.int32, device=dev)
    stats = torch.empty((k, 4), dtype=torch.int32, device=dev)
    carry_q = torch.empty((k, n, r), dtype=torch.int32, device=dev)
    carry_pods = torch.empty((k, n), dtype=torch.int32, device=dev)
    carry_nz = torch.empty((k, n, r), dtype=torch.int32, device=dev)
    rc = lib.lib.ktpu_wave_solve(
        req_q.data_ptr(), req_nz_q.data_ptr(), rows.data_ptr(),
        exc.data_ptr(), perms.data_ptr(), free_q.data_ptr(),
        free_pods.data_ptr(), used_nz_q.data_ptr(), alloc_q.data_ptr(),
        bits.data_ptr(), static_scores.data_ptr(), fit_col_w.data_ptr(),
        bal_col_mask.data_ptr(), shape_u.data_ptr(), shape_s.data_ptr(),
        s, float(w_fit), float(w_bal), STRATEGIES[strategy],
        k, p, n, r, bits.shape[1], W, int(poison),
        assign.data_ptr(), stats.data_ptr(), carry_q.data_ptr(),
        carry_pods.data_ptr(), carry_nz.data_ptr(), _stream(free_q))
    wave_solve.launches += 1
    lib.check(rc, "wave_solve")
    return assign, stats[:, 0], stats[:, 1], stats[:, 2] > 0


wave_solve.launches = 0


def _check(device, dtype, shape, **tensors) -> None:
    """Raise unless every tensor lies on `device` with `dtype`, `shape`
    and a contiguous layout."""
    for name, t in tensors.items():
        if t.device != device or t.dtype != dtype \
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
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
