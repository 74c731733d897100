"""The port's wavefront solve against the JAX Pallas kernel and solvers:
the multistart (poison) form.

Same seeded numpy inputs go through the reference's
`pallas_kernel.wave_solve(interpret=True)` (the Pallas kernel, run in
interpret mode on the CPU as the JAX package's own tests run it), its
multistart wrapper `multistart_greedy_assign_wave_pallas` and the W=1
multistart `_multistart_body` (the port's `multistart_greedy_assign`), and
through the port's `wave_solve` (on CPU tensors: its plain version
`wave_solve_reference`) and solver functions.
The replay form (poison=False) and the one-member waves are held in
tests/test_torch_wave_replay.py; each (W, strategy, form) costs one
interpret-mode compile of the reference kernel, so the two files let the
test workers share that cost.

Contract: assignments, commits, replays and poisoned flags are IDENTICAL —
no tolerance. The fixtures are class planes with exception columns and a
conflict storm (small identical nodes, equal static scores, so picks tie
everywhere and same-wave debits conflict), which drives both the in-wave
replay (poison=False) and the poisoned multistart rerun.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import pallas_kernel
from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu_torch.ops import solver as tsolver
from kubernetes_tpu_torch.ops import wave_kernel

STRATEGIES = ("LeastAllocated", "MostAllocated", "RequestedToCapacityRatio")
WIDTHS = (2, 8, 31)
K = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def storm(seed: int, n: int = 24, p: int = 40, r: int = 3, classes: int = 4):
    """Conflict storm over class planes: identical small nodes (every
    score ties), contested capacity and pod slots, exception columns.
    Returns the solver argument dict (numpy) and K pod orders."""
    rng = np.random.default_rng(seed)
    alloc = np.tile(rng.integers(3, 6, size=(1, r)) * 1000,
                    (n, 1)).astype(np.int32)
    used = np.zeros((n, r), np.int32)
    used[n // 2:] = alloc[n // 2:] // 4          # two node groups
    class_req = rng.integers(400, 1800, size=(classes, r)).astype(np.int32)
    rows = rng.integers(1, classes, size=(p,)).astype(np.int32)
    mask = rng.random((classes, n)) > 0.1
    mask[0] = False                               # the reserved empty class
    static = np.repeat(rng.integers(0, 3, size=(classes, 1)), n,
                       axis=1).astype(np.float32)
    exc = np.full((p,), -1, np.int32)
    pinned = rng.choice(p, size=5, replace=False)
    exc[pinned] = rng.integers(0, n, size=5).astype(np.int32)
    perms = np.stack([np.arange(p, dtype=np.int32)]
                     + [rng.permutation(p).astype(np.int32)
                        for _ in range(K - 1)])
    args = dict(
        req_q=class_req[rows], req_nz_q=class_req[rows],
        free_q=alloc - used,
        free_pods=rng.integers(1, 4, size=(n,)).astype(np.int32),
        used_nz_q=used, alloc_q=alloc, mask=mask, static_scores=static,
        fit_col_w=np.ones((r,), np.float32),
        bal_col_mask=np.ones((r,), np.bool_),
        shape_u=np.array([0.0, 50.0, 100.0], np.float32),
        shape_s=np.array([0.0, 4.0, 10.0], np.float32),
        w_fit=np.float32(1.0), w_bal=np.float32(1.0))
    return args, rows, exc, perms


def loose(seed: int, n: int = 48, p: int = 40, r: int = 2):
    """Uncontested cluster: roomy nodes and a static score that puts pod i
    on its own node i by a wide margin, so no same-wave debit can beat a
    pick — the speculation commits and no order is poisoned."""
    rng = np.random.default_rng(seed)
    alloc = rng.integers(20, 60, size=(n, r)).astype(np.int32) * 1000
    used = (alloc * rng.uniform(0, 0.3, size=(n, r))).astype(np.int32)
    req = rng.integers(100, 2000, size=(p, r)).astype(np.int32)
    static = rng.uniform(0, 4, size=(p, n)).astype(np.float32)
    static[np.arange(p), np.arange(p)] += 500.0
    mask = rng.random((p, n)) > 0.1
    mask[np.arange(p), np.arange(p)] = True
    perms = np.stack([np.arange(p, dtype=np.int32)]
                     + [rng.permutation(p).astype(np.int32)
                        for _ in range(K - 1)])
    args = dict(
        req_q=req, req_nz_q=req, free_q=alloc - used,
        free_pods=np.full((n,), 50, np.int32), used_nz_q=used,
        alloc_q=alloc, mask=mask,
        static_scores=static,
        fit_col_w=np.ones((r,), np.float32),
        bal_col_mask=np.ones((r,), np.bool_),
        shape_u=np.array([0.0, 100.0], np.float32),
        shape_s=np.array([0.0, 10.0], np.float32),
        w_fit=np.float32(1.0), w_bal=np.float32(1.0))
    return args, np.arange(p, dtype=np.int32), None, perms


def gangs(p: int):
    """Three gangs over the first pods, one of them unsatisfiable."""
    onehot = np.zeros((p, 16), np.float32)
    onehot[0:6, 0] = 1.0
    onehot[6:10, 1] = 1.0
    onehot[10:13, 2] = 1.0
    required = np.zeros((16,), np.float32)
    required[:3] = (6.0, 4.0, 99.0)
    return onehot, required


def _torch(args: dict) -> dict:
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) and v.ndim else float(v))
            for k, v in args.items()}


def _opt(x):
    return None if x is None else torch.from_numpy(x)


_JAX_WAVE = jax.jit(pallas_kernel.wave_solve,
                    static_argnames=("strategy", "wave_w", "poison",
                                     "interpret"))


def _jax_wave(args, strategy, w, rows, exc, poison, perms):
    out = _JAX_WAVE(**args, strategy=strategy, wave_w=w, rows=rows,
                    exc=exc, poison=poison, perms=perms, interpret=True)
    return [np.asarray(o) for o in out]


def _torch_wave(args, strategy, w, rows, exc, poison, perms):
    out = wave_kernel.wave_solve(
        **_torch(args), strategy=strategy, wave_w=w, rows=_opt(rows),
        exc=_opt(exc), poison=poison, perms=_opt(perms))
    return [o.numpy() for o in out]


def _assert_same(got, ref, what):
    for name, g, r in zip(("assign", "commits", "replays", "poisoned"),
                          got, ref):
        np.testing.assert_array_equal(g, r, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_multistart_poison_form_matches_pallas(strategy, w):
    """K=4 orders, poison=True: per-order speculative assignments, commit
    counts and poison flags equal the Pallas kernel's."""
    args, rows, exc, perms = storm(seed=STRATEGIES.index(strategy))
    ref = _jax_wave(args, strategy, w, rows, exc, True, perms)
    got = _torch_wave(args, strategy, w, rows, exc, True, perms)
    _assert_same(got, ref, f"{strategy} W={w} poison")


@pytest.mark.parametrize("fixture", (storm, loose))
def test_multistart_wrappers_match_reference(fixture):
    """The port's kernel-route multistart (and its scan-route twin)
    against `multistart_greedy_assign_wave_pallas`, with gangs: the
    storm poisons and reruns the chunk one pod per step, the loose
    cluster takes the speculative assignments."""
    args, rows, exc, perms = fixture(seed=30)
    onehot, required = gangs(args["req_q"].shape[0])
    a, com, rep = jsolver.multistart_greedy_assign_wave_pallas(
        **args, strategy="LeastAllocated", wave_w=8, perms=perms,
        gang_onehot=onehot, gang_required=required, rows=rows, exc=exc,
        interpret=True)
    ref = (np.asarray(a), int(com), int(rep))
    targs = dict(**_torch(args), strategy="LeastAllocated", wave_w=8,
                 perms=torch.from_numpy(perms),
                 gang_onehot=torch.from_numpy(onehot),
                 gang_required=torch.from_numpy(required), rows=_opt(rows),
                 exc=_opt(exc))
    for fn in (tsolver.multistart_greedy_assign_wave_kernel,
               tsolver.multistart_greedy_assign_wave):
        got_a, got_com, got_rep = fn(**targs)
        np.testing.assert_array_equal(got_a.numpy(), ref[0],
                                      err_msg=fn.__name__)
        assert (got_com, got_rep) == ref[1:], fn.__name__
    p = args["req_q"].shape[0]
    assert ref[1:] == ((0, p) if fixture is storm else (p, 0))


def test_multistart_body_matches_reference():
    """The W=1 multistart (the poisoned chunk's rerun) with gangs."""
    args, rows, exc, perms = storm(seed=40)
    onehot, required = gangs(args["req_q"].shape[0])
    body = jax.jit(partial(jsolver._multistart_body,
                           strategy="MostAllocated"))
    ref = np.asarray(body(**args, perms=perms, gang_onehot=onehot,
                          gang_required=required, rows=jnp.asarray(rows),
                          exc=jnp.asarray(exc)))
    got = tsolver.multistart_greedy_assign(
        **_torch(args), strategy="MostAllocated",
        perms=torch.from_numpy(perms), gang_onehot=torch.from_numpy(onehot),
        gang_required=torch.from_numpy(required), rows=_opt(rows),
        exc=_opt(exc))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[10:13] == -1).all()               # the unsatisfiable gang
