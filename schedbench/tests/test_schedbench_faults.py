"""A run with the timed path broken underneath comes out not correct: a
step that returns its state unchanged, half of each dispatch left out, and
an answer altered where it is produced. (One chip: no exchange between
chips to leave out.)"""

import pytest

from schedbench import run
from schedbench.tests.small import basic_spec


class _Fault:
    """Forwards to the backend; once armed (when the window opens) its
    `broken` stream replaces assign_stream."""

    def __init__(self, inner):
        self._inner = inner
        self._first = None
        self._armed = False

    def arm(self):
        self._armed = True

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __setattr__(self, name, value):
        if name in ("_inner", "_first", "_armed"):
            object.__setattr__(self, name, value)
        else:
            setattr(self._inner, name, value)

    def assign_stream(self, pods, snapshot, fwk):
        if self._first is None:
            self._first = snapshot
        if not self._armed:
            return self._inner.assign_stream(pods, snapshot, fwk)
        return self.broken(pods, snapshot, fwk)


class StaleState(_Fault):
    """Every dispatch of the window solves against the snapshot of the
    first dispatch of the run: the used state never advances."""

    async def broken(self, pods, snapshot, fwk):
        async for item in self._inner.assign_stream(pods, self._first, fwk):
            yield item


class HalfLeftOut(_Fault):
    """Only the first half of each dispatch is solved; the rest is
    reported unplaced (and requeued by the scheduler)."""

    async def broken(self, pods, snapshot, fwk):
        pods = list(pods)
        half = pods[: max(1, len(pods) // 2)]
        async for chunk, ctx in self._inner.assign_stream(half, snapshot,
                                                           fwk):
            yield chunk, ctx
        for pi in pods[len(half):]:
            ctx.assignments[pi.key] = None
            ctx.diagnostics.setdefault(pi.key, {})
        yield pods[len(half):], ctx


class AnswerAltered(_Fault):
    """Each placement moves to the next node of the snapshot."""

    async def broken(self, pods, snapshot, fwk):
        names = [ni.name for ni in snapshot.nodes]
        nxt = {n: names[(i + 1) % len(names)] for i, n in enumerate(names)}
        async for chunk, ctx in self._inner.assign_stream(pods, snapshot,
                                                          fwk):
            for pi in chunk:
                node = ctx.assignments.get(pi.key)
                if node:
                    ctx.assignments[pi.key] = nxt[node]
            yield chunk, ctx


@pytest.mark.parametrize("fault", [StaleState, HalfLeftOut, AnswerAltered])
def test_a_broken_timed_path_is_not_correct(fault):
    out, rows = run.execute(basic_spec(), 2 ** 31 + 7, 3.0, False,
                            device="cpu", fault=fault)
    assert out is not None
    assert out["correct"] is False, out["compared"]


def test_the_unbroken_path_is_correct():
    out, _ = run.execute(basic_spec(), 2 ** 31 + 7, 2.0, False,
                         device="cpu")
    assert out["correct"] is True, out["compared"]
