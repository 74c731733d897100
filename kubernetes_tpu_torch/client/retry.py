"""Client-side retry helpers (client-go util/retry).

`retry_on_conflict` is the remote-store CAS loop: GET → mutate → PUT with
the observed resourceVersion, retrying on Conflict — RetryOnConflict in
the reference. Shared by every remote store implementation (HTTP
RemoteStore, KTPU WireStore) so the semantics can't drift between wires.

Copy of `kubernetes_tpu/client/retry.py`.
"""

from __future__ import annotations

import copy
from typing import Callable

from kubernetes_tpu_torch.store.mvcc import Conflict


async def retry_on_conflict(
    store, resource: str, key: str,
    mutate: Callable[[dict], dict | None],
    max_retries: int = 16, return_copy: bool = True,
) -> dict | None:
    """guaranteed_update over a remote store's get/update surface."""
    for _ in range(max_retries):
        current = await store.get(resource, key)
        want_rv = current["metadata"]["resourceVersion"]
        pristine = copy.deepcopy(current) if return_copy else None
        updated = mutate(current)
        if updated is None:
            # mutate may have scribbled on `current`; the pristine copy
            # honors the "unchanged" contract without a second GET.
            return pristine
        updated["metadata"]["resourceVersion"] = want_rv
        try:
            out = await store.update(resource, updated)
            return out if return_copy else None
        except Conflict:
            continue
    raise Conflict(
        f"{resource} {key!r}: too many conflicts in guaranteed_update")
