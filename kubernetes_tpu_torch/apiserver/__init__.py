"""The API server: the only process that talks to the store (SURVEY L2).

`server.APIServer` serves kube-shaped REST+JSON over an MVCCStore — CRUD,
LIST with selectors/paging, chunked WATCH streams with bookmarks and 410
semantics, subresources (binding), a handler chain with API-Priority-and-
Fairness-lite inflight control, and /metrics / /healthz.

`client.RemoteStore` is the client-side counterpart: it implements the same
interface informers and controllers consume in-process (list/watch/create/
get/update/delete/guaranteed_update/subresource), so every component gains a
remote mode with zero changes — the §3.2 PROCESS BOUNDARY made real.

Copy of `kubernetes_tpu/apiserver/`: the HTTP server, its client, the KTPU
wire (`wire.WireServer`, `wire.WireStore`), admission, RBAC and the
process entry point (`python -m kubernetes_tpu_torch.apiserver`). The gRPC
service (`grpc_server.py`) waits; `server.py` and `client.py` say what they
refuse meanwhile.
"""

from kubernetes_tpu_torch.apiserver.client import RemoteStore
from kubernetes_tpu_torch.apiserver.server import APIServer, PriorityLevel

__all__ = ["APIServer", "PriorityLevel", "RemoteStore"]
