"""Hollow-kubelet node agent (SURVEY §2.5): per-node sync loop, pod
workers, device Allocate with a local checkpoint, heartbeats, merged
config sources (config), and the read-only kubelet server (server).
Port of `kubernetes_tpu/agent/`; `python -m kubernetes_tpu_torch.agent`
runs one as a process over the apiserver wire."""

from kubernetes_tpu_torch.agent.agent import NodeAgent
from kubernetes_tpu_torch.agent.config import ResolvedConfig, merge_config
from kubernetes_tpu_torch.agent.ledger import DeviceLedger
from kubernetes_tpu_torch.agent.server import AgentServer

__all__ = ["AgentServer", "DeviceLedger", "merge_config", "NodeAgent",
           "ResolvedConfig"]
