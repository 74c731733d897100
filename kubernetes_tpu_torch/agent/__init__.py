"""Hollow-kubelet node agent (SURVEY §2.5): per-node sync loop, pod
workers, device Allocate with a local checkpoint, heartbeats and merged
config sources (config). Port of `kubernetes_tpu/agent/` without its
process entry point and read-only kubelet server."""

from kubernetes_tpu_torch.agent.agent import NodeAgent
from kubernetes_tpu_torch.agent.config import ResolvedConfig, merge_config
from kubernetes_tpu_torch.agent.ledger import DeviceLedger

__all__ = ["DeviceLedger", "merge_config", "NodeAgent", "ResolvedConfig"]
