from kubernetes_tpu_torch.cli.kubectl import main

__all__ = ["main"]
