from kubernetes_tpu_torch.config.scheduler import (
    ConfigError,
    ProfileConfig,
    SchedulerConfig,
    load_config,
)

__all__ = [
    "ConfigError",
    "ProfileConfig",
    "SchedulerConfig",
    "load_config",
]
