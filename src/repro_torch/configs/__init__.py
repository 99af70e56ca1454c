from .base import (ARCH_IDS, ArchConfig, MambaConfig, MoEConfig,
                   all_configs, get_config, torch_dtype)

__all__ = ["ARCH_IDS", "ArchConfig", "MambaConfig", "MoEConfig",
           "all_configs", "get_config", "torch_dtype"]
