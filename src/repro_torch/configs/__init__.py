from repro_torch.configs.base import (ArchConfig, get_config, list_configs,
                                      reduced, register)

__all__ = ["ArchConfig", "get_config", "list_configs", "reduced", "register"]
