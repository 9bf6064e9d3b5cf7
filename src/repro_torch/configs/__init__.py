from repro_torch.configs.base import (ArchConfig, get_config, list_configs,
                                      reduced, register)
from repro_torch.configs.shapes import (SHAPES, InputShape, get_shape,
                                        input_specs)

__all__ = ["ArchConfig", "get_config", "list_configs", "reduced", "register",
           "SHAPES", "InputShape", "get_shape", "input_specs"]
