from repro_torch.models.params import (abstract_params,
                                       count_params_analytical, init_params,
                                       params_from_jax, trainable)
from repro_torch.models.transformer import Model, ParamTree

__all__ = ["Model", "ParamTree", "abstract_params",
           "count_params_analytical", "init_params",
           "params_from_jax", "trainable"]
