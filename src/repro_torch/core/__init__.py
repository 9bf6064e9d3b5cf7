"""DuetServe's primary contribution: the attention-aware roofline predictor,
the partition optimizer (Algorithm 1), the adaptive multiplexing controller,
and the interruption-free look-ahead decode programs."""
from repro_torch.core.device import fetch_to_host, resolve_device, to_device
from repro_torch.core.lookahead import (lookahead_decode_paged,
                                        make_paged_lookahead_fn,
                                        make_superiter_fn)
from repro_torch.core.multiplexer import AdaptiveMultiplexer, MultiplexerStats
from repro_torch.core.partition import (PartitionConfig, ScheduleDecision,
                                        decide, optimize_partition)
from repro_torch.core.roofline import (H100_LIKE, TPU_V5E, HardwareSpec,
                                       OpCost, RequestLoad, RooflineModel)

__all__ = [
    "HardwareSpec", "OpCost", "RequestLoad", "RooflineModel", "TPU_V5E",
    "H100_LIKE", "PartitionConfig", "ScheduleDecision", "decide",
    "optimize_partition", "AdaptiveMultiplexer", "MultiplexerStats",
    "lookahead_decode_paged", "make_paged_lookahead_fn", "make_superiter_fn",
    "resolve_device", "to_device", "fetch_to_host",
]
