from repro_torch.serving.request import Phase, Request, ServingMetrics
from repro_torch.serving.traces import TRACES, synth_trace, synthetic_fixed
from repro_torch.serving.kvcache import (PagedKVCacheManager, PagePoolConfig,
                                         PrefixCacheStats, copy_pool_pages,
                                         gather_kv, init_page_pools,
                                         write_kv_page)
from repro_torch.serving.scheduler import (ChunkedPrefillPolicy, DuetPolicy,
                                           IterationPlan, PrefillFirstPolicy,
                                           QueueState)
from repro_torch.serving.engine import DuetEngine, EngineConfig
from repro_torch.serving.async_engine import (AsyncDuetEngine, DispatchStats,
                                              FinishEvent, TokenEvent)

__all__ = [
    "AsyncDuetEngine", "DispatchStats", "FinishEvent", "TokenEvent",
    "Phase", "Request", "ServingMetrics", "TRACES", "synth_trace",
    "synthetic_fixed", "PagedKVCacheManager", "PagePoolConfig",
    "PrefixCacheStats", "copy_pool_pages", "gather_kv",
    "init_page_pools", "write_kv_page", "ChunkedPrefillPolicy", "DuetPolicy",
    "IterationPlan", "PrefillFirstPolicy", "QueueState",
    "DuetEngine", "EngineConfig",
]
