from repro_torch.serving.request import Phase, Request, ServingMetrics
from repro_torch.serving.traces import TRACES, synth_trace, synthetic_fixed
from repro_torch.serving.kvcache import (PagedKVCacheManager, PagePoolConfig,
                                         PrefixCacheStats, copy_pool_pages,
                                         gather_kv, init_page_pools,
                                         write_kv_page)
from repro_torch.serving.scheduler import (ChunkedPrefillPolicy, DuetPolicy,
                                           IterationPlan, PrefillFirstPolicy,
                                           QueueState)
from repro_torch.serving.simulator import (ClusterSim, DisaggSim,
                                           InstanceSim, SimConfig,
                                           kv_bytes_per_token,
                                           kv_capacity_tokens,
                                           make_baseline_instance,
                                           make_duet_instance)
from repro_torch.serving.engine import DuetEngine, EngineConfig
from repro_torch.serving.async_engine import (AsyncDuetEngine, DispatchStats,
                                              FinishEvent, TokenEvent)
from repro_torch.serving.router import (ROUTER_POLICIES, DispatchPolicy,
                                        LeastLoadedPolicy,
                                        PrefixAffinityPolicy,
                                        RoundRobinPolicy, Router,
                                        RouterEvent, make_dispatch_policy)

__all__ = [
    "AsyncDuetEngine", "DispatchStats", "FinishEvent", "TokenEvent",
    "Phase", "Request", "ServingMetrics", "TRACES", "synth_trace",
    "synthetic_fixed", "PagedKVCacheManager", "PagePoolConfig",
    "PrefixCacheStats", "copy_pool_pages", "gather_kv",
    "init_page_pools", "write_kv_page", "ChunkedPrefillPolicy", "DuetPolicy",
    "IterationPlan", "PrefillFirstPolicy", "QueueState", "ClusterSim",
    "DisaggSim", "InstanceSim", "SimConfig", "kv_bytes_per_token",
    "kv_capacity_tokens", "make_baseline_instance", "make_duet_instance",
    "DuetEngine", "EngineConfig",
    "ROUTER_POLICIES", "DispatchPolicy", "LeastLoadedPolicy",
    "PrefixAffinityPolicy", "RoundRobinPolicy", "Router", "RouterEvent",
    "make_dispatch_policy",
]
