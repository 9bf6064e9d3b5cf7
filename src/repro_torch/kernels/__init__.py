"""Hopper CUDA kernels for the serving hot spots, each with a plain PyTorch
version beside it (the CPU path and the on-card oracle), a launch counter
and a public dispatcher in ops.py:

  paged_decode         — decode attention over paged KV (block tables)
  paged_decode_splitkv — flash-decoding variant: the caller's S splits as
                         the S CTAs of one cluster, their (m, l, acc)
                         partials combined in shared memory, one launch
  duet_attention_paged — fused mixed-phase attention over the paged pool
                         (decode rows + one prefill chunk in one launch)
  duet_attention       — the same over the slab cache (the slab decode
                         step's kernel path)
  flash_prefill        — causal GQA flash attention with a query offset
                         for chunked prefill

``paged_decode_auto`` picks the plain or split-KV decode kernel from the
table capacity; where tensor parallelism cuts the KV heads it routes
through ``paged_decode_sharded``, which runs them on the rank's head
shard. Sources are in ``csrc/``; ``_build`` compiles them with nvcc at
first use.
"""
from typing import Dict

from repro_torch.kernels.ops import (DuetSchedule, build_duet_schedule,
                                     duet_attention, duet_attention_paged,
                                     flash_prefill, pack_duet_queries,
                                     paged_decode, paged_decode_auto,
                                     paged_decode_sharded,
                                     paged_decode_splitkv,
                                     unpack_duet_output)
# the submodules share names with the dispatchers above, so their launch
# counters are imported by full module path
from repro_torch.kernels.duet_attention import launches as _duet_launches
from repro_torch.kernels.flash_prefill import launches as _flash_launches
from repro_torch.kernels.ops import launches as _sharded_launches
from repro_torch.kernels.paged_decode import launches as _paged_launches

_COUNTERS = (_paged_launches, _duet_launches, _flash_launches,
             _sharded_launches)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper (and per role where the host picks it:
    ``"paged_decode[block]"``) since the last reset."""
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts():
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0


__all__ = [
    "DuetSchedule", "build_duet_schedule", "duet_attention",
    "duet_attention_paged", "flash_prefill", "pack_duet_queries",
    "paged_decode", "paged_decode_auto", "paged_decode_sharded",
    "paged_decode_splitkv",
    "unpack_duet_output", "launch_counts", "reset_launch_counts",
]
