"""Streaming read over exactly ``ctas`` SMs: a CUDA kernel for Hopper + its
plain version. The roofline's measured bandwidth curve B(S) is this
kernel's rate at S SMs (``core.device.partition_curves``).

Replaces no TPU kernel: the reference samples its Pi(S) / B(S) tables from
an analytic spec and leaves the hook for measured ones
(``src/repro/core/multiplexer.py``, ``pi_table`` / ``bw_table``).

Kernel source: ``csrc/sm_probe.cu`` (design notes there). One launch reads
an int32 buffer once with ``ctas`` CTAs of :data:`THREADS` threads, one to
an SM (each holds more than half of an SM's shared memory), and returns
each CTA's int64 sum of its elements (the checksum that keeps the loads)
and the SM it ran on. Bound on an H100: bytes. The elements must lie in
[0, :data:`MAX_VALUE`): the kernel sums a loop step's elements in int32.

On a CPU tensor the wrapper runs :func:`sm_probe_plain`; on a CUDA tensor
it launches the kernel or raises. :data:`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

launches = {"sm_probe": 0}

THREADS = 1024          # threads a CTA (csrc THREADS)
VEC = 4                 # int32 elements a 16-byte load
MAX_VALUE = 1 << 16     # elements lie in [0, MAX_VALUE)


def sm_probe_plain(buf: torch.Tensor, ctas: int) -> torch.Tensor:
    """Each CTA's int64 sum by the kernel's schedule: CTA b sums the
    16-byte vectors i (VEC elements each) with (i // THREADS) % ctas == b.
    Returns (ctas,) int64."""
    vec = buf.view(-1, VEC).sum(1, dtype=torch.int64)
    span = ctas * THREADS
    vec = torch.nn.functional.pad(vec, (0, -vec.numel() % span))
    return vec.view(-1, ctas, THREADS).sum((0, 2))


def occupancy() -> Tuple[int, int]:
    """(CTAs an SM holds at once, dynamic shared memory bytes a CTA) of
    the kernel on the current card: 1 CTA an SM by construction."""
    res = (ctypes.c_int * 2)()
    err = _build.load("sm_probe").sm_probe_occupancy(ctypes.addressof(res))
    _build.check(err, "sm_probe occupancy")
    return int(res[0]), int(res[1])


def sm_probe(buf: torch.Tensor, ctas: int
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """buf: 1-D contiguous int32, a multiple of VEC elements in [0,
    MAX_VALUE). Returns (each CTA's int64 sum (ctas,), the SM each CTA ran
    on (ctas,) int32, or None on the CPU)."""
    if buf.dtype != torch.int32 or buf.dim() != 1 or buf.numel() % VEC:
        raise ValueError("sm_probe: buf must be 1-D int32 of a multiple "
                         f"of {VEC} elements, got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    if ctas < 1:
        raise ValueError(f"sm_probe: ctas {ctas} < 1")
    if buf.device.type == "cpu":
        return sm_probe_plain(buf, ctas), None
    if not buf.is_cuda:
        raise ValueError(f"sm_probe: buf is not on the CPU or a CUDA card "
                         f"({buf.device})")
    if not buf.is_contiguous() or buf.data_ptr() % 16:
        raise ValueError("sm_probe: buf must be contiguous and 16-byte "
                         "aligned")
    sms = torch.cuda.get_device_properties(buf.device).multi_processor_count
    if ctas > sms:
        raise ValueError(f"sm_probe: {ctas} CTAs on a card of {sms} SMs")
    partial = torch.empty((ctas,), dtype=torch.int64, device=buf.device)
    smid = torch.empty((ctas,), dtype=torch.int32, device=buf.device)
    lib = _build.load("sm_probe")
    with torch.cuda.device(buf.device):
        err = lib.sm_probe_launch(
            buf.data_ptr(), buf.numel() // VEC, partial.data_ptr(),
            smid.data_ptr(), ctas,
            torch.cuda.current_stream(buf.device).cuda_stream)
    _build.check(err, "sm_probe")
    launches["sm_probe"] += 1
    return partial, smid
