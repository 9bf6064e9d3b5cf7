"""Single-device placement for the port.

The reference's ``DeviceContext`` (mesh, TP/DP shardings) is not yet
ported; the port serves on exactly one device. This module holds what
every entry point needs instead:

* :func:`resolve_device` — ``None`` means the card. Without CUDA that is an
  error, never a quiet move to the CPU; the CPU runs only when asked for.
* :func:`to_device` — host numpy to the device without a host sync (pinned
  staging buffer + ``non_blocking``), so the async engine can upload
  dispatch inputs while the previous program still runs.
* :func:`fetch_to_host` — every tensor of one iteration copied back with a
  single blocking synchronisation (the port's ``jax.device_get``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (explicitly or by default) and
    none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) "
                "to run the port's plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(arr, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Copy host data (numpy array or scalar list) to ``device``. On CUDA
    the copy stages through pinned memory and does not wait for the
    device, so it adds no host sync; the host array may be reused at once
    (the staging buffer is a copy)."""
    t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def fetch_to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Bring every tensor to host numpy with ONE blocking sync: the copies
    are enqueued into pinned buffers and the stream is synchronised once.
    bf16 values come back as float32 (numpy has no bf16)."""
    tensors = [t.float() if t.dtype == torch.bfloat16 else t
               for t in tensors]
    if not tensors:
        return []
    dev = tensors[0].device
    if dev.type == "cpu":
        return [t.detach().clone().numpy() for t in tensors]
    outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for o, t in zip(outs, tensors):
        o.copy_(t, non_blocking=True)
    torch.cuda.current_stream(dev).synchronize()
    return [o.numpy() for o in outs]
