"""The driver's green contexts: the host calls of ``csrc/green_split.cu``.

Replaces no TPU kernel (see the source's notes): these are the calls that
cut one card's SMs into two disjoint partitions for the SM split
(``core.device.SmSplit``). Each is a host call that launches nothing;
every failure raises. There is no plain version: a green context exists
only on a CUDA card, and the CPU never asks for one.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

from repro_torch.kernels import _build


def _lib():
    return _build.load("green_split")


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"green contexts: {what}: CUDA (driver) error "
                           f"{err}")


def granularity(device: int) -> Tuple[int, int, int]:
    """(the card's SMs, the smallest group of SMs the driver cuts off it,
    the step between the group sizes it cuts), asked of
    ``cuDevSmResourceSplitByCount`` on card ``device``."""
    res = (ctypes.c_int * 3)()
    _check(_lib().green_split_granularity(device, ctypes.addressof(res)),
           f"the SM granularity of card {device}")
    return int(res[0]), int(res[1]), int(res[2])


def create(device: int, group_sms: int) -> Tuple[int, ...]:
    """One cut of card ``device``'s SMs: a green context of a group of at
    least ``group_sms`` SMs (the driver rounds up to its granularity) and
    one of the remainder, each with its own non-blocking stream. Returns
    (group context, its stream, its SMs, remainder context, its stream,
    its SMs), handles as ints; :func:`destroy` frees them."""
    res = (ctypes.c_longlong * 8)()
    _check(_lib().green_split_create(device, group_sms,
                                     ctypes.addressof(res)),
           f"a split of {group_sms} SMs of card {device}")
    return tuple(int(x) for x in res[:6])


def destroy(handles: Tuple[int, ...]):
    """Destroy a split's streams and contexts (:func:`create`'s handles).
    The streams must have no work left."""
    ctx0, st0, _, ctx1, st1, _ = handles
    _check(_lib().green_split_destroy(ctx0, st0, ctx1, st1),
           "destroying a split")

