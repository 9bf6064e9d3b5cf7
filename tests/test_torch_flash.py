"""The tile algorithms of the port's tensor-core kernels, in plain PyTorch on
the CPU, against the JAX package:

* ``flash_prefill_tiled_plain`` — the bf16 ``flash_prefill`` kernel's
  schedule: (position, head) rows in blocks of 64, 64-key tiles up
  to each block's causal limit, the online softmax in the log2 domain, P
  rounded to bf16 before P V — against the Pallas ``flash_prefill`` in
  interpret mode (block-aligned shapes) and against
  ``repro.kernels.ref.flash_prefill_ref`` (ragged shapes, one query,
  ``kv_len`` cuts as the reference's keys cut to ``kv_len``).
* ``paged_decode_cluster_plain(cluster=S)`` — what the split-KV kernel now
  runs on the card (each request's live pages in S spans) — against the
  Pallas ``paged_decode_splitkv(num_splits=S)`` in interpret mode.

Inputs come from seeded numpy generators and feed both packages.
Tolerances are the kernel tests' ``TOL``: float32 2e-5, bfloat16 2e-2.
A row with no valid key (``kv_len`` 0) is zeros in the port; the Pallas
kernel leaves such a row undefined, so it is held to zeros."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill import flash_prefill as jflash_prefill
from repro.kernels.paged_decode import \
    paged_decode_splitkv as jpaged_decode_splitkv
from repro.kernels.ref import flash_prefill_ref as jflash_prefill_ref
from repro_torch.kernels.flash_prefill import (flash_prefill_plain,
                                               flash_prefill_tiled_plain)
from repro_torch.kernels.paged_decode import paged_decode_cluster_plain

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _both(arr, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(arr, jd), torch.from_numpy(arr).to(td)


def _close(got_t, want, dtype):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _qkv(seed, B, Sq, Sk, H, G, Dh, dtype):
    rng = np.random.default_rng(seed)
    return [_both(rng.standard_normal(shape, np.float32), dtype)
            for shape in ((B, Sq, H, Dh), (B, Sk, G, Dh), (B, Sk, G, Dh))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,G,Dh,off,kv_len,bq,bk", [
    (1, 32, 32, 2, 2, 32, 0, None, 16, 16),       # rep 1, Dh 32
    (1, 64, 96, 4, 2, 64, 32, None, 32, 32),      # rep 2, chunk at 32
    (2, 32, 64, 8, 2, 128, 32, 50, 16, 32),       # rep 4, kv_len mid-tile
    (1, 48, 48, 8, 1, 64, 0, None, 16, 16),       # rep 8
    (1, 16, 160, 4, 4, 64, 144, 150, 16, 32),     # MHA, last chunk, cut
])
def test_flash_prefill_tiled_plain_matches_pallas(B, Sq, Sk, H, G, Dh, off,
                                                  kv_len, bq, bk, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(20, B, Sq, Sk, H, G, Dh, dtype)
    want = jflash_prefill(jq, jk, jv, q_offset=off, kv_len=kv_len,
                          block_q=bq, block_k=bk, interpret=True)
    got = flash_prefill_tiled_plain(tq, tk, tv, q_offset=off, kv_len=kv_len)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,G,Dh,off,kv_len", [
    (1, 1, 1, 4, 4, 64, 0, None),                 # one query, one key
    (2, 1, 70, 8, 1, 128, 69, None),              # one query (decode-like)
    (1, 77, 177, 2, 2, 32, 100, None),            # rep 1, ragged Sq and Sk
    (2, 45, 130, 4, 2, 64, 85, None),             # rep 2, Sq * rep % 64
    (1, 67, 200, 16, 4, 128, 60, 129),            # rep 4, kv_len mid-tile
    (1, 33, 65, 16, 2, 64, 0, None),              # rep 8, keys past Sq
    (1, 9, 40, 64, 1, 32, 31, 35),                # rep 64: one position
    (1, 130, 300, 32, 8, 128, 170, None),         # qwen3-4b heads, 9 blocks
])
def test_flash_prefill_tiled_plain_matches_jax_oracle(B, Sq, Sk, H, G, Dh,
                                                      off, kv_len, dtype):
    """Ragged shapes the Pallas kernel does not take. ``kv_len`` cuts the
    keys; the reference oracle, which has no ``kv_len``, gets the keys cut
    to it."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(21, B, Sq, Sk, H, G, Dh, dtype)
    n = Sk if kv_len is None else kv_len
    want = jflash_prefill_ref(jq, jk[:, :n], jv[:, :n], q_offset=off)
    got = flash_prefill_tiled_plain(tq, tk, tv, q_offset=off, kv_len=kv_len)
    _close(got, want, dtype)
    _close(flash_prefill_plain(tq, tk, tv, q_offset=off, kv_len=kv_len),
           want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [0, -3])
def test_flash_prefill_rows_without_keys_are_zero(kv_len, dtype):
    (_, tq), (_, tk), (_, tv) = _qkv(22, 2, 20, 64, 8, 2, 64, dtype)
    for fn in (flash_prefill_tiled_plain, flash_prefill_plain):
        out = fn(tq, tk, tv, q_offset=5, kv_len=kv_len)
        assert out.shape == tq.shape and out.dtype == tq.dtype
        assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("S,lens", [
    (2, (1, 29)),            # a one-token request: its second span is dead
    (4, (1, 64)),            # dead spans, and a full table
    (8, (1, 17)),            # S = 8 (the cap), most spans dead
    (8, (40, 64)),           # S = 8 over 8 pages
])
def test_paged_decode_cluster_plain_matches_jax_splitkv(S, lens):
    rng = np.random.default_rng(23)
    B, H, G, Dh, N, ps, P = 2, 8, 2, 64, 24, 8, 8
    q = rng.standard_normal((B, H, Dh), np.float32)
    kp = rng.standard_normal((N, ps, G, Dh), np.float32)
    vp = rng.standard_normal((N, ps, G, Dh), np.float32)
    tables = rng.integers(1, N, (B, P)).astype(np.int32)
    lengths = np.asarray(lens, np.int32)
    want = jpaged_decode_splitkv(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(tables),
                                 jnp.asarray(lengths), num_splits=S,
                                 interpret=True)
    got = paged_decode_cluster_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lengths), cluster=S)
    _close(got, want, "float32")
