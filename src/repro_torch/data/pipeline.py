"""Synthetic token data pipeline: document sampling, packing, batching.

Generates a deterministic mixture of Zipf-distributed token documents,
packs them into fixed-length training sequences (document boundaries carry an
EOS separator), and yields model-ready batches for every frontend family
(text, audio codebooks, vision prefix embeds). Offline-safe by construction.

A copy of the reference's numpy-only ``repro.data.pipeline``: the same seed
gives the same batches, bit for bit (numpy arrays; the training loop moves
them to the model's device). :func:`shard_batch` cuts a data-parallel
rank's rows from one.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


class PackedLMDataset:
    def __init__(self, cfg: ArchConfig, *, seq_len: int, batch_size: int,
                 seed: int = 0, mean_doc_len: int = 512):
        self.cfg = cfg
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.mean_doc_len = mean_doc_len
        self.eos = min(1, cfg.vocab_size - 1)
        # Zipf over the true vocab (pad ids never appear in data)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks ** 1.1
        self._probs = probs / probs.sum()

    def _sample_doc(self, n: int) -> np.ndarray:
        return self.rng.choice(self.cfg.vocab_size, size=n, p=self._probs)

    def _pack_stream(self, total: int) -> np.ndarray:
        out = np.empty(total, np.int64)
        filled = 0
        while filled < total:
            n = max(8, int(self.rng.exponential(self.mean_doc_len)))
            doc = self._sample_doc(min(n, total - filled))
            out[filled:filled + len(doc)] = doc
            filled += len(doc)
            if filled < total:
                out[filled] = self.eos
                filled += 1
        return out

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        B, S = self.batch_size, self.seq_len
        while True:
            if cfg.frontend == "audio":
                toks = self._pack_stream(B * cfg.num_codebooks * S).reshape(
                    B, cfg.num_codebooks, S).astype(np.int32)
                yield {"tokens": toks, "labels": toks.copy()}
            elif cfg.frontend == "vision":
                p = cfg.num_prefix_tokens
                toks = self._pack_stream(B * (S - p)).reshape(
                    B, S - p).astype(np.int32)
                embeds = self.rng.standard_normal(
                    (B, p, cfg.d_model)).astype(np.float32) * 0.02
                yield {"patch_embeds": embeds, "tokens": toks,
                       "labels": toks.copy()}
            else:
                toks = self._pack_stream(B * S).reshape(B, S).astype(np.int32)
                yield {"tokens": toks, "labels": toks.copy()}


def data_iterator(cfg: ArchConfig, seq_len: int, batch_size: int,
                  seed: int = 0) -> Iterator[dict]:
    return iter(PackedLMDataset(cfg, seq_len=seq_len, batch_size=batch_size,
                                seed=seed))


def shard_batch(batch: dict, index: int, count: int) -> dict:
    """Rows ``[index * B / count, (index + 1) * B / count)`` of every array
    of ``batch`` (B rows each): data rank ``index`` of ``count``'s share
    of the global batch, as the reference splits a batch over its data
    axes. Raises when ``count`` does not divide B."""
    B = len(next(iter(batch.values())))
    if B % count:
        raise ValueError(f"the batch of {B} rows does not split over "
                         f"{count} data-parallel ranks; pass a batch that "
                         f"{count} divides")
    n = B // count
    return {k: v[index * n:(index + 1) * n] for k, v in batch.items()}
