#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) works on
one NVIDIA H100.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases build,kernels

Phases (each raises on failure; nothing is swallowed):

1. build   — compile every CUDA source of the port with nvcc (in
             parallel), print the build seconds and ptxas' registers and
             spills of each kernel, by name.
2. roofline — the card priced as itself (``core.roofline.card_spec``: its
             TPCs, its datasheet peak; ``core.device.partition_curves``:
             B(S) measured over SM counts). The sm_probe kernel (a
             streaming read of 4 x the L2 with exactly n CTAs, one an SM)
             against its plain version (each CTA's checksum, bitwise, its
             sum against torch.sum, its CTAs on n distinct SMs) at 2, 66
             and 132 CTAs, timed against its bound and torch.sum; then
             the engines' path: partition_curves measured once, its
             launches counted, B(u) printed at u = 1, 6, 13, 33, 66 TPCs
             beside the linear and H100_LIKE shares, B(66) against
             torch.sum's read of the same bytes. Then the roofline held to
             the card (the counterpart of the reference's
             benchmarks/fig8_roofline_accuracy.py): the prediction of an
             engine on the card (its spec and measured curve), of the
             analytic H100_LIKE and of the TPU v5e the CPU engines price,
             beside the measured device ms of the same work, for
             qwen3-4b at full width, bf16 (the async engine's bucket
             programs replayed from their CUDA graphs: decode-only at B=8,
             ctx 1000; a prefill-only chunk of 256 at 512; the kb=1 duet
             super-iteration of both) and granite-moe-3b-a800m's
             decode-only step. measured / predicted is printed, not held.
             Last, what the card's torch offers the SM split (a report
             for the next slice, printed, not held): green contexts'
             SUPPORTED and, for GREEN_SMS SMs asked, the SMs the probe's
             CTAs ran on from the green context's stream, one CTA for
             each of those SMs timed from that stream and from the
             default stream, and a CUDA graph of the probe captured on that stream.
3. kernels — hold each kernel against its plain PyTorch version on the card
             at the serving path's shapes, at the small GQA/MQA/MHA,
             odd-length, dead-split and ragged shapes of the kernel tests
             and at the cluster decode kernels' edges, in fp32 and bf16
             (paged_decode_splitkv against both its plain versions: the
             cluster's span split it runs and the reference's table
             split; flash_prefill also at a whole 4096-token prompt and at
             the last 512-token chunk of one, and at its tile edges;
             duet_attention_paged at the async engine's tiles of 64 // rep
             rows, the main record, and at one row a tile, and at its tile
             edges, against both its plain versions, pad rows zero);
             then every GQA head shape of the registered configs
             (granite-20b's rep 48, yi-9b's rep 8, minicpm-2b's rep 1 at
             Dh 64, qwen3-14b's rep 5, granite-moe-3b-a800m's rep 3 at
             Dh 64, and the frontends': paligemma-3b's rep 8 at Dh 256
             and musicgen-medium's rep 1 at Dh 64) through paged_decode,
             split-KV,
             the slab decode and the paged duet launch at each config's
             engine tiles, flash_prefill at rep 3, 5, 48, 96 and 128 and
             at Dh 256, and rep 96 and 128 (head blocks) through the
             decode and duet kernels.
             Each case prints its max error beside the tolerance, the
             kernel's time with its inputs in L2 (ms, back-to-back calls)
             and with a cold L2 (cold_ms), the plain version's and a
             library call's time (SDPA over the gathered, head-repeated KV
             with the same mask; for flash_prefill also SDPA with the
             lower-right causal bias where that is the same function;
             timed here only, never used by the port) from CUDA events, and
             the bound (the least time for the bytes and operations the
             inputs need, at the card's published 3.35 TB/s and 989 bf16 /
             67 fp32 TFLOP/s) with its share of cold_ms. Then the cluster
             kernels' and flash_prefill's occupancy at the main shapes
             (the paged duet kernel's at C = 1, 2, 4, 8 with registers),
             with the role each decode kernel's CTAs take (granite-20b's
             too).
4. parity  — full-width qwen3-4b cut to 4 layers, then yi-9b, minicpm-2b,
             granite-20b and granite-moe-3b-a800m cut to 2, fp32 with
             TF32 off: the kernel path's logits against the port's plain
             path for one paged prefill, one paged decode step, one duet
             step (the engine's tiles, and one row a tile for qwen3-4b),
             and one slab decode step after a chunked slab prefill; and,
             for qwen3-4b, flash_prefill on the port's gqa_prefill q/K/V
             against gqa_prefill's own attention. Then deepseek-v2-lite-16b
             cut to 2 layers (its dense MLA layer and one MLA + MoE layer;
             MLA runs no kernel): the paged decode with the latent
             up-projections absorbed against expanded, and the paged
             prefill and decode against the slab's. Then zamba2-1.2b cut
             to 6 layers (5 mamba2 + 1 shared_attn): its kernel path
             against its plain path (paged prefill and decode, slab
             decode); and zamba2 and xlstm-350m cut to 4 layers (3 mlstm
             + 1 slstm): a 600-token prompt prefilled in chunks of 256 and
             8 decode steps, paged and slab, each step's logits against
             one whole prefill of the same tokens. paligemma-3b cut to 2
             layers takes the GQA checks above; then both frontends at
             full depth and width: a slab prefill of 2 rows (paligemma:
             256 patch embeddings under the prefix-LM mask and 64 text
             tokens; musicgen: a 4-codebook grid of 64 positions) and 4
             slab decode steps through gqa_decode_kernel (the slab
             duet_attention kernel, which must launch once a layer a
             step) against the plain path on a copy of the cache
             (musicgen's logits (B, K, V)). Last, the async engine's
             CUDA graphs against its eager dispatches (fp32, TF32 off,
             paged, kernels on, 3 slots and a 16-token budget, so that
             chunk buckets recur): reduced qwen3-4b, zamba2-1.2b,
             granite-moe-3b-a800m and deepseek-v2-lite-16b give
             identical greedy streams and launch counts with graphs
             replayed, and capture decode-only, prefill-only and fused
             chunk buckets (duet ones for the GQA configs); one bucket of
             zamba2 and deepseek (fused, prefill-only) and of granite-moe
             (duet) is captured and replayed at other chunk starts,
             slots and resume tokens, bitwise equal to a fresh eager
             program (check_bucket_graphs); reduced qwen3-4b at
             temperature 0.8 with the engine's generator registered with
             each graph (CUDAGraph.register_generator_state; the streams
             against the eager run's printed, not held). Last, the
             card's Algorithm 1: reduced qwen3-4b, fp32, the async engine
             on the engine tests' trace (3 slots, a 48-token budget),
             priced by the card, at a TBT bound between its predicted
             decode and mixed times, where it must take duet iterations
             (each one's S_p, S_d in TPCs and k printed), and at the
             default 0.1 s, where it takes none: greedy streams identical.
5. serve   — full qwen3-4b (36 layers, bf16, random weights from a seed)
             serves azure-conv requests (serve_qps()) on two paths, each with
             attn_kernel=True and strict_kernel=True and the launch counts
             reset to 0 just before it and read just after it:
             the paged path (4 of the 8 requests, those with the shortest
             outputs, through the async engine replaying a CUDA graph per
             dispatch bucket (the default), the async engine with every
             dispatch eager, the sync engine, and the async engine again
             with split_kv_threshold=256) and the slab path (all 8
             requests, outputs cut to 64 tokens; paged=False: the sync and
             the async engine). The kernels line's launches sum both paths. Every
             request must finish, the async runs must keep host_syncs <=
             super_iterations, every async run on the one card must
             replay graphs and account each dispatch as a capture, a
             replay or an eager dispatch of a named rule, the graphed and
             the eager paged async runs must give identical greedy streams
             and launch counts, the paged async runs must make at least one
             duet dispatch, and every kernel of a path must have launched
             on it. Wall-clock tokens/s, captures, replays and the graph
             pool's bytes are printed as measured.
             A profile step then times one full-width decode step of each
             path, one decode-only super-iteration (kb 1) eager and
             replayed from its graph (with the host's runtime calls: one
             graph launch and no kernel launch a replay), and one fused
             duet super-iteration (kb 1, a 256-row chunk), with the duet
             kernel's share; a replay's trace must hold each kernel as
             often as its capture counted. Then qwen3-4b's duet, fused
             and prefill-only buckets (a 256-row chunk) are each run
             eagerly, captured and replayed at other chunk starts, slots
             and resume tokens, each held bitwise to a fresh eager
             program on a copy of the state. Then yi-9b, minicpm-2b,
             granite-20b, granite-moe-3b-a800m and deepseek-v2-lite-16b,
             one at a time at full depth (bf16, random weights from seed 0,
             their measured weight bytes and peak memory printed), each
             serve 4 requests of at most 32 output tokens through the
             async engine on the paged path (the duet kernel on for the
             GQA configs; deepseek's MLA runs no kernel, and its paths
             must launch none) and on the slab path, each path's launch
             counts reset just before it and read just after it; a decode
             step of granite-moe is profiled as qwen3-4b's. zamba2-1.2b
             (Mamba2 + a shared attention block) and xlstm-350m (mLSTM +
             sLSTM) serve the same way, their per-slot state bytes
             printed: zamba2's paths must launch paged_decode (paged) and
             the slab duet_attention (slab) and no duet_attention_paged
             (the engines fuse duet steps for all-GQA configs only),
             xlstm's none; a paged decode step of each is profiled.
             paligemma-3b serves text-only (as the reference's engines
             take it) through the async and the sync engine on both
             paths. Every single-device engine on the card must plan
             with the card: its multiplexer's spec named as nvidia-smi
             names the card, over its 66 TPCs. Last,
             slot reuse: zamba2 cut to 12 layers, fp32, the sync engine at
             2 slots serves 4 requests, and each stream must equal the
             request's stream served alone.
6. tp      — tensor parallelism at TP = 2: two ranks (one process each,
             spawned) share the one card over gloo (its collectives copy
             CUDA tensors through host memory and block the host, so the
             TP step is slower than TP 1 by construction: no TP speed is
             claimed). Each rank draws the same full bf16 (fp32 for parity)
             weights from seed 0 leaf by leaf and keeps its slice. (a)
             paged_decode_sharded on each rank's qwen3-4b shard (B=8, 16 /
             4 heads at Dh 128, pages of 16, contexts 256..2048) at S = 1
             and 8, fp32 and bf16, against the plain paged decode over the
             full heads sliced to the rank's, timed on rank 0 alone (ms,
             cold_ms, bound, plain, SDPA at the rank-local shape). (b)
             full-width qwen3-4b cut to 4 layers, fp32, TF32 off: the TP 2
             kernel path's logits (paged prefill, paged decode, duet step
             at the engine's tiles) against TP 1's within 1e-4 x
             max|logit|, both ranks' bitwise equal. (c) full qwen3-4b
             (36 layers, bf16) serves the paged path's 4 requests, outputs
             cut to 32 tokens, through the async and then the sync engine
             (kernels on, strict), the
             launch counts reset just before and read just after: every
             request finishes, kernel_path is cuda_sharded, both ranks'
             streams are equal, host_syncs <= super_iterations, a duet
             dispatch happened, and paged_decode_sharded launched, as
             often as the inner decode kernels; then one decode step is
             profiled on rank 0 with the all-reduces it made. Every other
             block kind and both frontends: (d) deepseek-v2-lite-16b (1
             mla + 3 mla_moe), granite-moe-3b-a800m, xlstm-350m and
             paligemma-3b cut to 4 layers, zamba2-1.2b to 12 (2
             shared_attn), musicgen-medium to 4, full width, fp32, TF32
             off: the TP 2 kernel path's logits (paged prefill and decode
             for the text configs; the slab prefill with paligemma's 256
             patch embeddings or musicgen's codebook grid, then a slab
             decode step) against TP 1's (rank 0, after its TP model is
             freed) within 1e-4 x max|logit|, both ranks bitwise equal,
             each forward's all-reduces = collectives_per_iteration + 1.
             (e) paged_decode_sharded at granite-moe's 12 / 4 and zamba2's
             16 / 16 rank shards (Dh 64), as (a) at S = 1. (f) full
             deepseek-v2-lite-16b and zamba2-1.2b (bf16, every layer)
             serve 4 azure-conv requests (outputs cut to 16) through the
             async engine on the paged path, the launch counts reset just
             before and read just after: every request finishes, both
             ranks' streams are equal, host_syncs <= super_iterations,
             one decode step's all-reduces = collectives_per_iteration +
             1, zamba2's kernel_path is cuda_sharded and it launches
             paged_decode_sharded, deepseek (MLA: no kernel) launches
             none; tokens/s and the peak memory a rank are printed.
7. dp      — data parallelism: full qwen3-4b (36 layers, bf16, random
             weights from seed 0) as 2 replicas served from this one
             process on the one card (share_card: one weight tree, a
             page pool of 16-token pages each; one host thread and
             torch's one stream serve both), through the Router (kernels
             on, strict). One sync engine serves a pair trace (3 groups
             of 2 requests sharing a 256-token prefix, prompts of 392 to
             424, 64 outputs), and one engine each of round-robin's
             shards; then, the launch counts reset: round-robin over the
             2 replicas, whose streams must equal the independent
             engines' exactly (wall tokens/s beside the one engine's);
             prefix affinity on the same trace (outputs cut to 8): each
             pair's second member on its first's replica with the whole
             prefix matched, cluster hits >= 3 x 256, and the router's
             (replica, matched) decisions the ClusterSim's (its replicas
             priced as the engines: the card's spec, measured curve and
             TPCs); elastic over
             async replicas on a burst of 8 requests (400 + 64), then
             silence: an up and a down that drains live requests, the
             scaling and dispatch sequences the ClusterSim's, every
             request finished once, host_syncs <= super_iterations; and
             one serve CLI run (--dp 2 --share-card --router-policy prefix
             --arrival mmpp --service-mix mixture --rho 0.8 --stream, 8
             requests). The counts are read after it and must show the
             paged decode and duet kernels; the peak memory over the
             router runs is printed. Then a paged decode step of each
             replica alone and of both in turn is profiled (device busy
             share a replica).
8. train   — fp32 with TF32 off. First reduced minicpm-2b, 3 train steps
             (make_train_step: the loss, autograd, AdamW on its WSD
             schedule) on the card and on the CPU from the same weights
             and batches: losses, lr and grad norms within 1e-4, the
             parameters within a tenth of the learning rate. Then
             minicpm-2b at full width and depth (40 layers, 2.72 B
             parameters; fp32 weights, gradients and AdamW moments,
             16 bytes a parameter; each block checkpointed) takes 8 steps
             on its WSD schedule at batch 2 x 512 tokens from the data
             pipeline: each step's loss, lr, grad norm and wall ms, the
             peak memory and training tokens/s; every loss finite and the
             last below the first. One more step is split by CUDA events
             into the loss with its gradients and the AdamW update, and
             one is traced by torch.profiler. No kernel of the port runs
             here: the training forward is the plain blockwise attention,
             as the reference's.
9. grid    — the (data, model) grid of ranks, every rank on the one card
             over gloo (share_card). (a) Serving: full qwen3-4b (36
             layers, bf16) as DP 2 x TP 2: 2 processes, each its rank of
             both replicas (a process group a replica), the async engine
             on the paged kernel path, 4 azure-conv requests cut to 16
             tokens, round-robin: both ranks' streams bitwise equal, each
             replica's streams equal a TP 2 engine serving its requests
             alone, every request finished, at most one host sync a
             super-iteration; paged_decode_sharded's launches join the
             kernels line. (b) Training: minicpm-2b at full width cut to
             4 layers (fp32, TF32 off, remat) as DP 2 x TP 2 (4
             processes) against DP 1 x TP 1 (run first in this process,
             then freed) on the same global batches (2 x 512), 3 WSD
             steps: losses, lr and grad norms within 1e-4 and the data
             ranks' parameters equal, free-running (the gathered
             parameters logged, not held: Adam's m / sqrt(v) has no
             scale); then forced from the same weights: each step's
             gathered gradients within 1e-4 of their leaf's largest, and
             the parameters after AdamW fed TP 1's gradients within a
             tenth of the learning rate. (c) Gradients: one step each of
             zamba2-1.2b (12 layers: both shared attention blocks) and
             deepseek-v2-lite-16b (2 layers: MLA, then MLA with the
             MoE) at full width and TP 2 (a model group each, in the
             same 4 processes): every gathered gradient leaf against
             TP 1's within 1e-4 of the leaf's largest. Prints wall ms a
             step, all-reduces a step and peak GB a rank, with the
             card's name and power limit. Ranks sharing one card
             time-slice it and every collective copies through host
             memory: these numbers show parity and memory, not speed.
10. dryrun — the dry run (``launch/dryrun.py``: one rank of a grid run
             on shape-only tensors on the host, no device) held to one
             rank built on the card. (a) ``lower_one`` for every assigned
             arch at decode_32k on the 16 x 16 grid: each record's spec
             and port GB a rank, GFLOPs and collectives; an error record
             fails. (b) qwen3-4b's decode_32k rank 0 on (data 16, model
             1), 8 rows at 32,768 positions, bf16: the record's
             prediction, then that rank on the card: the bytes its
             weights and cache request from the allocator within 512 B a
             tensor of the record's argument bytes (the allocator's own
             rounded bytes printed beside them), one plain decode step's
             requested peak within 5% of the record's, its
             FlopCounterMode count equal to the record's; then the kernel
             path (the slab duet_attention
             kernel at 32,768 keys, once a layer), its logits beside the
             plain path's, both paths' device and wall ms a step
             (torch.profiler) beside the bound (the argument bytes at
             3.35 TB/s); the kernel path's
             logits at 32,768 keys against the plain path's within
             PARITY_TOL at full width cut to 4 layers, fp32, TF32 off;
             and the kernel alone at those shapes against its plain
             version, timed hot and cold beside its bound, its plain
             version and SDPA.
             (c) the (data 16, model 2) record's rank 0 weight bytes
             against shard_params(tp=2, rank=0) as allocated on the card.
             (d), in the train phase: the dry run's peak for minicpm-2b's
             train step (fp32, remat, 2 x 512) within 10% of the peak the
             card measured over its steps. The records of (a)-(d) are
             host work: one spawned process makes them beside the card's
             phases from the script's start, and the phases wait for it.
             The launches here are checks, not the main path: they join
             no count of the kernels line. The records are those of the
             context-parallel layout (a decode rank holds its span of the
             GQA caches' sequence).
11. cp      — context-parallel decode, every rank on card 0 over gloo.
             (d) the slab duet_attention kernel alone with its
             log-sum-exp and the key offset, at paligemma-3b's rank span
             (8 rows, 8 / 1 / 256, 16,384 keys) and at granite-20b's
             block role over as many keys, fp32 and bf16: out and lse
             against the plain version (rows before, inside and past the
             span; dead rows' lse exactly -inf), then timed hot and cold
             with and without lse beside the bound (the span's KV bytes
             at 3.35 TB/s), the plain version and SDPA (checks: no
             count). (a) paligemma-3b at TP 2: its one KV head does not
             divide the model axis, so each rank holds 16,384 of the
             32,768 positions of 8 rows (the whole random cache cut by
             shard_cache); 4 decode steps from positions with one row in
             rank 0's span only and one crossing the spans: the CP kernel
             path against TP 1's whole cache (plain path, here) and the
             CP plain path, at full depth in bf16 (error and argmax
             agreement printed) and at 4 layers in fp32, TF32 off,
             within PARITY_TOL (the hard check); both ranks' logits
             bitwise equal; duet_attention launched once a layer a step
             (these launches join the kernels line). (b) qwen3-4b cut to
             4 layers, fp32, batch 1, long_500k's sliding ring of 8,192
             cut over (data 2, model 1), positions past 524,287: logits
             within PARITY_TOL of one model with the whole ring. (c)
             minicpm-2b's decode_32k rank 0 of 16 x 16 allocated on the
             card (its weight shards and its span of 2,048 keys of 36 KV
             heads, 8 rows): the bytes requested within 512 B a tensor
             of the record's arguments; the record's peak under 80 GB;
             no step (its peers do not exist); (c') the same for
             deepseek-v2-lite-16b's rank (its span of 2,048 of the MLA
             latents' 32,768 positions). (e), in (a)'s spawn:
             deepseek-v2-lite-16b at full width cut to 4 layers (the
             dense MLA layer and three MLA + MoE layers), fp32, TF32 off,
             at TP 2: each rank holds 16,384 of the 32,768 latent
             positions of 8 rows (the whole random latents cut by
             shard_cache), 4 decode steps from (a)'s positions, for
             mla_absorb off and on: logits within 1e-5 x max|logit| of
             TP 1's whole latents, both ranks bitwise equal, two
             all-gathers an MLA layer a step (every head's query over
             the model group, then the partials' combine); MLA runs no
             kernel, and its path must launch none.

Before the last line it prints the card's name and power limit
(``nvidia-smi``) and a ``{"kernels": [...]}`` JSON line (flash_prefill
has no serving path: the reference calls it only from its tests, and the
serve phase fails unless its count reads 0); the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the repository
beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "roofline", "kernels", "parity", "serve", "tp", "dp",
          "train", "grid", "dryrun", "cp")
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the decode and duet kernels in bf16 (paged_decode, split-KV, both
# duet_attention kernels), (atol, rtol): their errors are the bf16
# rounding of the output (an ulp) and of P before P V (about 2^-9 of a
# key's weight times |v|, at most ~3e-3 on rows of a few keys); the
# paged duet's CPU decomposition tests read at most 0.62 of this limit,
# and the card's largest error on these kernels is 7.8e-3 at outputs of
# 1 to 2 (a bf16 ulp there), under its 5e-3 + 1e-2 x |value|
ATTN_BF16_TOL = (5e-3, 1e-2)
# logits (and flash_prefill's attention output) of the kernel path vs the
# plain path, full width, fp32, TF32 off: only the attention reduction
# order differs
PARITY_TOL = 1e-4           # relative to the reference's max |value|
KERNEL_SOURCES = {
    "paged_decode": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                     "src/repro/kernels/paged_decode.py:85"),
    "paged_decode_splitkv": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                             "src/repro/kernels/paged_decode.py:183"),
    "duet_attention_paged": (
        "src/repro_torch/kernels/csrc/duet_attention_paged.cu",
        "src/repro/kernels/duet_attention.py:189"),
    "duet_attention": ("src/repro_torch/kernels/csrc/duet_attention.cu",
                       "src/repro/kernels/duet_attention.py:112"),
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:78"),
}
# the block role (rep > 16: the 64-row tensor-core block) of the kernels
# that pick their role on the host, a record each at granite-20b's shapes
for _name in ("paged_decode", "paged_decode_splitkv", "duet_attention"):
    KERNEL_SOURCES[f"{_name}[block]"] = KERNEL_SOURCES[_name]
# the TP route: paged_decode.cu's kernels on each rank's head shard
KERNEL_SOURCES["paged_decode_sharded"] = (
    "src/repro_torch/kernels/csrc/paged_decode.cu",
    "src/repro/kernels/ops.py:115")
# the roofline's bandwidth probe replaces no TPU kernel: the reference
# samples its B(S) table from the analytic spec at this line
KERNEL_SOURCES["sm_probe"] = ("src/repro_torch/kernels/csrc/sm_probe.cu",
                              "src/repro/core/multiplexer.py:130")
# the serving path that must launch each kernel, of the role the config's
# rep takes ("[block]" above 16 heads a group: granite-20b); split-KV runs
# only in qwen3-4b's split_kv_threshold run; flash_prefill is on none (the
# reference calls it only from its tests), and its count must read 0
PATH_OF = {"paged_decode": "paged", "paged_decode[block]": "paged",
           "paged_decode_splitkv": "paged", "duet_attention_paged": "paged",
           "duet_attention": "slab", "duet_attention[block]": "slab"}
# the served traces' load: SERVE_RHO x the capacity of one replica as the
# card prices it (serve_qps), so the requests overlap on the engines'
# virtual clock whatever its prices, and the engines batch, fuse duet
# steps and take the wall time they do (under the TPU v5e's prices these
# runs took qps 4, a load of 1.46 by the same measure)
SERVE_RHO = 1.5
PAGED_MAX_OUTPUT = 160      # see phase_serve's requests()
SLAB_MAX_OUTPUT = 64        # the same: keeps the script inside its limit
# the registered configs whose GQA head shapes the kernels phase runs at
# the main path's shapes: granite-20b's MQA (rep 48, every CTA on the
# 64-row block; its bf16 records are the block roles' in the kernels
# line), yi-9b's rep 8, minicpm-2b's rep 1 at Dh 64, and qwen3-14b's rep 5
# (12-position duet tiles), and granite-moe-3b-a800m's rep 3 at Dh 64
# (21-position duet tiles); then the frontends' shapes: paligemma-3b's
# MQA at Dh 256 (rep 8) and musicgen-medium's MHA at Dh 64 (rep 1)
HEAD_CONFIGS = ("granite-20b", "yi-9b", "minicpm-2b", "qwen3-14b",
                "granite-moe-3b-a800m", "paligemma-3b", "musicgen-medium")
SERVED_CONFIGS = ("yi-9b", "minicpm-2b", "granite-20b",
                  "granite-moe-3b-a800m", "deepseek-v2-lite-16b",
                  "zamba2-1.2b", "xlstm-350m", "paligemma-3b")
# served through both engines (sync too) on both paths: paligemma-3b,
# text-only, as the reference's engines take it
BOTH_ENGINES = ("paligemma-3b",)
# the frontends' parity at full depth and width (fp32): a slab prefill of
# FRONTEND_PROMPT text tokens after paligemma's 256 patch embeddings, or of
# a codebook grid of FRONTEND_PROMPT positions, then FRONTEND_DECODE decode
# steps, 2 rows
FRONTEND_PROMPT, FRONTEND_DECODE = 64, 4
# the train phase: minicpm-2b at full width and depth, fp32 weights and
# moments, remat, TRAIN_STEPS AdamW steps on its WSD schedule at
# TRAIN_BATCH x TRAIN_SEQ from the data pipeline; first the reduced config
# on the card against the CPU for TRAIN_CHECK_STEPS steps (fp32, TF32 off;
# losses, lr, grad norms and each gradient entry against its leaf's
# largest within TRAIN_TOL; parameters within a tenth of the learning rate
# after AdamW from the same gradients: Adam's m / sqrt(v) has no scale, so
# free-running, an entry whose gradient is at the rounding noise moves by
# a fraction of lr that the host's summation order sets, train_check)
TRAIN_ARCH = "minicpm-2b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 2, 512, 3e-4
TRAIN_CHECK_STEPS, TRAIN_CHECK_SEQ, TRAIN_CHECK_LR = 3, 64, 1e-3
TRAIN_TOL, TRAIN_PARAM_TOL_LR = 1e-4, 0.1
# each served config's runs (outputs of 32 keep the whole script inside
# its time limit on a slow host)
SERVE_REQUESTS, SERVE_MAX_OUTPUT = 4, 32
# the recurrent configs' parity depth: zamba2's first 6 layers (5 mamba2
# + 1 shared_attn), xlstm's first 4 (3 mlstm + 1 slstm)
RECURRENT_PARITY_LAYERS = {"zamba2-1.2b": 6, "xlstm-350m": 4}
# the chunked-versus-whole check: a prompt of CHUNKED_PROMPT tokens
# prefilled in chunks of CHUNKED_CHUNK, then CHUNKED_DECODE decode steps
CHUNKED_PROMPT, CHUNKED_CHUNK, CHUNKED_DECODE = 600, 256, 8
# the parity phase's graphs against eager: reduced qwen3-4b and configs of
# the block kinds beyond its own, fp32; reduced qwen3-4b sampling at
# GRAPH_SAMPLING_TEMPERATURE; the bucket kinds each config's dispatch
# buckets are checked in (check_bucket_graphs)
GRAPH_PARITY_CONFIGS = {"qwen3-4b": (), "zamba2-1.2b": ("fused", "prefill"),
                        "granite-moe-3b-a800m": ("duet",),
                        "deepseek-v2-lite-16b": ("fused", "prefill")}
# parity_graphs' engine and requests (rid, arrival s, prompt, output):
# 3 slots and a 16-token budget cut the prompts into chunks whose buckets
# recur, so fused, duet and prefill-only chunk buckets are captured and
# replayed beside the decode-only ones (tests/test_torch_graphs.py's trace)
GRAPH_PARITY_ENGINE = dict(max_slots=3, max_len=128, token_budget=16,
                           page_size=32)
GRAPH_PARITY_SPECS = tuple((i, 0.0003 * i, 40 + 5 * i, 4 + i)
                           for i in range(5))
# the dispatch-bucket check (check_bucket_graphs): slots, pages a slot's
# table, page size, chunk rows, and (chunk start, its slot, resume token)
# of each dispatch of one bucket: the eager warm-up, the capture, a replay
BUCKET_SHAPE = dict(B=8, P=64, ps=16, chunk=256)
BUCKET_DISPATCHES = ((512, 1, 7), (256, 3, 11), (640, 6, 13))
# bucket kinds: (decode steps kb, finish, sample, duet). A finishing chunk
# that does not sample is a resumed one: its slot decodes from the resume
# token (override_tok)
BUCKET_KINDS = {"duet": (1, True, False, True),
                "fused": (2, True, True, False),
                "prefill": (0, False, False, False)}
# each wrapper's counter -> the __global__ functions it launches (a
# replay's trace is held to the launches its capture counted)
KERNEL_FUNCTIONS = {
    "paged_decode": ("paged_decode_cluster_kernel",),
    "paged_decode[block]": ("paged_decode_block_kernel",),
    "paged_decode_splitkv": ("paged_decode_cluster_kernel",),
    "paged_decode_splitkv[block]": ("paged_decode_block_kernel",),
    "duet_attention": ("duet_attention_cluster_kernel",),
    "duet_attention[block]": ("duet_attention_block_kernel",),
    "duet_attention_paged": ("duet_attention_paged_kernel",),
    "flash_prefill": ("flash_prefill_kernel", "flash_prefill_mma_kernel"),
}
GRAPH_SAMPLING_TEMPERATURE = 0.8
# the card's Algorithm 1 (parity_duet_split): reduced qwen3-4b, fp32, on the
# engine tests' geometry and trace (tests/test_torch_engine.py's KW and
# SPECS); the TBT bound at the first of SPLIT_FRACTIONS of the way from the
# card's predicted decode time (the full decode batch at SPLIT_CTX tokens)
# to its mixed time (that batch and a chunk of the rest of the budget)
# that makes Algorithm 1 take duet iterations
SPLIT_ENGINE = dict(max_slots=3, max_len=128, token_budget=48, page_size=8)
SPLIT_SPECS = tuple((i, i * 0.0003, 20 + 7 * i, 6 + i) for i in range(5))
SPLIT_CTX, SPLIT_FRACTIONS = 40, (0.5, 0.25, 0.75)
# the slot-reuse run: zamba2 cut to its first 12 layers (2 shared_attn),
# fp32, 2 slots, 4 requests of at most 32 output tokens
REUSE_LAYERS, REUSE_SLOTS, REUSE_MAX_OUTPUT = 12, 2, 32


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# A spin kernel queued ahead of the timed work keeps the card busy while
# the host queues it, so the events time the card and not the host's pace.
# Where the card was no longer spinning once the host had queued the timed
# work (the start event had completed), the hold grows 4x and the timing
# runs again, HOLD_TRIES times at most.
HOLD_CYCLES = 400_000       # about 0.2 ms at the H100's clock
HOLD_TRIES = 4
FLUSH_BYTES = 128 << 20     # written between cold calls: > the 50 MB L2


def _held(run, hold: int, stats):
    """``run(hold)`` -> (ms, ahead, host_ms) until ``ahead`` (the card was
    still spinning when the host had queued the timed calls), the hold
    growing 4x a try. ``stats`` (a dict or None) gets the host's ms per
    queued call, the tries and whether the card was ahead at the last."""
    for tries in range(1, HOLD_TRIES + 1):
        ms, ahead, host_ms = run(hold)
        if ahead:
            break
        hold *= 4
    if stats is not None:
        stats.update(host_ms=host_ms, tries=tries, ahead=ahead)
    return ms


def time_ms(fn, iters: int = 20, warmup: int = 3, stats=None) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls (their inputs stay in L2
    where they fit), behind a spin of HOLD_CYCLES per call."""
    for _ in range(warmup):
        fn()

    def run(hold):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters, ahead, host_ms
    return _held(run, HOLD_CYCLES * iters, stats)


def time_cold_ms(fn, iters: int = 10, stats=None) -> float:
    """Mean device time of one call with a cold L2: a FLUSH_BYTES buffer is
    written before each call, and CUDA events time each call alone (the
    flush is not timed), each behind a spin of HOLD_CYCLES."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()

    def run(hold):
        pairs, ahead, host_s = [], True, 0.0
        for i in range(iters):
            flush.fill_(i & 0xFF)
            torch.cuda._sleep(hold)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            host_s += time.perf_counter() - t0
            end.record()
            ahead &= not start.query()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return (sum(s.elapsed_time(e) for s, e in pairs) / iters, ahead,
                host_s * 1e3 / iters)
    return _held(run, HOLD_CYCLES, stats)


def _time_kernel(kernel, rec):
    """A kernel's hot and cold ms into ``rec``, with the host's ms to queue
    one hot call and whether the card stayed ahead of the host in both."""
    hot, cold = {}, {}
    rec["ms"] = time_ms(kernel, stats=hot)
    rec["cold_ms"] = time_cold_ms(kernel, stats=cold)
    rec["host_ms"] = hot["host_ms"]
    rec["held"] = hot["ahead"] and cold["ahead"]
    rec["hold_tries"] = (hot["tries"], cold["tries"])


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.time()
    logs = _build.build_all()
    log(f"[build] {len(logs)} sources built in {time.time() - t0:.2f} s "
        f"into {_build.BUILD_DIR}")
    for name, text in logs.items():
        for kernel, line in ptxas_report(text):
            log(f"[build] {name}: {kernel}: {line}")


def ptxas_report(text: str):
    """(kernel, ptxas line) for each register and spill line of an nvcc
    -Xptxas -v log; kernel names demangled with c++filt where it exists."""
    import re
    import shutil
    rows, kernel = [], "?"
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            kernel = m.group(1)
        elif "registers" in line or "spill" in line:
            rows.append((kernel, line.strip()))
    names = sorted({k for k, _ in rows})
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt", *names], capture_output=True,
                             text=True, check=True).stdout.splitlines()
        plain = dict(zip(names, out))
        rows = [(plain.get(k, k), line) for k, line in rows]
    return rows


# ---------------------------------------------------------------------------
# phase 2: the card priced as itself
# ---------------------------------------------------------------------------
# the TPC counts whose measured bandwidth the phase prints
ROOFLINE_TPCS = (1, 6, 13, 33, 66)
# the shapes held to the card (the profile steps'): ROOFLINE_B decode rows
# at ROOFLINE_CTX tokens of context, a chunk of ROOFLINE_CHUNK rows at
# ROOFLINE_CHUNK_AT, pages of 16, tables of 64 pages; CUDA events around
# ROOFLINE_REPLAYS back-to-back replays of each bucket's graph
ROOFLINE_B, ROOFLINE_CTX, ROOFLINE_CHUNK, ROOFLINE_CHUNK_AT = 8, 1000, 256, 512
ROOFLINE_REPLAYS = 10
# the SM counts asked of a green context in the roofline phase's report
GREEN_SMS = (32, 64)
# the configs held and the bucket kinds of each
ROOFLINE_SHAPES = {"qwen3-4b": ("decode", "prefill", "duet"),
                   "granite-moe-3b-a800m": ("decode",)}


def phase_roofline():
    """The card's spec and measured curve, the sm_probe kernel against its
    plain version, and the roofline's predictions against the card's
    measured step times. Returns sm_probe's record for the kernels line,
    its ``launches`` those of the engines' path (partition_curves)."""
    card = card_line()
    rec = roofline_probe(card)
    roofline_accuracy(card)
    green_contexts(card)
    return rec


def _stream_ms(fn, stream, reps=20):
    """Mean device ms of ``fn()`` on ``stream`` (CUDA events on it, after
    one warm-up call)."""
    with torch.cuda.stream(stream):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        for _ in range(reps):
            out = fn()
        end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def green_contexts(card):
    """What the card's torch offers for the SM split: a report, printed,
    not held. Whether ``torch.cuda.green_contexts`` is SUPPORTED; then for
    each of GREEN_SMS SMs asked: the sm_probe kernel at one CTA for every
    SM of the card, launched on the green context's stream (the SMs its
    CTAs ran on are the SMs the context really gives), and the rate of
    one CTA for each of those SMs from the green context's stream and
    from the default stream; then the probe captured into a CUDA graph on the green
    context's stream and replayed (its checksum against torch.sum, and
    the SMs the replay ran on)."""
    from repro_torch.kernels import sm_probe as probe
    from torch.cuda import green_contexts as gc
    log(f"[green] torch {torch.__version__}: "
        f"torch.cuda.green_contexts.SUPPORTED = {gc.SUPPORTED} [{card}]")
    if not gc.SUPPORTED:
        return
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    n = -(-4 * props.L2_cache_size // 16) * 4
    gen = torch.Generator(device="cuda").manual_seed(1)
    buf = torch.randint(0, probe.MAX_VALUE, (n,), dtype=torch.int32,
                        device="cuda", generator=gen)
    nbytes, total = buf.numel() * buf.element_size(), int(buf.sum())
    default = torch.cuda.current_stream()
    for asked in GREEN_SMS:
        # the stream lives only as long as its green context
        green = gc.GreenContext.create(num_sms=asked, device_id=0)
        stream = green.Stream()
        ms, (got, smid) = _stream_ms(lambda: probe.sm_probe(buf, sms),
                                     stream)
        held = torch.unique(smid).numel()
        # one wave of `held` CTAs on each stream: the same work and SMs,
        # without the tail of a 132-CTA launch on fewer SMs
        one, _ = _stream_ms(lambda: probe.sm_probe(buf, held), stream)
        alone, _ = _stream_ms(lambda: probe.sm_probe(buf, held), default)
        full, _ = _stream_ms(lambda: probe.sm_probe(buf, sms), default)
        log(f"[green] {asked} SMs asked: the probe's {sms} CTAs from its "
            f"stream ran on {held} distinct SMs, checksum "
            f"{'equal to' if int(got.sum()) == total else 'NOT'} "
            f"torch.sum, {ms:.4f} ms = {nbytes / ms / 1e6:.1f} GB/s; "
            f"{held} CTAs from its stream {one:.4f} ms = "
            f"{nbytes / one / 1e6:.1f} GB/s, from the default stream "
            f"{alone:.4f} ms = {nbytes / alone / 1e6:.1f} GB/s; {sms} CTAs "
            f"there {nbytes / full / 1e6:.1f} GB/s [{card}]")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            got, smid = probe.sm_probe(buf, sms)
        for label, replay_on in (("its stream", stream),
                                 ("the default stream", default)):
            with torch.cuda.stream(replay_on):
                graph.replay()
            torch.cuda.synchronize()
            log(f"[green] {asked} SMs asked: a CUDA graph of the probe "
                f"captured on its stream, replayed on {label}: checksum "
                f"{'equal to' if int(got.sum()) == total else 'NOT'} "
                f"torch.sum, on {torch.unique(smid).numel()} distinct SMs")
        del graph, stream, green
    del buf
    torch.cuda.empty_cache()


def _hold_card_pricing(engine, label, card):
    """An engine on the one card plans with the card: its multiplexer's
    spec is named as nvidia-smi names the card, over the card's TPCs
    (SMs / 2)."""
    props = torch.cuda.get_device_properties(engine.device)
    mux = engine.mux
    if mux.hw.name != card.split(", ")[0] or \
            mux.total_units != props.multi_processor_count // 2:
        raise AssertionError(f"[pricing] {label}: the engine plans with "
                             f"{mux.hw.name} over {mux.total_units} units "
                             f"on {card}")


def roofline_probe(card):
    """The sm_probe kernel at 2, half the SMs and every SM of the card
    against its plain version: each CTA's int64 checksum bitwise, their
    sum against torch.sum, the CTAs on as many distinct SMs; its time on
    every SM beside the bound (the buffer's bytes at 3.35 TB/s), the
    plain version and torch.sum. Then the engines' path: the card's curve
    measured once by partition_curves (the cache emptied first), its
    launches counted, and B(u) at ROOFLINE_TPCS beside the linear share
    u / 66 and H100_LIKE's (u / 66)^0.32, B(66) beside torch.sum's rate
    on the same bytes."""
    from repro_torch.core import device as core_device
    from repro_torch.core.roofline import H100_LIKE, card_spec
    from repro_torch.kernels import sm_probe as probe
    props = torch.cuda.get_device_properties(0)
    spec, sms = card_spec(props), props.multi_processor_count
    per_sm, smem = probe.occupancy()
    log(f"[roofline] {spec.name}: {sms} SMs = {spec.num_units} TPCs; "
        f"datasheet {spec.pi(spec.num_units) / 1e12:.1f} bf16 TFLOP/s and "
        f"{spec.bw(spec.num_units) / 1e12:.2f} TB/s; L2 "
        f"{props.L2_cache_size} B; sm_probe holds {per_sm} CTA an SM at "
        f"{smem} B of shared memory a CTA [{card}]")
    if per_sm != 1:
        raise AssertionError(f"[roofline] sm_probe: {per_sm} CTAs an SM")
    n = -(-4 * props.L2_cache_size // 16) * 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    buf = torch.randint(0, probe.MAX_VALUE, (n,), dtype=torch.int32,
                        device="cuda", generator=gen)
    nbytes, total = buf.numel() * buf.element_size(), int(buf.sum())
    rec = {"name": "sm_probe", "max_abs_err": 0}
    for ctas in (2, sms // 2, sms):
        got, smid = probe.sm_probe(buf, ctas)
        err = int((got - probe.sm_probe_plain(buf, ctas)).abs().max())
        distinct = torch.unique(smid).numel()
        log(f"[roofline] sm_probe at {ctas} CTAs over {nbytes} B: CTA "
            f"checksums against the plain version max abs err {err}, their "
            f"sum {int(got.sum())} against torch.sum {total}, on "
            f"{distinct} distinct SMs")
        if err or int(got.sum()) != total or distinct != ctas:
            raise AssertionError(f"[roofline] sm_probe at {ctas} CTAs "
                                 "disagrees with its plain version")
    rec["ms"] = time_ms(lambda: probe.sm_probe(buf, sms), iters=10)
    rec["plain_ms"] = time_ms(lambda: probe.sm_probe_plain(buf, sms),
                              iters=3)
    rec["library_ms"] = time_ms(lambda: torch.sum(buf), iters=10)
    # torch's reads of the same bytes without the int64 promotion
    reads = {"sum(dtype=int32)": time_ms(
        lambda: buf.sum(dtype=torch.int32), iters=10),
        "amax": time_ms(lambda: torch.amax(buf), iters=10)}
    rec["bound_ms"], rec["bound_by"] = nbytes / HBM_BYTES_PER_S * 1e3, \
        "bytes"
    log(f"[roofline] sm_probe at {sms} CTAs: {rec['ms']:.4f} ms = "
        f"{nbytes / rec['ms'] / 1e6:.1f} GB/s; bound {rec['bound_ms']:.4f} "
        f"(bytes, {100 * rec['bound_ms'] / rec['ms']:.1f}%); plain "
        f"{rec['plain_ms']:.4f}; torch.sum (int64, the same checksum) "
        f"{rec['library_ms']:.4f} = {nbytes / rec['library_ms'] / 1e6:.1f}"
        f" GB/s [{card}]")
    del buf
    torch.cuda.empty_cache()
    core_device._CURVES.clear()
    probe.launches["sm_probe"] = 0        # the engines' path starts here
    t0 = time.time()
    bw = core_device.partition_curves("cuda", spec)
    rec["launches"] = probe.launches["sm_probe"]         # and ends here
    log(f"[roofline] partition_curves: B(u) at u = 1..{spec.num_units} "
        f"TPCs in {time.time() - t0:.2f} s, {rec['launches']} probe "
        "launches; GB/s: "
        + " ".join(f"{bw[u] / 1e9:.1f}" for u in sorted(bw)))
    full = bw[spec.num_units]
    for u in ROOFLINE_TPCS:
        share = u / spec.num_units
        log(f"[roofline] B({u:2d} TPCs = {2 * u:3d} SMs) = "
            f"{bw[u] / 1e9:8.1f} GB/s, {100 * bw[u] / full:5.1f}% of "
            f"B({spec.num_units}) (linear {100 * share:5.1f}%, H100_LIKE "
            f"{100 * H100_LIKE.bw(u) / H100_LIKE.bw(spec.num_units):5.1f}"
            f"%) [{card}]")
    log(f"[roofline] B({spec.num_units}) {full / 1e9:.1f} GB/s against "
        "torch's reads of the same bytes: "
        + ", ".join(f"{k} {nbytes / ms / 1e6:.1f}" for k, ms in reads.items())
        + f" GB/s; the datasheet's {HBM_BYTES_PER_S / 1e9:.0f} [{card}]")
    return rec


def _replay_ms(model, kind):
    """Device ms of one replay of the async engine's ``kind`` bucket
    (decode: kb 1; prefill: the chunk alone; duet: kb 1 and the chunk in
    one duet launch a layer) at the ROOFLINE_* shapes, in the model's
    dtype: the program run once eagerly, captured, replayed once, then
    CUDA events around ROOFLINE_REPLAYS back-to-back replays (the decode
    rows' context grows by one a replay)."""
    from repro_torch.core.lookahead import BucketProgram, make_superiter_fn
    from repro_torch.kernels.ops import build_duet_schedule, duet_block_q
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    cfg, B, P, ps, dev = model.cfg, ROOFLINE_B, 64, 16, "cuda"
    kb = 0 if kind == "prefill" else 1
    chunk = 0 if kind == "decode" else ROOFLINE_CHUNK
    duet = kind == "duet"
    bq = duet_block_q(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) \
        if duet else 1
    bucket = BucketProgram(
        make_superiter_fn(model, kb, paged=True, chunk=chunk,
                          duet_kernel=duet, duet_block_q=bq),
        torch.device(dev), B, width=P if kb else 1, chunk=chunk,
        pwidth=P if chunk else 1)
    pools = init_page_pools(cfg, PagePoolConfig(num_pages=(B + 1) * P + 1,
                                                page_size=ps),
                            model.dtype, device=dev)
    state = model.init_state_cache(B)
    bucket.feed(np.full(B, kb > 0),
                np.arange(1, B * P + 1).reshape(B, P) if kb else None,
                np.zeros((1, chunk), np.int32) if chunk else None,
                np.arange(B * P + 1, (B + 1) * P + 1)[None] if chunk
                else None, (ROOFLINE_CHUNK_AT, 0, 0))
    last_tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    pos = torch.full((B,), ROOFLINE_CTX, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    args = (pools, state, last_tok, pos, bucket.tables, gen, bucket.active,
            bucket.pre_toks, bucket.pre_tbl, bucket.pre_start,
            bucket.pre_slot, bucket.override_tok)
    if duet:
        args += (torch.tensor(build_duet_schedule(
            [(b, 0) for b in range(B)], [(B, i) for i in range(chunk)],
            block_q=bq).row_src, dtype=torch.int32, device=dev),)
    bucket.run(*args)
    pos.fill_(ROOFLINE_CTX)
    bucket.capture(args, torch.cuda.graph_pool_handle())
    pos.fill_(ROOFLINE_CTX)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(ROOFLINE_REPLAYS):
        bucket.graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / ROOFLINE_REPLAYS
    del bucket, pools, state
    return ms


def roofline_accuracy(card):
    """The counterpart of the reference's fig8_roofline_accuracy on the
    card: for each of ROOFLINE_SHAPES (full width and depth, bf16, random
    weights from seed 0), the iteration an engine on the card prices
    (``mux.predict_mixed``: the card's spec and measured curve over its
    66 TPCs; the engine is held to plan with the card), the analytic
    H100_LIKE's prediction at 66 TPCs and the TPU v5e's at one chip (what
    the CPU engines price), beside the device ms of the same work
    replayed from its CUDA graph, and measured / predicted. A
    measurement: nothing here is held but the engine's pricing."""
    from repro_torch.configs import get_config
    from repro_torch.core.roofline import (H100_LIKE, TPU_V5E, RequestLoad,
                                           RooflineModel)
    from repro_torch.models import Model
    from repro_torch.serving import AsyncDuetEngine, EngineConfig
    dec = [RequestLoad(q=1, c=ROOFLINE_CTX) for _ in range(ROOFLINE_B)]
    pre = [RequestLoad(q=ROOFLINE_CHUNK, c=ROOFLINE_CHUNK_AT,
                       phase="prefill")]
    loads = {"decode": dec, "prefill": pre, "duet": dec + pre}
    rows = []
    for name, kinds in ROOFLINE_SHAPES.items():
        cfg = get_config(name)
        model = Model.init(cfg, seed=0, dtype=torch.bfloat16, device="cuda",
                           attn_kernel=True)
        engine = AsyncDuetEngine(model, EngineConfig(
            max_slots=ROOFLINE_B, max_len=1024, token_budget=256,
            page_size=16), seed=0, device="cuda")
        _hold_card_pricing(engine, f"{name} roofline", card)
        h100 = RooflineModel(cfg, H100_LIKE, page_size=16)
        tpu = RooflineModel(cfg, TPU_V5E, page_size=16)
        for kind in kinds:
            pred = (engine.mux.predict_mixed(loads[kind]) * 1e3,
                    h100.iteration_latency(loads[kind]) * 1e3,
                    tpu.iteration_latency(loads[kind], units=1) * 1e3)
            rows.append((f"{name} {kind}", pred, _replay_ms(model, kind)))
        del engine, model
        torch.cuda.empty_cache()
    log(f"[roofline] predicted ms (the card's spec and curve at 66 TPCs; "
        f"H100_LIKE at 66; TPU v5e at 1 chip) against the measured device "
        f"ms of the same work (CUDA events, {ROOFLINE_REPLAYS} graph "
        f"replays); measured / predicted. B={ROOFLINE_B} at ctx "
        f"{ROOFLINE_CTX}, chunk {ROOFLINE_CHUNK} at {ROOFLINE_CHUNK_AT}, "
        f"pages of 16, bf16 [{card}]")
    for what, (card_p, h100_p, tpu_p), ms in rows:
        log(f"[roofline] {what:36s} card {card_p:7.3f}  H100_LIKE "
            f"{h100_p:7.3f}  TPU v5e {tpu_p:7.3f}  measured {ms:7.3f}  "
            f"ratio {ms / card_p:5.2f} / {ms / h100_p:5.2f} / "
            f"{ms / tpu_p:5.2f} [{card}]")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def _bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _decode_inputs(rng, B, H, G, Dh, N, ps, P, dtype, lengths=None,
                   distinct=False):
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((B, H, Dh), np.float32))
    kp = torch.from_numpy(rng.standard_normal((N, ps, G, Dh), np.float32))
    vp = torch.from_numpy(rng.standard_normal((N, ps, G, Dh), np.float32))
    if distinct:     # a real pool: every request owns its own pages
        tables = 1 + rng.permutation(N - 1)[:B * P].reshape(B, P)
    else:
        tables = rng.integers(1, N, (B, P))
    if lengths is None:
        lengths = rng.integers(1, P * ps + 1, (B,))
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.tensor(tables, dtype=torch.int32, device=dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def _sdpa_decode(q, kp, vp, tables, lengths):
    """Library yardstick: SDPA over the gathered, head-repeated KV."""
    B, H, Dh = q.shape
    _, ps, G, _ = kp.shape
    P = tables.shape[1]
    k = kp[tables.long()].reshape(B, P * ps, G, Dh)
    v = vp[tables.long()].reshape(B, P * ps, G, Dh)
    k = k.repeat_interleave(H // G, dim=2).transpose(1, 2)
    v = v.repeat_interleave(H // G, dim=2).transpose(1, 2)
    mask = (torch.arange(P * ps, device=q.device)[None, :]
            < lengths[:, None].long())[:, None, None, :]
    qq = q[:, :, None, :]
    fn = torch.nn.functional.scaled_dot_product_attention
    return lambda: fn(qq, k, v, attn_mask=mask)


def _check(name, got, want, dtype, label, record, tol=None):
    atol, rtol = tol or (TOL[dtype], TOL[dtype])
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
    record.update(max_abs_err=err, tol=atol, rtol=rtol)
    if not ok:
        raise AssertionError(f"{name} [{label}] disagrees with its plain "
                             f"version: max abs err {err:.3e} > "
                             f"atol {atol:.0e} + rtol {rtol:.0e}")


def check_decode(rng, label, dtype, B, H, G, Dh, N, ps, P, splits=None,
                 lengths=None, distinct=False):
    from repro_torch.kernels.paged_decode import (
        paged_decode, paged_decode_cluster_plain, paged_decode_plain,
        paged_decode_splitkv, paged_decode_splitkv_plain, splitkv_spans)
    q, kp, vp, tables, ln = _decode_inputs(rng, B, H, G, Dh, N, ps, P, dtype,
                                           lengths, distinct)
    if splits is None:
        name = "paged_decode"
        kernel = lambda: paged_decode(q, kp, vp, tables, ln)  # noqa: E731
        plain = lambda: paged_decode_plain(q, kp, vp, tables, ln)  # noqa
    else:
        name = "paged_decode_splitkv"
        kernel = lambda: paged_decode_splitkv(  # noqa: E731
            q, kp, vp, tables, ln, num_splits=splits)
        plain = lambda: paged_decode_splitkv_plain(  # noqa: E731
            q, kp, vp, tables, ln, num_splits=splits)
    if splits is None:
        from repro_torch.kernels.paged_decode import cluster_for
        label += f" C={cluster_for(q, kp, tables)}"
    from repro_torch.kernels.ops import cta_role
    role = cta_role(H // G)
    rec = {"name": name if role == "decode" else f"{name}[{role}]",
           "case": label, "dtype": str(dtype)}
    tol = ATTN_BF16_TOL if dtype == torch.bfloat16 else None
    got = kernel()
    torch.cuda.synchronize()
    if splits is not None:
        # the algorithm the kernel runs: the live pages in C = S spans
        C = splitkv_spans(P, splits)[0]
        _check(name, got, paged_decode_cluster_plain(
            q, kp, vp, tables, ln, cluster=C), dtype, label + " (spans)",
            rec, tol)
        span_err = rec["max_abs_err"]
    _check(name, got, plain(), dtype, label, rec, tol)
    if splits is not None:
        rec["max_abs_err"] = max(rec["max_abs_err"], span_err)
    elt = q.element_size()
    live = int(ln.long().sum().item())
    nbytes = (2 * q.numel() * elt + tables.numel() * 4 + B * 4
              + 2 * live * G * Dh * elt)
    ops = 4.0 * live * H * Dh
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, ops, dtype)
    _time_kernel(kernel, rec)
    rec["plain_ms"] = time_ms(plain, iters=5)
    rec["library_ms"] = time_ms(_sdpa_decode(q, kp, vp, tables, ln))
    return rec


def check_duet(rng, label, dtype, N, ps, G, H, Dh, P, decode_rows,
               prefill_rows, bq, pad_tile=False, library=True):
    from repro_torch.kernels.duet_attention import (
        duet_attention_paged, duet_attention_paged_plain,
        duet_attention_paged_tiled_plain, paged_cluster_for)
    from repro_torch.kernels.ops import (build_duet_schedule,
                                         pack_duet_queries,
                                         unpack_duet_output)
    dev = "cuda"
    kp = torch.from_numpy(rng.standard_normal((N, ps, G, Dh), np.float32)
                          ).to(dev, dtype)
    vp = torch.from_numpy(rng.standard_normal((N, ps, G, Dh), np.float32)
                          ).to(dev, dtype)
    nslot = max(s for s, _ in decode_rows + prefill_rows) + 1
    tables = torch.tensor(1 + rng.permutation(N - 1)[:nslot * P]
                          .reshape(nslot, P), dtype=torch.int32, device=dev)
    sched = build_duet_schedule(decode_rows, prefill_rows, block_q=bq)
    rows = decode_rows + prefill_rows
    src_q = torch.from_numpy(rng.standard_normal((len(rows), H, Dh),
                                                 np.float32)).to(dev, dtype)
    q = pack_duet_queries(sched, src_q)
    row_pos = torch.tensor(sched.row_pos, device=dev)
    tile_slot = torch.tensor(sched.tile_slot, device=dev)
    if pad_tile:     # one more tile of pad rows on a -1 slot
        q = torch.cat([q, torch.ones_like(q[:bq])])
        row_pos = torch.cat([row_pos, torch.full_like(row_pos[:bq], -1)])
        tile_slot = torch.cat([tile_slot, torch.full_like(tile_slot[:1],
                                                          -1)])
    q, row_pos = q.contiguous(), row_pos[:, None].contiguous()
    kernel = lambda: duet_attention_paged(  # noqa: E731
        q, row_pos, tile_slot, kp, vp, tables, block_q=bq)
    plain = lambda: duet_attention_paged_plain(  # noqa: E731
        q, row_pos, tile_slot, kp, vp, tables, block_q=bq)
    C = paged_cluster_for(q, tile_slot, kp, tables)
    label += f" C={C}"
    rec = {"name": "duet_attention_paged", "case": label,
           "dtype": str(dtype)}
    out = kernel()
    torch.cuda.synchronize()
    got = unpack_duet_output(sched, out[:len(sched.row_src)], len(rows))
    want = unpack_duet_output(sched, plain()[:len(sched.row_src)],
                              len(rows))
    tol = ATTN_BF16_TOL if dtype == torch.bfloat16 else None
    _check("duet_attention_paged", got, want, dtype, label, rec, tol)
    # the algorithm the kernel runs: roles, C spans of 64-key units, the
    # rank-order combine
    err = rec["max_abs_err"]
    _check("duet_attention_paged", got, unpack_duet_output(
        sched, duet_attention_paged_tiled_plain(
            q, row_pos, tile_slot, kp, vp, tables, block_q=bq,
            cluster=C)[:len(sched.row_src)], len(rows)), dtype,
        label + " (tiles)", rec, tol)
    rec["max_abs_err"] = max(err, rec["max_abs_err"])
    # pad rows come out as zeros
    if torch.count_nonzero(out[row_pos[:, 0] < 0]):
        raise AssertionError(f"duet_attention_paged [{label}]: pad rows "
                             "are not zeros")
    elt = q.element_size()
    chain = {}
    for s, p in rows:
        chain[s] = max(chain.get(s, 0), p + 1)
    kv_tokens = sum(chain.values())
    nbytes = (2 * len(rows) * H * Dh * elt + 2 * kv_tokens * G * Dh * elt
              + tables.numel() * 4 + 4 * (len(rows) + len(sched.tile_slot)))
    ops = 4.0 * H * Dh * sum(p + 1 for _, p in rows)
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, ops, dtype)
    _time_kernel(kernel, rec)
    rec["plain_ms"] = time_ms(plain, iters=3)
    if not library:      # its head-repeated chains would not fit the card
        rec["library_ms"] = float("nan")
        return rec
    # library yardstick: SDPA with one query row per batch entry over
    # its gathered, head-repeated chain, masked causally by row position
    R = len(rows)
    slots = torch.tensor([s for s, _ in rows], device=dev).long()
    pos = torch.tensor([p for _, p in rows], device=dev)
    chains = tables.long()[slots]
    k = kp[chains].reshape(R, P * ps, G, Dh).repeat_interleave(
        H // G, dim=2).transpose(1, 2)
    v = vp[chains].reshape(R, P * ps, G, Dh).repeat_interleave(
        H // G, dim=2).transpose(1, 2)
    mask = (torch.arange(P * ps, device=dev)[None, :]
            <= pos[:, None])[:, None, None, :]
    qq = src_q[:, :, None, :]
    fn = torch.nn.functional.scaled_dot_product_attention
    rec["library_ms"] = time_ms(lambda: fn(qq, k, v, attn_mask=mask))
    del k, v
    return rec


def check_duet_slab(rng, label, dtype, Ns, S, G, H, Dh, decode_rows,
                    prefill_rows, bq, block_k=128):
    from repro_torch.kernels.duet_attention import (duet_attention,
                                                    duet_attention_plain)
    from repro_torch.kernels.ops import (build_duet_schedule,
                                         pack_duet_queries,
                                         unpack_duet_output)
    dev = "cuda"
    ks = torch.from_numpy(rng.standard_normal((Ns, S, G, Dh), np.float32)
                          ).to(dev, dtype)
    vs = torch.from_numpy(rng.standard_normal((Ns, S, G, Dh), np.float32)
                          ).to(dev, dtype)
    sched = build_duet_schedule(decode_rows, prefill_rows, block_q=bq)
    rows = decode_rows + prefill_rows
    src_q = torch.from_numpy(rng.standard_normal((len(rows), H, Dh),
                                                 np.float32)).to(dev, dtype)
    q = pack_duet_queries(sched, src_q).contiguous()
    row_pos = torch.tensor(sched.row_pos, device=dev)[:, None].contiguous()
    tile_slot = torch.tensor(sched.tile_slot, device=dev)
    kernel = lambda: duet_attention(  # noqa: E731
        q, row_pos, tile_slot, ks, vs, block_q=bq, block_k=block_k)
    plain = lambda: duet_attention_plain(  # noqa: E731
        q, row_pos, tile_slot, ks, vs, block_q=bq)
    from repro_torch.kernels.duet_attention import cluster_for, slab_role
    label += f" C={cluster_for(q, tile_slot, ks, bq)}"
    role = slab_role(bq, H // G)
    rec = {"name": "duet_attention" if role == "decode"
           else f"duet_attention[{role}]", "case": label,
           "dtype": str(dtype)}
    got = unpack_duet_output(sched, kernel(), len(rows))
    torch.cuda.synchronize()
    want = unpack_duet_output(sched, plain(), len(rows))
    _check("duet_attention", got, want, dtype, label, rec,
           ATTN_BF16_TOL if dtype == torch.bfloat16 else None)
    elt = q.element_size()
    live = {}
    for s_, p in rows:
        live[s_] = max(live.get(s_, 0), p + 1)
    nbytes = (2 * len(rows) * H * Dh * elt
              + 2 * sum(live.values()) * G * Dh * elt
              + 4 * (len(rows) + len(sched.tile_slot)))
    ops = 4.0 * H * Dh * sum(p + 1 for _, p in rows)
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, ops, dtype)
    _time_kernel(kernel, rec)
    rec["plain_ms"] = time_ms(plain, iters=3)
    # library yardstick: SDPA with one query row per batch entry over its
    # slot's head-repeated slab row, masked causally by row position
    slots = torch.tensor([s_ for s_, _ in rows], device=dev).long()
    pos = torch.tensor([p for _, p in rows], device=dev)
    k = ks[slots].repeat_interleave(H // G, dim=2).transpose(1, 2)
    v = vs[slots].repeat_interleave(H // G, dim=2).transpose(1, 2)
    mask = (torch.arange(S, device=dev)[None, :]
            <= pos[:, None])[:, None, None, :]
    qq = src_q[:, :, None, :]
    fn = torch.nn.functional.scaled_dot_product_attention
    rec["library_ms"] = time_ms(lambda: fn(qq, k, v, attn_mask=mask))
    del k, v
    return rec


def check_flash(rng, label, dtype, B, Sq, Sk, H, G, Dh, q_offset,
                kv_len=None):
    """flash_prefill against its plain version, timed with the plain
    version and SDPA."""
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_plain)
    dev = "cuda"

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, dtype)
    q, k, v = randn(B, Sq, H, Dh), randn(B, Sk, G, Dh), randn(B, Sk, G, Dh)
    kernel = lambda: flash_prefill(  # noqa: E731
        q, k, v, q_offset=q_offset, kv_len=kv_len)
    plain = lambda: flash_prefill_plain(  # noqa: E731
        q, k, v, q_offset=q_offset, kv_len=kv_len)
    rec = {"name": "flash_prefill", "case": label, "dtype": str(dtype)}
    want = plain()
    got = kernel()
    torch.cuda.synchronize()
    _check("flash_prefill", got, want, dtype, label, rec)
    del want, got
    # the work these inputs need: query i sees keys 0..min(q_offset + i,
    # kv_end - 1)
    kv_end = Sk if kv_len is None else min(Sk, kv_len)
    qpos = q_offset + np.arange(Sq)
    pairs = int(np.clip(np.minimum(qpos + 1, kv_end), 0, None).sum())
    keys = min(kv_end, q_offset + Sq)
    elt = q.element_size()
    nbytes = (2 * B * Sq * H * Dh + 2 * B * keys * G * Dh) * elt
    ops = 4.0 * B * H * Dh * pairs
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, ops, dtype)
    _time_kernel(kernel, rec)
    rec["plain_ms"] = time_ms(plain, iters=5)
    # library yardsticks: SDPA over head-repeated K/V with the
    # causal-offset (and kv_len) mask (library_ms, as for every kernel),
    # and, where the queries are the tail of the keys (q_offset = Sk - Sq,
    # no kv_len cut), SDPA with the lower-right causal bias, which SDPA
    # runs on its fused causal path without a mask (library_causal_ms)
    qq = q.transpose(1, 2)
    kk = k.repeat_interleave(H // G, dim=2).transpose(1, 2)
    vv = v.repeat_interleave(H // G, dim=2).transpose(1, 2)
    kpos = torch.arange(Sk, device=dev)
    mask = (kpos[None, :] <= torch.tensor(qpos, device=dev)[:, None]) \
        & (kpos[None, :] < kv_end)
    fn = torch.nn.functional.scaled_dot_product_attention
    rec["library_ms"] = time_ms(lambda: fn(qq, kk, vv, attn_mask=mask))
    if q_offset == Sk - Sq and kv_end == Sk:
        from torch.nn.attention.bias import causal_lower_right
        bias = causal_lower_right(Sq, Sk)
        ref = fn(qq, kk, vv, attn_mask=mask)
        alt = fn(qq, kk, vv, attn_mask=bias)
        if not torch.allclose(alt.float(), ref.float(), atol=TOL[dtype],
                              rtol=TOL[dtype]):
            raise AssertionError(f"[kernels] SDPA's lower-right causal "
                                 f"bias disagrees with its mask [{label}]")
        rec["library_causal_ms"] = time_ms(
            lambda: fn(qq, kk, vv, attn_mask=bias))
    return rec


def phase_kernels():
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import duet_block_q, num_splits_for
    rng = np.random.default_rng(0)
    records = []
    main = {}
    # the serving path's shapes: qwen3-4b heads, 8 decode slots with
    # contexts 256..2048 tokens (table bucket P=128 pages of 16), one
    # 256-row prefill chunk beside them in the duet launch
    B, H, G, Dh, ps, P = 8, 32, 8, 128, 16, 128
    lens = np.linspace(256, 2048, B).astype(np.int64)
    N = B * P + 1 + 64
    splits = num_splits_for(P, ps, 256)
    duet_bq = duet_block_q(H, G, Dh)
    for dtype in (torch.bfloat16, torch.float32):
        r = check_decode(rng, "main B=8 ctx 256-2048", dtype, B, H, G, Dh, N,
                         ps, P, lengths=lens, distinct=True)
        records.append(r)
        r = check_decode(rng, f"main B=8 ctx 256-2048 S={splits}", dtype, B,
                         H, G, Dh, N, ps, P, splits=splits, lengths=lens,
                         distinct=True)
        records.append(r)
        decode_rows = [(b, int(lens[b]) - 1) for b in range(B)]
        prefill_rows = [(B, 512 + i) for i in range(256)]
        # the async engine's tiles (64 // rep rows: decode rows on the
        # decode core, chunk tiles on the prefill block)
        r = check_duet(rng, f"main 8 decode + 256-row chunk bq={duet_bq}",
                       dtype, (B + 1) * P + 1, ps, G, H, Dh, P, decode_rows,
                       prefill_rows, bq=duet_bq)
        records.append(r)
        # the slab decode step: 8 decode rows (block_q 1) over the engine's
        # slab (8 slots x 1024), contexts 256..1000
        slab_rows = [(b, int(c) - 1) for b, c in
                     enumerate(np.linspace(256, 1000, B).astype(np.int64))]
        records.append(check_duet_slab(
            rng, "main slab 8 decode ctx 256-1000", dtype, B, 1024, G, H,
            Dh, slab_rows, [], bq=1))
        # a slab prefill chunk's shapes: 256 queries at offset 512
        records.append(check_flash(
            rng, "main Sq 256 @ 512, Sk 768", dtype, 1, 256, 768, H, G, Dh,
            512))
        if dtype == torch.bfloat16:      # the serving path's working type
            for rec in records[-5:]:
                main[rec["name"]] = rec
        # the reference's layout, one row a tile
        records.append(check_duet(
            rng, "main 8 decode + 256-row chunk bq=1", dtype,
            (B + 1) * P + 1, ps, G, H, Dh, P, decode_rows, prefill_rows,
            bq=1))
        # a whole 4096-token prompt, and the last 512-token chunk of one
        records.append(check_flash(
            rng, "long Sq 4096 @ 0, Sk 4096", dtype, 1, 4096, 4096, H, G, Dh,
            0))
        records.append(check_flash(
            rng, "chunk Sq 512 @ 3584, Sk 4096", dtype, 1, 512, 4096, H, G,
            Dh, 3584))
        records.append(check_flash(
            rng, "ragged Sq 100 @ 200, Sk 300, kv_len 250", dtype, 2, 100,
            300, H, G, Dh, 200, kv_len=250))
    # the kernel tests' shapes: GQA / MQA / MHA, odd lengths, dead splits
    for dtype in (torch.float32, torch.bfloat16):
        for (Bs, Hs, Gs, Ds, Ns, pss, Ps) in [(2, 4, 2, 64, 16, 16, 4),
                                               (3, 8, 1, 128, 32, 16, 6),
                                               (2, 4, 4, 64, 16, 8, 5)]:
            records.append(check_decode(
                rng, f"sweep B{Bs} H{Hs} G{Gs} Dh{Ds} ps{pss} P{Ps}", dtype,
                Bs, Hs, Gs, Ds, Ns, pss, Ps))
        for (Bs, Hs, Gs, Ds, Ns, pss, Ps, S, ln) in [
                (2, 4, 2, 64, 16, 16, 4, 2, None),
                (2, 4, 2, 64, 16, 16, 5, 2, None),
                (3, 8, 1, 128, 32, 16, 6, 3, None),
                (2, 8, 2, 64, 16, 8, 6, 4, None),
                (2, 4, 2, 64, 16, 8, 1, 4, None),
                (2, 4, 2, 64, 16, 8, 4, 2, (16, 32)),
                (2, 4, 2, 64, 16, 8, 4, 4, (1, 31))]:
            records.append(check_decode(
                rng, f"splitkv B{Bs} H{Hs} G{Gs} P{Ps} S{S} lens {ln}",
                dtype, Bs, Hs, Gs, Ds, Ns, pss, Ps, splits=S, lengths=ln))
        for bq in (1, 4):
            records.append(check_duet(
                rng, f"mixed phases bq={bq}", dtype, 40, 16, 2, 4, 64, 8,
                [(0, 100), (1, 57), (2, 127)],
                [(3, 64 + i) for i in range(20)], bq=bq))
        for bq in (1, 8):
            records.append(check_duet_slab(
                rng, f"slab mixed phases bq={bq}", dtype, 4, 256, 2, 4, 64,
                [(0, 100), (1, 57), (2, 200)],
                [(3, 64 + i) for i in range(20)], bq=bq))
        for (Bs, Sq, Sk, Hs, Gs, Ds, off, kvl) in [
                (1, 128, 128, 4, 2, 64, 0, None),
                (2, 128, 256, 4, 4, 64, 128, None),
                (1, 256, 256, 8, 2, 128, 0, None),
                (1, 128, 128, 4, 1, 64, 0, None),
                (1, 77, 200, 4, 2, 64, 100, 150),
                # the bf16 kernel's tile edges: one query, rows that end
                # mid-block (Sq * rep not a multiple of 64 or 128), keys
                # that end mid-tile (Sk not a multiple of 64), kv_len
                # inside a tile, rep 8 and 64, Dh 32, no valid key at all
                (1, 1, 33, 32, 8, 128, 32, None),
                (2, 45, 130, 32, 8, 128, 85, 100),
                (1, 200, 200, 8, 1, 32, 0, None),
                (1, 67, 129, 64, 1, 64, 62, None),
                (1, 16, 64, 4, 2, 64, 0, 0)]:
            records.append(check_flash(
                rng, f"sweep B{Bs} Sq{Sq} Sk{Sk} H{Hs} G{Gs} Dh{Ds} "
                f"off{off} kv_len {kvl}", dtype, Bs, Sq, Sk, Hs, Gs, Ds, off,
                kv_len=kvl))
    # the cluster kernels' edges: one request or row (C = 8), 32 of them
    # (C = 1 or 2), lengths 1, 16, 17 and 2048, Dh 64 / 128 / 256, slab
    # tiles of block_q 1 and 8
    edge = (1, 16, 17, 2048)
    edge_rows = [(0, 0), (1, 15), (2, 16), (3, 2047)]
    chunk = [(3, 64 + i) for i in range(20)]
    for dtype in (torch.float32, torch.bfloat16):
        for (Bs, Hs, Gs, Ds, ln) in [(1, 32, 8, 128, (2048,)),
                                     (1, 32, 8, 128, (1,)),
                                     (4, 32, 8, 128, edge),
                                     (32, 32, 8, 128, edge * 8),
                                     (4, 8, 2, 64, edge),
                                     (4, 8, 4, 256, edge),
                                     (2, 8, 2, 256, (17, 128))]:
            records.append(check_decode(
                rng, f"edge B{Bs} H{Hs} G{Gs} Dh{Ds} lens {ln[:4]}", dtype,
                Bs, Hs, Gs, Ds, 257, 16, 128, lengths=ln))
        for (bq, drows, prows, S, Hs, Gs, Ds) in [
                (1, [(0, 1000)], [], 1024, 32, 8, 128),
                (1, [(b, (0, 15, 16, 1023)[b % 4]) for b in range(32)], [],
                 1024, 32, 8, 128),
                (1, edge_rows, [], 2048, 8, 2, 64),
                (1, edge_rows, [], 2048, 8, 4, 256),
                (8, edge_rows[:3], chunk, 256, 4, 2, 128),
                (8, edge_rows[:3], chunk, 256, 4, 2, 256)]:
            records.append(check_duet_slab(
                rng, f"edge bq={bq} {len(drows)} decode + {len(prows)} "
                f"S{S} H{Hs} G{Gs} Dh{Ds}", dtype,
                max(s_ for s_, _ in drows + prows) + 1, S, Gs, Hs, Ds, drows,
                prows, bq=bq))
    # the paged duet kernel's tiles at full width (the CPU tile tests'
    # edges): decode contexts 1, 16, 17 and 2048, chunks of 20 and 1 rows
    # (one at position 0), pages of 8, 16 and 32, a pad tile, Dh 64 and
    # 128, and enough tiles for C = 8, 4, 2 and 1
    def edge_rows(n):
        return [(b, (0, 15, 16, 2047)[b % 4]) for b in range(n)]
    for dtype in (torch.float32, torch.bfloat16):
        for (nd, chunk_rows, pss, Ds, pad) in [
                (1, 16, 32, 128, True),     # 3 tiles: C = 8
                (4, 20, 16, 128, False),    # C = 4
                (4, 1, 8, 128, True),       # a one-row chunk at position 0
                (14, 20, 16, 128, False),   # 16 tiles: C = 2
                (32, 20, 16, 128, True),    # 35 tiles: C = 1
                (4, 20, 16, 64, True)]:     # Dh 64
            start = 0 if chunk_rows == 1 else 64
            drows = edge_rows(nd)
            records.append(check_duet(
                rng, f"edge {nd} decode + {chunk_rows} chunk ps{pss} "
                f"Dh{Ds}{' pad tile' if pad else ''}", dtype,
                (nd + 1) * (2048 // pss) + 1, pss, G, H, Ds, 2048 // pss,
                drows, [(nd, start + i) for i in range(chunk_rows)],
                bq=duet_block_q(H, G, Ds), pad_tile=pad))
    # every GQA head shape of the registered configs at the main path's
    # shapes: the decode kernels, the slab decode and the paged duet launch
    # at each config's engine tiles (duet_block_q: 1, 8, 64, 12); then
    # flash_prefill at reps that do not divide 64, above 64 and at Dh 256,
    # and the head blocks of rep 96 and 128 through every kernel
    edge4 = edge_rows(4)
    chunk20 = [(4, 64 + i) for i in range(20)]
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        for cname in HEAD_CONFIGS:
            cfg = get_config(cname)
            Hs, Gs, Ds = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            first = len(records)
            records.append(check_decode(
                rng, f"{cname} B=8 ctx 256-2048", dtype, B, Hs, Gs, Ds, N,
                ps, P, lengths=lens, distinct=True))
            records.append(check_decode(
                rng, f"{cname} B=8 ctx 256-2048 S={splits}", dtype, B, Hs,
                Gs, Ds, N, ps, P, splits=splits, lengths=lens,
                distinct=True))
            records.append(check_duet_slab(
                rng, f"{cname} slab 8 decode ctx 256-1000", dtype, B, 1024,
                Gs, Hs, Ds, slab_rows, [], bq=1))
            bq = duet_block_q(Hs, Gs, Ds)
            records.append(check_duet(
                rng, f"{cname} 8 decode + 256-row chunk bq={bq}", dtype,
                (B + 1) * P + 1, ps, Gs, Hs, Ds, P, decode_rows,
                prefill_rows, bq=bq, library=bf16))
            for rec in records[first:]:       # the block roles' records
                if bf16 and rec["name"].endswith("[block]"):
                    main.setdefault(rec["name"], rec)
        for (hlabel, Hs, Gs, Ds) in [("rep 3", 24, 8, 64),
                                     ("rep 5", 40, 8, 128),
                                     ("rep 48", 48, 1, 128),
                                     ("Dh 256 rep 8", 8, 1, 256),
                                     ("rep 96", 96, 1, 64),
                                     ("rep 128", 128, 1, 64)]:
            records.append(check_flash(
                rng, f"{hlabel} Sq 256 @ 512, Sk 768", dtype, 1, 256, 768,
                Hs, Gs, Ds, 512))
        for (Hs, Gs, Ds) in [(96, 1, 64), (128, 1, 64)]:
            records.append(check_decode(
                rng, f"rep {Hs} B=8 ctx 256-2048", dtype, B, Hs, Gs, Ds, N,
                ps, P, lengths=lens, distinct=True))
            records.append(check_duet_slab(
                rng, f"rep {Hs} slab 4 decode ctx 1-2048", dtype, 4, 2048,
                Gs, Hs, Ds, edge4, [], bq=1))
            records.append(check_duet(
                rng, f"rep {Hs} 4 decode + 20 chunk bq=1", dtype,
                5 * (2048 // ps) + 1, ps, Gs, Hs, Ds, 2048 // ps, edge4,
                chunk20, bq=1, pad_tile=True, library=bf16))
    card = card_line()
    for rec in records:
        log(f"[kernels] {rec['name']:27s} {rec['dtype']:15s} "
            f"{rec['case']:44s} max_abs_err={rec['max_abs_err']:.3e} "
            f"tol={rec['tol']:.0e}/{rec['rtol']:.0e} ms={rec['ms']:.4f} "
            f"cold_ms={rec['cold_ms']:.4f} "
            f"host_ms={rec['host_ms']:.4f} hold_tries="
            f"{rec['hold_tries'][0]}/{rec['hold_tries'][1]}"
            f"{'' if rec['held'] else ' (host behind the hold)'} "
            f"plain_ms={rec['plain_ms']:.4f} "
            f"library_ms={rec['library_ms']:.4f} "
            f"bound_ms={rec['bound_ms']:.3g} ({rec['bound_by']}, "
            f"{rec['bound_ms'] / rec['cold_ms']:.1%} of cold_ms)"
            + (f" library_causal_ms={rec['library_causal_ms']:.4f}"
               if "library_causal_ms" in rec else "")

            + f" [{card}]")
    report_occupancy(card)
    return main


def report_occupancy(card):
    """The cluster kernels' residency at the main path's shapes (bf16): the
    cluster size the wrappers pick, how many clusters the card holds at
    once (cudaOccupancyMaxActiveClusters) and the ring's loads that can be
    in flight per SM."""
    from repro_torch.kernels.duet_attention import cluster_for as slab_c
    from repro_torch.kernels.duet_attention import occupancy as slab_occ
    from repro_torch.kernels.paged_decode import cluster_for as paged_c
    from repro_torch.kernels.paged_decode import occupancy as paged_occ
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B, G, rep, Dh, P, S = 8, 8, 4, 128, 128, 1024
    bf16 = torch.bfloat16
    q = torch.empty((B, G * rep, Dh), dtype=bf16, device="cuda")
    kp = torch.empty((1, 16, G, Dh), dtype=bf16, device="cuda")
    tables = torch.empty((B, P), dtype=torch.int32, device="cuda")
    ks = torch.empty((B, S, G, Dh), dtype=bf16, device="cuda")
    tiles = torch.empty((B,), dtype=torch.int32, device="cuda")
    picks = {"paged_decode": (paged_c(q, kp, tables), lambda C: paged_occ(
                 dev, bf16, Dh, rep, P, C)),
             "duet_attention": (slab_c(q, tiles, ks, 1), lambda C: slab_occ(
                 dev, bf16, Dh, rep, C))}
    from repro_torch.kernels.flash_prefill import occupancy as flash_occ
    blocks, smem = flash_occ(dev, Dh)
    log(f"[kernels] flash_prefill bf16 Dh {Dh}: {blocks} blocks of 4 warps "
        f"(64 rows, {smem / 1024:.0f} KB shared memory each) resident per "
        f"SM [{card}]")
    # granite-20b's heads (rep 48, MQA): both decode kernels' CTAs take the
    # 64-row block role
    from repro_torch.kernels.duet_attention import slab_role
    from repro_torch.kernels.ops import cta_role as paged_role
    qg = torch.empty((B, 48, Dh), dtype=bf16, device="cuda")
    kg = torch.empty((1, 16, 1, Dh), dtype=bf16, device="cuda")
    ksg = torch.empty((B, S, 1, Dh), dtype=bf16, device="cuda")
    grid = {"paged_decode": B, "duet_attention": B}
    picks["paged_decode"] += (paged_role(rep), G)
    picks["duet_attention"] += (slab_role(1, rep), G)
    picks["paged_decode granite"] = (
        paged_c(qg, kg, tables),
        lambda C: paged_occ(dev, bf16, Dh, 48, P, C), paged_role(48), 1)
    picks["duet_attention granite"] = (
        slab_c(qg, tiles, ksg, 1),
        lambda C: slab_occ(dev, bf16, Dh, 48, C), slab_role(1, 48), 1)
    for name, (C, occupancy, role, groups) in picks.items():
        clusters, smem, ahead = occupancy(C)
        per_sm = clusters * C / sms
        ctas = grid[name.split()[0]] * groups * C
        log(f"[kernels] {name} main bf16, {role} role: C={C}, grid {ctas} "
            f"CTAs of "
            f"{smem / 1024:.1f} KB shared memory; {clusters} clusters "
            f"({clusters * C} CTAs, {per_sm:.2f} per SM) resident at once; "
            f"{ahead / 1024:.0f} KB of loads ahead per CTA, up to "
            f"{min(per_sm, ctas / sms) * ahead / 1024:.0f} KB in flight "
            f"per SM [{card}]")
    # the paged duet kernel at the engine's main launch: 8 decode tiles and
    # 16 chunk tiles of 16 rows (T = 24)
    from repro_torch.kernels.duet_attention import (paged_cluster_for,
                                                    paged_occupancy)
    T = 24
    tiles = torch.empty((T,), dtype=torch.int32, device="cuda")
    C = paged_cluster_for(q, tiles, kp, tables)
    for c in sorted({1, 2, 4, 8, C}):
        clusters, smem, regs = paged_occupancy(dev, bf16, Dh, 16, P, c)
        log(f"[kernels] duet_attention_paged main bf16 C={c}"
            f"{' (the wrapper picks it)' if c == C else ''}: grid "
            f"{T * G * c} CTAs of {smem / 1024:.1f} KB shared memory, "
            f"{regs} registers a thread; {clusters} clusters "
            f"({clusters * c} CTAs, {clusters * c / sms:.2f} per SM) "
            f"resident at once [{card}]")


# ---------------------------------------------------------------------------
# phase 4: logits parity, kernel path vs plain path
# ---------------------------------------------------------------------------
def phase_parity():
    """qwen3-4b cut to 4 layers, then each served config
    beyond it cut to 2 layers (full width; the recurrent ones to
    RECURRENT_PARITY_LAYERS), fp32 with TF32 off."""
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[parity] fp32, TF32 off (matmul and cudnn)")
    parity_for("qwen3-4b", 4, flash=True)
    for name in SERVED_CONFIGS:
        cfg = get_config(name)
        if _is_gqa(cfg):
            parity_for(name, 2)
        elif cfg.kv_lora_rank:
            parity_mla(name, 2)
        else:
            parity_recurrent(name, RECURRENT_PARITY_LAYERS[name])
    for name in ("paligemma-3b", "musicgen-medium"):
        parity_frontend(name)
    parity_graphs()
    parity_duet_split()


def parity_duet_split():
    """The card's Algorithm 1 on reduced qwen3-4b, fp32, TF32 off: the
    async engine on the paged kernel path (graphs on, strict), priced by
    the card (held), serves SPLIT_SPECS at the default TBT bound of 0.1 s,
    where it takes no duet iteration, and at a bound between its
    predicted decode and mixed times (SPLIT_FRACTIONS), where it must take
    some: each one's (S_p, S_d, k) printed, S_p + S_d the card's TPCs. The
    greedy streams of the two runs must be identical: the split changes
    the schedule (k decode steps a super-iteration), not the tokens."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.roofline import RequestLoad
    from repro_torch.models import Model
    from repro_torch.serving import AsyncDuetEngine, EngineConfig, Request
    t0 = time.time()
    card = card_line()
    cfg = reduced(get_config("qwen3-4b"))
    model = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda",
                       attn_kernel=True)

    def serve(tbt):
        engine = AsyncDuetEngine(model, EngineConfig(
            **SPLIT_ENGINE, tbt_slo=tbt, strict_kernel=True), seed=0,
            device="cuda")
        _hold_card_pricing(engine, f"{cfg.name} at tbt_slo {tbt}", card)
        parts, step = [], engine.mux.step

        def record(pre, dec):
            decision = step(pre, dec)
            if decision.mode == "duet":
                p = decision.partition
                parts.append((p.s_prefill, p.s_decode, p.k))
            return decision
        engine.mux.step = record
        engine.submit([Request(rid=r, arrival=a, prompt_len=p, output_len=o)
                       for r, a, p, o in SPLIT_SPECS])
        metrics = engine.run()
        if metrics.summary()["num_finished"] != len(SPLIT_SPECS):
            raise AssertionError(f"[parity] {cfg.name} at tbt_slo {tbt}: a "
                                 "request did not finish")
        return engine, {r.rid: list(r.output_tokens)
                        for r in metrics.requests}, parts

    engine, base, parts = serve(EngineConfig().tbt_slo)
    if parts:
        raise AssertionError(f"[parity] {cfg.name}: duet iterations {parts} "
                             "at the default 0.1 s")
    B = SPLIT_ENGINE["max_slots"]
    dec = [RequestLoad(q=1, c=SPLIT_CTX) for _ in range(B)]
    chunk = [RequestLoad(q=SPLIT_ENGINE["token_budget"] - B, c=0,
                         phase="prefill")]
    t_dec = engine.mux.predict_mixed(dec)
    t_mix = engine.mux.predict_mixed(dec + chunk)
    units = engine.mux.total_units
    for frac in SPLIT_FRACTIONS:
        tbt = t_dec + frac * (t_mix - t_dec)
        engine, split, parts = serve(tbt)
        if parts:
            break
    else:
        raise AssertionError(f"[parity] {cfg.name}: no duet iteration at "
                             f"any bound between {t_dec} and {t_mix} s")
    log(f"[parity] {cfg.name} ({cfg.num_layers} layers, fp32), the card's "
        f"Algorithm 1 over {units} TPCs: predicted decode {t_dec * 1e6:.3f}"
        f" us, mixed {t_mix * 1e6:.3f} us; at tbt_slo {tbt * 1e6:.3f} us "
        f"{len(parts)} duet iterations of "
        f"{engine.mux.stats.iterations}, (S_p, S_d, k) {parts}; at 0.1 s "
        f"none; greedy streams identical {split == base} [{card}], "
        f"{time.time() - t0:.1f} s")
    if split != base or any(s_p + s_d != units or min(s_p, s_d) < 1
                            for s_p, s_d, _ in parts):
        raise AssertionError(f"[parity] {cfg.name}: the duet-split run "
                             "differs from the aggregated one")
    del engine, model
    torch.cuda.empty_cache()


def parity_graphs():
    """The async engine's CUDA graphs against its eager dispatches, fp32
    with TF32 off, paged, kernels on, on GRAPH_PARITY_ENGINE and
    GRAPH_PARITY_SPECS' requests, whose chunk buckets recur: on reduced
    qwen3-4b and the configs of the block kinds beyond its own
    (GRAPH_PARITY_CONFIGS: Mamba2 with a shared GQA block, GQA with an
    MoE, MLA with an MoE) greedy streams and launch counts identical, and
    decode-only, prefill-only and fused chunk buckets captured (duet ones
    where the engine fuses: GQA); then each config's bucket kinds held by
    check_bucket_graphs; then reduced qwen3-4b sampling at
    GRAPH_SAMPLING_TEMPERATURE, the engine's generator registered with
    each graph (its streams against the eager run's printed, not held:
    only temperature 0 is the reference's)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    from repro_torch.serving import AsyncDuetEngine, Request
    card = card_line()

    def reqs():
        return [Request(rid=rid, arrival=a, prompt_len=p, output_len=o)
                for rid, a, p, o in GRAPH_PARITY_SPECS]
    for name, kinds in GRAPH_PARITY_CONFIGS.items():
        t0 = time.time()
        cfg = reduced(get_config(name))
        model = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda",
                           attn_kernel=True)
        got = {graphs: _serve_run(
            f"{cfg.name} {'eager' if graphs is False else 'graphs'}",
            AsyncDuetEngine, model, reqs(), card, GRAPH_PARITY_ENGINE,
            graphs) for graphs in (None, False)}
        _graphs_vs_eager(f"{cfg.name} ({cfg.num_layers} layers, fp32)",
                         got[None], got[False])
        want = {"decode", "prefill", "fused"} | (
            {"duet"} if _is_gqa(cfg) else set())
        if set(got[None]["captured"]) != want:
            raise AssertionError(f"[parity] {cfg.name}: captured bucket "
                                 f"kinds {got[None]['captured']}, not "
                                 f"{sorted(want)}")
        for kind in kinds:
            check_bucket_graphs(model, kind, card)
        if name == "qwen3-4b":
            extra = {**GRAPH_PARITY_ENGINE,
                     "temperature": GRAPH_SAMPLING_TEMPERATURE}
            hot = {graphs: _serve_run(
                f"{cfg.name} {'eager' if graphs is False else 'graphs'} "
                f"temperature {GRAPH_SAMPLING_TEMPERATURE}",
                AsyncDuetEngine, model, reqs(), card, extra, graphs)
                for graphs in (None, False)}
            log(f"[parity] {cfg.name} at temperature "
                f"{GRAPH_SAMPLING_TEMPERATURE}: the generator registered "
                f"with each graph; graphed and eager streams identical "
                f"{hot[None]['streams'] == hot[False]['streams']} (not "
                f"held) [{card}]")
        log(f"[parity] {cfg.name} graphs: {time.time() - t0:.1f} s")
        del model
        torch.cuda.empty_cache()


def _bucket_kind(key) -> str:
    """The kind of the async engine's bucket ``key`` = (kb, width, chunk,
    pwidth, finish, sample, duet): decode, prefill (no decode), fused
    (decode then the chunk) or duet (one fused launch)."""
    kb, _, chunk = key[:3]
    return "duet" if key[-1] else "decode" if not chunk else \
        "prefill" if not kb else "fused"


def _bucket_world(model, rng):
    """Page pools (BUCKET_SHAPE's slots' tables and one chunk table of P
    pages each), recurrent state and decode inputs on the card, the
    floating ones random, so a graph that read a wrong slot, page or
    position would show it."""
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    cfg = model.cfg
    B, P, ps, chunk = (BUCKET_SHAPE[k] for k in ("B", "P", "ps", "chunk"))
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(99)))
    pools = init_page_pools(cfg, PagePoolConfig(num_pages=(B + 1) * P + 1,
                                                page_size=ps),
                            model.dtype, device="cuda")
    state = model.init_state_cache(B)
    for group in [g for g in pools + state if g is not None]:
        for t in group:
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    last_tok = torch.tensor(rng.integers(0, cfg.vocab_size, (B, 1)),
                            dtype=torch.int32, device="cuda")
    pos = torch.tensor(rng.integers(chunk, P * ps - 8, B),
                       dtype=torch.int32, device="cuda")
    return {"pools": pools, "state": state, "last_tok": last_tok,
            "pos": pos}


def _world_tensors(world):
    out = [world["last_tok"], world["pos"]]
    for group in world["pools"] + world["state"]:
        if group is not None:
            out.extend(group)
    return out


def _kernel_events(events, steps) -> dict:
    """Launches a step of each of the port's kernels in a trace's device
    events, by wrapper counter (wrappers that launch one function share
    its count, listed under the first)."""
    import re
    fn_count = {}
    for e in events:
        m = re.search(r"(\w+_kernel)\s*[<(]", e.key)
        if m:
            fn_count[m.group(1)] = fn_count.get(m.group(1), 0) + e.count
    return {fn: n / steps for fn, n in fn_count.items()
            if any(fn in fns for fns in KERNEL_FUNCTIONS.values())}


def _hold_trace(what, launches, events, steps, card):
    """Hold the launches a bucket's capture counted (``launches``, by
    wrapper) to the device kernel events of ``steps`` traced replays: each
    kernel function as often a replay as the wrappers that launch it
    counted. Replayed launches are capture-time counts; this is what shows
    that the graph holds them."""
    want = {}
    for name, n in launches.items():
        fn = KERNEL_FUNCTIONS[name][0]
        want[fn] = want.get(fn, 0) + n
    got = _kernel_events(events, steps)
    flash = KERNEL_FUNCTIONS["flash_prefill"]
    if flash[1] in got:      # one counter, two functions
        got[flash[0]] = got.get(flash[0], 0) + got.pop(flash[1])
    log(f"[graphs] {what}: a replay's kernels in the trace {got}, counted "
        f"at capture {launches} [{card}]")
    if got != {fn: float(n) for fn, n in want.items()}:
        raise AssertionError(f"[graphs] {what}: the replayed graph's "
                             f"kernels {got} differ from the launches "
                             f"counted at its capture {launches}")


def check_bucket_graphs(model, kind, card, steps: int = 2):
    """One dispatch bucket of BUCKET_KINDS' ``kind`` on ``model``
    (BUCKET_SHAPE, paged, the model's dtype): the engine's BucketProgram
    run eagerly at BUCKET_DISPATCHES' first (chunk start, slot, resume
    token), captured at the second and replayed at the third, each fed
    other tables, active slots and chunk tokens through its static
    buffers. The captured and the replayed dispatch are held bitwise to a
    freshly built eager program on a copy of the state, given new tensors
    and the scalars as host ints: tokens, the sampled token, every pool,
    the recurrent state, ``pos`` and ``last_tok``; the capture's counted
    launches to the fresh program's and to the trace of ``steps`` more
    replays."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.lookahead import (BucketProgram, graph_pool_bytes,
                                            make_superiter_fn)
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.ops import build_duet_schedule, duet_block_q
    t0 = time.time()
    cfg = model.cfg
    B, P, chunk = (BUCKET_SHAPE[k] for k in ("B", "P", "chunk"))
    kb, finish, sample, duet = BUCKET_KINDS[kind]
    bq = duet_block_q(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) \
        if duet else 1
    kw = dict(paged=True, chunk=chunk, finish=finish, sample=sample,
              duet_kernel=duet, duet_block_q=bq)
    width = P if kb else 1
    bucket = BucketProgram(make_superiter_fn(model, kb, **kw),
                           torch.device("cuda"), B, width=width,
                           chunk=chunk, pwidth=P)
    order = None
    if duet:
        order = torch.tensor(build_duet_schedule(
            [(b, 0) for b in range(B)], [(B, i) for i in range(chunk)],
            block_q=bq).row_src, dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(len(kind))
    world = _bucket_world(model, rng)
    gen = torch.Generator(device="cuda").manual_seed(0)
    pool = torch.cuda.graph_pool_handle()
    what = (f"{cfg.name} {kind} bucket (kb {kb}, a {chunk}-row chunk, "
            f"finish {finish}, sample {sample}; {cfg.num_layers} layers, "
            f"B={B}, {str(model.dtype)[6:]})")
    for i, (start, slot, override) in enumerate(BUCKET_DISPATCHES):
        active = rng.random(B) < 0.8
        active[slot] = False
        tables = rng.permutation(np.arange(1, B * P + 1)).reshape(B, P) \
            if kb else np.zeros((B, 1), np.int64)
        pre_toks = rng.integers(0, cfg.vocab_size, (1, chunk))
        pre_tbl = rng.permutation(np.arange(B * P + 1,
                                            (B + 1) * P + 1))[None]
        bucket.feed(active, tables, pre_toks, pre_tbl,
                    (start, slot, override))
        args = (world["pools"], world["state"], world["last_tok"],
                world["pos"], bucket.tables, gen, bucket.active,
                bucket.pre_toks, bucket.pre_tbl, bucket.pre_start,
                bucket.pre_slot, bucket.override_tok) + (
                    (order,) if duet else ())
        if i == 0:
            bucket.run(*args)
            continue
        before = copy.deepcopy(world)
        got = bucket.capture(args, pool) if i == 1 else bucket.replay()
        fresh = make_superiter_fn(model, kb, **kw)
        counted = launch_counts()

        def dev(a):
            return torch.tensor(a, dtype=torch.int32, device="cuda")
        want = fresh(before["pools"], before["state"], before["last_tok"],
                     before["pos"], dev(tables), gen, torch.tensor(
                         active, device="cuda"), dev(pre_toks),
                     dev(pre_tbl), start, slot, override,
                     *((order.clone(),) if duet else ()))
        eager = {k: n - counted[k] for k, n in launch_counts().items()
                 if n != counted[k]}
        same = [torch.equal(got[0], want[0]),
                (got[1] is None) == (want[1] is None) == (not sample)
                and (got[1] is None or torch.equal(got[1], want[1]))]
        same += [torch.equal(a, b) for a, b in zip(_world_tensors(world),
                                                    _world_tensors(before))]
        if finish:
            same.append(int(world["pos"][slot]) == start + chunk)
        if finish and not sample:
            same.append(int(world["last_tok"][slot, 0]) == override)
        if not all(same) or eager != bucket.launches:
            raise AssertionError(
                f"[graphs] {what}: the {'captured' if i == 1 else 'replayed'}"
                f" dispatch at start {start}, slot {slot} differs from a "
                f"fresh eager program: {same.count(False)} of {len(same)} "
                f"outputs and tensors; launches {bucket.launches} vs "
                f"{eager}")
        del before, want
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            bucket.replay()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    _hold_trace(what, bucket.launches, [
        e for e in prof.key_averages() if e.device_type == cuda], steps,
        card)
    log(f"[graphs] {what}: eager at (start, slot, resume) "
        f"{BUCKET_DISPATCHES[0]}, captured at {BUCKET_DISPATCHES[1]} and "
        f"replayed at {BUCKET_DISPATCHES[2]}, each bitwise equal to a fresh "
        f"eager program (tokens, pools, state, pos, last_tok); launches a "
        f"replay {bucket.launches}; graph pool {graph_pool_bytes(pool)} "
        f"bytes; {time.time() - t0:.1f} s [{card}]")
    del bucket, world
    torch.cuda.empty_cache()


def _is_gqa(cfg) -> bool:
    from repro_torch.configs.base import GQA_KINDS
    return all(k in GQA_KINDS for k in cfg.block_pattern)


def _cut(name, n_layers):
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config(name)
    return dataclasses.replace(full, num_layers=n_layers,
                               block_pattern=full.block_pattern[:n_layers])


def _check_parity(name, n_layers, cfg, checks):
    for what, got, want in checks:
        V = cfg.vocab_size          # padded logit columns hold finfo.min
        got, want = got[..., :V], want[..., :V]
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        if not (torch.isfinite(got).all() and err <= PARITY_TOL * scale):
            raise AssertionError(f"[parity] {name} {what}: max abs err "
                                 f"{err:.3e} > {PARITY_TOL:.0e} x "
                                 f"{scale:.3g}")
        log(f"[parity] {name} ({n_layers} layers) {what}: max abs err "
            f"{err:.3e} (tol {PARITY_TOL:.0e} x max|reference| "
            f"{scale:.3g})")


def parity_frontend(name):
    """A frontend at full depth and width, fp32: a slab prefill of 2 rows
    (paligemma: 256 patch embeddings under the prefix-LM mask, then
    FRONTEND_PROMPT text tokens; musicgen: a (2, 4, FRONTEND_PROMPT)
    codebook grid), then FRONTEND_DECODE slab decode steps through
    ``gqa_decode_kernel`` (the slab duet_attention kernel) against the
    plain path's on a copy of the same cache, each step fed the plain
    path's greedy tokens; musicgen's logits are (B, K, V). The kernel must
    launch on every decode step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models import Model
    t0 = time.time()
    cfg = get_config(name)
    kern = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda",
                      attn_kernel=True)
    plain = copy.copy(kern)          # the same weights, plain attention
    plain.attn_kernel = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    B, S = 2, FRONTEND_PROMPT
    audio = cfg.frontend == "audio"
    K = cfg.num_codebooks
    shape = (B, K, S) if audio else (B, S)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, shape), device=dev)
    kw, P = {}, 0
    if not audio:
        P = cfg.num_prefix_tokens
        kw["patch_embeds"] = torch.from_numpy(0.02 * rng.standard_normal(
            (B, P, cfg.d_model), np.float32)).to(dev)
    checks = []
    with torch.no_grad():
        # the slab's rows in whole 128-key tiles, as the kernel takes them
        cache = plain.init_cache(B, -(-(P + S + FRONTEND_DECODE) // 128)
                                 * 128)
        first, _ = plain.prefill(toks, cache=cache, **kw)
        kcache = [type(c)(*(t.clone() for t in c)) for c in cache]
        tok = first.argmax(-1)[..., None]       # (B, 1) or (B, K, 1)
        before = launch_counts()["duet_attention"]
        for i in range(FRONTEND_DECODE):
            pos = torch.full((B,), P + S + i, dtype=torch.int32, device=dev)
            lk, _ = kern.decode_step(kcache, tok, pos)
            lp, _ = plain.decode_step(cache, tok, pos)
            checks.append((f"slab decode step {i} after the "
                           f"{'codebook' if audio else 'patch + text'} "
                           f"prefill{' (B, K, V)' if audio else ''}", lk,
                           lp))
            tok = lp.argmax(-1)[..., None]
        launched = launch_counts()["duet_attention"] - before
    if not torch.isfinite(first).all():
        raise AssertionError(f"[parity] {name}: prefill logits not finite")
    if launched != FRONTEND_DECODE * cfg.num_layers:
        raise AssertionError(f"[parity] {name}: duet_attention launched "
                             f"{launched} times over {FRONTEND_DECODE} "
                             f"steps of {cfg.num_layers} layers")
    _check_parity(name, cfg.num_layers, cfg, checks)
    log(f"[parity] {name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"H {cfg.num_heads} G {cfg.num_kv_heads} Dh {cfg.head_dim}, "
        + (f"{K} codebooks" if audio else f"{P} patch embeddings, prefix-LM")
        + f", prefill logits {tuple(first.shape)}; duet_attention launched "
        f"{launched} times; {time.time() - t0:.1f} s")
    del kern, plain, cache, kcache
    torch.cuda.empty_cache()


def parity_mla(name, n_layers):
    """An MLA config at full width cut to ``n_layers`` layers (deepseek:
    its dense MLA layer and one MLA + MoE layer), fp32: a 200-token paged
    prefill and one paged decode step with the latent up-projections
    absorbed against expanded, then the same prompt prefilled into the
    slab and one slab decode step against the paged ones. Both prefill in
    chunks of 128 + 72, so the MoE routes the same rows together on both
    layouts."""
    from repro_torch.models import Model
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    t0 = time.time()
    cfg = _cut(name, n_layers)
    expand = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda")
    absorb = copy.copy(expand)       # the same weights
    absorb.mla_absorb = True
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    ps, P = 16, 16
    tbl = torch.arange(1, 1 + P, dtype=torch.int32, device=dev)[None]
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 201)),
                        device=dev)
    pos = torch.tensor([200], dtype=torch.int32, device=dev)
    state = [None] * cfg.num_layers
    chunks = ((0, 128), (128, 200))   # the same rows routed on both layouts
    with torch.no_grad():
        logits, prefill = {}, {}
        for label, model in (("expand", expand), ("absorb", absorb)):
            pools = init_page_pools(cfg, PagePoolConfig(num_pages=32,
                                                        page_size=ps),
                                    torch.float32, device=dev)
            for s0, s1 in chunks:
                prefill[label], _, _ = model.prefill_paged(
                    toks[:, s0:s1], pools, state, tbl, start_pos=s0)
            logits[label], _, _ = model.decode_step_paged(
                pools, state, toks[:, 200:], pos, tbl)
        cache = expand.init_cache(1, 256)
        for s0, s1 in chunks:
            ls, _ = expand.prefill(toks[:, s0:s1], cache=cache, start_pos=s0)
        lsd, _ = expand.decode_step(cache, toks[:, 200:], pos)
    _check_parity(name, n_layers, cfg, [
        ("paged decode step, absorbed vs expanded", logits["absorb"],
         logits["expand"]),
        ("slab chunked prefill vs paged", ls, prefill["expand"]),
        ("slab decode step vs paged decode step", lsd, logits["expand"])])
    log(f"[parity] {name}: H {cfg.num_heads}, latent rank "
        f"{cfg.kv_lora_rank}, rope {cfg.qk_rope_dim}, layers "
        f"{cfg.block_pattern}, {time.time() - t0:.1f} s")
    del expand, absorb
    torch.cuda.empty_cache()


def parity_recurrent(name, n_layers):
    """A recurrent config at full width cut to ``n_layers`` layers, fp32,
    every recurrent state starting where the engines start it
    (``init_state_cache`` / ``init_cache``). With GQA layers among them
    (zamba2's shared_attn), the kernel path against the plain path: a
    200-token paged prefill, one paged decode step, and one slab decode
    step after a slab prefill in chunks of 128 + 72. Then, on the kernel
    path, a CHUNKED_PROMPT-token prompt prefilled in chunks of
    CHUNKED_CHUNK and CHUNKED_DECODE decode steps, paged and slab, each
    step's logits (and the prefill's last) against one whole prefill (no
    cache) of the same tokens: the chunked SSD and chunkwise mLSTM forms
    and the one-step recurrences across chunk edges at full width."""
    from repro_torch.configs.base import GQA_KINDS
    from repro_torch.models import Model
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    t0 = time.time()
    cfg = _cut(name, n_layers)
    kern = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda",
                      attn_kernel=True)
    plain = copy.copy(kern)          # the same weights, plain attention
    plain.attn_kernel = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    n = CHUNKED_PROMPT + CHUNKED_DECODE
    ps, P = 16, -(-n // 16)
    tbl = torch.arange(1, 1 + P, dtype=torch.int32, device=dev)[None]
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, n)), device=dev)

    def pools():
        return init_page_pools(cfg, PagePoolConfig(num_pages=P + 1,
                                                   page_size=ps),
                               torch.float32, device=dev)

    def at(p):
        return torch.tensor([p], dtype=torch.int32, device=dev)

    checks = []
    with torch.no_grad():
        if any(k in GQA_KINDS for k in cfg.block_pattern):
            got = {}
            for label, model in (("kernel", kern), ("plain", plain)):
                pl, st = pools(), model.init_state_cache(1)
                lp, _, _ = model.prefill_paged(toks[:, :200], pl, st, tbl,
                                               start_pos=0)
                ld, _, _ = model.decode_step_paged(pl, st, toks[:, 200:201],
                                                   at(200), tbl)
                cache = model.init_cache(1, 256)
                for s0, s1 in ((0, 128), (128, 200)):
                    model.prefill(toks[:, s0:s1], cache=cache, start_pos=s0)
                ls, _ = model.decode_step(cache, toks[:, 200:201], at(200))
                got[label] = (lp, ld, ls)
            checks += [(f"kernel vs plain path, {what}", k, p)
                       for what, k, p in zip(
                           ("paged prefill", "paged decode step",
                            "slab decode step"), got["kernel"],
                           got["plain"])]
        # one whole prefill (no cache) per position checked
        whole = torch.stack([kern.prefill(toks[:, :t + 1])[0][0]
                             for t in range(CHUNKED_PROMPT - 1, n)])
        chunks = [(s0, min(s0 + CHUNKED_CHUNK, CHUNKED_PROMPT))
                  for s0 in range(0, CHUNKED_PROMPT, CHUNKED_CHUNK)]
        for path in ("paged", "slab"):
            if path == "paged":
                pl, st = pools(), kern.init_state_cache(1)
                for s0, s1 in chunks:
                    last, _, _ = kern.prefill_paged(toks[:, s0:s1], pl, st,
                                                    tbl, start_pos=s0)
            else:
                cache = kern.init_cache(1, 1024)    # the engines' rows
                for s0, s1 in chunks:
                    last, _ = kern.prefill(toks[:, s0:s1], cache=cache,
                                           start_pos=s0)
            steps = [last[0]]
            for t in range(CHUNKED_PROMPT, n):
                if path == "paged":
                    lg, _, _ = kern.decode_step_paged(
                        pl, st, toks[:, t:t + 1], at(t), tbl)
                else:
                    lg, _ = kern.decode_step(cache, toks[:, t:t + 1], at(t))
                steps.append(lg[0])
            checks.append((
                f"{path}: chunks {[s1 - s0 for s0, s1 in chunks]} + "
                f"{len(steps) - 1} decode steps vs whole prefills "
                f"(positions {CHUNKED_PROMPT - 1}..{n - 1})",
                torch.stack(steps), whole))
    _check_parity(name, n_layers, cfg, checks)
    log(f"[parity] {name}: layers {cfg.block_pattern}, "
        f"{time.time() - t0:.1f} s")
    del kern, plain
    torch.cuda.empty_cache()


def parity_for(name, n_layers, flash=False):
    """The kernel path's logits against the plain path's on one config at
    full width cut to ``n_layers`` layers: a paged prefill, a paged decode
    step, a duet step at one row a tile (qwen3-4b) and at the async
    engine's tiles, and a slab decode step after a chunked slab prefill;
    with ``flash``, flash_prefill on gqa_prefill's q/K/V against
    gqa_prefill's own attention. An MoE config's duet checks run at
    capacity factor 64 (see below); its other checks at its own."""
    import dataclasses
    from repro_torch.kernels import build_duet_schedule
    from repro_torch.kernels.ops import duet_block_q
    from repro_torch.models import Model
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    t0 = time.time()
    cfg = _cut(name, n_layers)
    kern = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda",
                      attn_kernel=True)
    plain = copy.copy(kern)          # the same weights, plain attention
    plain.attn_kernel = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    ps, P = 16, 16
    pool = PagePoolConfig(num_pages=64, page_size=ps)

    def fresh():
        return init_page_pools(cfg, pool, torch.float32, device=dev)

    tblA = torch.arange(1, 1 + P, dtype=torch.int32, device=dev)[None]
    tblB = torch.arange(1 + P, 1 + 2 * P, dtype=torch.int32,
                        device=dev)[None]
    toksA = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 200)),
                         device=dev)
    toksB = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 64)),
                         device=dev)
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 1)), device=dev)
    pos = torch.tensor([200], dtype=torch.int32, device=dev)
    state = [None] * cfg.num_layers

    def prefilled():
        pools = fresh()
        plain.prefill_paged(toksA, pools, state, tblA, start_pos=0)
        return pools

    engine_bq = duet_block_q(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    # the duet step against the sequential decode + prefill pair: a duet
    # step routes its decode and chunk rows through the MoE together, the
    # pair apart, so the two agree only where the capacity drops nothing
    dkern, dplain, dnote = kern, plain, ""
    if cfg.is_moe:
        wide = dataclasses.replace(cfg, capacity_factor=64.0)
        dkern, dplain = copy.copy(kern), copy.copy(plain)
        dkern.cfg = dplain.cfg = wide
        dnote = " (MoE capacity factor 64)"
    own = {}                # an MoE's duet step and pair at its capacity
    with torch.no_grad():
        lpk, _, _ = kern.prefill_paged(toksA, fresh(), state, tblA,
                                       start_pos=0)
        lpp, _, _ = plain.prefill_paged(toksA, fresh(), state, tblA,
                                        start_pos=0)
        lk, _, _ = kern.decode_step_paged(prefilled(), state, tok, pos, tblA)
        lp, _, _ = plain.decode_step_paged(prefilled(), state, tok, pos,
                                           tblA)
        C = toksB.shape[1]
        row_tok = torch.cat([tok[:, 0], toksB[0]])[:, None]
        row_pos = torch.cat([pos, torch.arange(C, dtype=torch.int32,
                                               device=dev)])
        row_tbl = torch.cat([tblA, tblB.expand(C, P)])
        duet = {}
        # the reference's tiles (one row each; qwen3-4b) and the async
        # engine's
        for bq in sorted({engine_bq} | ({1} if flash else set())):
            sched = build_duet_schedule([(0, 200)],
                                        [(1, i) for i in range(C)],
                                        block_q=bq)
            order = torch.tensor(sched.row_src, device=dev)
            duet[bq], _, _ = dkern.duet_step_paged(
                prefilled(), state, row_tok, row_pos, row_tbl, order,
                block_q=bq)
            if cfg.is_moe:
                own["duet"], _, _ = kern.duet_step_paged(
                    prefilled(), state, row_tok, row_pos, row_tbl, order,
                    block_q=bq)
        seq_pools = prefilled()
        ls_dec, _, _ = dplain.decode_step_paged(seq_pools, state, tok, pos,
                                                tblA)
        ls_pre, _, _ = dplain.prefill_paged(toksB, seq_pools, state, tblB,
                                            start_pos=0)
        if cfg.is_moe:
            seq_pools = prefilled()
            own["dec"], _, _ = plain.decode_step_paged(seq_pools, state, tok,
                                                       pos, tblA)
            own["pre"], _, _ = plain.prefill_paged(toksB, seq_pools, state,
                                                   tblB, start_pos=0)
        # slab: two slots, 200-token prompts prefilled in chunks of 128 +
        # 72, then one decode step of both
        toks2 = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 201)),
                             device=dev)

        def slab_prefilled():
            cache = plain.init_cache(2, 256)
            for s0, s1 in ((0, 128), (128, 200)):
                plain.prefill(toks2[:, s0:s1], cache=cache, start_pos=s0)
            return cache
        tok2 = toks2[:, 200:]
        pos2 = torch.full((2,), 200, dtype=torch.int32, device=dev)
        lsk, _ = kern.decode_step(slab_prefilled(), tok2, pos2)
        lsp, _ = plain.decode_step(slab_prefilled(), tok2, pos2)
        checks = [("paged prefill", lpk, lpp), ("decode step", lk, lp)]
        for bq, ld in duet.items():
            checks += [(f"duet step bq={bq}, decode row{dnote}", ld[0],
                        ls_dec[0]),
                       (f"duet step bq={bq}, last chunk row{dnote}", ld[C],
                        ls_pre[0])]
        checks.append(("slab decode step", lsk, lsp))
        if flash:
            # flash_prefill's contract: on gqa_prefill's own q/K/V it gives
            # gqa_prefill's attention (the reference's tests/test_kernels.py)
            from repro_torch.kernels import flash_prefill
            from repro_torch.models import attention as attn_mod
            p0 = kern.params["layers"][0]["attn"]
            x = torch.from_numpy(rng.standard_normal(
                (1, 256, cfg.d_model), np.float32)).to(dev)
            positions = torch.arange(256, device=dev)[None]
            out_model, cache = attn_mod.gqa_prefill(p0, cfg, x, positions)
            q, _, _ = attn_mod._project_qkv(p0, cfg, x, positions)
            out_kernel = torch.einsum("bshe,hed->bsd", flash_prefill(
                q.contiguous(), cache.k.contiguous(), cache.v.contiguous()),
                p0["w_o"])
            checks.append(("flash_prefill on gqa_prefill's q/K/V "
                           "(attention output)", out_kernel, out_model))
    _check_parity(name, n_layers, cfg, checks)
    if cfg.is_moe:
        # not held: at the config's own capacity the two route other rows
        # together, so their drops differ (as in the reference)
        V = cfg.vocab_size
        for what, got, want in (("decode row", own["duet"][0], own["dec"][0]),
                                ("last chunk row", own["duet"][C],
                                 own["pre"][0])):
            log(f"[parity] {name}: duet step vs the sequential pair at "
                f"capacity factor {cfg.capacity_factor}, {what}: max abs "
                f"diff {(got[:V] - want[:V]).abs().max().item():.3e} "
                "(not held: the MoE routes other rows together)")
    log(f"[parity] {name}: H {cfg.num_heads} G {cfg.num_kv_heads} Dh "
        f"{cfg.head_dim}, duet tiles of {engine_bq} rows, "
        f"{time.time() - t0:.1f} s")
    del kern, plain
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: full-width serving through the engines
# ---------------------------------------------------------------------------
def serve_qps():
    """The served traces' arrival rate: SERVE_RHO / E[S], E[S] qwen3-4b's
    mean azure-conv request (``request_cost``) under the card's datasheet
    spec (``card_spec``) over its TPCs, at the engines' token budget and
    pages. The datasheet's spec and not the measured curve, so that every
    process of a TP or grid phase draws the same trace (the curve moves
    by a few percent between measurements); the measured curve prices
    the same request about 10% slower."""
    from repro_torch.configs import get_config
    from repro_torch.core.roofline import card_spec
    from repro_torch.serving.loadgen import (ServiceSpec, qps_for_rho,
                                             request_cost)
    from repro_torch.serving.traces import TRACES
    spec = card_spec(torch.cuda.get_device_properties(0))
    cost = request_cost(get_config("qwen3-4b"),
                        ServiceSpec(trace=TRACES["azure-conv"]), spec,
                        units=spec.num_units, token_budget=256,
                        page_size=16)
    return qps_for_rho(SERVE_RHO, cost)


def _requests(path, n=None, max_output=None):
    """The serve phase's azure-conv requests (8, serve_qps(), seed 0,
    clamped to max_len 1024). The qwen3-4b paged path's three runs serve those of at
    most PAGED_MAX_OUTPUT output tokens (4 of the 8), which halves their
    decode steps, its slab path all 8 with outputs cut to SLAB_MAX_OUTPUT
    tokens; a served config's runs take the first ``n`` with outputs cut
    to ``max_output`` tokens."""
    from repro_torch.launch.serve import _clamp_lengths
    from repro_torch.serving.traces import synth_trace
    reqs = _clamp_lengths(synth_trace("azure-conv", 8, serve_qps(), seed=0),
                          1024, True)
    if n is None and path == "paged":
        return [r for r in reqs if r.output_len <= PAGED_MAX_OUTPUT]
    if n is None:
        n, max_output = len(reqs), SLAB_MAX_OUTPUT
    reqs = reqs[:n]
    for r in reqs:
        r.output_len = min(r.output_len, max_output)
    return reqs


def _serve_run(label, cls, model, reqs, card, extra, graphs=None):
    """One engine run at max_slots 8, max_len 1024, token budget 256 (or
    what ``extra`` sets), with
    the kernels on and strict; every request must finish with tokens in the
    vocabulary, the async engine must keep host_syncs <= super_iterations,
    replay CUDA graphs (``graphs`` None: on, one device; False: every
    dispatch eager), account every dispatch as a replay, a capture or an
    eager dispatch of a named rule and, on the paged path, dispatch a
    fused duet step where the engine fuses them (GQA blocks) and none where
    it does not (MLA). Returns the greedy streams, the run's launches,
    tokens/s and, for the async engine, its DispatchStats, graph pool
    bytes and the kinds of the buckets it captured (_bucket_kind: kind ->
    buckets)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.serving import AsyncDuetEngine, EngineConfig
    cfg = model.cfg
    ec = EngineConfig(**{"max_slots": 8, "max_len": 1024,
                         "token_budget": 256, **extra}, strict_kernel=True)
    kw = {"graphs": graphs} if cls is AsyncDuetEngine else {}
    engine = cls(model, ec, seed=0, device="cuda", **kw)
    _hold_card_pricing(engine, label, card)
    before = launch_counts()
    engine.submit(reqs)
    torch.cuda.synchronize()
    t0 = time.time()
    metrics = engine.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    summ = metrics.summary()
    n_tok = sum(len(r.output_tokens) for r in metrics.requests)
    if summ["num_finished"] != len(reqs):
        raise AssertionError(f"[serve] {label}: "
                             f"{summ['num_finished']}/{len(reqs)} "
                             "requests finished")
    for r in metrics.requests:
        if len(r.output_tokens) != r.output_len or not all(
                0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(f"[serve] {label}: request "
                                 f"{r.rid} produced bad tokens")
    if engine.kernel_path != "cuda":
        raise AssertionError(f"[serve] {label}: kernel_path "
                             f"{engine.kernel_path}")
    out = {"streams": {r.rid: list(r.output_tokens)
                       for r in metrics.requests},
           "launches": launches, "tokens_per_s": n_tok / wall}
    line = (f"[serve] {label}: {len(reqs)} requests, {n_tok} tokens "
            f"in {wall:.2f} s wall = {n_tok / wall:.1f} tokens/s "
            f"measured on the card [{card}]; launches {launches}")
    if cls is AsyncDuetEngine:
        st = engine.dstats
        out["dstats"], out["pool_bytes"] = st, engine.graph_pool_bytes()
        out["captured"] = {}
        for key, prog in engine._programs.items():
            if prog.graph is not None:
                kind = _bucket_kind(key)
                out["captured"][kind] = out["captured"].get(kind, 0) + 1
        if not 0 < st.host_syncs <= st.super_iterations:
            raise AssertionError(
                f"[serve] {label}: host_syncs {st.host_syncs} > "
                f"super_iterations {st.super_iterations}")
        if engine.graphs != (graphs is not False) or (
                engine.graphs and st.replays == 0):
            raise AssertionError(f"[serve] {label}: graphs "
                                 f"{engine.graphs}, replays {st.replays}")
        if st.captures + st.replays + st.eager_dispatches != \
                st.dispatches or sum(st.eager_reasons.values()) != \
                st.eager_dispatches:
            raise AssertionError(f"[serve] {label}: dispatches unaccounted "
                                 f"for: {st}")
        line += (f"; super_iterations {st.super_iterations}, "
                 f"host_syncs {st.host_syncs}; dispatches {st.dispatches}: "
                 f"{st.captures} captures, {st.replays} replays, "
                 f"{st.eager_dispatches} eager {st.eager_reasons}; "
                 f"captured buckets by kind {out['captured']}; graph "
                 f"pool {out['pool_bytes'] / 1e6:.1f} MB")
        if ec.paged:
            duet = sum(1 for k in engine._programs if k[-1])
            launched = launches["duet_attention_paged"]
            if engine._duet_kernel and (duet == 0 or launched == 0):
                raise AssertionError(f"[serve] {label}: no duet "
                                     "dispatch")
            if not engine._duet_kernel and (duet or launched):
                raise AssertionError(f"[serve] {label}: a duet dispatch "
                                     "on a config the engine does not "
                                     "fuse")
            line += f", duet buckets {duet}"
    log(line)
    log(f"[serve] {label}: virtual-clock summary (the roofline's "
        f"prediction for {engine.mux.hw.name} over {engine.mux.total_units} "
        f"TPCs, not a measurement): mean TTFT {summ['mean_ttft_s']} s, mean "
        f"TBT {summ['mean_tbt_s']} s; duet iterations "
        f"{engine.mux.stats.duet_iterations} of "
        f"{engine.mux.stats.iterations}")
    del engine
    torch.cuda.empty_cache()
    return out


def _graphs_vs_eager(what, graphed, eager):
    """Hold a graphed async run to the same run with every dispatch
    eager: identical greedy streams and kernel launches."""
    same = graphed["streams"] == eager["streams"]
    log(f"[serve] {what}: graphs vs eager greedy streams identical "
        f"{same}, launch counts identical "
        f"{graphed['launches'] == eager['launches']}; tokens/s "
        f"{graphed['tokens_per_s']:.1f} with graphs, "
        f"{eager['tokens_per_s']:.1f} eager; {graphed['dstats'].captures} "
        f"captures, {graphed['dstats'].replays} replays, graph pool "
        f"{graphed['pool_bytes']} bytes")
    if not same or graphed["launches"] != eager["launches"]:
        raise AssertionError(f"[serve] {what}: the graphed run differs from "
                             "the eager one")


def _path_counts(path, counts, cfg, split_kv=False):
    """Read a path's launches (reset just before it), add them to
    ``counts`` and fail if a kernel of the path, of the role the config's
    rep takes (split-KV where ``split_kv``), never launched. A config
    with GQA layers among others (zamba2's shared_attn beside Mamba2)
    runs the decode kernels but no fused duet step, so its paths must not
    launch ``duet_attention_paged``; a config without GQA layers (MLA,
    xLSTM) runs no kernel, so its paths must launch none."""
    from repro_torch.configs.base import GQA_KINDS
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.ops import cta_role
    got = launch_counts()
    log(f"[serve] {path} path launches: {got}")
    gqa = any(k in GQA_KINDS for k in cfg.block_pattern)
    fused = _is_gqa(cfg)
    block = cta_role(cfg.num_heads // cfg.num_kv_heads) == "block"
    for name, n in got.items():
        counts[name] = counts.get(name, 0) + n
        needed = (gqa and PATH_OF.get(name) == path.split()[-1]
                  and (fused if name == "duet_attention_paged"
                       else name.endswith("[block]") == block)
                  and (split_kv or "splitkv" not in name))
        if needed and n <= 0:
            raise AssertionError(f"[serve] kernel {name} was never "
                                 f"launched on the {path} path")
        if n and (not gqa or (name == "duet_attention_paged"
                              and not fused)):
            raise AssertionError(f"[serve] kernel {name} launched {n} "
                                 f"times on the path {path}, which must "
                                 "not launch it")


def phase_serve():
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.serving import AsyncDuetEngine, DuetEngine
    cfg = get_config("qwen3-4b")
    t0 = time.time()
    model = Model.init(cfg, seed=0, dtype=torch.bfloat16, device="cuda",
                       attn_kernel=True)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, bf16 weights "
        f"{sum(b.numel() for b in model.buffers()) * 2 / 1e9:.2f} GB, "
        f"random from seed 0 in {time.time() - t0:.1f} s")
    card = card_line()
    log(f"[serve] azure-conv arrivals at qps {serve_qps():.4f}: load "
        f"{SERVE_RHO} of one replica as the card's datasheet prices it")
    paths = {
        "paged": [("async", AsyncDuetEngine, {}, None),
                  ("async eager", AsyncDuetEngine, {}, False),
                  ("sync", DuetEngine, {}, None),
                  ("async split_kv_threshold=256", AsyncDuetEngine,
                   {"split_kv_threshold": 256}, None)],
        "slab": [("slab sync", DuetEngine, {"paged": False}, None),
                 ("slab async", AsyncDuetEngine, {"paged": False}, None)],
    }
    outputs, runs, counts = {}, {}, {}
    for path, path_runs in paths.items():
        reset_launch_counts()        # this path's launches start here
        for label, cls, extra, graphs in path_runs:
            runs[label] = _serve_run(label, cls, model, _requests(path),
                                     card, extra, graphs)
            outputs[label] = runs[label]["streams"]
        # this path's launches end here
        _path_counts(path, counts, cfg, split_kv=path == "paged")
    if counts["flash_prefill"] != 0:
        raise AssertionError("[serve] flash_prefill launched "
                             f"{counts['flash_prefill']} times on a serving "
                             "path (the reference serves without it)")
    _graphs_vs_eager(f"{cfg.name} paged async, bf16", runs["async"],
                     runs["async eager"])
    for a_label, b_label in (("async", "sync"), ("slab async", "slab sync"),
                             ("slab sync", "sync")):
        a, b = outputs[a_label], outputs[b_label]
        a = {r: a[r] for r in b if r in a}     # the paged path serves fewer
        same = sum(a[r] == b[r] for r in a)
        first = {r: next((i for i, (x, y) in enumerate(zip(a[r], b[r]))
                          if x != y), None) for r in a}
        log(f"[serve] {a_label} vs {b_label} greedy streams identical for "
            f"{same}/{len(a)} requests (bf16; the kernels differ in "
            f"summation order); first differing token index per request: "
            f"{first}")
    for slab in (False, True):
        profile_decode(model, card, slab)
    profile_replay(model, card)
    profile_duet(model, card)
    for kind in BUCKET_KINDS:
        check_bucket_graphs(model, kind, card)
    del model
    torch.cuda.empty_cache()
    for name in SERVED_CONFIGS:
        serve_config(name, counts, card)
    if counts["flash_prefill"] != 0:
        raise AssertionError("[serve] flash_prefill launched on a served "
                             "config's path")
    serve_slot_reuse(card)
    return counts


def serve_slot_reuse(card):
    """Slot reuse on the card: zamba2 at full width cut to its first
    REUSE_LAYERS layers, fp32 with TF32 off, the sync engine on the paged
    path (kernels on, strict) at REUSE_SLOTS slots serves SERVE_REQUESTS
    requests of at most REUSE_MAX_OUTPUT output tokens, so later requests
    take slots that earlier ones left; each request's greedy stream must
    equal the same request served alone on a fresh engine of the same
    geometry (the chunk boundaries may differ between the two, which is
    why this runs in fp32). The engines reset a slot's recurrent state
    when a prefill starts at position 0; without it a request would start
    from its slot's last occupant's state. Launches here come after the
    main path's counts were read."""
    from repro_torch.models import Model
    from repro_torch.serving import DuetEngine, EngineConfig
    t0 = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _cut("zamba2-1.2b", REUSE_LAYERS)
    model = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda",
                       attn_kernel=True)
    ec = EngineConfig(max_slots=REUSE_SLOTS, max_len=1024, token_budget=256,
                      strict_kernel=True)

    def serve(reqs):
        engine = DuetEngine(model, ec, seed=0, device="cuda")
        _hold_card_pricing(engine, "slot reuse", card)
        engine.submit(reqs)
        metrics = engine.run()
        if metrics.summary()["num_finished"] != len(reqs):
            raise AssertionError("[serve] slot reuse: a request did not "
                                 "finish")
        return {r.rid: list(r.output_tokens) for r in metrics.requests}

    def reqs():
        return _requests("paged", SERVE_REQUESTS, REUSE_MAX_OUTPUT)

    together = serve(reqs())
    alone = {}
    for i in range(SERVE_REQUESTS):
        alone.update(serve(reqs()[i:i + 1]))
    first = {r: next((i for i, (x, y) in enumerate(zip(together[r],
                                                        alone[r]))
                      if x != y), None) for r in alone}
    log(f"[serve] slot reuse: zamba2 cut to {REUSE_LAYERS} layers "
        f"({cfg.block_pattern.count('shared_attn')} shared_attn), fp32, "
        f"sync paged, {SERVE_REQUESTS} requests on {REUSE_SLOTS} slots "
        f"(outputs {[len(t) for t in together.values()]}) against each "
        f"served alone: first differing token index per request {first} "
        f"[{card}], {time.time() - t0:.1f} s")
    if together != alone:
        raise AssertionError("[serve] slot reuse: a request's greedy stream "
                             "differs from the one it gives alone")
    del model
    torch.cuda.empty_cache()


def serve_config(name, counts, card):
    """One served config at full depth, bf16, random weights from seed 0
    (``Model.init`` draws each leaf on the card, in fp32, and casts it
    before the next, so the peak stays near the weights' own bytes), alone
    on the card: a paged run through the async engine (the fused duet
    kernel on for GQA configs) and a slab run through the async engine
    (and each through the sync engine too for BOTH_ENGINES),
    each path's launch counts reset just before it and read just after,
    SERVE_REQUESTS requests of at most SERVE_MAX_OUTPUT output tokens; the
    peak allocated memory after both runs; an MoE config with GQA blocks
    (granite-moe) and the recurrent configs then profile one paged decode
    step. A recurrent config also prints its per-slot state bytes."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RECURRENT_KINDS
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.ops import duet_block_q
    from repro_torch.models import Model
    from repro_torch.serving import AsyncDuetEngine, DuetEngine
    cfg = get_config(name)
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    model = Model.init(cfg, seed=0, dtype=torch.bfloat16, device="cuda",
                       attn_kernel=True)
    torch.cuda.synchronize()
    nbytes = sum(b.numel() * b.element_size() for b in model.buffers())
    gqa = _is_gqa(cfg)
    recurrent = [k for k in cfg.block_pattern if k in RECURRENT_KINDS]
    if gqa:
        bq = duet_block_q(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        heads = (f"G {cfg.num_kv_heads} Dh {cfg.head_dim}, duet tiles of "
                 f"{bq} rows")
    elif cfg.kv_lora_rank:
        heads = (f"MLA latent rank {cfg.kv_lora_rank} + rope "
                 f"{cfg.qk_rope_dim}, no duet kernel")
    else:
        state = sum(t.numel() * t.element_size()
                    for c in model.init_state_cache(1) if c is not None
                    for t in c)
        kinds = {k: cfg.block_pattern.count(k)
                 for k in dict.fromkeys(cfg.block_pattern)}
        heads = (f"G {cfg.num_kv_heads} Dh {cfg.head_dim}; layers {kinds}"
                 f" (SSM heads {cfg.ssm_heads} x {cfg.ssm_head_dim}, state "
                 f"{cfg.ssm_state})" if "mamba2" in kinds else
                 f"G {cfg.num_kv_heads}; layers {kinds}")
        heads += (f"; recurrent state {state} bytes a slot ({state / 1e6:.2f}"
                  f" MB over {len(recurrent)} layers, "
                  f"{8 * state / 1e6:.1f} MB for 8 slots); no duet kernel")
    moe = (f"; MoE {cfg.num_experts} experts top-{cfg.moe_top_k} width "
           f"{cfg.moe_d_ff}, {cfg.num_shared_experts} shared"
           if cfg.is_moe else "")
    log(f"[serve] {name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"H {cfg.num_heads} {heads}{moe}; bf16 weights {nbytes / 1e9:.3f} "
        f"GB on the card ({nbytes} bytes), random from seed 0 in "
        f"{time.time() - t0:.1f} s, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
    engines = [("async", AsyncDuetEngine)]
    if name in BOTH_ENGINES:
        engines.append(("sync", DuetEngine))
    for path, extra in (("paged", {}), ("slab", {"paged": False})):
        reset_launch_counts()        # this path's launches start here
        for ename, cls in engines:
            label = f"{name} {'slab ' if extra else ''}{ename}"
            _serve_run(label, cls, model,
                       _requests(path, SERVE_REQUESTS, SERVE_MAX_OUTPUT),
                       card, extra)
        _path_counts(f"{name} {path}", counts, cfg)
    log(f"[serve] {name}: peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB over the weights "
        f"and both runs (max_slots 8, max_len 1024) [{card}]")
    if (cfg.is_moe and gqa) or recurrent:
        profile_decode(model, card, slab=False, top=14)
    del model
    torch.cuda.empty_cache()


def profile_decode(model, card, slab: bool, top: int = 8):
    """Where one full-width decode step's time goes: 8 slots at 1000 tokens
    of context through the kernel path (paged pool, or slab cache with the
    engine's 1024-token rows), timed on the host clock without the
    profiler, then traced with torch.profiler for the device time by
    kernel. Device busy share = summed kernel time / wall time. A config
    with recurrent layers also lists the top aten ops by device time and
    profiles the step again without the inactive-slot freeze (no
    ``active_mask``: no ``where`` over the recurrent state), to read what
    the freeze costs. Launches made here come after the main path's counts
    were read."""
    from repro_torch.core.lookahead import lookahead_decode
    from repro_torch.models.transformer import RECURRENT
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    cfg, B, P, ps, steps = model.cfg, 8, 64, 16, 4
    pos = torch.full((B,), 1000, dtype=torch.int32, device="cuda")
    tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    if slab:
        cache = model.init_cache(B, 1024)
        active = torch.ones((B,), dtype=torch.bool, device="cuda")

        def step():   # the engine's slab step: decode + inactive freeze
            lookahead_decode(model, cache, tok, pos, 1, active_mask=active)
    else:
        pools = init_page_pools(cfg, PagePoolConfig(num_pages=B * P + 1,
                                                    page_size=ps),
                                torch.bfloat16, device="cuda")
        tables = torch.arange(1, B * P + 1, dtype=torch.int32,
                              device="cuda").reshape(B, P)
        state = model.init_state_cache(B)
        active = torch.ones((B,), dtype=torch.bool, device="cuda")

        def step(mask=active):   # the engine's paged step: decode + freeze
            model.decode_step_paged(pools, state, tok, pos, tables,
                                    active_mask=mask)

    def run(**kw):
        for _ in range(steps):
            step(**kw)
        torch.cuda.synchronize()

    what = (f"{cfg.name} {'slab' if slab else 'paged'} decode step, "
            f"{cfg.num_layers} layers, B={B}, ctx 1000, bf16")
    wall, events, ops = _profile(run, steps)
    log_profile(what, wall, events, steps, card, top=top)
    if slab or not any(k in RECURRENT for k in cfg.block_pattern):
        return
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / steps / 1e3:8.3f} "
            f"ms/step  {e.count // steps:5d} calls/step  {e.key} (aten op)")
    wall0, events0, _ = _profile(lambda: run(mask=None), steps)
    dev = sum(e.self_device_time_total for e in events) / steps / 1e3
    dev0 = sum(e.self_device_time_total for e in events0) / steps / 1e3
    log(f"[profile] {what}: the inactive-slot freeze of the recurrent "
        f"state (its torch.where) adds {dev - dev0:.3f} ms of device time a "
        f"step ({dev:.3f} with it, {dev0:.3f} without) and "
        f"{wall - wall0:.2f} ms of wall ({wall:.2f} / {wall0:.2f}) "
        f"[{card}]")


def profile_replay(model, card, steps: int = 4):
    """One decode-only super-iteration (kb 1: a decode step of 8 slots at
    1000 tokens of context, the engine's paged program with its static
    inputs) run eagerly and replayed from its CUDA graph: wall ms on the
    host clock, device kernel ms (torch.profiler) and busy share of each,
    the replay's device ms from CUDA events, and the host's runtime calls
    a super-iteration: a replay must make one graph launch and no kernel
    launch of its own (its outputs' copies are memcpys), and its trace
    must hold each of the port's kernels as often as the capture counted
    (_hold_trace)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.lookahead import (BucketProgram, graph_pool_bytes,
                                            make_superiter_fn)
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    cfg, B, P, ps, dev = model.cfg, 8, 64, 16, "cuda"
    bucket = BucketProgram(make_superiter_fn(model, 1, paged=True),
                           torch.device(dev), B, width=P)
    bucket.feed(np.ones(B, bool), np.arange(1, B * P + 1).reshape(B, P))
    pools = init_page_pools(cfg, PagePoolConfig(num_pages=B * P + 1,
                                                page_size=ps),
                            torch.bfloat16, device=dev)
    state = model.init_state_cache(B)
    last_tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    pos = torch.full((B,), 1000, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    args = (pools, state, last_tok, pos, bucket.tables, gen, bucket.active,
            None, None, bucket.pre_start, bucket.pre_slot,
            bucket.override_tok)
    bucket.run(*args)
    pool = torch.cuda.graph_pool_handle()
    t0 = time.time()
    bucket.capture(args, pool)
    torch.cuda.synchronize()
    capture_ms = (time.time() - t0) * 1e3
    pool_bytes = graph_pool_bytes(pool)
    what = (f"{cfg.name} decode-only super-iteration, kb 1, "
            f"{cfg.num_layers} layers, B={B}, ctx 1000, bf16")
    for mode, call in (("eager", lambda: bucket.run(*args)),
                       ("replayed", bucket.replay)):
        def run():
            pos.fill_(1000)          # every run decodes at the same depth
            for _ in range(steps):
                call()
            torch.cuda.synchronize()
        run()
        t0 = time.time()
        run()
        wall = (time.time() - t0) / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        cuda = torch.autograd.DeviceType.CUDA
        ev = prof.key_averages()
        kernels = [e for e in ev if e.device_type == cuda]
        host = {e.key: e.count for e in ev if e.device_type != cuda
                and e.key.startswith(("cuda", "cu"))}
        graph = sum(n for k, n in host.items() if "GraphLaunch" in k)
        launch = sum(n for k, n in host.items() if "LaunchKernel" in k)
        log_profile(f"{what}, {mode}", wall, kernels, steps, card,
                    f"; host runtime calls a super-iteration: "
                    f"{graph / steps:g} graph launches, {launch / steps:g} "
                    f"kernel launches ({ {k: n / steps for k, n in host.items()} })",
                    top=4)
        if mode == "replayed":
            # the one pos.fill_ a run is the only kernel the host launches
            if graph != steps or launch > 1:
                raise AssertionError(f"[profile] {what}: a replay made "
                                     f"{graph / steps:g} graph and "
                                     f"{launch / steps:g} kernel launches")
            _hold_trace(what, bucket.launches, kernels, steps, card)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    pos.fill_(1000)
    start.record()
    for _ in range(steps):
        bucket.graph.replay()
    end.record()
    end.synchronize()
    log(f"[profile] {what}: replay {start.elapsed_time(end) / steps:.3f} ms "
        f"on the device (CUDA events, back to back); capture "
        f"{capture_ms:.1f} ms with its device sync; graph pool "
        f"{pool_bytes} bytes [{card}]")
    del bucket, pools


def log_profile(what, wall, events, steps, card, extra="", top=8):
    """Print a profiled step: wall ms, device kernel ms and busy share, the
    kernels (and copies) launched a step, and the ``top`` kernels with the
    most device time."""
    dev = sum(e.self_device_time_total for e in events) / steps / 1e3
    launched = sum(e.count for e in events) // steps
    busy = (f"{dev:.2f} ms/step (torch.profiler); device busy "
            f"{100 * dev / wall:.1f}%; {launched} kernels a step" if dev > 0
            else "not measured (the profiler recorded no device time)")
    log(f"[profile] {what}: wall {wall:.2f} ms/step (host clock, no "
        f"profiler); device kernel time {busy}{extra} [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / steps / 1e3:8.3f} "
            f"ms/step  {e.count // steps:5d} calls/step  {e.key[:70]}")


def _profile(run, steps, trace=True):
    """(wall ms per step on the host clock without the profiler, device
    kernel events of a traced run, the run's aten ops that launched
    device work) of ``run``, which does ``steps`` steps and
    synchronises. With ``trace`` False it makes the same calls of ``run``
    untraced and returns None: a TP rank that does not profile keeps its
    collectives in step with the rank that does."""
    from torch.profiler import ProfilerActivity, profile
    run()
    t0 = time.time()
    run()
    wall = (time.time() - t0) / steps * 1e3
    if not trace:
        run()
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    return wall, [e for e in averages if e.device_type == cuda], [
        e for e in averages if e.device_type != cuda
        and e.key.startswith("aten::") and e.self_device_time_total > 0]


def profile_duet(model, card):
    """Where one fused duet super-iteration's time goes: the async engine's
    program for kb = 1 and a 256-row chunk (8 decode slots at 1000 tokens
    of context, the chunk at positions 512..767 of a ninth request; bf16,
    the engine's tiles of 64 // rep rows), timed on the host clock without
    the profiler, then traced for the device time by kernel and the duet
    kernel's share."""
    from repro_torch.core.lookahead import make_superiter_fn
    from repro_torch.kernels.ops import build_duet_schedule, duet_block_q
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    cfg, B, P, ps, chunk, steps = model.cfg, 8, 64, 16, 256, 4
    dev = "cuda"
    bq = duet_block_q(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    prog = make_superiter_fn(model, 1, paged=True, chunk=chunk,
                             duet_kernel=True, duet_block_q=bq)
    pools = init_page_pools(cfg, PagePoolConfig(num_pages=(B + 1) * P + 1,
                                                page_size=ps),
                            torch.bfloat16, device=dev)
    tables = torch.arange(1, B * P + 1, dtype=torch.int32,
                          device=dev).reshape(B, P)
    pre_tbl = torch.arange(B * P + 1, (B + 1) * P + 1, dtype=torch.int32,
                           device=dev)[None]
    sched = build_duet_schedule([(b, 0) for b in range(B)],
                                [(B, i) for i in range(chunk)], block_q=bq)
    order = torch.tensor(sched.row_src, dtype=torch.int32, device=dev)
    last_tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    pos = torch.full((B,), 1000, dtype=torch.int32, device=dev)
    pre_toks = torch.zeros((1, chunk), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = model.init_state_cache(B)

    # the chunk's start, slot and resume token, as the engine passes them
    scalars = torch.tensor([512, 0, 0], dtype=torch.int32,
                           device=dev).unbind(0)

    def run():
        for _ in range(steps):
            prog(pools, state, last_tok, pos, tables, gen, active, pre_toks,
                 pre_tbl, *scalars, order)
        torch.cuda.synchronize()

    wall, events, _ = _profile(run, steps)
    duet = [e for e in events if "duet_attention_paged" in e.key]
    duet_ms = sum(e.self_device_time_total for e in duet) / steps / 1e3
    calls = sum(e.count for e in duet) // steps
    log_profile(f"duet super-iteration, {cfg.num_layers} layers, B={B} at "
                f"ctx 1000 + a {chunk}-row chunk at 512, kb=1, bq={bq}, "
                f"bf16", wall, events, steps, card,
                f"; duet_attention_paged {duet_ms:.3f} ms/step over {calls} "
                f"calls ({duet_ms / max(calls, 1):.4f} ms a call)")


# ---------------------------------------------------------------------------
# phase 6: tensor parallelism, two ranks on the one card over gloo
# ---------------------------------------------------------------------------
TP = 2
TP_PARITY_LAYERS = 4
# the TP serve runs' outputs are cut to this many tokens: gloo's host
# round trips on one card make a TP step about 4x a TP 1 step's wall (32
# keeps the whole script inside its time limit on a slow host)
TP_MAX_OUTPUT = 32
# (d): every other block kind and both frontends at full width, the depth
# cut to this many layers (zamba2's 12 hold its 2 shared_attn blocks)
TP_BLOCK_LAYERS = {"deepseek-v2-lite-16b": 4, "granite-moe-3b-a800m": 4,
                   "zamba2-1.2b": 12, "xlstm-350m": 4, "paligemma-3b": 4,
                   "musicgen-medium": 4}
# (e): the sharded decode at these configs' rank shards too
TP_SHARD_CONFIGS = ("granite-moe-3b-a800m", "zamba2-1.2b")
# (f): full width and depth at TP 2, 4 requests of at most 16 tokens
TP_SERVED = ("deepseek-v2-lite-16b", "zamba2-1.2b")
TP_SERVE_REQUESTS, TP_SERVE_MAX_OUTPUT = 4, 16


def phase_tp():
    """Spawn the TP ranks (the kernels are built first, here, so the ranks
    do not build them twice), then check and print what they return.
    Returns (the bf16 S = 1 record of paged_decode_sharded on rank 0, the
    TP path's launch counts on rank 0)."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_ranks
    _build.build_all()
    torch.cuda.empty_cache()
    card = card_line()
    log(f"[tp] {TP} ranks, one process each, on cuda:0 over gloo "
        "(share_card): every all_reduce copies its CUDA tensor through host "
        "memory and blocks the host; NCCL refuses two ranks of one "
        "communicator on one card. The TP step is slower than TP 1 by "
        f"construction here; no TP speed is claimed [{card}]")
    t0 = time.time()
    ranks = run_ranks(tp_rank, TP, device="cuda", share_card=True,
                      args=(card,))
    log(f"[tp] {TP} ranks done in {time.time() - t0:.1f} s")
    r0 = ranks[0]
    # (a) the sharded route on each rank's shard
    for r, res in enumerate(ranks):
        for rec in res["kernels"]:
            log(f"[tp] rank {r} {rec['name']} {rec['dtype']:15s} "
                f"{rec['case']:56s} max_abs_err={rec['max_abs_err']:.3e} "
                f"tol={rec['tol']:.0e}/{rec['rtol']:.0e}"
                + ("" if "ms" not in rec else
                   f" ms={rec['ms']:.4f} cold_ms={rec['cold_ms']:.4f} "
                   f"plain_ms={rec['plain_ms']:.4f} "
                   f"library_ms={rec['library_ms']:.4f} "
                   f"bound_ms={rec['bound_ms']:.3g} ({rec['bound_by']}, "
                   f"{rec['bound_ms'] / rec['cold_ms']:.1%} of cold_ms) "
                   f"[{card}]"))
    # (b) parity: TP 2 against TP 1, and rank against rank
    cfg = _cut("qwen3-4b", TP_PARITY_LAYERS)
    for what, want in r0["tp1_logits"].items():
        got = r0["logits"][what]
        if not np.array_equal(got, ranks[1]["logits"][what]):
            raise AssertionError(f"[tp] {what}: the ranks' logits differ")
        _check_parity(f"qwen3-4b TP {TP} vs TP 1", TP_PARITY_LAYERS, cfg,
                      [(what + " (both ranks bitwise equal)",
                        torch.from_numpy(got), torch.from_numpy(want))])
    # (c) serving
    for label in ("async", "sync"):
        a, b = (res["serve"][label] for res in ranks)
        if a["streams"] != b["streams"]:
            raise AssertionError(f"[tp] serve {label}: the ranks' token "
                                 "streams differ")
        log(f"[tp] serve {label}: {a['line']}; both ranks' streams equal "
            f"[{card}]")
    log(f"[tp] TP path launches (rank 0): {r0['counts']}; rank 1: "
        f"{ranks[1]['counts']}")
    log(f"[tp] {r0['profile']}")
    for line in r0["profile_top"]:
        log(f"[tp]   {line}")
    # (d) every other block kind and both frontends: TP 2 against TP 1
    for name, n_layers in TP_BLOCK_LAYERS.items():
        a, b = (res["blocks"][name] for res in ranks)
        cfg = _cut(name, n_layers)
        for what, want in a["tp1"].items():
            if not np.array_equal(a["logits"][what], b["logits"][what]):
                raise AssertionError(f"[tp] {name} {what}: the ranks' "
                                     "logits differ")
            _check_parity(f"{name} TP {TP} vs TP 1", n_layers, cfg,
                          [(what + " (both ranks bitwise equal)",
                            torch.from_numpy(a["logits"][what]),
                            torch.from_numpy(want))])
        log(f"[tp] {name} ({n_layers} layers): {a['line']}")
    # (f) full width and depth
    for name in TP_SERVED:
        a, b = (res["served"][name] for res in ranks)
        if a["streams"] != b["streams"]:
            raise AssertionError(f"[tp] serve {name}: the ranks' token "
                                 "streams differ")
        log(f"[tp] serve {name}: rank 0 {a['line']}; rank 1 peak "
            f"{b['peak_gb']:.2f} GB; both ranks' streams equal [{card}]")
        log(f"[tp] {a['profile']}")
        for line in a["profile_top"]:
            log(f"[tp]   {line}")
        for k, n in a["counts"].items():
            r0["counts"][k] = r0["counts"].get(k, 0) + n
    main = next(rec for rec in r0["kernels"] if rec.get("main"))
    return main, r0["counts"]


def tp_rank(rank, card):
    """One rank of the tp phase (a spawned process; see phase_tp)."""
    import torch.distributed as dist
    res = {"kernels": tp_kernels(rank)}
    dist.barrier()
    res.update(tp_parity(rank))
    dist.barrier()
    res.update(tp_serve(rank))
    dist.barrier()
    res["blocks"] = {name: tp_block_parity(rank, name, n)
                     for name, n in TP_BLOCK_LAYERS.items()}
    dist.barrier()
    res["served"] = {name: tp_block_serve(rank, name, card)
                     for name in TP_SERVED}
    return res


def tp_kernels(rank):
    """paged_decode_sharded on this rank's TP shard of qwen3-4b (S = 1
    and 8) and of each TP_SHARD_CONFIGS config (S = 1) against the plain
    paged decode over the full heads, sliced; rank 0 times each case
    while the other ranks wait."""
    records = tp_kernels_at(rank, "qwen3-4b", (1, 8))
    for name in TP_SHARD_CONFIGS:
        records += tp_kernels_at(rank, name, (1,))
    return records


def tp_kernels_at(rank, name, splits):
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import paged_decode_sharded
    from repro_torch.kernels.paged_decode import (paged_decode_plain,
                                                  paged_decode_splitkv_plain)
    cfg = get_config(name)
    ctx = rank.context(cfg)
    B, H, G, Dh, ps, P = 8, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim, 16, 128
    Hl, Gl = H // TP, G // TP
    heads = slice(rank.rank * Hl, (rank.rank + 1) * Hl)
    kvh = slice(rank.rank * Gl, (rank.rank + 1) * Gl)
    lens = np.linspace(256, 2048, B).astype(np.int64)
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        for S in splits:
            rng = np.random.default_rng(0)      # the same on every rank
            q, kp, vp, tables, ln = _decode_inputs(
                rng, B, H, G, Dh, B * P + 1 + 64, ps, P, dtype, lens,
                distinct=True)
            want = paged_decode_plain(q, kp, vp, tables, ln)[:, heads]
            q, kp, vp = (q[:, heads].contiguous(),
                         kp[:, :, kvh].contiguous(),
                         vp[:, :, kvh].contiguous())
            kernel = lambda: paged_decode_sharded(  # noqa: E731
                q, kp, vp, tables, ln, ctx=ctx, num_splits=S)
            if S == 1:
                plain = lambda: paged_decode_plain(  # noqa: E731
                    q, kp, vp, tables, ln)
            else:
                plain = lambda: paged_decode_splitkv_plain(  # noqa: E731
                    q, kp, vp, tables, ln, num_splits=S)
            label = (f"TP {TP} rank {rank.rank}: {name} B=8 {Hl}/{Gl}/{Dh}"
                     f" ctx 256-2048 S={S}")
            rec = {"name": "paged_decode_sharded", "case": label,
                   "dtype": str(dtype),
                   "main": (S == 1 and dtype == torch.bfloat16
                            and name == "qwen3-4b")}
            got = kernel()
            torch.cuda.synchronize()
            _check("paged_decode_sharded", got, want, dtype, label, rec,
                   ATTN_BF16_TOL if dtype == torch.bfloat16 else None)
            if rank.rank == 0:
                elt = q.element_size()
                live = int(ln.long().sum().item())
                nbytes = (2 * q.numel() * elt + tables.numel() * 4 + B * 4
                          + 2 * live * Gl * Dh * elt)
                rec["bound_ms"], rec["bound_by"] = _bound(
                    nbytes, 4.0 * live * Hl * Dh, dtype)
                _time_kernel(kernel, rec)
                rec["plain_ms"] = time_ms(plain, iters=5)
                rec["library_ms"] = time_ms(_sdpa_decode(q, kp, vp, tables,
                                                         ln))
            records.append(rec)
            dist.barrier()
    return records


def _tp_step_logits(model):
    """A 200-token paged prefill, one paged decode step and one duet step
    at the async engine's tiles (the decode row beside a 64-row chunk), on
    ``model``'s context (pools of its KV heads); fp32 logits on the host:
    the prefill's, the decode row's and the chunk's last row's."""
    from repro_torch.kernels import build_duet_schedule
    from repro_torch.kernels.ops import duet_block_q
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    cfg, dev, ps, P = model.cfg, model.device, 16, 16
    pool = PagePoolConfig(num_pages=2 * P + 1, page_size=ps)
    rng = np.random.default_rng(5)
    toksA = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 200)),
                         device=dev)
    toksB = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 64)),
                         device=dev)
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 1)), device=dev)
    tblA = torch.arange(1, 1 + P, dtype=torch.int32, device=dev)[None]
    tblB = torch.arange(1 + P, 1 + 2 * P, dtype=torch.int32,
                        device=dev)[None]
    pos = torch.tensor([200], dtype=torch.int32, device=dev)
    state = [None] * cfg.num_layers

    def fresh():
        return init_page_pools(cfg, pool, torch.float32, device=dev,
                               kv_heads=model.ctx.local_kv_heads)

    def prefilled():
        pools = fresh()
        model.prefill_paged(toksA, pools, state, tblA, start_pos=0)
        return pools

    C = toksB.shape[1]
    bq = duet_block_q(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    sched = build_duet_schedule([(0, 200)], [(1, i) for i in range(C)],
                                block_q=bq)
    with torch.no_grad():
        pre = model.prefill_paged(toksA, fresh(), state, tblA,
                                  start_pos=0)[0]
        dec = model.decode_step_paged(prefilled(), state, tok, pos, tblA)[0]
        duet = model.duet_step_paged(
            prefilled(), state, torch.cat([tok[:, 0], toksB[0]])[:, None],
            torch.cat([pos, torch.arange(C, dtype=torch.int32,
                                         device=dev)]),
            torch.cat([tblA, tblB.expand(C, P)]),
            torch.tensor(sched.row_src, device=dev), block_q=bq)[0]
    # numpy: a rank's results cross to the parent by value
    return {"paged prefill": pre.cpu().numpy(),
            "decode step": dec.cpu().numpy(),
            f"duet step bq={bq}, decode row": duet[:1].cpu().numpy(),
            f"duet step bq={bq}, last chunk row":
                duet[C:C + 1].cpu().numpy()}


def tp_parity(rank):
    """The TP kernel path's logits at full width cut to
    TP_PARITY_LAYERS layers, fp32 with TF32 off; rank 0 also computes TP
    1's (the same draws from seed 0) while the other ranks wait."""
    import torch.distributed as dist
    from repro_torch.models import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _cut("qwen3-4b", TP_PARITY_LAYERS)
    model = Model.init(cfg, seed=0, dtype=torch.float32,
                       ctx=rank.context(cfg), attn_kernel=True)
    out = {"logits": _tp_step_logits(model)}
    del model
    torch.cuda.empty_cache()
    if rank.rank == 0:
        one = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda",
                         attn_kernel=True)
        out["tp1_logits"] = _tp_step_logits(one)
        del one
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def tp_serve(rank):
    """Full qwen3-4b at TP (36 layers, bf16, kernels on, strict): the
    paged path's requests through the async and then the sync engine, the
    launch counts reset just before and read just after; then one decode
    step profiled on rank 0 (every rank runs it)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.serving import AsyncDuetEngine, DuetEngine, \
        EngineConfig
    cfg = get_config("qwen3-4b")
    ctx = rank.context(cfg)
    model = Model.init(cfg, seed=0, dtype=torch.bfloat16, ctx=ctx,
                       attn_kernel=True)
    torch.cuda.synchronize()
    gb = sum(b.numel() for b in model.buffers()) * 2 / 1e9
    serve = {}
    reset_launch_counts()        # the TP path's launches start here
    for label, cls in (("async", AsyncDuetEngine), ("sync", DuetEngine)):
        reqs = _requests("paged")
        for r in reqs:
            r.output_len = min(r.output_len, TP_MAX_OUTPUT)
        eng = cls(model, EngineConfig(max_slots=8, max_len=1024,
                                      token_budget=256, strict_kernel=True),
                  seed=0, device=ctx.device)
        if eng.kernel_path != "cuda_sharded":
            raise AssertionError(f"[tp] {label}: kernel_path "
                                 f"{eng.kernel_path}")
        eng.submit(reqs)
        reduces = ctx.all_reduces
        torch.cuda.synchronize()
        t0 = time.time()
        metrics = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        summ = metrics.summary()
        n_tok = sum(len(r.output_tokens) for r in metrics.requests)
        if summ["num_finished"] != len(reqs) or any(
                len(r.output_tokens) != r.output_len
                for r in metrics.requests):
            raise AssertionError(f"[tp] {label}: {summ['num_finished']}/"
                                 f"{len(reqs)} requests finished")
        line = (f"rank {rank.rank}, {len(reqs)} requests, {n_tok} tokens in "
                f"{wall:.2f} s wall = {n_tok / wall:.1f} tokens/s at TP "
                f"{TP} over gloo on one card ({gb:.2f} GB of bf16 weights a "
                f"rank); {ctx.all_reduces - reduces} all-reduces")
        if cls is AsyncDuetEngine:
            st = eng.dstats
            duet = sum(1 for k in eng._programs if k[-1])
            if not 0 < st.host_syncs <= st.super_iterations:
                raise AssertionError(f"[tp] {label}: host_syncs "
                                     f"{st.host_syncs} > super_iterations "
                                     f"{st.super_iterations}")
            if duet == 0:
                raise AssertionError(f"[tp] {label}: no duet dispatch")
            line += (f"; super_iterations {st.super_iterations}, engine "
                     f"host_syncs {st.host_syncs} (gloo's waits, one an "
                     "all-reduce, are apart), duet buckets "
                     f"{duet}")
        serve[label] = {"line": line, "streams": {
            r.rid: list(r.output_tokens) for r in metrics.requests}}
        del eng
        torch.cuda.empty_cache()
    counts = launch_counts()     # the TP path's launches end here
    inner = sum(n for k, n in counts.items()
                if k.startswith("paged_decode") and k != "paged_decode_sharded")
    if not 0 < counts["paged_decode_sharded"] == inner:
        raise AssertionError(f"[tp] paged_decode_sharded launched "
                             f"{counts['paged_decode_sharded']} times, the "
                             f"inner decode kernels {inner}")
    if counts["duet_attention_paged"] <= 0:
        raise AssertionError("[tp] duet_attention_paged never launched")
    out = {"serve": serve, "counts": counts}
    out.update(tp_profile(rank, model, ctx))
    return out


def tp_profile(rank, model, ctx):
    """One full-width TP decode step (B=8 at 1000 tokens of context, bf16,
    kernel path): wall on the host clock, device time and busy share from
    torch.profiler on rank 0 (where gloo's host copies show among the top
    ops), and the all-reduces one step makes."""
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    cfg, B, P, ps, steps = model.cfg, 8, 64, 16, 4
    pools = init_page_pools(cfg, PagePoolConfig(num_pages=B * P + 1,
                                                page_size=ps),
                            torch.bfloat16, device=ctx.device,
                            kv_heads=ctx.local_kv_heads)
    tables = torch.arange(1, B * P + 1, dtype=torch.int32,
                          device=ctx.device).reshape(B, P)
    state = model.init_state_cache(B)
    pos = torch.full((B,), 1000, dtype=torch.int32, device=ctx.device)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=ctx.device)
    active = torch.ones((B,), dtype=torch.bool, device=ctx.device)

    def run():
        for _ in range(steps):
            model.decode_step_paged(pools, state, tok, pos, tables,
                                    active_mask=active)
        torch.cuda.synchronize()

    before = ctx.all_reduces
    run()
    per_step = (ctx.all_reduces - before) // steps
    if rank.rank != 0:
        _profile(run, steps, trace=False)
        return {"all_reduces_per_step": per_step}
    wall, events, _ = _profile(run, steps)
    dev = sum(e.self_device_time_total for e in events) / steps / 1e3
    launched = sum(e.count for e in events) // steps
    busy = (f"{dev:.2f} ms/step (torch.profiler); device busy "
            f"{100 * dev / wall:.1f}%; {launched} kernels and copies a step"
            if dev > 0 else "not measured (no device time recorded)")
    top = [f"{e.self_device_time_total / steps / 1e3:8.3f} ms/step  "
           f"{e.count // steps:5d} calls/step  {e.key[:70]}"
           for e in sorted(events,
                           key=lambda e: -e.self_device_time_total)[:8]]
    return {"all_reduces_per_step": per_step, "profile": (
        f"{cfg.name} TP {TP} paged decode step on rank 0, "
        f"{cfg.num_layers} layers, B={B}, ctx 1000, bf16: wall {wall:.2f} "
        f"ms/step (host clock, no profiler); device time {busy}; "
        f"{per_step} all-reduces a step (collectives_per_iteration "
        f"{ctx.collectives_per_iteration()}, plus the vocab-parallel "
        "embedding's)"), "profile_top": top}


def _tp_block_logits(model):
    """The kernel path's logits of one config under ``model``'s context,
    fp32 on the host. Text: a 200-token paged prefill and one paged decode
    step (pools of the rank's KV heads, the rank's recurrent state).
    Frontends: a slab prefill of FRONTEND_PROMPT positions (after
    paligemma's 256 patch embeddings; musicgen's (1, 4, S) codebook grid)
    and one slab decode step. Also the all-reduces of one prefill."""
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    cfg, dev, ctx = model.cfg, model.device, model.ctx
    rng = np.random.default_rng(5)
    out = {}
    with torch.no_grad():
        if cfg.frontend is None:
            ps, P, S = 16, 16, 200
            toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, S)),
                                device=dev)
            tok = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 1)),
                               device=dev)
            pools = init_page_pools(
                cfg, PagePoolConfig(num_pages=P + 1, page_size=ps),
                torch.float32, device=dev, kv_heads=ctx.local_kv_heads)
            state = model.init_state_cache(1)
            tbl = torch.arange(1, P + 1, dtype=torch.int32, device=dev)[None]
            before = ctx.all_reduces
            out["paged prefill"] = model.prefill_paged(
                toks, pools, state, tbl, start_pos=0)[0]
            reduces = ctx.all_reduces - before
            out["paged decode"] = model.decode_step_paged(
                pools, state, tok, torch.tensor([S], dtype=torch.int32,
                                                device=dev), tbl)[0]
        else:
            S = FRONTEND_PROMPT
            audio = cfg.frontend == "audio"
            lead = (1, cfg.num_codebooks) if audio else (1,)
            toks = torch.tensor(rng.integers(0, cfg.vocab_size, lead + (S,)),
                                device=dev)
            tok = torch.tensor(rng.integers(0, cfg.vocab_size, lead + (1,)),
                               device=dev)
            kw, P = {}, 0
            if not audio:
                P = cfg.num_prefix_tokens
                kw["patch_embeds"] = torch.from_numpy(
                    0.02 * rng.standard_normal((1, P, cfg.d_model),
                                               np.float32)).to(dev)
            cache = model.init_cache(1, -(-(P + S + 1) // 128) * 128)
            before = ctx.all_reduces
            out["slab prefill"] = model.prefill(toks, cache=cache, **kw)[0]
            reduces = ctx.all_reduces - before
            out["slab decode"] = model.decode_step(
                cache, tok, torch.tensor([P + S], dtype=torch.int32,
                                         device=dev))[0]
    return {k: v.cpu().numpy() for k, v in out.items()}, reduces


def tp_block_parity(rank, name, n_layers):
    """(d) One config at full width cut to ``n_layers`` layers, fp32, TF32
    off, at TP 2 (this rank) and, on rank 0 after the TP model is freed,
    at TP 1 from the same draws while the other ranks wait."""
    import torch.distributed as dist
    from repro_torch.models import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    cfg = _cut(name, n_layers)
    ctx = rank.context(cfg)
    model = Model.init(cfg, seed=0, dtype=torch.float32, ctx=ctx,
                       attn_kernel=True)
    logits, reduces = _tp_block_logits(model)
    want = ctx.collectives_per_iteration() + 1
    if reduces != want:
        raise AssertionError(f"[tp] {name}: {reduces} all-reduces in a "
                             f"prefill, collectives_per_iteration + 1 = "
                             f"{want}")
    cut = [a for a in ("heads", "kv_heads", "ffn", "experts", "moe_ffn",
                       "ssm_inner", "ssm_heads", "vocab") if ctx.sharded(a)]
    out = {"logits": logits, "line": (
        f"{dict((k, cfg.block_pattern.count(k)) for k in dict.fromkeys(cfg.block_pattern))}"
        f", axes cut {cut}, {reduces} all-reduces a prefill "
        f"(collectives_per_iteration {want - 1} + the embedding's); "
        f"TP 2 model, logits and TP 1 in {time.time() - t0:.1f} s")}
    del model
    torch.cuda.empty_cache()
    if rank.rank == 0:
        one = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda",
                         attn_kernel=True)
        out["tp1"] = _tp_block_logits(one)[0]
        del one
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def tp_block_serve(rank, name, card):
    """(f) One config at full width and depth, bf16, kernels on, strict,
    at TP 2: TP_SERVE_REQUESTS azure-conv requests (outputs cut to
    TP_SERVE_MAX_OUTPUT) through the async engine on the paged path, the
    launch counts reset just before and read just after; then one decode
    step profiled on rank 0 (every rank runs it) with its all-reduces."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.serving import AsyncDuetEngine, EngineConfig
    cfg = get_config(name)
    ctx = rank.context(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = Model.init(cfg, seed=0, dtype=torch.bfloat16, ctx=ctx,
                       attn_kernel=True)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    gb = sum(b.numel() * b.element_size() for b in model.buffers()) / 1e9
    reqs = _requests("paged", TP_SERVE_REQUESTS, TP_SERVE_MAX_OUTPUT)
    eng = AsyncDuetEngine(model, EngineConfig(max_slots=8, max_len=1024,
                                              token_budget=256,
                                              strict_kernel=True),
                          seed=0, device=ctx.device)
    # as the reference's engine, the path follows the kv_heads rule (MLA's
    # too, though no kernel reads its whole latent pools)
    want_path = "cuda_sharded" if ctx.sharded("kv_heads") else "cuda"
    if eng.kernel_path != want_path:
        raise AssertionError(f"[tp] {name}: kernel_path {eng.kernel_path}, "
                             f"expected {want_path}")
    eng.submit(reqs)
    reset_launch_counts()        # this TP path's launches start here
    torch.cuda.synchronize()
    t0 = time.time()
    metrics = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()     # and end here
    summ = metrics.summary()
    n_tok = sum(len(r.output_tokens) for r in metrics.requests)
    if summ["num_finished"] != len(reqs) or any(
            len(r.output_tokens) != r.output_len for r in metrics.requests):
        raise AssertionError(f"[tp] {name}: {summ['num_finished']}/"
                             f"{len(reqs)} requests finished")
    st = eng.dstats
    if not 0 < st.host_syncs <= st.super_iterations:
        raise AssertionError(f"[tp] {name}: host_syncs {st.host_syncs} > "
                             f"super_iterations {st.super_iterations}")
    launched = {k: n for k, n in counts.items() if n}
    if cfg.kv_lora_rank:
        if launched:
            raise AssertionError(f"[tp] {name}: MLA runs no kernel, but "
                                 f"{launched} launched")
    else:
        inner = sum(n for k, n in counts.items()
                    if k.startswith("paged_decode")
                    and k != "paged_decode_sharded")
        if not 0 < counts["paged_decode_sharded"] == inner:
            raise AssertionError(f"[tp] {name}: paged_decode_sharded "
                                 f"launched {counts['paged_decode_sharded']}"
                                 f" times, the inner decode kernels {inner}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    path = eng.kernel_path
    del eng
    # one profiled decode step (8 slots at 1000 tokens of context) and its
    # all-reduces
    prof = tp_profile(rank, model, ctx)
    per_step = prof["all_reduces_per_step"]
    want = ctx.collectives_per_iteration() + 1
    if per_step != want:
        raise AssertionError(f"[tp] {name}: {per_step} all-reduces a decode"
                             f" step, collectives_per_iteration + 1 = "
                             f"{want}")
    line = (f"{cfg.num_layers} layers, bf16, {gb:.2f} GB of weights a rank "
            f"(drawn in {t_init:.1f} s), {len(reqs)} requests, {n_tok} "
            f"tokens in {wall:.2f} s wall = {n_tok / wall:.1f} tokens/s at "
            f"TP {TP} over gloo on one card; kernel_path {path};"
            f" {per_step} all-reduces a decode step (collectives_per_"
            f"iteration {want - 1} + the embedding's); super_iterations "
            f"{st.super_iterations}, host_syncs {st.host_syncs}; launches "
            f"{launched or 'none'}; peak allocated {peak:.2f} GB over the "
            "weights and the run")
    out = {"line": line, "peak_gb": peak, "counts": counts, "streams": {
        r.rid: list(r.output_tokens) for r in metrics.requests}, **prof}
    del model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: data parallelism, two replicas on the one card
# ---------------------------------------------------------------------------
DP = 2
# the engines of the dp phase: the serve phase's geometry (pages of 16)
DP_ENGINE = dict(max_slots=8, max_len=1024, token_budget=256,
                 strict_kernel=True)
# the pair trace at full width: DP_GROUPS groups of 2 requests sharing a
# DP_SHARED-token prefix (16 full pages) before a body of DP_BODY + 16 g
# tokens (prompts of 392 to 424), DP_OUTPUT output tokens each; the pair's
# second member arrives DP_PAIR_GAP virtual seconds after the first, when
# the first's prefill (about 0.015 s on the card's virtual clock) is done
# and its prefix cached, and the groups overlap (a request decodes for
# about 0.2 s on the card's clock), so an engine batches several requests
# a step
DP_GROUPS, DP_SHARED, DP_BODY, DP_OUTPUT = 3, 256, 136, 64
DP_GROUP_GAP, DP_PAIR_GAP = 0.1, 0.05
# the prefix-affinity run checks routing and prefix hits, not tokens/s:
# the same pair trace with outputs cut to this many tokens
DP_PREFIX_OUTPUT = 8
# the elastic run (async replicas): DP_BURST requests DP_BURST_GAP virtual
# seconds apart, then silence. The scale-up threshold is crossed by the
# third arrival; the scale-down fires while replica 1 still holds live
# requests, which are drained and recomputed on replica 0 (the port's
# ClusterSim at this geometry, priced by the card: up at 0.006 s, down at
# about 0.201 s with 3 requeued)
DP_BURST, DP_BURST_GAP, DP_BURST_PROMPT, DP_BURST_OUTPUT = 8, 0.002, 400, 64
DP_ELASTIC = dict(min_replicas=1, max_replicas=DP, scale_up_tokens=1000,
                  scale_down_tokens=200, cooldown_s=0.05,
                  check_interval=0.05)
# the CLI run; --max-len 256 caps prompts at 128 tokens and outputs at
# 64 (the phase's time)
DP_CLI = ["--attn-kernel", "--dp", "2", "--share-card", "--router-policy",
          "prefix", "--arrival", "mmpp", "--service-mix", "mixture",
          "--rho", "0.8", "--stream", "--num-requests", "8", "--max-len",
          "256"]


def _dp_pairs(vocab, output=DP_OUTPUT):
    from repro_torch.serving import Request
    from repro_torch.serving.request import synth_prompt_tokens
    reqs = []
    for g in range(DP_GROUPS):
        common = np.random.default_rng(1000 + g).integers(
            0, vocab, DP_SHARED).astype(np.int32)
        for j in range(2):
            rid = 2 * g + j
            body = synth_prompt_tokens(rid, vocab, DP_BODY + 16 * g)
            reqs.append(Request(
                rid=rid, arrival=g * DP_GROUP_GAP + j * DP_PAIR_GAP,
                prompt_len=DP_SHARED + len(body), output_len=output,
                prompt_tokens=np.concatenate([common, body])))
    return reqs


def _dp_check(label, metrics, reqs, vocab):
    """Every request finished exactly once with its output length of
    tokens in the vocabulary. Returns (streams, tokens)."""
    rids = sorted(r.rid for r in metrics.requests)
    if rids != sorted(r.rid for r in reqs):
        raise AssertionError(f"[dp] {label}: served rids {rids}")
    for r in metrics.requests:
        if r.finish_time is None or len(r.output_tokens) != r.output_len \
                or not all(0 <= t < vocab for t in r.output_tokens):
            raise AssertionError(f"[dp] {label}: request {r.rid} did not "
                                 "finish with its tokens")
    streams = {r.rid: list(r.output_tokens) for r in metrics.requests}
    return streams, sum(len(t) for t in streams.values())


def _dp_one(model, ec, reqs, card):
    """One sync engine on ``reqs``: (streams, tokens, wall s)."""
    from repro_torch.serving import DuetEngine
    engine = DuetEngine(model, ec, seed=0, device="cuda")
    _hold_card_pricing(engine, "one engine", card)
    engine.submit(copy.deepcopy(reqs))
    torch.cuda.synchronize()
    t0 = time.time()
    metrics = engine.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    streams, n_tok = _dp_check("one engine", metrics, reqs,
                               model.cfg.vocab_size)
    return streams, n_tok, wall


def _dp_router(model, ec, ctx, reqs, policy, cls, elastic=None):
    """The router over ``ctx``'s replicas on ``reqs``: (router, metrics,
    events, streams, tokens, wall s). The caller drops the router and
    collects it (``_dp_free``) before the next run, so the peak memory
    reads one router's pools."""
    from repro_torch.serving.router import Router
    router = Router(model, ec, ctx=ctx, policy=policy, engine_cls=cls,
                    seed=0, elastic=elastic)
    if any(e.kernel_path != "cuda" for e in router.engines):
        raise AssertionError("[dp] a replica's kernel_path is not cuda")
    for i, e in enumerate(router.engines):
        _hold_card_pricing(e, f"{policy} router replica {i}", card_line())
    router.submit(copy.deepcopy(reqs))
    events = []
    torch.cuda.synchronize()
    t0 = time.time()
    metrics = router.run(on_event=events.append)
    torch.cuda.synchronize()
    wall = time.time() - t0
    streams, n_tok = _dp_check(f"{policy} router", metrics, reqs,
                               model.cfg.vocab_size)
    return router, metrics, events, streams, n_tok, wall


def _dp_free():
    """Collect dropped engines (their pools) and return the memory."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _dp_sim(cfg, reqs, policy, elastic=None):
    """The port's ClusterSim on ``reqs``, its replicas priced as the
    engines' (the card's spec and measured curve over its TPCs, pages of
    16, the engines' token budget and batch; the admission ledger's bytes
    a replica as before, spread over the TPCs)."""
    from repro_torch.serving.engine import device_pricing
    from repro_torch.serving.router import ElasticConfig
    from repro_torch.serving.simulator import (ClusterSim, SimConfig,
                                               make_duet_instance)
    hw = device_pricing(torch.device("cuda"))
    units = hw.num_units
    sim = ClusterSim(
        lambda i: make_duet_instance(
            cfg, SimConfig(units=units, tp=1, page_size=16,
                           hbm_per_unit=SimConfig.hbm_per_unit / units),
            hw=hw, token_budget=DP_ENGINE["token_budget"],
            max_batch=DP_ENGINE["max_slots"]),
        n=DP, policy=policy,
        elastic=None if elastic is None else ElasticConfig(**elastic))
    sim.run(copy.deepcopy(reqs))
    return sim


def cli_rate(stderr, card):
    """The serve CLI's --rho line: its E[S] must be the mean request's
    cost as the engines price it (``device_pricing``: the card's spec and
    measured curve over its TPCs), beside the TPU v5e's."""
    from repro_torch.configs import get_config
    from repro_torch.core.roofline import TPU_V5E
    from repro_torch.serving.engine import device_pricing
    from repro_torch.serving.loadgen import ServiceSpec, request_cost
    from repro_torch.serving.traces import TRACES
    line = next(ln for ln in stderr.splitlines() if "rho=" in ln)
    got = float(line.split("E[S]=")[1].split("s")[0])
    cfg, hw = get_config("qwen3-4b"), device_pricing(torch.device("cuda"))
    service = ServiceSpec(trace=TRACES["azure-conv"], mix="mixture")
    want = request_cost(cfg, service, hw, units=hw.num_units)
    tpu = request_cost(cfg, service, TPU_V5E)
    log(f"[dp] CLI {line.removeprefix('warning: ')}; the engines' pricing "
        f"gives E[S] {want:.6f} s (the TPU v5e's {tpu:.6f} s) [{card}]")
    if abs(got - want) > 5e-5:
        raise AssertionError(f"[dp] CLI: E[S] {got} s, not the engines' "
                             f"{want:.6f} s")


def phase_dp():
    """qwen3-4b at full width and depth, bf16, random weights from seed
    0: DP = 2 replicas from one process on the one card (share_card: one
    weight tree, a page pool each), through the Router. Round-robin's
    streams against two independent engines fed its shards (exact), prefix
    affinity on the warm replica against the ClusterSim's decisions, an
    elastic run of async replicas against the ClusterSim's scaling and
    dispatch sequences, and one serve CLI run; the launch counts reset
    just before the first router run and read after the CLI's, the peak
    memory over the router runs. Then a profiled decode step of each
    replica and of the pair. Returns the DP path's launch counts."""
    import contextlib
    import io
    from repro_torch.configs import get_config
    from repro_torch.core.device import DeviceContext
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import Model
    from repro_torch.serving import (AsyncDuetEngine, DuetEngine,
                                     EngineConfig)
    from repro_torch.serving.router import ElasticConfig
    card = card_line()
    cfg = get_config("qwen3-4b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model.init(cfg, seed=0, dtype=torch.bfloat16, device="cuda",
                       attn_kernel=True)
    weights = sum(b.numel() for b in model.buffers()) * 2 / 1e9
    ctx = DeviceContext.for_replicas(cfg, DP, "cuda", share_card=True)
    ec = EngineConfig(**DP_ENGINE)
    log(f"[dp] {cfg.name} at full width and depth, bf16 ({weights:.2f} GB "
        f"of weights, one tree for both replicas), {DP} replicas on "
        f"{ctx.replica_devices} from one process: one host thread and "
        "torch's current stream serve both, so a replica's blocking fetch "
        f"waits for the other's queued work [{card}]")
    pairs = _dp_pairs(cfg.vocab_size)
    # the references: one engine on every request, and one engine on each
    # of round-robin's shards (not counted: the DP path starts below)
    one, one_tok, one_wall = _dp_one(model, ec, pairs, card)
    indep = {}
    for shard in (pairs[0::2], pairs[1::2]):
        indep.update(_dp_one(model, ec, shard, card)[0])
    _dp_free()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()            # the DP path's launches start here
    # (a) round-robin: the streams of independent engines, exactly
    rr, _, _, rr_streams, rr_tok, rr_wall = _dp_router(
        model, ec, ctx, pairs, "round-robin", DuetEngine)
    rr_hits, rr_decisions = rr.prefix_stats()["hit_tokens"], rr.decisions
    del rr
    _dp_free()
    if [d.replica for d in rr_decisions] != [i % DP for i in
                                               range(len(pairs))]:
        raise AssertionError("[dp] round-robin did not alternate")
    if rr_streams != indep:
        diff = [r for r in indep if rr_streams[r] != indep[r]]
        raise AssertionError(f"[dp] round-robin streams differ from the "
                             f"independent engines' for requests {diff}")
    log(f"[dp] round-robin (sync replicas): {len(pairs)} requests, "
        f"{rr_tok} tokens in {rr_wall:.2f} s wall = {rr_tok / rr_wall:.1f} "
        f"tokens/s; one engine on the same requests {one_tok} tokens in "
        f"{one_wall:.2f} s = {one_tok / one_wall:.1f} tokens/s; every "
        "stream equals the independent engines' on its shard, exactly; "
        f"one engine's streams equal for "
        f"{sum(one[r] == rr_streams[r] for r in one)}/{len(one)} requests "
        f"[{card}]")
    # (b) prefix affinity: the pairs reunite on the warm replica
    short = _dp_pairs(cfg.vocab_size, DP_PREFIX_OUTPUT)
    pf, _, _, _, pf_tok, pf_wall = _dp_router(model, ec, ctx, short,
                                              "prefix", DuetEngine)
    by_rid = {d.rid: d for d in pf.decisions}
    for g in range(DP_GROUPS):
        first, second = by_rid[2 * g], by_rid[2 * g + 1]
        if second.replica != first.replica or \
                second.matched_tokens < DP_SHARED:
            raise AssertionError(f"[dp] prefix: group {g} routed "
                                 f"{first} then {second}")
    stats = pf.prefix_stats()
    if stats["hit_tokens"] < DP_GROUPS * DP_SHARED:
        raise AssertionError(f"[dp] prefix: {stats['hit_tokens']} hit "
                             "tokens")
    real = [(d.replica, d.matched_tokens) for d in pf.decisions]
    sim = [(d.replica, d.matched_tokens)
           for d in _dp_sim(cfg, short, "prefix").decisions]
    if real != sim:
        raise AssertionError(f"[dp] prefix: router {real}, ClusterSim "
                             f"{sim}")
    log(f"[dp] prefix affinity (sync replicas, outputs cut to "
        f"{DP_PREFIX_OUTPUT}): decisions (replica, matched) {real}, equal "
        f"to the ClusterSim's; cluster hit tokens {stats['hit_tokens']} "
        f"(round-robin's {rr_hits}); {pf_tok} tokens in {pf_wall:.2f} s "
        f"wall [{card}]")
    del pf
    _dp_free()
    # (c) elastic: async replicas on a burst, then silence
    burst = [type(pairs[0])(rid=i, arrival=i * DP_BURST_GAP,
                            prompt_len=DP_BURST_PROMPT,
                            output_len=DP_BURST_OUTPUT)
             for i in range(DP_BURST)]
    el, el_m, _, _, el_tok, el_wall = _dp_router(
        model, ec, ctx, burst, "round-robin", AsyncDuetEngine,
        elastic=ElasticConfig(**DP_ELASTIC))
    el_sim = _dp_sim(cfg, burst, "round-robin", elastic=DP_ELASTIC)
    scale = [(e.action, e.replica) for e in el.scale_events]
    if ("up", 1) not in scale or ("down", 1) not in scale:
        raise AssertionError(f"[dp] elastic: scale events {scale}")
    if scale != [(e.action, e.replica) for e in el_sim.scale_events]:
        raise AssertionError(
            f"[dp] elastic: router {scale}, ClusterSim "
            f"{[(e.action, e.replica) for e in el_sim.scale_events]}")
    if [d.replica for d in el.decisions] != [d.replica for d in
                                              el_sim.decisions]:
        raise AssertionError("[dp] elastic: dispatch sequences differ")
    requeued = sum(e.requeued for e in el.scale_events)
    if requeued == 0:
        raise AssertionError("[dp] elastic: the scale-down drained nothing")
    for i, eng in enumerate(el.engines):
        st = eng.dstats
        if not st.host_syncs <= st.super_iterations:
            raise AssertionError(f"[dp] elastic: replica {i} host_syncs "
                                 f"{st.host_syncs} > super_iterations "
                                 f"{st.super_iterations}")
        if not (eng.graphs and st.replays > 0):
            raise AssertionError(f"[dp] elastic: replica {i} replayed no "
                                 f"CUDA graph ({st})")
    def events_of(obj):
        return [(e.action, e.replica, e.requeued, round(e.t, 3))
                for e in obj.scale_events]
    syncs = [(e.dstats.super_iterations, e.dstats.host_syncs,
              e.dstats.captures, e.dstats.replays) for e in el.engines]
    pool = el.engines[0].graph_pool_bytes()
    log(f"[dp] elastic (async replicas): scale events {events_of(el)}, "
        f"the ClusterSim's {events_of(el_sim)}; dispatch "
        f"{[d.replica for d in el.decisions]}, equal; "
        f"{len(el_m.requests)} requests each finished once, "
        f"{sum(r.preemptions for r in el_m.requests)} preempted and "
        f"recomputed; {el_tok} tokens in {el_wall:.2f} s wall = "
        f"{el_tok / el_wall:.1f} tokens/s; (super_iterations, host_syncs, "
        f"captures, replays) a replica {syncs}, one graph pool of {pool} "
        f"bytes [{card}]")
    del el
    _dp_free()
    peak = torch.cuda.max_memory_allocated() / 1e9
    # (d) the serve CLI (its own model: ours stays for the timings below)
    buf, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        serve_cli.main(DP_CLI)
    cli_wall = time.time() - t0
    sys.stderr.write(err.getvalue())
    cli_rate(err.getvalue(), card)
    out = buf.getvalue()
    summ = json.loads(out[out.index("{\n"):])
    events = [json.loads(ln) for ln in out[:out.index("{\n")].splitlines()]
    routed = sum(e["event"] == "router" for e in events)
    n_cli = sum(e["event"] == "token" for e in events)
    if summ["num_finished"] != 8 or routed != 8 or \
            summ["kernel_path"] != "cuda" or summ["router"][
                "routed_requests"] != 8:
        raise AssertionError(f"[dp] CLI: {summ['num_finished']} finished, "
                             f"{routed} routed, {summ['kernel_path']}")
    for st in summ["dispatch_stats"]:
        if not st["host_syncs"] <= st["super_iterations"]:
            raise AssertionError(f"[dp] CLI: dispatch stats {st}")
    log(f"[dp] CLI {' '.join(DP_CLI)}: {summ['num_finished']} requests "
        f"finished, {n_cli} tokens streamed in {cli_wall:.1f} s wall "
        f"(model init included), dispatch "
        f"{summ['router']['dispatch_counts']}, prefix hit tokens "
        f"{summ['prefix_cache']['hit_tokens']}, mesh {summ['mesh']}; "
        "virtual clock (the card's roofline prediction, not a "
        "measurement): mean "
        f"TTFT {summ['mean_ttft_s']:.4f} s, mean TBT "
        f"{summ['mean_tbt_s']:.4f} s [{card}]")
    counts = launch_counts()         # the DP path's launches end here
    log(f"[dp] DP path launches: {counts}")
    for name in ("paged_decode", "duet_attention_paged"):
        if counts[name] <= 0:
            raise AssertionError(f"[dp] kernel {name} was never launched "
                                 "on the DP path")
    for name in ("flash_prefill", "duet_attention"):
        if counts[name]:
            raise AssertionError(f"[dp] kernel {name} launched on the "
                                 "paged DP path")
    log(f"[dp] peak memory {peak:.2f} GB over the router runs (the weights "
        f"{weights:.2f} GB once, a page pool a replica) [{card}]")
    profile_dp(model, ctx, card)
    return counts


def profile_dp(model, ctx, card):
    """One paged decode step (B=8 at 1000 tokens of context, bf16, kernel
    path) of each replica alone, and of both in turn (replica 0's, then
    replica 1's, from one thread on one stream: what a router pass does):
    wall on the host clock, device time and busy share from
    torch.profiler. The replicas share the weights and have a pool each."""
    from repro_torch.models import Model
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    cfg, B, P, ps, steps = model.cfg, 8, 64, 16, 4
    tree = model.param_tree()
    replicas = []
    for c in ctx.split_replicas():
        rm = Model(cfg, c.place_params(tree), ctx=c, attn_kernel=True)
        pools = init_page_pools(cfg, PagePoolConfig(num_pages=B * P + 1,
                                                    page_size=ps),
                                torch.bfloat16, device=c.device)
        replicas.append((rm, pools, rm.init_state_cache(B)))
    dev = ctx.device
    tables = torch.arange(1, B * P + 1, dtype=torch.int32,
                          device=dev).reshape(B, P)
    pos = torch.full((B,), 1000, dtype=torch.int32, device=dev)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)

    def run(which):
        for _ in range(steps):
            for i in which:
                rm, pools, state = replicas[i]
                rm.decode_step_paged(pools, state, tok, pos, tables,
                                     active_mask=active)
        torch.cuda.synchronize()

    for which in ([0], [1], [0, 1]):
        wall, events, _ = _profile(lambda: run(which), steps)
        log_profile(f"DP {DP} on one card, replica(s) {which} paged decode "
                    f"step, {cfg.num_layers} layers, B={B} a replica, ctx "
                    f"1000, bf16", wall, events, steps, card, top=4)


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------
def phase_train():
    """The reduced train step on the card against the CPU, then
    TRAIN_ARCH at full width trained for TRAIN_STEPS steps, fp32 with TF32
    off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    train_check(card)
    train_full(card)


def _train_run(model, opt_cfg, data, steps, sync=False):
    """``steps`` train steps from ``make_train_step``; returns the final
    params and the per-step metrics (host floats) and wall ms (host clock,
    each step synchronised)."""
    from repro_torch.training import init_adamw, make_train_step
    params = model.param_tree()
    state = init_adamw(params)
    step_fn = make_train_step(model, opt_cfg)
    rows = []
    for _ in range(steps):
        batch = next(data)
        t0 = time.time()
        params, state, m = step_fn(params, state, batch)
        if sync:
            torch.cuda.synchronize()
        rows.append({k: float(v) for k, v in m.items()}
                    | {"ms": (time.time() - t0) * 1e3})
    return params, state, rows


def _grads(model, params, batch, group=None):
    """The loss of ``model`` (whose weights ``params`` are) on ``batch``
    and each leaf's gradient (path -> tensor; the mean over the data
    group ``group`` where one is given): a train step's gradients, kept so
    a check can hold them or feed them to :func:`_fed_adamw`."""
    from repro_torch.models.params import _leaves
    from repro_torch.training.train_loop import _mean_over
    leaves = list(_leaves(params))
    loss = model.loss(batch)
    got = list(torch.autograd.grad(loss, [t for _, t in leaves]))
    if group is not None:
        got = _mean_over(got, group)
    return loss, dict(zip((p for p, _ in leaves), got))


def _fed_adamw(opt_cfg, params, state, grads, ctx=None):
    """One AdamW step of ``params`` fed ``grads`` (path -> tensor, moved
    to each leaf's device): (params, state, metrics) as adamw_update."""
    from repro_torch.models.params import _map
    from repro_torch.training import adamw_update
    return adamw_update(opt_cfg, _map(
        lambda path, t: grads[path].to(t.device), params), state, params,
        ctx=ctx)


def _train_forced(cpu, card, opt_cfg, data, steps):
    """(b) of train_check: ``steps`` steps of the CPU's model and the
    card's from the same weights and batches, each side computing its own
    loss and gradients, then both sides' AdamW fed the CPU's gradients.
    Returns the largest gradient difference, each entry's relative to its
    leaf's largest |gradient| on the CPU, and both sides' parameters."""
    from repro_torch.training import init_adamw
    from repro_torch.training.train_loop import batch_to
    models = (cpu, card)
    trees = [m.param_tree() for m in models]
    states = [init_adamw(t) for t in trees]
    worst = 0.0
    for _ in range(steps):
        batch = next(data)
        grads = [{path: g.detach().cpu() for path, g in _grads(
            model, tree, batch_to(batch, model.device))[1].items()}
                 for model, tree in zip(models, trees)]
        for path, want in grads[0].items():
            scale = want.abs().max().item()
            err = (grads[1][path] - want).abs().max().item()
            worst = max(worst, err / scale if scale else
                        (0.0 if err == 0 else float("inf")))
        for i, tree in enumerate(trees):
            _, states[i], _ = _fed_adamw(opt_cfg, tree, states[i], grads[0])
    return worst, trees


def train_check(card):
    """TRAIN_ARCH reduced, fp32, TF32 off, TRAIN_CHECK_STEPS train steps on
    the card and on the CPU from the same weights and batches. (a) Each
    side free-running through ``make_train_step``: the losses, learning
    rates and grad norms within TRAIN_TOL of the CPU's. (b) Each step's
    gradients on both sides from the same weights, every entry within
    TRAIN_TOL of its leaf's largest |gradient|, then AdamW on both sides
    fed the CPU's gradients: the parameters within TRAIN_PARAM_TOL_LR x
    lr. (a)'s parameters are logged, not held to a tolerance: Adam's m /
    sqrt(v) has no scale, so an entry whose gradient is at the rounding
    noise moves by a fraction of lr that depends on the summation order
    (``train_check_floor.py`` measures how far correct runs fall apart:
    CPU runs that differ only in their thread count or instruction set,
    and the card's)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import data_iterator
    from repro_torch.models import Model, trainable
    from repro_torch.models.params import _leaves, _map
    from repro_torch.training import AdamWConfig
    t0 = time.time()
    cfg = reduced(get_config(TRAIN_ARCH))
    opt = AdamWConfig(lr=TRAIN_CHECK_LR, schedule=cfg.lr_schedule,
                      warmup_steps=2, total_steps=TRAIN_CHECK_STEPS)

    def pair():
        cpu = Model.init(cfg, seed=0, device="cpu", requires_grad=True,
                         remat=True)
        return cpu, Model(cfg, trainable(_map(
            lambda _, t: t.detach().to("cuda", copy=True),
            cpu.param_tree())), remat=True)

    def distance(cpu_tree, card_tree):
        want = dict(_leaves(cpu_tree))
        return max((t.detach().cpu() - want[path].detach()).abs().max()
                   .item() for path, t in _leaves(card_tree))

    # (a)
    out = {label: _train_run(model, opt, data_iterator(
        cfg, TRAIN_CHECK_SEQ, 2, seed=0), TRAIN_CHECK_STEPS)
        for label, model in zip(("cpu", "card"), pair())}
    (pc, _, rc), (pg, _, rg) = out["cpu"], out["card"]
    worst = {}
    for key in ("loss", "lr", "grad_norm"):
        worst[key] = max(abs(g[key] - c[key]) / abs(c[key])
                         for c, g in zip(rc, rg))
    free = distance(pc, pg)
    del out, pc, pg
    # (b)
    worst["grads"], (pc, pg) = _train_forced(*pair(), opt, data_iterator(
        cfg, TRAIN_CHECK_SEQ, 2, seed=0), TRAIN_CHECK_STEPS)
    worst["params"] = distance(pc, pg)
    log(f"[train] {cfg.name} ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, lr_schedule {cfg.lr_schedule}), "
        f"{TRAIN_CHECK_STEPS} steps at 2 x {TRAIN_CHECK_SEQ}, fp32, TF32 "
        f"off: (a) card losses {[round(r['loss'], 6) for r in rg]} vs CPU "
        f"{[round(r['loss'], 6) for r in rc]}; largest relative "
        f"difference loss {worst['loss']:.2e}, lr {worst['lr']:.2e}, grad "
        f"norm {worst['grad_norm']:.2e} (tol {TRAIN_TOL:.0e}); parameters "
        f"free-running {free:.2e} (rounding through Adam, not held); (b) "
        f"gradients {worst['grads']:.2e} of their leaf's largest (tol "
        f"{TRAIN_TOL:.0e}), parameters from the CPU's gradients "
        f"{worst['params']:.2e} (tol {TRAIN_PARAM_TOL_LR} x lr "
        f"{TRAIN_CHECK_LR:.0e}) [{card}], {time.time() - t0:.1f} s")
    if max(worst[k] for k in ("loss", "lr", "grad_norm", "grads")) > \
            TRAIN_TOL or worst["params"] > TRAIN_PARAM_TOL_LR * TRAIN_CHECK_LR:
        raise AssertionError("[train] the card's train steps differ from "
                             "the CPU's")


def train_full(card):
    """TRAIN_ARCH at full width and depth: fp32 weights and AdamW moments,
    remat on, TRAIN_STEPS steps on its WSD schedule (warmup max(2, steps //
    10), as launch/train.py) at TRAIN_BATCH x TRAIN_SEQ from the data
    pipeline, each step synchronised and timed on the host clock; every
    loss must be finite and the last below the first. Then the peak memory,
    training tokens/s at the median wall of steps 1.. (B x S tokens a
    step), and one step
    split by CUDA events into the loss with its gradients and the AdamW
    update, and traced by torch.profiler."""
    from repro_torch.configs import get_config
    from repro_torch.data import data_iterator
    from repro_torch.models import Model, count_params_analytical
    from repro_torch.models.params import _leaves, _map
    from repro_torch.training import (AdamWConfig, adamw_update,
                                      make_train_step)
    from repro_torch.training.train_loop import batch_to
    t0 = time.time()
    cfg = get_config(TRAIN_ARCH)
    n = count_params_analytical(cfg)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda",
                       requires_grad=True, remat=True)
    torch.cuda.synchronize()
    log(f"[train] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n} parameters ({n * 4 / 1e9:.2f} GB fp32; with "
        f"their gradients and two fp32 moments {n * 16 / 1e9:.2f} GB), "
        f"random from seed 0 in {time.time() - t0:.1f} s [{card}]")
    opt = AdamWConfig(lr=TRAIN_LR, schedule=cfg.lr_schedule,
                      warmup_steps=max(2, TRAIN_STEPS // 10),
                      total_steps=TRAIN_STEPS)
    data = data_iterator(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    params, state, rows = _train_run(model, opt, data, TRAIN_STEPS,
                                     sync=True)
    peak = torch.cuda.max_memory_allocated()
    for i, r in enumerate(rows):
        log(f"[train] {cfg.name} step {i}: loss {r['loss']:.4f} lr "
            f"{r['lr']:.3e} grad_norm {r['grad_norm']:.4f} wall "
            f"{r['ms']:.1f} ms [{card}]")
    losses = [r["loss"] for r in rows]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # steps 1.. (step 0 pays the first calls' set-up); the median, since
    # one step can wait on the shared host
    steady = float(np.median([r["ms"] for r in rows[1:]]))
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"[train] {cfg.name}: {TRAIN_STEPS} steps at {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} on {cfg.lr_schedule}, fp32, remat, TF32 off: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; steps 1-{TRAIN_STEPS - 1} "
        f"median {steady:.1f} ms wall = {tokens / steady * 1e3:.1f} "
        f"training tokens/s measured on the card; peak allocated "
        f"{peak / 1e9:.2f} GB of {total / 1e9:.1f} [{card}]")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[train] losses {losses}: not all finite, or "
                             "the last is not below the first")
    train_dryrun(cfg, peak - base, card)
    # one more step split by CUDA events (loss + gradients, AdamW), then
    # traced; these steps come after the checked run
    batch = batch_to(next(data), torch.device("cuda"))
    leaves = list(_leaves(params))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    loss = model.loss(batch)
    grads = dict(zip((p for p, _ in leaves), torch.autograd.grad(
        loss, [t for _, t in leaves])))
    ev[1].record()
    params, state, _ = adamw_update(opt, _map(lambda p, _: grads[p], params),
                                    state, params)
    ev[2].record()
    torch.cuda.synchronize()
    del grads, loss
    fwd_bwd, upd = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    log(f"[profile] {cfg.name} train step (CUDA events): loss with its "
        f"gradients {fwd_bwd:.1f} ms, AdamW update over {len(leaves)} "
        f"leaves {upd:.1f} ms ({100 * upd / (fwd_bwd + upd):.1f}%) [{card}]")
    step_fn, box = make_train_step(model, opt), [params, state]

    def run():                # one synchronised step, for _profile
        box[0], box[1], _ = step_fn(box[0], box[1], batch)
        torch.cuda.synchronize()
    wall, events, ops = _profile(run, 1)
    log_profile(f"{cfg.name} train step, {TRAIN_BATCH} x {TRAIN_SEQ}, fp32",
                wall, events, 1, card, top=10)
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} "
            f"ms/step  {e.count:5d} calls/step  {e.key} (aten op)")
    del model, params, state, box
    torch.cuda.empty_cache()


def train_dryrun(cfg, peak: int, card):
    """(d) of the dryrun phase: the dry run's peak for this run's step
    (one rank, fp32 weights, remat, TRAIN_BATCH x TRAIN_SEQ; host counts
    from DRYRUN_COUNTS) against the peak the card measured over its
    steps, within DRYRUN_TRAIN_TOL."""
    rec = DRYRUN_COUNTS.get("train")
    pred = rec["rank_memory"]["peak_bytes"]
    miss = (peak - pred) / pred
    log(f"[dryrun] (d) {cfg.name} train step at {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, fp32, remat: the dry run's peak {_gb(pred)} GB "
        f"(host count, {rec['lower_s']} s) vs {_gb(peak)} GB measured "
        f"over {TRAIN_STEPS} steps ({100 * miss:+.2f}%, tol "
        f"{100 * DRYRUN_TRAIN_TOL:.0f}%) [{card}]")
    if abs(miss) > DRYRUN_TRAIN_TOL:
        raise AssertionError("[dryrun] the train step's peak misses the "
                             "dry run's")


# ---------------------------------------------------------------------------
# phase 9: the (data, model) grid of ranks on the one card
# ---------------------------------------------------------------------------
GRID_DP, GRID_TP = 2, 2
# (a) serving: qwen3-4b at full width and depth, DP 2 x TP 2
GRID_SERVE_ARCH = "qwen3-4b"
GRID_SERVE_REQUESTS, GRID_SERVE_MAX_OUTPUT = 4, 16
# (b) training: TRAIN_ARCH at full width, cut to this depth, at TRAIN_BATCH
# x TRAIN_SEQ, TRAIN_LR on its WSD schedule
GRID_TRAIN_LAYERS, GRID_TRAIN_STEPS = 4, 3
# (c) gradients at TP 2 against TP 1: the configs whose sharded blocks
# read whole leaves (Mamba2's B/C and conv, the shared block's q/k norms;
# MLA's latent projection, norm and rope key, the MoE router), at full
# width cut to this depth, one batch of GRID_GRAD_SHAPE
GRID_GRAD_LAYERS = {"zamba2-1.2b": 12, "deepseek-v2-lite-16b": 2}
GRID_GRAD_SHAPE = (2, 512)
GRID_GRAD_TOL = 1e-4        # relative to the leaf's largest |gradient|
# where the ranks and the TP 1 references run (a rehearsal on the CPU sets
# "cpu" in each rank)
GRID_DEVICE = "cuda"


def phase_grid():
    """(a) serving over 2 ranks, then (b) training and (c) gradients over
    a 2 x 2 grid of ranks, every rank on card 0 over gloo; the TP 1
    training reference runs here first. Returns the serving path's launch
    counts on rank 0."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_ranks
    _build.build_all()
    torch.cuda.empty_cache()
    card = card_line()
    log(f"[grid] every rank on cuda:0 over gloo (share_card): ranks "
        "time-slice the card and every all-reduce copies through host "
        f"memory, so no speed is claimed [{card}]")
    # (a)
    t0 = time.time()
    ranks = run_ranks(grid_serve_rank, GRID_TP, device=GRID_DEVICE,
                      share_card=True, args=(card,))
    if ranks[0]["streams"] != ranks[1]["streams"]:
        raise AssertionError("[grid] serve: the ranks' streams differ")
    for r, res in enumerate(ranks):
        log(f"[grid] serve rank {r}: {res['line']} [{card}]")
    log(f"[grid] serve: both ranks' streams bitwise equal; {GRID_DP} x "
        f"TP {GRID_TP} done in {time.time() - t0:.1f} s")
    counts = ranks[0]["counts"]
    # (b)
    ranks = grid_train_check(card)
    # (c)
    for r, res in enumerate(ranks):
        if "grads" in res:
            log(f"[grid] {res['grads']} [{card}]")
    return counts


def grid_train_check(card):
    """(b) DP 2 x TP 2 training against DP 1 x TP 1 (its reference run
    first in this process and freed before the grid starts; its gradients
    go to the ranks through files): the free-running steps' losses, lr and
    grad norms within TRAIN_TOL, their gathered parameters logged; the
    forced steps' gradients within GRID_GRAD_TOL of their leaf's largest
    and their gathered parameters within TRAIN_PARAM_TOL_LR x lr. Returns
    the ranks' results ((c) rides the same spawn)."""
    from repro_torch.launch.mesh import run_ranks
    t0 = time.time()
    with tempfile.TemporaryDirectory() as grad_dir:
        rows, want = grid_train_reference(card, grad_dir)
        ranks = run_ranks(grid_train_rank, GRID_TP, dp=GRID_DP,
                          device=GRID_DEVICE, share_card=True,
                          args=(card, grad_dir))
    got = ranks[0]["train"]
    worst = {k: max(abs(g[k] - w[k]) / abs(w[k])
                    for g, w in zip(got["rows"], rows))
             for k in ("loss", "lr", "grad_norm")}
    free = max(np.abs(got["params"][k] - w).max() for k, w in want.items())
    worst["grads"] = max(res["forced"]["grads"] for res in ranks)
    forced = max(np.abs(ranks[0]["forced"]["params"][k] - w).max()
                 for k, w in want.items())
    del want
    for r, res in enumerate(ranks):
        log(f"[grid] train rank {r} (data {r // GRID_TP}, model "
            f"{r % GRID_TP}): {res['train']['line']}; forced steps: "
            f"gradients {res['forced']['grads']:.2e} of their leaf's "
            f"largest [{card}]")
        if res["train"]["rows"] != got["rows"]:
            raise AssertionError(f"[grid] train: rank {r}'s losses differ "
                                 "from rank 0's")
        if not res["train"]["data_equal"]:
            raise AssertionError(f"[grid] train: rank {r}'s parameters "
                                 "differ from its data peer's")
    log(f"[grid] train DP {GRID_DP} x TP {GRID_TP} vs DP 1 x TP 1: losses "
        f"{[round(r['loss'], 6) for r in got['rows']]} vs "
        f"{[round(r['loss'], 6) for r in rows]}; largest relative "
        f"difference loss {worst['loss']:.2e}, lr {worst['lr']:.2e}, grad "
        f"norm {worst['grad_norm']:.2e} (tol {TRAIN_TOL:.0e}); gathered "
        f"parameters free-running {free:.2e} (rounding through Adam, not "
        f"held); forced: each step's gradients from the same weights "
        f"{worst['grads']:.2e} of their leaf's largest (tol "
        f"{GRID_GRAD_TOL:.0e}), gathered parameters after AdamW fed TP 1's "
        f"gradients {forced:.2e} (tol {TRAIN_PARAM_TOL_LR} x lr "
        f"{TRAIN_LR:.0e}); the data ranks' parameters equal; "
        f"{time.time() - t0:.1f} s with the reference [{card}]")
    if max(worst[k] for k in ("loss", "lr", "grad_norm")) > TRAIN_TOL or \
            worst["grads"] > GRID_GRAD_TOL or \
            forced > TRAIN_PARAM_TOL_LR * TRAIN_LR:
        raise AssertionError("[grid] the grid's train steps differ from "
                             "TP 1's")
    return ranks


def grid_serve_rank(rank, card):
    """(a) One rank of DP 2 x TP 2 serving (a spawned process): its rank
    of both replicas of GRID_SERVE_ARCH, bf16, kernels on and strict.
    Each replica's round-robin share of the requests is first served
    alone by a TP 2 engine over the default group; then the router serves
    them all, the launch counts reset just before and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.serving import AsyncDuetEngine, EngineConfig
    from repro_torch.serving.router import Router
    cfg = get_config(GRID_SERVE_ARCH)
    ctx = rank.context(cfg, dp=GRID_DP, share_card=True)
    model = Model.init(cfg, seed=0, dtype=torch.bfloat16, ctx=ctx,
                       attn_kernel=True)
    gb = sum(b.numel() * b.element_size() for b in model.buffers()) / 1e9
    ec = EngineConfig(max_slots=8, max_len=1024, token_budget=256,
                      strict_kernel=True)
    reqs = _requests("paged", GRID_SERVE_REQUESTS, GRID_SERVE_MAX_OUTPUT)
    alone = {}
    for i in range(GRID_DP):
        eng = AsyncDuetEngine(model, ec, seed=0, device=ctx.device)
        eng.submit(copy.deepcopy(reqs[i::GRID_DP]))
        alone.update({r.rid: list(r.output_tokens)
                      for r in eng.run().requests})
        del eng
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    router = Router(model, ec, ctx=ctx, policy="round-robin",
                    engine_cls=AsyncDuetEngine, seed=0)
    subs = ctx.split_replicas()
    router.submit(copy.deepcopy(reqs))
    reduces = sum(c.all_reduces for c in subs)
    reset_launch_counts()        # the DP x TP path's launches start here
    torch.cuda.synchronize()
    t0 = time.time()
    metrics = router.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()     # and end here
    reduces = sum(c.all_reduces for c in subs) - reduces
    peak = torch.cuda.max_memory_allocated() / 1e9
    streams = {r.rid: list(r.output_tokens) for r in metrics.requests}
    if metrics.summary()["num_finished"] != len(reqs) or any(
            len(r.output_tokens) != r.output_len for r in metrics.requests):
        raise AssertionError("[grid] serve: not every request finished")
    if streams != alone:
        raise AssertionError("[grid] serve: a replica's streams differ from "
                             "a TP 2 engine serving its requests alone")
    if len({id(c.group) for c in subs}) != GRID_DP:
        raise AssertionError("[grid] serve: the replicas share a group")
    syncs = []
    for e in router.engines:
        st = e.dstats
        if e.kernel_path != "cuda_sharded":
            raise AssertionError(f"[grid] serve: kernel_path "
                                 f"{e.kernel_path}")
        if not 0 < st.host_syncs <= st.super_iterations:
            raise AssertionError(f"[grid] serve: host_syncs "
                                 f"{st.host_syncs} > super_iterations "
                                 f"{st.super_iterations}")
        syncs.append(f"{st.host_syncs}/{st.super_iterations}")
    inner = sum(n for k, n in counts.items()
                if k.startswith("paged_decode")
                and k != "paged_decode_sharded")
    if not 0 < counts["paged_decode_sharded"] == inner:
        raise AssertionError(f"[grid] serve: paged_decode_sharded launched "
                             f"{counts['paged_decode_sharded']} times, the "
                             f"inner decode kernels {inner}")
    n_tok = sum(len(t) for t in streams.values())
    launched = {k: n for k, n in counts.items() if n}
    line = (f"{cfg.name}, {cfg.num_layers} layers, bf16, {gb:.2f} GB of "
            f"weights a rank shared by its {GRID_DP} replicas; "
            f"{len(reqs)} requests round-robin, {n_tok} tokens in "
            f"{wall:.2f} s wall ({n_tok / wall:.1f} tokens/s over gloo on "
            f"one card); {reduces} all-reduces over the replicas' groups; "
            f"host_syncs/super_iterations a replica {syncs}; each "
            f"replica's streams equal a TP {GRID_TP} engine's alone; "
            f"launches {launched}; peak allocated {peak:.2f} GB a rank")
    return {"streams": streams, "counts": counts, "line": line}


def _grid_train_cfg():
    return _cut(TRAIN_ARCH, GRID_TRAIN_LAYERS)


def _grid_opt(cfg):
    from repro_torch.training import AdamWConfig
    return AdamWConfig(lr=TRAIN_LR, schedule=cfg.lr_schedule,
                       warmup_steps=2, total_steps=GRID_TRAIN_STEPS)


def grid_train_reference(card, grad_dir):
    """(b)'s DP 1 x TP 1 run in this process (make_train_step's loss,
    gradients and AdamW, split by :func:`_grads` and :func:`_fed_adamw`
    so the gradients can be kept): the metrics
    of each step and the final parameters on the host; each step's
    gradients are written to ``grad_dir`` (``step<i>.pt``, leaf path ->
    fp32 tensor) for the grid's forced steps. The card is freed after."""
    from repro_torch.data import data_iterator
    from repro_torch.models import Model
    from repro_torch.models.params import _leaves
    from repro_torch.training import init_adamw
    from repro_torch.training.train_loop import batch_to
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _grid_train_cfg()
    opt = _grid_opt(cfg)
    model = Model.init(cfg, seed=0, dtype=torch.float32,
                       device=GRID_DEVICE, requires_grad=True, remat=True)
    params = model.param_tree()
    state = init_adamw(params)
    data = data_iterator(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    rows = []
    for i in range(GRID_TRAIN_STEPS):
        batch = batch_to(next(data), model.device)
        t0 = time.time()
        loss, grads = _grads(model, params, batch)
        params, state, m = _fed_adamw(opt, params, state, grads, model.ctx)
        torch.cuda.synchronize()
        rows.append({"loss": float(loss.detach()), "lr": float(m["lr"]),
                     "grad_norm": float(m["grad_norm"]),
                     "ms": (time.time() - t0) * 1e3})
        torch.save({"/".join(map(str, p)): g.cpu() for p, g in
                    grads.items()}, os.path.join(grad_dir, f"step{i}.pt"))
        del grads, loss
    want = {"/".join(map(str, p)): t.detach().cpu().numpy()
            for p, t in _leaves(params)}
    n = sum(w.size for w in want.values())
    log(f"[grid] train reference DP 1 x TP 1: {cfg.name} cut to "
        f"{cfg.num_layers} layers, {n} parameters ({n * 16 / 1e9:.2f} GB "
        f"of fp32 weights, gradients and moments), {GRID_TRAIN_STEPS} "
        f"steps at {TRAIN_BATCH} x {TRAIN_SEQ}: wall ms "
        f"{[round(r['ms'], 1) for r in rows]} [{card}]")
    del model, params, state
    torch.cuda.empty_cache()
    return rows, want


def grid_train_rank(rank, card, grad_dir):
    """One rank of the 2 x 2 grid (a spawned process): (b) the train steps
    of DP 2 x TP 2, free-running and then forced by TP 1's gradients, then
    (c) one config's TP 2 gradients on this rank's model group."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"train": grid_train(rank)}
    torch.cuda.empty_cache()
    out["forced"] = grid_train_forced(rank, grad_dir)
    torch.cuda.empty_cache()
    name = list(GRID_GRAD_LAYERS)[rank.data_rank]
    line = grid_grads(rank, name)
    if line is not None:
        out["grads"] = line
    return out


def grid_train_forced(rank, grad_dir):
    """(b) forced: GRID_TRAIN_STEPS steps of DP 2 x TP 2 from the same
    weights as TP 1's steps, each computing its gradients (the data
    group's mean, make_train_step's) and holding every entry of its slices
    against TP 1's gradient of that step (read from ``grad_dir``),
    relative to the whole leaf's largest |gradient|, then feeding AdamW
    TP 1's gradients, cut to the rank's slices. Returns the largest
    relative gradient difference and, on global rank 0, the gathered
    parameters. Adam's m / sqrt(v) has no scale, so free-running parameters
    part by a fraction of lr wherever a gradient sits at the rounding
    noise; fed the same gradients, they must not."""
    from repro_torch.data import data_iterator, shard_batch
    from repro_torch.models import Model
    from repro_torch.models.params import (_leaves, _shard_leaf,
                                           gather_params, param_specs)
    from repro_torch.training import init_adamw
    from repro_torch.training.train_loop import batch_to
    cfg = _grid_train_cfg()
    ctx = rank.context(cfg)
    model = Model.init(cfg, seed=0, dtype=torch.float32, ctx=ctx,
                       requires_grad=True, remat=True)
    opt = _grid_opt(cfg)
    params = model.param_tree()
    state = init_adamw(params)
    specs = dict(_leaves(param_specs(cfg, ctx.tp)))
    data = data_iterator(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    worst = 0.0
    for i in range(GRID_TRAIN_STEPS):
        batch = batch_to(shard_batch(next(data), rank.data_rank, GRID_DP),
                         model.device)
        loss, got = _grads(model, params, batch, rank.data_group)
        ref = torch.load(os.path.join(grad_dir, f"step{i}.pt"), mmap=True)
        fed = {}
        for path, g in got.items():
            full = ref["/".join(map(str, path))]
            want = _shard_leaf(full, specs[path], ctx.tp, ctx.rank)
            scale = full.abs().max().item()
            err = (g.detach().cpu() - want).abs().max().item()
            worst = max(worst, err / scale if scale else
                        (0.0 if err == 0 else float("inf")))
            fed[path] = want
        params, state, _ = _fed_adamw(opt, params, state, fed, ctx)
        del ref, fed, got, loss
    full = gather_params(params, ctx)
    out = {"grads": worst}
    if rank.rank == 0:
        out["params"] = {"/".join(map(str, p)): t.cpu().numpy()
                         for p, t in _leaves(full)}
    del full, model, params, state
    return out


def grid_train(rank):
    """(b) GRID_TRAIN_STEPS steps of DP 2 x TP 2 on the global batches,
    each synchronised and timed; then the gathered parameters (returned
    by global rank 0) and whether this rank's parameters equal its data
    peer's, bit for bit."""
    import torch.distributed as dist
    from repro_torch.data import data_iterator
    from repro_torch.models import Model
    from repro_torch.models.params import _leaves, gather_params
    from repro_torch.training import init_adamw, make_train_step
    cfg = _grid_train_cfg()
    ctx = rank.context(cfg)
    torch.cuda.reset_peak_memory_stats()
    model = Model.init(cfg, seed=0, dtype=torch.float32, ctx=ctx,
                       requires_grad=True, remat=True)
    step = make_train_step(model, _grid_opt(cfg),
                           data_group=rank.data_group)
    params = model.param_tree()
    state = init_adamw(params)
    data = data_iterator(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    rows, fwd, bwd = [], [], []
    for _ in range(GRID_TRAIN_STEPS):
        batch = next(data)
        f0, b0 = ctx.all_reduces, ctx.grad_all_reduces
        torch.cuda.synchronize()
        t0 = time.time()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        rows.append({k: float(v) for k, v in m.items()}
                    | {"ms": (time.time() - t0) * 1e3})
        fwd.append(ctx.all_reduces - f0)
        bwd.append(ctx.grad_all_reduces - b0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    equal = True
    for _, t in _leaves(params):
        top = t.detach().clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=rank.data_group)
        equal &= torch.equal(top, t.detach())
    full = gather_params(params, ctx)
    ms = [round(r["ms"], 1) for r in rows]
    out = {"rows": [{k: v for k, v in r.items() if k != "ms"}
                    for r in rows],
           "data_equal": bool(equal),
           "line": (f"{cfg.name} cut to {cfg.num_layers} layers, fp32, "
                    f"remat, TF32 off: wall ms a step {ms} (steps 1-"
                    f"{GRID_TRAIN_STEPS - 1} median "
                    f"{float(np.median(ms[1:])):.1f}); model-group "
                    f"all-reduces a step: forward {fwd[-1]} (the "
                    f"recomputed blocks' too), backward {bwd[-1]}, the "
                    "norm's 1; data-group all-reduces a step: 2 (one "
                    "flat fp32 gradient bucket, the loss); peak allocated "
                    f"{peak:.2f} GB a rank")}
    if rank.rank == 0:
        out["params"] = {"/".join(map(str, p)): t.cpu().numpy()
                         for p, t in _leaves(full)}
    del full, model, params, state
    return out


def grid_grads(rank, name):
    """(c) One step's gradients of ``name`` (full width, GRID_GRAD_LAYERS
    deep, fp32) at TP 2 on this rank's model group, gathered, against TP
    1's computed on the card by the group's rank 0 (which returns the
    line; the other rank None)."""
    from repro_torch.data import data_iterator
    from repro_torch.models import Model
    from repro_torch.models.params import _leaves, _map, gather_params
    from repro_torch.training.train_loop import batch_to
    cfg = _cut(name, GRID_GRAD_LAYERS[name])
    B, S = GRID_GRAD_SHAPE
    batch = batch_to(next(data_iterator(cfg, S, B, seed=0)),
                     torch.device(GRID_DEVICE))

    def grads(model):
        loss = model.loss(batch)
        leaves = list(_leaves(model.param_tree()))
        got = dict(zip((p for p, _ in leaves), torch.autograd.grad(
            loss, [t for _, t in leaves])))
        return float(loss.detach()), _map(lambda p, _: got[p],
                                          model.param_tree())

    lead = rank.model_rank == 0
    if lead:
        one = Model.init(cfg, seed=0, dtype=torch.float32,
                         device=GRID_DEVICE, requires_grad=True, remat=True)
        loss1, want = grads(one)
        del one
    ctx = rank.context(cfg)
    torch.cuda.reset_peak_memory_stats()
    model = Model.init(cfg, seed=0, dtype=torch.float32, ctx=ctx,
                       requires_grad=True, remat=True)
    f0 = ctx.all_reduces
    torch.cuda.synchronize()
    t0 = time.time()
    loss2, got = grads(model)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    full = gather_params(got, ctx)
    del model, got
    if not lead:
        return None
    worst, n = 0.0, 0
    flat = dict(_leaves(full))
    for path, w in _leaves(want):
        scale = max(w.abs().max().item(), 1e-12)
        err = (flat[path] - w).abs().max().item() / scale
        if not err <= GRID_GRAD_TOL:
            raise AssertionError(f"[grid] {name}: gradient "
                                 f"{'/'.join(map(str, path))} differs from "
                                 f"TP 1's by {err:.2e} of its largest")
        worst, n = max(worst, err), n + 1
    if abs(loss2 - loss1) > TRAIN_TOL * abs(loss1):
        raise AssertionError(f"[grid] {name}: loss {loss2} vs TP 1 {loss1}")
    return (f"grads {name} cut to {cfg.num_layers} layers, fp32, TP "
            f"{GRID_TP} vs TP 1 at {B} x {S}: loss {loss2:.6f} vs "
            f"{loss1:.6f}; {n} gathered gradient leaves, the largest "
            f"difference {worst:.2e} of its leaf's largest |gradient| (tol "
            f"{GRID_GRAD_TOL:.0e}); loss with its gradients {ms:.1f} ms "
            f"wall on the model group, {ctx.all_reduces - f0} forward and "
            f"{ctx.grad_all_reduces} backward all-reduces; peak allocated "
            f"{peak:.2f} GB on rank 0 (with TP 1's gradients)")


# ---------------------------------------------------------------------------
# phase 10: the dry run, and one of its ranks built on the card
# ---------------------------------------------------------------------------
DRYRUN_SHAPE = "decode_32k"
# (b) the measured rank: DRYRUN_ARCH's decode_32k rank 0 on (data 16,
# model 1): 128 / 16 = 8 rows at 32,768 positions, bf16; (c) its TP rank
# on (data 16, model 2)
DRYRUN_ARCH = "qwen3-4b"
DRYRUN_RANK_GRID, DRYRUN_TP_GRID = (16, 1), (16, 2)
DRYRUN_ALLOC_SLACK = 512    # bytes a tensor: a request's rounding
DRYRUN_PEAK_TOL = 0.05      # the measured peak against the record's
DRYRUN_TRAIN_TOL = 0.10     # (d) the train phase's peak against the record's
DRYRUN_COUNTS_TIMEOUT = 600  # seconds from the script's start
# the kernel path's logits at 32,768 keys against the plain path's, fp32
# with TF32 off, DRYRUN_ARCH at full width cut to this depth
DRYRUN_PARITY_LAYERS = 4


def dryrun_counts(conn):
    """The dry run's host counts, in a process of their own (started by
    :class:`DryrunCounts`): (a) the sweep's records, the records of (b)
    and (c), and (d)'s train step on one rank (TRAIN_ARCH, fp32, remat,
    TRAIN_BATCH x TRAIN_SEQ), sent through ``conn``. They need no card."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ASSIGNED_ARCHS
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import lower_one
    from repro_torch.launch.mesh import Grid
    t0 = time.time()
    recs = {"sweep": [lower_one(arch, DRYRUN_SHAPE, verbose=False)
                      for arch in ASSIGNED_ARCHS]}
    recs["sweep_s"] = time.time() - t0
    recs["rank"] = _dryrun_record(DRYRUN_RANK_GRID)
    recs["tp"] = _dryrun_record(DRYRUN_TP_GRID)
    recs["train"] = lower_one(
        TRAIN_ARCH, InputShape(f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", TRAIN_SEQ,
                               TRAIN_BATCH, "train"),
        grid=Grid(("data", "model"), (1, 1)), cfg=get_config(TRAIN_ARCH),
        dtype=torch.float32, verbose=False)
    recs["seconds"] = time.time() - t0
    conn.send(recs)


class DryrunCounts:
    """:func:`dryrun_counts` in a spawned process, started before the
    first phase so that its host work (about a minute on one core) runs
    beside the card's phases; ``get`` waits for it, at most
    DRYRUN_COUNTS_TIMEOUT seconds from the start."""

    def __init__(self):
        import multiprocessing
        mp = multiprocessing.get_context("spawn")
        self.conn, child = mp.Pipe(duplex=False)
        self.proc = mp.Process(target=dryrun_counts, args=(child,),
                               daemon=True)
        self.t0 = time.time()
        self.proc.start()
        child.close()
        self.recs = None

    def get(self, key):
        if self.recs is None:
            self.recs = self._wait()
            self.proc.join()
            log(f"[dryrun] host counts: {self.recs['seconds']:.1f} s in "
                "their own process beside the card's phases, waited for "
                f"{time.time() - self.t0:.1f} s after its start")
        return self.recs[key]

    def _wait(self) -> dict:
        while not self.conn.poll(1.0):
            if not self.proc.is_alive() or \
                    time.time() - self.t0 > DRYRUN_COUNTS_TIMEOUT:
                break
        else:
            try:
                return self.conn.recv()
            except EOFError:          # it ended without sending
                pass
        raise RuntimeError("[dryrun] the host counts' process ended (exit "
                           f"code {self.proc.exitcode}) or ran past "
                           f"{DRYRUN_COUNTS_TIMEOUT} s, and sent nothing")

    def stop(self):
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join()


DRYRUN_COUNTS = None         # a DryrunCounts, made by main()


def phase_dryrun():
    """(a) the sweep, (b) one rank measured, with its kernel path, (c) a TP
    rank's weights; (d) runs in the train phase (train_full). The records
    come from DRYRUN_COUNTS."""
    card = card_line()
    dryrun_sweep(card)
    dryrun_rank(card)
    dryrun_kernel(card)
    dryrun_parity(card)
    dryrun_tp(card)


def _gb(n) -> str:
    return f"{n / 1e9:.3f}"


def dryrun_sweep(card):
    """(a) ``lower_one`` for every assigned arch at DRYRUN_SHAPE on the
    16 x 16 grid (host counts, no device); a combination that raises
    fails the phase."""
    recs = DRYRUN_COUNTS.get("sweep")
    for rec in recs:
        mem, rank, coll = rec["memory"], rec["rank_memory"], \
            rec["collectives"]
        log(f"[dryrun] {rec['arch']} {DRYRUN_SHAPE} on {rec['mesh']} (host "
            f"counts, rank 0): spec arguments "
            f"{_gb(mem['argument_size_in_bytes'])} GB, port rank entry {_gb(rank['entry_bytes'])} GB, peak "
            f"{_gb(rank['peak_bytes'])} GB "
            f"({'fits' if rank['peak_bytes'] <= 80e9 else 'exceeds'} 80 "
            f"GB); {rec['flops'] / 1e9:.1f} GFLOPs; {coll['all-reduce']} "
            f"all-reduce bytes in {coll['count']} collectives; "
            f"{rec['lower_s']} s")
    log(f"[dryrun] sweep of {len(recs)} archs in "
        f"{DRYRUN_COUNTS.get('sweep_s'):.1f} s [{card}]")


def _dryrun_record(grid_sizes):
    """DRYRUN_ARCH's DRYRUN_SHAPE record on a (data, model) grid."""
    from repro_torch.launch.dryrun import lower_one
    from repro_torch.launch.mesh import Grid
    return lower_one(DRYRUN_ARCH, DRYRUN_SHAPE,
                     grid=Grid(("data", "model"), grid_sizes), verbose=False)


def _requested(which: str = "current") -> int:
    """Bytes the live tensors asked the caching allocator for (before its
    rounding: a large block keeps up to 1 MiB of its segment's tail)."""
    return torch.cuda.memory_stats()[f"requested_bytes.all.{which}"]


def dryrun_rank(card):
    """(b) DRYRUN_ARCH's decode_32k rank 0 on (data 16, model 1): the
    record's prediction, then that rank built on the card (bf16 weights
    from seed 0, the slab cache of 8 x 32,768, filled at random): the
    bytes its tensors request from the allocator against the record's
    arguments (within DRYRUN_ALLOC_SLACK a tensor; the weights and the
    cache apart too), one plain decode step's requested peak against the
    record's (within DRYRUN_PEAK_TOL), its FLOPs (FlopCounterMode) equal
    to the record's; the allocator's own (rounded) bytes beside them;
    then the kernel path (the slab duet_attention kernel at 32,768 keys,
    once a layer), its logits beside the plain path's, both paths'
    device and wall ms a step (torch.profiler) beside the bound (the
    argument bytes at HBM_BYTES_PER_S). Every number is printed before a
    miss raises."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models import Model
    from repro_torch.models.params import _leaves
    rec = DRYRUN_COUNTS.get("rank")
    args = rec["memory"]["argument_size_in_bytes"]
    weights = rec["rank_memory"]["weight_bytes"]
    pred_peak = rec["rank_memory"]["peak_bytes"]
    log(f"[dryrun] prediction: {DRYRUN_ARCH} {DRYRUN_SHAPE} rank 0 of "
        f"{rec['mesh']}: arguments {args} B (weights {weights} B), peak "
        f"{pred_peak} B, {rec['flops']} FLOPs (host counts)")
    cfg = get_config(DRYRUN_ARCH)
    B, S = 128 // DRYRUN_RANK_GRID[0], 32_768
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base, base_alloc = _requested(), torch.cuda.memory_allocated()
    model = Model.init(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    got_w = _requested() - base
    cache = model.init_cache(B, S)
    gen = torch.Generator(device=dev).manual_seed(1)
    token = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                          device=dev, dtype=torch.int32)
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    held = _requested() - base
    alloc = torch.cuda.memory_allocated() - base_alloc
    n_w = len(list(_leaves(model.param_tree())))
    n = n_w + sum(len(c) for c in cache) + 2
    misses = []
    log(f"[dryrun] measured: the rank's tensors request {held} B vs the "
        f"record's arguments {args} B ({held - args:+d} B over {n} "
        f"tensors, slack {DRYRUN_ALLOC_SLACK} B a tensor); the weights "
        f"{got_w} B vs {weights} B ({got_w - weights:+d} B over {n_w}); "
        f"the allocator holds {alloc} B ({alloc - args:+d} B of block "
        f"rounding) [{card}]")
    if abs(held - args) > DRYRUN_ALLOC_SLACK * n or \
            abs(got_w - weights) > DRYRUN_ALLOC_SLACK * n_w:
        misses.append("the rank's bytes differ from the record's arguments")
    for c in cache:
        for t in c:
            t.normal_(generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain, _ = model.decode_step(cache, token, pos)
    torch.cuda.synchronize()
    peak = _requested("peak") - base
    peak_alloc = torch.cuda.max_memory_allocated() - base_alloc
    miss = (peak - pred_peak) / pred_peak
    log(f"[dryrun] measured: one plain decode step's requested peak {peak} "
        f"B vs the record's {pred_peak} B ({100 * miss:+.2f}%, tol "
        f"{100 * DRYRUN_PEAK_TOL:.0f}%); max_memory_allocated "
        f"{peak_alloc} B ({100 * (peak_alloc - pred_peak) / pred_peak:+.2f}"
        f"%) [{card}]")
    if abs(miss) > DRYRUN_PEAK_TOL:
        misses.append("the step's peak misses the record's")
    with FlopCounterMode(display=False) as fc:
        model.decode_step(cache, token, pos)
    flops = fc.get_total_flops()
    log(f"[dryrun] measured: the step on the card counts {flops} FLOPs vs "
        f"the record's {rec['flops']}")
    if flops != rec["flops"]:
        misses.append("the card's FLOPs differ from the record's")
    model.attn_kernel = True
    before = launch_counts()["duet_attention"]
    kern, _ = model.decode_step(cache, token, pos)
    launched = launch_counts()["duet_attention"] - before
    if launched != cfg.num_layers:
        misses.append(f"duet_attention launched {launched} times in one "
                      f"step of {cfg.num_layers} layers")
    V = cfg.vocab_size
    kv, pv = kern[:, :V].float(), plain[:, :V].float()
    if not torch.isfinite(kv).all():
        misses.append("kernel path logits not finite")
    err = (kv - pv).abs().max().item()
    scale = pv.abs().max().item()
    same = (kv.argmax(-1) == pv.argmax(-1)).float().mean().item()
    # each path's device time a step (torch.profiler) beside its wall time
    bound = args / HBM_BYTES_PER_S * 1e3
    dev = {}
    for label, on in (("plain", False), ("kernel", True)):
        model.attn_kernel = on

        def run():
            for _ in range(2):
                model.decode_step(cache, token, pos)
            torch.cuda.synchronize()
        wall, events, _ = _profile(run, 2)
        dev[label] = sum(e.self_device_time_total for e in events) / 2e3
        log_profile(f"{DRYRUN_ARCH} bf16 decode step, {label} path, B={B} "
                    f"at {S} keys", wall, events, 2, card,
                    extra=f"; bound {bound:.3f} ms", top=5)
    log(f"[dryrun] measured: {DRYRUN_ARCH} bf16 decode step, B={B} at "
        f"{S} keys: kernel path (duet_attention x {launched}) logits max "
        f"abs diff {err:.3e} of max|plain| {scale:.3g} (bf16; fp32 parity "
        f"below), argmax agreement {same:.3f}; device time a step: kernel "
        f"path {dev['kernel']:.3f} ms, plain path {dev['plain']:.3f} ms "
        f"(torch.profiler); bound {bound:.3f} ms ({_gb(args)} GB at 3.35 "
        f"TB/s), the kernel path at {100 * bound / dev['kernel']:.1f}% of "
        f"it [{card}]")
    del model, cache, plain, kern
    torch.cuda.empty_cache()
    if misses:
        raise AssertionError("[dryrun] " + "; ".join(misses))


def dryrun_kernel(card):
    """(b) the slab duet_attention kernel alone at the rank's shapes (8
    decode rows at 32,768 keys, DRYRUN_ARCH's heads, bf16): against its
    plain version, its ms hot and cold beside its bound, the plain
    version's and SDPA's (the kernels phase's record)."""
    from repro_torch.configs import get_config
    cfg = get_config(DRYRUN_ARCH)
    B, S = 128 // DRYRUN_RANK_GRID[0], 32_768
    rec = check_duet_slab(
        np.random.default_rng(24), f"slab {B} decode at {S} keys",
        torch.bfloat16, B, S, cfg.num_kv_heads, cfg.num_heads, cfg.head_dim,
        [(i, S - 1) for i in range(B)], [], bq=1)
    log(f"[dryrun] {rec['name']} [{rec['case']}] bf16: max abs err "
        f"{rec['max_abs_err']:.3e}; {rec['ms']:.4f} ms hot, "
        f"{rec['cold_ms']:.4f} cold; bound {rec['bound_ms']:.4f} "
        f"({rec['bound_by']}), {100 * rec['bound_ms'] / rec['cold_ms']:.1f}"
        f"% of cold; plain {rec['plain_ms']:.4f}; SDPA "
        f"{rec['library_ms']:.4f} [{card}]")
    torch.cuda.empty_cache()


def dryrun_parity(card):
    """(b) the kernel path at 32,768 keys against the plain path's logits:
    DRYRUN_ARCH at full width cut to DRYRUN_PARITY_LAYERS layers, fp32,
    TF32 off, 8 rows whose positions run from 32,767 down in steps of
    4,096 over a cache filled at random, each path on its own copy."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _cut(DRYRUN_ARCH, DRYRUN_PARITY_LAYERS)
    dev = torch.device("cuda")
    kern = Model.init(cfg, seed=0, dtype=torch.float32, device=dev,
                      attn_kernel=True)
    plain = copy.copy(kern)
    plain.attn_kernel = False
    B, S = 128 // DRYRUN_RANK_GRID[0], 32_768
    gen = torch.Generator(device=dev).manual_seed(2)
    cache = plain.init_cache(B, S)
    for c in cache:
        for t in c:
            t.normal_(generator=gen)
    kcache = [type(c)(*(t.clone() for t in c)) for c in cache]
    token = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                          device=dev, dtype=torch.int32)
    pos = (S - 1 - 4096 * torch.arange(B, device=dev)).to(torch.int32)
    with torch.no_grad():
        want, _ = plain.decode_step(cache, token, pos)
        before = launch_counts()["duet_attention"]
        got, _ = kern.decode_step(kcache, token, pos)
        launched = launch_counts()["duet_attention"] - before
    if launched != cfg.num_layers:
        raise AssertionError(f"[dryrun] duet_attention launched {launched} "
                             f"times in {cfg.num_layers} layers")
    _check_parity(DRYRUN_ARCH, cfg.num_layers, get_config(DRYRUN_ARCH),
                  [(f"slab decode at {S} keys (B={B}, positions "
                    f"{pos.tolist()})", got, want)])
    del kern, plain, cache, kcache
    torch.cuda.empty_cache()


def dryrun_tp(card):
    """(c) the (data 16, model 2) record's rank 0 weight bytes against
    ``shard_params(..., tp=2, rank=0)`` as allocated on the card (bf16,
    the full tree drawn from seed 0 and freed)."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import (_leaves, init_params,
                                           shard_params, tp_adjusted_config)
    rec = DRYRUN_COUNTS.get("tp")
    want = rec["rank_memory"]["weight_bytes"]
    tp = DRYRUN_TP_GRID[1]
    log(f"[dryrun] prediction: {DRYRUN_ARCH} rank 0 of {rec['mesh']}: "
        f"weights {want} B, spec arguments "
        f"{rec['memory']['argument_size_in_bytes']} B, port rank peak "
        f"{rec['rank_memory']['peak_bytes']} B (host counts)")
    cfg = tp_adjusted_config(get_config(DRYRUN_ARCH), tp)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base, base_alloc = _requested(), torch.cuda.memory_allocated()
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                       torch.bfloat16, dev)
    shard = shard_params(full, cfg, tp, 0)
    del full
    torch.cuda.synchronize()
    held = _requested() - base
    alloc = torch.cuda.memory_allocated() - base_alloc
    n = len(list(_leaves(shard)))
    log(f"[dryrun] measured: shard_params(tp={tp}, rank=0) requests {held} "
        f"B on the card vs the record's {want} B: {held - want:+d} B over "
        f"{n} tensors; the allocator holds {alloc} B [{card}]")
    if abs(held - want) > DRYRUN_ALLOC_SLACK * n:
        raise AssertionError("[dryrun] the TP rank's weights differ from "
                             "the record's")
    del shard
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 11: context-parallel decode
# ---------------------------------------------------------------------------
# (a) CP_ARCH at full width and depth, bf16, at TP CP_TP: its one KV head
# does not divide the model axis, so the cache's sequence is cut over it
# (cache_pspecs); CP_B rows at CP_S positions, a span of CP_S / CP_TP keys
# a rank; CP_STEPS decode steps from CP_POS: row 0 in rank 0's span only
# (rank 1 holds none of its keys), row 1 crossing from rank 0's span into
# rank 1's; then CP_PARITY_LAYERS layers in fp32, TF32 off
CP_ARCH, CP_TP = "paligemma-3b", 2
CP_B, CP_S, CP_STEPS, CP_PARITY_LAYERS = 8, 32_768, 4, 4
CP_POS = (1_000, 16_382, 16_384, 20_000, 24_000, 28_000, 32_000, 32_764)
CP_SEED = 25
# (b) CP_RING_ARCH's long_500k ring at (data CP_RING_DP, model 1), batch 1:
# the sliding window's ring cut over data, the positions past 524,287 (the
# ring has wrapped), CP_PARITY_LAYERS layers, fp32
CP_RING_ARCH, CP_RING_DP, CP_RING_POS = "qwen3-4b", 2, 524_288 + 37
# (c), (c') each CP_RANK_ARCHS' decode_32k rank 0 of the 16 x 16 grid,
# allocated; the rank's peak when it held its whole sequence (GB, host
# counts of the dry run before the sequence cut: minicpm-2b's GQA cache,
# deepseek-v2-lite-16b's MLA latents)
CP_RANK_ARCHS = {"minicpm-2b": 103.478, "deepseek-v2-lite-16b": 10.455}
# (e) CP_MLA_ARCH at full width cut to CP_MLA_LAYERS layers (its dense MLA
# layer and three MLA + MoE layers), fp32, TF32 off, at TP CP_TP: the
# latents cut over model as (a)'s cache (CP_B x CP_S from CP_POS), both
# mla_absorb values, within CP_MLA_TOL x max|logit| of TP 1's whole cache
CP_MLA_ARCH, CP_MLA_LAYERS, CP_MLA_TOL = "deepseek-v2-lite-16b", 4, 1e-5
# (d) the kernel's log-sum-exp in bf16, (atol, rtol): l sums the bf16
# rounded P, about 2^-9 of each key's weight, so log l moves by at most
# ~2e-3; fp32 at TOL
LSE_BF16_TOL = (1e-2, 1e-3)
CARD_BYTES = 80e9


def phase_cp():
    """(d) the kernel alone with its log-sum-exp and key offset, (a) CP_ARCH
    at TP CP_TP over the sequence and, in the same spawn, (e) CP_MLA_ARCH's
    MLA latents over it, (b) the wrapped long_500k ring over the data
    axis, (c) and (c') a decode_32k rank of the 16 x 16 grid allocated on
    the card. Every rank on card 0 over gloo. Returns (a)'s kernel path's
    launch counts on rank 0 (MLA runs no kernel: (e) checks that it
    launched none)."""
    from repro_torch.kernels import _build
    _build.build_all()
    torch.cuda.empty_cache()
    card = card_line()
    log(f"[cp] every rank on cuda:0 over gloo (share_card): each decode "
        "layer's all-gather copies through host memory, so no CP speed is "
        f"claimed [{card}]")
    cp_kernel(card)
    counts = cp_model(card)
    cp_ring(card)
    for arch in CP_RANK_ARCHS:
        cp_rank(card, arch)
    return counts


def _cp_cache(cfg, B, S, dtype, seed, sliding=False):
    """A whole slab (or ring) cache on the card, every leaf drawn normal
    from ``seed`` (the same bits in every process)."""
    from repro_torch.core.device import DeviceContext
    from repro_torch.models.transformer import _build_cache
    dev = torch.device("cuda")
    cache = _build_cache(cfg, B, S, dtype, sliding, dev,
                         ctx=DeviceContext(cfg, dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    for c in cache:
        for t in c:
            t.normal_(generator=gen)
    return cache


def _cp_steps(cfg, positions):
    """CP_STEPS (tokens (B, 1), positions (B,)) from CP_SEED."""
    rng = np.random.default_rng(CP_SEED)
    B = len(positions)
    return [(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32),
             np.asarray(positions, np.int32) + i) for i in range(CP_STEPS)]


def _cp_decode(model, cache, steps, sliding=False):
    """(fp32 logits of every step (steps, B, V) on the host, wall ms a step
    on the host clock, synchronised)."""
    dev, out = model.device, []
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.no_grad():
        for tok, pos in steps:
            lg, cache = model.decode_step(
                cache, torch.from_numpy(tok).to(dev),
                torch.from_numpy(pos).to(dev), sliding=sliding)
            out.append(lg.float())
    torch.cuda.synchronize()
    ms = (time.time() - t0) / len(steps) * 1e3
    return torch.stack(out).cpu().numpy(), ms


def _cp_cases():
    """(label, config, dtype) of (a): full depth bf16, then the cut fp32."""
    from repro_torch.configs import get_config
    return (("bf16", get_config(CP_ARCH), torch.bfloat16),
            (f"fp32 {CP_PARITY_LAYERS} layers",
             _cut(CP_ARCH, CP_PARITY_LAYERS), torch.float32))


def _agree(got, want, vocab):
    """(max abs diff, max |want|, share of rows whose argmax agrees)."""
    got, want = got[..., :vocab], want[..., :vocab]
    return (float(np.abs(got - want).max()), float(np.abs(want).max()),
            float((got.argmax(-1) == want.argmax(-1)).mean()))


def cp_model(card):
    """(a) TP 1 with the whole cache (plain path) here, then CP_TP ranks
    each holding its span: the CP kernel path against the TP 1 logits and
    against the CP plain path; fp32 within PARITY_TOL is the hard check,
    bf16 prints its error and argmax agreement; both ranks' logits bitwise
    equal; the kernel path launches duet_attention once a layer a step."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    want = {}
    for label, cfg, dtype in _cp_cases():
        model = Model.init(cfg, seed=0, dtype=dtype, device="cuda")
        cache = _cp_cache(cfg, CP_B, CP_S, dtype, CP_SEED)
        want[label], ms = _cp_decode(model, cache, _cp_steps(cfg, CP_POS))
        kv = sum(t.numel() * t.element_size() for c in cache for t in c)
        log(f"[cp] {CP_ARCH} {label} TP 1, whole cache ({_gb(kv)} GB of "
            f"KV, {CP_B} x {CP_S}), plain path: {ms:.1f} ms a step (wall) "
            f"[{card}]")
        del model, cache
        torch.cuda.empty_cache()
    t_mla = time.time()
    want_mla = cp_mla_reference(card)
    t_mla = time.time() - t_mla
    ranks = run_ranks(cp_model_rank, CP_TP, device="cuda", share_card=True)
    cp_mla_check(card, ranks, want_mla, t_mla)
    for label, cfg, _ in _cp_cases():
        V = cfg.vocab_size
        for path in ("kernel", "plain"):
            if not np.array_equal(ranks[0][label][path],
                                  ranks[1][label][path]):
                raise AssertionError(f"[cp] {label} {path}: the ranks' "
                                     "logits differ")
        r0 = ranks[0][label]
        for r, res in enumerate(ranks):
            log(f"[cp] {CP_ARCH} {label} rank {r}: {res[label]['line']} "
                f"[{card}]")
        if label == "bf16":
            for what, ref in (("TP 1 whole-cache plain path", want[label]),
                              ("CP plain path", r0["plain"])):
                if not np.isfinite(r0["kernel"]).all():
                    raise AssertionError("[cp] kernel path logits not "
                                         "finite")
                err, scale, same = _agree(r0["kernel"], ref, V)
                log(f"[cp] {CP_ARCH} bf16, {CP_STEPS} steps from "
                    f"{list(CP_POS)}: CP kernel path against the {what}: "
                    f"max abs diff {err:.3e} of max|logit| {scale:.3g}, "
                    f"argmax agrees on {same:.3f} of the rows (both ranks "
                    f"bitwise equal) [{card}]")
        else:
            checks = [(f"CP {path} path vs TP 1 whole cache, {CP_STEPS} "
                       f"steps (both ranks bitwise equal)",
                       torch.from_numpy(r0[path]),
                       torch.from_numpy(want[label]))
                      for path in ("kernel", "plain")]
            _check_parity(f"{CP_ARCH} TP {CP_TP} CP", CP_PARITY_LAYERS, cfg,
                          checks)
    log(f"[cp] (a) done in {time.time() - t0:.1f} s")
    return ranks[0]["counts"]


def cp_model_rank(rank):
    """(a) One rank (a spawned process): its context over the sequence
    group cache_seq_axes names, the model from seed 0 (its slices), the
    whole random cache cut to its span by shard_cache, then CP_STEPS
    decode steps on the kernel path (launches counted) and on a copy of
    its span on the plain path, for each of _cp_cases."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.models.transformer import cache_seq_axes, shard_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for label, cfg, dtype in _cp_cases():
        axes = cache_seq_axes(cfg, rank.grid, CP_B)
        if axes != ("model",):
            raise AssertionError(f"[cp] {CP_ARCH}: sequence axes {axes}")
        ctx = rank.context(cfg, seq_axes=axes)
        model = Model.init(cfg, seed=0, dtype=dtype, ctx=ctx,
                           attn_kernel=True)
        whole = _cp_cache(cfg, CP_B, CP_S, dtype, CP_SEED)
        span = shard_cache(whole, cfg, rank.grid, CP_B, rank.rank)
        del whole
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        copy_ = [type(c)(*(t.clone() for t in c)) for c in span]
        steps = _cp_steps(cfg, CP_POS)
        reset_launch_counts()          # the CP kernel path starts here
        got, kms = _cp_decode(model, span, steps)
        counts = {k: n for k, n in launch_counts().items() if n}
        plain = copy.copy(model)
        plain.attn_kernel = False
        pgot, pms = _cp_decode(plain, copy_, steps)
        want = CP_STEPS * cfg.num_layers
        if counts.get("duet_attention") != want:
            raise AssertionError(f"[cp] {label}: the kernel path launched "
                                 f"{counts}, want duet_attention x {want}")
        kv = sum(t.numel() * t.element_size() for c in span for t in c)
        w = sum(t.numel() * t.element_size()
                for t in model.params.buffers())
        out[label] = {"kernel": got, "plain": pgot, "line": (
            f"sequence group {ctx.seq} over {axes}, span of "
            f"{span[0].k.shape[1]} keys from {ctx.seq_span(CP_S)[0]}, "
            f"{_gb(kv)} GB of KV (x2: the plain path's copy) and {_gb(w)} "
            f"GB of weights; kernel path {kms:.1f} ms a step (wall), plain "
            f"{pms:.1f}; {ctx.seq_gathers} all-gathers in "
            f"{2 * CP_STEPS} steps; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
            f"{counts}")}
        if label == "bf16":
            out["counts"] = counts
        del model, plain, span, copy_
        torch.cuda.empty_cache()
    out["mla"] = cp_mla_rank(rank)
    return out


def cp_mla_reference(card):
    """(e) TP 1 with CP_MLA_ARCH's whole latents, fp32, TF32 off: the
    logits of CP_STEPS decode steps from CP_POS for each mla_absorb."""
    from repro_torch.models import Model
    cfg = _cut(CP_MLA_ARCH, CP_MLA_LAYERS)
    model = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda")
    cache = _cp_cache(cfg, CP_B, CP_S, torch.float32, CP_SEED + 2)
    lat = sum(t.numel() * t.element_size() for c in cache for t in c)
    out = {}
    for absorb in (False, True):
        model.mla_absorb = absorb
        out[absorb], ms = _cp_decode(
            model, [type(c)(*(t.clone() for t in c)) for c in cache],
            _cp_steps(cfg, CP_POS))
        log(f"[cp] (e) {CP_MLA_ARCH} {CP_MLA_LAYERS} layers fp32 TP 1, "
            f"whole latents ({_gb(lat)} GB, {CP_B} x {CP_S}), mla_absorb "
            f"{absorb}: {ms:.1f} ms a step (wall) [{card}]")
    del model, cache
    torch.cuda.empty_cache()
    return out


def cp_mla_rank(rank):
    """(e) One rank: its context over the sequence group cache_seq_axes
    names for CP_MLA_ARCH (``model``: MLA's latents), the model from seed
    0 (its heads and experts), the whole random latents cut to its span
    by shard_cache, CP_STEPS decode steps for each mla_absorb, with the
    all-gathers and the kernel launches each made."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.models.transformer import cache_seq_axes, shard_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _cut(CP_MLA_ARCH, CP_MLA_LAYERS)
    axes = cache_seq_axes(cfg, rank.grid, CP_B)
    if axes != ("model",):
        raise AssertionError(f"[cp] {CP_MLA_ARCH}: sequence axes {axes}")
    ctx = rank.context(cfg, seq_axes=axes)
    model = Model.init(cfg, seed=0, dtype=torch.float32, ctx=ctx)
    whole = _cp_cache(cfg, CP_B, CP_S, torch.float32, CP_SEED + 2)
    span = shard_cache(whole, cfg, rank.grid, CP_B, rank.rank)
    del whole
    torch.cuda.empty_cache()
    steps = _cp_steps(cfg, CP_POS)
    out = {}
    for absorb in (False, True):
        model.mla_absorb = absorb
        g0 = ctx.seq_gathers
        reset_launch_counts()
        got, ms = _cp_decode(model, [type(c)(*(t.clone() for t in c))
                                     for c in span], steps)
        out[absorb] = {"logits": got, "ms": ms,
                       "gathers": ctx.seq_gathers - g0,
                       "launches": {k: n for k, n in launch_counts().items()
                                    if n}}
    lat = sum(t.numel() * t.element_size() for c in span for t in c)
    out["line"] = (f"sequence group {ctx.seq} over {axes}, a span of "
                   f"{span[0].ckv.shape[1]} latents from "
                   f"{ctx.seq_span(CP_S)[0]}, {_gb(lat)} GB, "
                   f"{ctx.local_experts} experts, heads "
                   f"{model.params['layers'][0]['attn']['w_uv'].shape[1]}"
                   f" of {cfg.num_heads}")
    return out


def cp_mla_check(card, ranks, want, ref_s):
    """(e) the ranks' logits for each mla_absorb: bitwise equal, within
    CP_MLA_TOL x max|logit| of TP 1's whole latents, 2 all-gathers an MLA
    layer a step (the query gather and the combine), no kernel launched
    (the reference has no MLA kernel)."""
    from repro_torch.configs.base import MLA_KINDS
    cfg = _cut(CP_MLA_ARCH, CP_MLA_LAYERS)
    n_mla = sum(k in MLA_KINDS for k in cfg.block_pattern)
    V = cfg.vocab_size
    for r, res in enumerate(ranks):
        log(f"[cp] (e) {CP_MLA_ARCH} rank {r}: {res['mla']['line']}")
    for absorb in (False, True):
        res = [r["mla"][absorb] for r in ranks]
        if not all(np.array_equal(x["logits"], res[0]["logits"])
                   for x in res):
            raise AssertionError(f"[cp] (e) mla_absorb {absorb}: the ranks' "
                                 "logits differ")
        got, ref = res[0]["logits"][..., :V], want[absorb][..., :V]
        err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
        gathers = [x["gathers"] for x in res]
        launches = [x["launches"] for x in res]
        log(f"[cp] (e) {CP_MLA_ARCH} {CP_MLA_LAYERS} layers fp32 TP "
            f"{CP_TP} CP over model, mla_absorb {absorb}, {CP_STEPS} steps "
            f"from {list(CP_POS)}: max abs diff {err:.3e} of max|logit| "
            f"{scale:.3g} against TP 1's whole latents (tol "
            f"{CP_MLA_TOL:.0e} x max|logit|; both ranks bitwise equal); "
            f"{gathers[0] / CP_STEPS:.1f} all-gathers a step ({n_mla} MLA "
            f"layers); {res[0]['ms']:.1f} ms a step (wall, gloo); kernel "
            f"launches {launches[0] or 'none'} [{card}]")
        if not (np.isfinite(got).all() and err <= CP_MLA_TOL * scale):
            raise AssertionError(f"[cp] (e) mla_absorb {absorb}: max abs "
                                 f"diff {err:.3e} > {CP_MLA_TOL:.0e} x "
                                 f"{scale:.3g}")
        if any(g != 2 * n_mla * CP_STEPS for g in gathers):
            raise AssertionError(f"[cp] (e) all-gathers {gathers}, want "
                                 f"{2 * n_mla * CP_STEPS} a rank")
        if any(launches):
            raise AssertionError(f"[cp] (e) MLA launched kernels "
                                 f"{launches}")
    log(f"[cp] (e) TP 1 references {ref_s:.1f} s; MLA runs no kernel "
        f"(the reference has none): its path launched none [{card}]")


def cp_ring(card):
    """(b) CP_RING_ARCH cut to CP_PARITY_LAYERS layers, fp32, TF32 off,
    batch 1: the long_500k ring (the sliding window) whole on one model
    here, then cut over the data axis of (data CP_RING_DP, model 1), each
    rank its span of the ring, CP_STEPS sliding decode steps from
    CP_RING_POS: logits within PARITY_TOL, both ranks bitwise equal."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    cfg = _cut(CP_RING_ARCH, CP_PARITY_LAYERS)
    model = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda")
    ring = _cp_cache(cfg, 1, SHAPES["long_500k"].seq_len, torch.float32,
                     CP_SEED + 1, sliding=True)
    want, ms = _cp_decode(model, ring, _cp_steps(cfg, [CP_RING_POS]),
                          sliding=True)
    W = ring[0].k.shape[1]
    del model, ring
    torch.cuda.empty_cache()
    ranks = run_ranks(cp_ring_rank, 1, dp=CP_RING_DP, device="cuda",
                      share_card=True)
    if not np.array_equal(ranks[0]["logits"], ranks[1]["logits"]):
        raise AssertionError("[cp] ring: the ranks' logits differ")
    for r, res in enumerate(ranks):
        log(f"[cp] {CP_RING_ARCH} long_500k ring rank {r}: {res['line']} "
            f"[{card}]")
    _check_parity(f"{CP_RING_ARCH} DP {CP_RING_DP} CP ring",
                  CP_PARITY_LAYERS, cfg,
                  [(f"sliding decode, ring of {W} wrapped, {CP_STEPS} steps "
                    f"from {CP_RING_POS}, vs the whole ring ({ms:.1f} ms a "
                    "step) (both ranks bitwise equal)",
                    torch.from_numpy(ranks[0]["logits"]),
                    torch.from_numpy(want))])
    log(f"[cp] (b) done in {time.time() - t0:.1f} s")


def cp_ring_rank(rank):
    """(b) One rank (a spawned process) of the ring's data axis."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.models import Model
    from repro_torch.models.transformer import cache_seq_axes, shard_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _cut(CP_RING_ARCH, CP_PARITY_LAYERS)
    axes = cache_seq_axes(cfg, rank.grid, 1)
    if axes != ("data",):
        raise AssertionError(f"[cp] ring: sequence axes {axes}")
    ctx = rank.context(cfg, seq_axes=axes)
    model = Model.init(cfg, seed=0, dtype=torch.float32, ctx=ctx)
    whole = _cp_cache(cfg, 1, SHAPES["long_500k"].seq_len, torch.float32,
                      CP_SEED + 1, sliding=True)
    span = shard_cache(whole, cfg, rank.grid, 1, rank.rank, sliding=True)
    del whole
    got, ms = _cp_decode(model, span, _cp_steps(cfg, [CP_RING_POS]),
                         sliding=True)
    return {"logits": got, "line": (
        f"sequence group {ctx.seq} over {axes}, ring span of "
        f"{span[0].k.shape[1]} slots from {ctx.seq_span(ctx.seq * span[0].k.shape[1])[0]}; "
        f"{ms:.1f} ms a step (wall), plain path (the reference's: no "
        f"kernel under sliding); {ctx.seq_gathers} all-gathers")}


def cp_rank(card, arch):
    """(c) ``arch``'s decode_32k rank 0 of the 16 x 16 grid built on the
    card (one of CP_RANK_ARCHS: (c') is deepseek's, its MLA latents cut
    over model): its weight shards (``init_params(tp=16, rank=0)``) and
    its span of the cache (``init_cache`` under its sequence group), the
    bytes they request against the record's arguments within
    DRYRUN_ALLOC_SLACK a tensor; the record's peak under the card's 80 GB.
    No step runs (its peers do not exist)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.core.device import DeviceContext
    from repro_torch.launch.mesh import make_production_mesh, seq_group
    from repro_torch.models.params import (_leaves, init_params,
                                           tp_adjusted_config)
    from repro_torch.models.transformer import _build_cache, cache_seq_axes
    rec = next(r for r in DRYRUN_COUNTS.get("sweep") if r["arch"] == arch)
    args = rec["memory"]["argument_size_in_bytes"]
    peak = rec["rank_memory"]["peak_bytes"]
    log(f"[cp] prediction: {arch} decode_32k rank 0 of "
        f"{rec['mesh']}: arguments {args} B, rank entry "
        f"{rec['rank_memory']['entry_bytes']} B, peak {peak} B (host "
        f"counts; its peak with the whole sequence {CP_RANK_ARCHS[arch]} "
        "GB)")
    grid = make_production_mesh()
    tp = grid.shape["model"]
    shape = SHAPES["decode_32k"]
    cfg = tp_adjusted_config(get_config(arch), tp)
    B = shape.global_batch // grid.shape["data"]
    axes = cache_seq_axes(cfg, grid, shape.global_batch)
    seq, seq_rank, _ = seq_group(axes, grid.shape["data"], tp, 0, None,
                                 None)
    dev = torch.device("cuda")
    ctx = DeviceContext(cfg, dev, tp=tp, rank=0, seq=seq, seq_rank=seq_rank)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = _requested()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         torch.bfloat16, dev, tp=tp, rank=0)
    torch.cuda.synchronize()
    got_w = _requested() - base
    cache = _build_cache(cfg, B, shape.seq_len, torch.bfloat16, False, dev,
                         ctx=ctx)
    token = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros((B,), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    held = _requested() - base
    n = len(list(_leaves(params))) + sum(len(c) for c in cache) + 2
    log(f"[cp] measured: {arch} rank 0 (sequence group {seq} over "
        f"{axes}, a span of {cache[0][0].shape[1]} positions of "
        f"{type(cache[0]).__name__} {list(cache[0][0].shape)}, {B} rows): "
        f"its tensors request "
        f"{held} B vs the record's arguments {args} B ({held - args:+d} B "
        f"over {n} tensors, slack {DRYRUN_ALLOC_SLACK} B a tensor); weights "
        f"{got_w} B vs {rec['rank_memory']['weight_bytes']} B; the record's "
        f"peak {_gb(peak)} GB {'<' if peak < CARD_BYTES else '>='} 80 GB "
        f"[{card}]")
    del params, cache, token, pos
    torch.cuda.empty_cache()
    if abs(held - args) > DRYRUN_ALLOC_SLACK * n:
        raise AssertionError(f"[cp] {arch}: the rank's bytes differ from "
                             "the record's arguments")
    if peak >= CARD_BYTES:
        raise AssertionError(f"[cp] {arch}: the record's peak exceeds the "
                             "card")


def cp_kernel(card):
    """(d) the slab duet_attention kernel with its log-sum-exp and the key
    offset, alone, at CP_ARCH's rank span (CP_B rows of CP_ARCH's heads,
    CP_S / CP_TP keys) and at granite-20b's block role over as many
    keys: out and lse against the plain version with the rows of CP_POS
    as rank 1 sees them (before its span: dead; inside; past it), bf16
    and fp32; then, every row past the span (all of it live), the kernel
    with and without lse timed hot and cold beside its bound (the span's
    KV bytes at 3.35 TB/s), its plain version and SDPA. These launches
    are checks: they join no count."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.duet_attention import (cluster_for,
                                                    duet_attention,
                                                    duet_attention_plain,
                                                    slab_role)
    S, base = CP_S // CP_TP, CP_S // CP_TP
    dev = "cuda"
    for name in (CP_ARCH, "granite-20b"):
        cfg = get_config(name)
        H, G, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        rng = np.random.default_rng(26)
        for dtype in (torch.float32, torch.bfloat16):
            def draw(shape):
                return torch.from_numpy(rng.standard_normal(
                    shape, np.float32)).to(dev, dtype)
            q, k, v = draw((CP_B, H, Dh)), draw((CP_B, S, G, Dh)), \
                draw((CP_B, S, G, Dh))
            slot = torch.arange(CP_B, dtype=torch.int32, device=dev)
            mixed = torch.tensor(np.asarray(CP_POS) - base, device=dev,
                                 dtype=torch.int32)[:, None]
            past = torch.full_like(mixed, S + 100)
            rec = {"name": "duet_attention" if slab_role(1, H // G)
                   == "decode" else "duet_attention[block]"}
            for label, rp in (("mixed", mixed), ("past", past)):
                got, lse = duet_attention(q, rp, slot, k, v, block_q=1,
                                          return_lse=True)
                torch.cuda.synchronize()
                want, wlse = duet_attention_plain(q, rp, slot, k, v,
                                                  block_q=1,
                                                  return_lse=True)
                bf16 = dtype == torch.bfloat16
                _check(rec["name"], got, want, dtype, f"{label} out", rec,
                       ATTN_BF16_TOL if bf16 else None)
                err_out = rec["max_abs_err"]
                if not torch.equal(torch.isneginf(lse), torch.isneginf(wlse)):
                    raise AssertionError(f"[cp] {name} {label}: the "
                                         "kernel's -inf rows differ")
                fin = torch.isfinite(wlse)
                _check(rec["name"], lse[fin], wlse[fin], dtype,
                       f"{label} lse", rec, LSE_BF16_TOL if bf16 else None)
                log(f"[cp] {rec['name']} {name} {H}/{G}/{Dh}, {CP_B} rows "
                    f"over a span of {S} keys, rows {label} "
                    f"({rp[:, 0].tolist()}), {dtype}: out max abs err "
                    f"{err_out:.3e}, lse {rec['max_abs_err']:.3e} (tol "
                    f"{rec['tol']:.0e}/{rec['rtol']:.0e}); "
                    f"{int((~fin).sum())} dead (row, head) pairs at -inf")
            if dtype != torch.bfloat16:
                continue
            kern = lambda: duet_attention(  # noqa: E731
                q, past, slot, k, v, block_q=1, return_lse=True)
            nolse = lambda: duet_attention(  # noqa: E731
                q, past, slot, k, v, block_q=1)
            plain = lambda: duet_attention_plain(  # noqa: E731
                q, past, slot, k, v, block_q=1, return_lse=True)
            elt = q.element_size()
            nbytes = (2 * CP_B * S * G * Dh * elt + 2 * CP_B * H * Dh * elt
                      + 4 * CP_B * H + 8 * CP_B)
            rec["bound_ms"], rec["bound_by"] = _bound(
                nbytes, 4.0 * H * Dh * CP_B * S, dtype)
            _time_kernel(kern, rec)
            off = {}
            _time_kernel(nolse, off)
            rec["plain_ms"] = time_ms(plain, iters=3)
            kk = k.repeat_interleave(H // G, dim=2).transpose(1, 2)
            vv = v.repeat_interleave(H // G, dim=2).transpose(1, 2)
            fn = torch.nn.functional.scaled_dot_product_attention
            qq = q[:, :, None, :]
            rec["library_ms"] = time_ms(lambda: fn(qq, kk, vv))
            del kk, vv
            log(f"[cp] {rec['name']} {name} bf16, {CP_B} rows over the "
                f"whole span of {S} keys, C={cluster_for(q, slot, k, 1)}: "
                f"with lse {rec['ms']:.4f} ms hot, {rec['cold_ms']:.4f} "
                f"cold; without lse {off['ms']:.4f} hot, "
                f"{off['cold_ms']:.4f} cold; bound {rec['bound_ms']:.4f} "
                f"({rec['bound_by']}), {100 * rec['bound_ms'] / rec['cold_ms']:.1f}"
                f"% of cold with lse; plain {rec['plain_ms']:.4f}; SDPA "
                f"{rec['library_ms']:.4f} [{card}]")
    torch.cuda.empty_cache()


def run_phases(phases):
    """Run the chosen phases in PHASES' order: the kernels' records, and
    the kernels' launch counts on the main path."""
    main_rec, counts = {}, {}
    for phase in (p for p in PHASES if p in phases):
        t_phase = time.time()
        if phase == "build":
            phase_build()
        elif phase == "roofline":
            main_rec["sm_probe"] = phase_roofline()
            counts["sm_probe"] = main_rec["sm_probe"]["launches"]
        elif phase == "kernels":
            main_rec.update(phase_kernels())
        elif phase == "parity":
            phase_parity()
        elif phase == "serve":
            counts.update(phase_serve())
        elif phase == "tp":
            main_rec["paged_decode_sharded"], tp_counts = phase_tp()
            for name, n in tp_counts.items():
                counts[name] = counts.get(name, 0) + n
        elif phase == "dp":
            for name, n in phase_dp().items():
                counts[name] = counts.get(name, 0) + n
        elif phase == "train":
            phase_train()
        elif phase == "grid":
            for name, n in phase_grid().items():
                counts[name] = counts.get(name, 0) + n
        elif phase == "dryrun":
            phase_dryrun()
        elif phase == "cp":
            for name, n in phase_cp().items():
                counts[name] = counts.get(name, 0) + n
        log(f"[time] {phase} phase {time.time() - t_phase:.1f} s")
    return main_rec, counts


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke test "
              "needs one card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} card {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    global DRYRUN_COUNTS
    if {"train", "dryrun", "cp"} & set(phases):
        DRYRUN_COUNTS = DryrunCounts()
    try:
        main_rec, counts = run_phases(phases)
    finally:
        if DRYRUN_COUNTS is not None:
            DRYRUN_COUNTS.stop()
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        rec = main_rec.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": counts.get(name) if counts else None,
            "max_abs_err": rec.get("max_abs_err"), "ms": rec.get("ms"),
            "cold_ms": rec.get("cold_ms"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"),
            "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms")})
    log(f"[done] {time.time() - t0:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
