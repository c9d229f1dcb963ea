#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (Hopper, sm_90a):

    python3 chip_smoke.py

It builds the kernels from ``src/repro_torch/csrc`` into
``build/kernels/`` (one ``nvcc`` per source, all at once), holds the four
signature kernels against their plain PyTorch versions at the width of
the paper's webspam (trigram) dataset, and ``minhash4u`` on an edge chunk
(indices and coefficients at and past the edge of the domain where its
power-sum form holds), then drives the paper's main path
-- §3 GPU preprocessing -> packed ``.sig`` cache -> §6 online SGD -- and
the §3 batch entry point ``preprocess_shards``, and checks what comes
out.  Phase 5 drives retrieval at rcv1's document count: ``.sig`` ->
banded ``.idx`` -> ``IndexSearcher`` exact and LSH flushes -> a 4-shard
``ShardedIndex``, holding the ``packed_match`` kernel against its plain
version (the corpus, odd shapes, every code width that divides 32) and
every search against the same searcher scoring through the
plain version.  Phase 2 also holds ``sigbag`` on an edge set on both
sides of its dispatch rule (staged slot tables and direct gather).  Phase
6 serves the published Wide & Deep (40 fields x 1,000,000 rows x d = 32,
MLP 1024-512-256, minhash frontend k = 64, b = 8) through
``serve_scores`` in its two serving cells, ``serve_p99`` (512 rows a
request) and ``serve_bulk`` (262,144), holding ``sigbag`` and
``minhash2u`` at the frontend's shapes against their plain versions and
the served scores against the same model scoring through the plain
versions, and runs the ``repro_torch.launch.serve --arch wide-deep
--no-smoke`` entry point.  Phase 7 serves phase 5's corpus through
``SearchServer``.  Phase 8 drives the paper's batch-learning path on
phase 3's rows: permutations vs 2U vs 4U (Fig. 4) through
``minhash_signatures`` and ``Trainer``, a restarted fit, the VW baseline,
``online_epochs``, offline dedup and the Appendix-A estimator.  Phase 9
drives the rest of the recsys family at its published widths: AutoInt
(39 fields x 1,000,000 x d = 16, with the frontend), DIN and MIND in all
four cells (``serve_p99``, ``serve_bulk``, ``retrieval_cand`` at
1,000,000 candidates in chunks, ``train_batch`` at 65,536 rows with the
fused Adafactor step) and Wide & Deep in the last two, holding ``sigbag``
at d = 16 in both designs and ``minhash2u`` at AutoInt's frontend
bit-exact against their plain versions, AutoInt's scores against the
plain frontend, DIN's and MIND's against the same code in float64, the
frontend table's gradient against autograd through ``sigbag_plain``, a
restarted DIN fit against the unfailed one, and both launchers.  Phase
10 serves the five LM archs at their published widths in bfloat16, depth
and batch cut to fit the card (``LM_RUNS``): a timed prefill and a timed
greedy decode of each through ``build_cell`` / ``init_inputs`` /
``step`` beside their bounds, then at depth 2 bfloat16 against the same
weights in float32, float32 decode against prefill, each decode step
writing the cache at pos - 1 only, deepseek-v3's MoE dispatch against a
per-token loop, and ``launch.serve --arch`` for each arch; the LM path
runs none of the six kernels (the reference's attention and MoE are plain
jnp).  Phase 11 trains the five LM archs at their published widths in
bfloat16 (``LM_TRAIN_RUNS``): timed ``train_4k`` steps through
``build_cell`` / ``init_inputs`` / ``step`` with the published optimizer
and microbatch count beside their FLOP bound, ``matmul_f32``'s bfloat16
backward against widened autograd, at depth 2 bfloat16 against float32
(MoE routing replayed), microbatched against one-batch gradients, remat
against none and an optimizer step moving every leaf, and ``launch.train
--arch`` for each arch with a resumed run; no kernel of ours runs there
either.  Phase 12 trains GatedGCN at its published config (16 layers, d
70, remat, float32) in its four cells (``ogb_products`` cut by
``OGB_CUT``, ``minibatch_lg`` on subgraphs that ``neighbor_sample`` draws
from a reddit-size CSR graph on the card, its time and invariants
checked), each step timed beside ``gnn_bound``, then the layer against a
float64 oracle, remat against none and a resumed ``launch.train --arch
gatedgcn`` against the unbroken run under deterministic algorithms; no
kernel of ours either (the reference's scatter is plain jnp).  Scratch data goes to ``build/smoke/`` and is removed at the end.  It
exits non-zero, with no result line, when there is no CUDA device, when
it is not run from a checkout, or when any check fails.

Output: one line per phase and kernel, the card's name and power limit,
a ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SMOKE_DIR = ROOT / "build" / "smoke"

# Published H100 SXM rates (NVIDIA data sheet; full 700 W power limit):
# HBM3 at 3.35 TB/s, and 67 TFLOP/s float32 outside the tensor cores,
# i.e. 33.5e12 lane-instructions/s (128 lanes per SM, an FMA counted
# once) -- the dispatch rate that also bounds 32-bit integer instructions.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
# The least 32-bit lane-instructions each function needs, in sm_90 SASS
# forms.  2U hash: one IMAD (a1 + a2*t, mod 2^32); variant high's shift
# keeps the order of values, min(v >> x) == (min v) >> x, so minhash needs
# it once per (row, j) and OPH, which splits every value, once per
# nonzero.  4U hash by Horner (OPH, one evaluation per nonzero): three
# steps of 6 -- IMAD.WIDE.U32 (acc*t + coef, mod 2^64), each fold as LOP3
# (x & p) + LEA.HI (adding the funnel shift), the conditional subtract as
# one VIADDMNMX.U32, min(v, v - p) -- then the s-bit mask.  4U minhash
# shares the powers of t across its k functions: per nonzero, t^2 and t^3
# mod p, two BitMod products of 6 as above; per (nonzero, j), three
# IMAD.WIDE.U32 chained into one 64-bit sum a0 + a1 t + a2 t^2 + a3 t^3,
# its reduction (OPS_REDUCE4, see below), and the s-bit mask.  Minhash's
# running min takes half a VIMNMX3 per (nonzero, j) (a three-input min
# folds in two values); its epilogue takes the b-bit mask and, packed,
# one IMAD per code.  OPH takes bin, offset, the bin's shared address and
# the atomicMin per nonzero, and three per bin to write sentinel codes.
# (minhash2u_kernel's loop is these forms exactly: 64 IMAD, 32
# VIMNMX3.U32 and 4 LDS.128 per 16 nonzeros x 4 functions; its variant
# low runs on coefficients shifted left, so it too shifts once per
# (row, j).  On the H100 IMAD and VIMNMX3 do not issue together at the
# dispatch rate this bound assumes: ~2.6 cycles per warp evaluation, not
# 1.5.  OPH 4U's Horner hash compiles to ~40 instructions with its
# scatter, twice the count here.)
# OPS_REDUCE4, the least reduction of a sum < 2^64 to [0, p): fold 1 in
# 64 bits -- LOP3 (lo & p), SHF.R.U64 (the low word of v >> 31), IADD3
# with carry-out and LEA.HI.X (the high word, hi >> 31 plus the carry) --
# fold 2 as Horner's, LOP3 + LEA.HI, and one VIADDMNMX.U32, min(v, v - p).
# (ptxas emits fold 2 of minhash4u_kernel as SHF.R.U64 + LOP3 + IMAD.IADD,
# one more than the function needs; the bound does not count it.)
OPS_2U, OPS_SHIFT, OPS_4U = 1, 1, 3 * 6 + 1
OPS_REDUCE4 = 7
OPS_MH4U_EVAL, OPS_MH4U_STAGE = 3 + OPS_REDUCE4 + 1, 2 * 6
OPS_MIN, OPS_SCATTER, OPS_CODE = 0.5, 4, 3
# Packed match, per (query, doc, word) when code_bits | 32 (b = 8): the
# zero-field test ~(((x & lo) + lo) | x) & hi of x = q ^ c takes three
# LOP3 and one add ((q ^ c) & lo and y | (q ^ c) as three-input LOP3s, the
# add of lo, the mask of hi); counting takes one more -- the flag bits of
# up to code_bits words are disjoint after a shift, so LEA.HI
# (shift-and-add) folds them ahead of one POPC and one add per code_bits
# words (cuobjdump -sass of swar_kernel<8, false> shows these five).  Straddling codes (9 bits), per (query, doc,
# code): one ISETP for the compare and one predicated IADD; sentinel
# wires split the hit between matches and jointly-EMPTY with a second
# ISETP and IADD.  Pulling a code out of its word pair (SHF funnel shift
# + LOP3 mask) is per (row, code), not per pair.
OPS_MATCH_WORD, OPS_MATCH_CODE, OPS_MATCH_CODE_SENT, OPS_EXTRACT = 5, 2, 4, 2

SEED = 0
K_OPH, K_MIN, K_PAPER, S, B = 512, 512, 500, 24, 8
CHUNK = 10_000
ACC_MARGIN = 0.30      # test accuracy must exceed chance (0.5) by this
REPS = 7               # timed launches per kernel, after one warm-up
# minhash4u edge chunk (phase 2): k, row lengths, indices at the domain's edge
EDGE_K = 128
EDGE_ROWS = (1, 2, 3, 4, 5, 31, 100, 1_023, 1_024, 1_025, 2_047, 2_048,
             2_049, 4_096, 5_000)
EDGE_T = (0, 1, 2**31 - 2, 2**31 - 1)
# minhash2u edge chunk (phase 2): row lengths, k, s, b; every case in both
# variants, and packed where k is a multiple of 128.  k <= 128 runs one
# function a thread; 256, 500 one block of four a thread; 640 and 1,024
# two blocks a row (the second partly live at 640)
EDGE2_ROWS = (0, 1, 2, 3, 4, 5, 31, 2_047, 2_048, 2_049, 5_000)
EDGE2_K = (1, 33, 64, 128, 256, 500, 640, 1_024)
EDGE2_S = (1, 24, 31, 32)
EDGE2_B = (0, 8, 32)
# OPH edge chunk (phase 2): every nnz % 4, and rows longer than one round
# of 16-byte loads (4,096 indices at 256 threads)
OPH_EDGE_NNZ = (125, 126, 127, 128, 20_003)
# sigbag edge set (phase 2), (n, k, 2^b, d, dtype, token offset): n
# "bulk" is SMs x the staged block's rows less half a block (design A
# where the shape allows it, the last block partial), "below" one block
# short of a block per SM (B), other n go to the direct gather (B); k not
# a multiple of the 8-slot token stage (1, 33, 36, 500), 2^b in {16, 256,
# 1024}, d in {1, 8, 31, 32, 33, 64, 128}; offset 1 misaligns the tokens
# (A's 4-byte token copies, B's scalar token loads).  Tokens -1, 2^b and
# 2^31 - 1 are sprinkled in, one row is all out of range.
SIGBAG_EDGES = (
    ("bulk", 1, 256, 32, "float32", 0), ("bulk", 33, 256, 32, "float32", 0),
    ("bulk", 64, 256, 32, "float32", 0), ("bulk", 500, 256, 32, "float32", 0),
    ("bulk", 64, 256, 32, "float32", 1), ("bulk", 36, 16, 8, "float32", 0),
    ("bulk", 33, 256, 64, "float32", 0), ("bulk", 64, 16, 32, "bfloat16", 0),
    ("bulk", 64, 256, 32, "bfloat16", 0), ("bulk", 33, 1024, 32, "bfloat16", 0),
    ("bulk", 64, 256, 8, "bfloat16", 1),
    ("bulk", 64, 1024, 32, "float32", 0), ("bulk", 64, 256, 128, "float32", 0),
    ("bulk", 64, 256, 1, "float32", 0), ("bulk", 33, 256, 31, "bfloat16", 0),
    ("below", 64, 256, 32, "float32", 0), ("below", 64, 256, 32, "bfloat16", 0),
    (512, 64, 256, 32, "float32", 0), (512, 64, 256, 32, "bfloat16", 0),
    (512, 64, 256, 32, "float32", 1), (512, 64, 256, 32, "bfloat16", 1),
    (1, 1, 16, 1, "float32", 0), (3, 500, 256, 1, "bfloat16", 0),
    (257, 33, 16, 8, "float32", 0), (257, 33, 16, 8, "bfloat16", 0),
    (130, 65, 1024, 31, "float32", 0), (130, 65, 256, 33, "bfloat16", 0),
    (130, 128, 256, 33, "float32", 1), (130, 500, 256, 64, "bfloat16", 0),
    (1_000, 64, 256, 128, "float32", 0), (1_000, 64, 256, 128, "bfloat16", 0),
)
# phase 2 times these over a CUDA graph of KERNEL_LOOP launches: one
# launch is too short to rank on by one pair of events
LOOP_TIMED = ("oph2u", "oph4u", "minhash2u")
KERNEL_LOOP = 20

# Retrieval (phase 5): rcv1's document count (Li, Shrivastava & König
# 2012, Table 1), rows 256 nonzeros wide (rcv1 has ~12,062); OPH 2U,
# k = 512, s = 30, b = 8.
N_DOCS, NNZ_DOCS, K_IDX, S_IDX = 677_399, 256, 512, 30
N_QUERIES, TOPK, BLOCK = 256, 10, 4096
SENT_DOCS = 65_536     # sentinel-wire kernel check: the first docs
RAW_SHARDS, SIG_CHUNK, N_SHARDS = 16, 50_000, 4
FLUSH_REPS = {"exact": 5, "lsh": 2}   # timed flushes after the checked one
BLOCK_LOOP = 20        # back-to-back block launches per timed sample

# Search serving (phase 7): phase 5's corpus and shards behind
# SearchServer; open-loop Zipf traffic (alpha 1.1, seed 1, Poisson
# arrivals) at about 60% of what phase 5's direct exact flush reached
SERVE_REQUESTS, SERVE_QPS, SERVE_MAX_BATCH, SERVE_DELAY_S = 2048, 4000.0, 256, 0.005
STREAM_WINDOW = 64 << 20      # device window of the streamed scan, bytes
LSH_QUERIES, LSH_SUB = 64, 32  # held-out queries, lsh_batch
APPEND_REQUESTS, APPEND_QPS = 2048, 2000.0   # over the grown corpus
SOCKET_LSH_QUERIES = 8

# Recsys serving (phase 6): wide-deep CONFIG, cells serve_p99 (batch 512)
# and serve_bulk (262,144 rows).
N_REQUESTS, WARMUP_REQUESTS, CLI_REQUESTS = 128, 3, 16
BULK_ROWS = 262_144
BULK_REQUESTS = 3      # serve_bulk requests after one warm-up
SIGBAG_LOOP = 20       # back-to-back 512-row launches per timed sample

# Batch learning (phase 8): phase 3's webspam-width rows (40,000 train,
# 10,000 test), k = 200, s = 24, as examples/quickstart.py runs the paper's
# Fig. 4 (perm / 2U / 4U) and bbit_vs_vw.py its Figs 10-12
K_BATCH, BATCH_BITS, BATCH_STEPS = 200, (1, 4, 8), 100
FAIL_AT, CKPT_EVERY = 50, 25          # the restarted fit
CHECK_ROWS = 1_000                    # 4U Mod and kernel-vs-plain rows
VW_BITS = (8, 14)                     # equal-k (m = 256) and 2^14 bins
ONLINE_EPOCHS, ONLINE_BATCH = 2, 512
# offline dedup (§1): 20,000 uniform sets of 3,728 ids over [0, 2^24) and
# 2,000 copies of the first 2,000 with 5% of ids replaced (R ~ 0.905)
DEDUP_SETS, DEDUP_DUPS, DEDUP_NNZ, DEDUP_SWAP, DEDUP_SEED = 20_000, 2_000, 3_728, 0.05, 18
DEDUP_BANDS, DEDUP_ROWS, DEDUP_THRESHOLD = 50, 4, 0.8
# Appendix A (examples/resemblance.py): Table 5 pairs at D = 2^18, k = 256,
# 20 repetitions, as one 2U family of 20 x 256 functions for each b
APPX_D_BITS, APPX_K, APPX_REPS, APPX_BITS = 18, 256, 20, (1, 2, 4)

# The rest of the recsys family (phase 9): AutoInt, DIN and MIND at their
# published widths in all four cells; Wide & Deep (phase 6's CONFIG) in
# retrieval_cand and train_batch
FAMILY = ("autoint", "din", "mind", "wide-deep")
FAMILY_REQUESTS, FAMILY_BULK = 32, 3     # serve_p99, serve_bulk requests
RETRIEVAL_QUERIES = 3                    # timed, after one warm-up query
RETRIEVAL_CHECK = 512                    # candidates held to explicit rows
TRAIN_ROWS, TRAIN_STEPS = 65_536, 20
RESTART_STEPS, RESTART_FAIL_AT, RESTART_EVERY = 6, 3, 2   # DIN, restarted
CLI_TRAIN_STEPS = 5
# float32 against the same code in float64 (DIN, MIND): rtol, and an atol
# of this share of the largest |logit|.  Products of <= 200 terms in
# float32 carry ~1e-6 relative rounding; TF32 is off in the phase.
F64_RTOL = F64_ATOL_SHARE = 1e-4
# the same rows scored in a 65,536-candidate chunk and as a 512-row batch:
# cuBLAS may pick another algorithm for each shape
CHUNK_RTOL = CHUNK_ATOL_SHARE = 1e-5
# sigbag's table gradient by the scatter-add against autograd through
# sigbag_plain: both sum the same terms, in other orders (atomics)
GRAD_ATOL_SHARE = 1e-5

# LM serving (phase 10): each arch at its published widths in bfloat16,
# depth and batch cut to fit one 80 GB card: arch -> (layers, prefill
# positions, decode cell, decode batch, decode steps).  Cuts: deepseek-7b
# prefill batch 32 -> 1, decode_32k batch 128 -> 2; llama4-scout 48 -> 4
# layers (3 chunked-local + 1 global), prefill batch 32 -> 1; deepseek-v3
# 61 -> 4 layers (its 3 dense + 1 MoE), prefill 32 x 32,768 -> 1 x 8,192,
# decode_32k batch 128 -> 8; yi-34b 60 -> 2, mistral-large 88 -> 2 layers,
# prefill 32 x 32,768 -> 1 x 4,096, decode_32k batch 128 -> 2.
LM_RUNS = {
    "deepseek-7b": (30, 32_768, "decode_32k", 2, 64),
    "llama4-scout-17b-a16e": (4, 32_768, "long_500k", 1, 16),
    "deepseek-v3-671b": (4, 8_192, "decode_32k", 8, 16),
    "yi-34b": (2, 4_096, "decode_32k", 2, 16),
    "mistral-large-123b": (2, 4_096, "decode_32k", 2, 16),
}
BF16_DENSE_FLOPS = 989e12     # H100 SXM bfloat16 tensor-core peak, dense
LM_WARMUP_SEQ = 2_048         # untimed prefill before the timed one
LM_PROFILE_SEQ = 8_192        # deepseek-7b prefill under the profiler
# the checks at depth 2: prefill then decode CHECK_TOKENS tokens in
# float32; decode's next token == argmax of prefill's logits wherever the
# top-2 margin exceeds LOGIT_MARGIN (float32 products in two orders differ
# by ~1e-5 there)
CHECK_DEPTH, CHECK_TOKENS, LOGIT_MARGIN = 2, 64, 1e-3
# bfloat16 against float32 on the same weights, per token: ||h_bf16 -
# h_f32|| / ||h_f32|| of the rms-normed hidden state.  bfloat16 rounds a
# value by up to 2^-9; ~10 roundings in series a layer, two layers, give
# ~1% (deepseek-7b on an H100: 1.04e-2 over all tokens).  The median and
# the largest are bounded for every arch.  The float32 pass runs first and
# records each MoE layer's expert choices; the bfloat16 pass routes every
# token to those experts, weighted by its own bfloat16 router scores there
# (``replayed_routing``): a token whose scores nearly tie might otherwise go
# to another expert in bfloat16 (top-1 in llama4-scout: its whole FFN
# output changes), a discrete difference that would hide a rounding fault
# in the expert FFN.  How many token-layers free bfloat16 routing would
# have sent elsewhere is counted and printed, not bounded.
BF16_REL_L2, BF16_REL_MAX = 3e-2, 1e-1
# the MoE dispatch against a per-token loop, float32 with TF32 off: the
# same products in other shapes (cuBLAS may pick another algorithm)
MOE_ATOL_SHARE = 1e-4

# LM training (phase 11): the train_4k cell of each arch at its published
# widths in bfloat16, with the published config's optimizer and microbatch
# count: arch -> (layers, sequence).  Cuts: the batch 256 -> cfg.microbatch
# sequences, one a microbatch, so that accumulation runs; deepseek-7b 30 ->
# 8 layers, yi-34b 60 -> 2, mistral-large 88 -> 2, llama4-scout 48 -> 2
# (both chunked-local: its 8,192 window covers all 4,096 positions, so a
# local layer computes what a global one would), deepseek-v3 61 -> 2 (1
# dense + 1 MoE) and its sequence 4,096 -> 2,048 (27.9 GB each of weights
# and gradients, and its 128 heads' attention backward at 4,096, do not fit
# 80 GB).
LM_TRAIN_RUNS = {
    "deepseek-7b": (8, 4_096),
    "yi-34b": (2, 4_096),
    "mistral-large-123b": (2, 4_096),
    "llama4-scout-17b-a16e": (2, 4_096),
    "deepseek-v3-671b": (2, 2_048),
}
TRAIN_TIMED = 3               # timed steps, after one untimed step
TRAIN_CLI_STEPS = 4
# the checks at depth 2: a sequence of 256 in blocks and loss chunks of 128
TRAIN_CHECK_SEQ, TRAIN_CHECK_BLK = 256, 128
# bfloat16 against float32 on the same weights and tokens, routing replayed:
# the loss relative, and each gradient leaf's ||g_bf16 - g_f32|| / ||g_f32||
# (a leaf whose float32 gradient is under 1e-3 of the largest leaf's, such
# as llama4-scout's top-1 router, whose true gradient is 0, against that
# floor).  bfloat16 rounds by 2^-9; the forward's ~1% per token (phase 10)
# and a backward of as many roundings again put a leaf's gradient at a few
# percent.
TRAIN_BF16_LOSS, TRAIN_BF16_GRAD = 1e-2, 1e-1
# float32: the microbatched gradient against the one-batch gradient, the
# same sums in another order: at initialisation a projection's gradient is
# a small difference of large terms, and the rounding grows with m (on an
# H100: 4.98e-6 at m = 2, 6.25e-6 at m = 4, 1.08e-5 for mistral-large's wk
# at m = 8), while a slice dropped, doubled or misplaced moves it by ~1/m.
# remat against none: the same products recomputed.  Both run under
# deterministic algorithms (the MoE combine adds atomically otherwise).
MICRO_REL, REMAT_REL = 1e-4, 1e-6
# gradient-free leaves of the float32 checks: the float32 gradients of the
# MoE expert stacks (llama4-scout 16.1 GB, deepseek-v3 45 GB) and v3's
# embedding and head (7.4 GB) do not fit beside its float32 weights (25.9,
# 55.8 GB); the backward still runs through them
TRAIN_FROZEN = {
    "llama4-scout-17b-a16e": ("layers/ffn/w_gate", "layers/ffn/w_up",
                              "layers/ffn/w_down"),
    "deepseek-v3-671b": ("layers/ffn/w_gate", "layers/ffn/w_up",
                         "layers/ffn/w_down", "embed", "out"),
}

# GNN training (phase 12): GatedGCN's published config (16 layers, d_hidden
# 70, remat, float32, AdamW) in its four cells, TF32 off.  full_graph_sm
# (cora: 2,708 x 10,556, padded 3,072 x 10,752, d_feat 1,433), molecule
# (128 graphs of 30 nodes, 8,192 edges) and minibatch_lg (1,024 seeds at
# fanouts (15, 10) sampled from a reddit-size graph: 169,984 nodes, 168,960
# edges, d_feat 602) run whole.  ogb_products (2,449,029 nodes, 61,859,140
# edges) does not fit one card: one (E, 70) float32 tensor is 17.32 GB at
# its padded 61,859,328 edges, and the remat stash of e alone 16 of them.
# Cut: nodes and edges divided by one factor, OGB_CUT, so its mean degree
# (25.3), d_feat 100, 47 classes and 16 layers stay.  Reckoning: a step
# holds the stash (e at the input of 15 layers, the first one's a
# broadcast) and one layer's recompute and backward (~10 saved (E, 70)
# tensors and ~4 gradients): ~29 x 280 B an edge, ~63 GB at 1/8 (7,732,392
# edges).  Measured on an NVIDIA H100 80GB HBM3 (700 W): an allocator peak
# of 64.76 GB at 1/8, 8,375 B an edge; 1/7 would need ~74 GB.
OGB_CUT = 8
GNN_TIMED = 3                 # timed steps, after one untimed step
REDDIT_NODES, REDDIT_EDGES = 232_965, 114_615_892
GNN_CLI_STEPS = 4
# the float32 layer on the card against a float64 oracle, at the toy graph
# of tests/test_gnn.py: ~20 float32 roundings in series, values O(1)
GNN_ORACLE_TOL = 1e-5
# the loss in default mode (atomic scatter-adds, an order that changes
# from run to run) against deterministic algorithms: sums of ~25 terms a
# node, 16 layers, a mean over the nodes; ~1e-7 expected
GNN_DET_REL = 1e-5

KERNEL_INFO = {
    "oph2u": ("src/repro_torch/csrc/oph.cu", "src/repro/kernels/oph.py:141"),
    "oph4u": ("src/repro_torch/csrc/oph.cu", "src/repro/kernels/oph.py:178"),
    "minhash2u": ("src/repro_torch/csrc/minhash.cu",
                  "src/repro/kernels/minhash.py:177"),
    "minhash4u": ("src/repro_torch/csrc/minhash.cu",
                  "src/repro/kernels/minhash.py:213"),
    "packed_match": ("src/repro_torch/csrc/hamming.cu",
                     "src/repro/kernels/hamming.py:99"),
    "sigbag": ("src/repro_torch/csrc/sigbag.cu",
               "src/repro/kernels/sigbag.py:47"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, torch) -> float:
    """Device milliseconds of one call of ``fn``, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(fn, torch) -> float:
    fn()                                   # warm-up
    torch.cuda.synchronize()
    return statistics.median(cuda_ms(fn, torch) for _ in range(REPS))


def graph_ms(fn, torch, loop: int = 1) -> float:
    """Device milliseconds of one call of ``fn`` with no host time between
    launches: ``loop`` calls captured in one CUDA graph, the median of
    REPS timed replays over ``loop``.  For work shorter than the host's
    launch overhead, where CUDA events around eager calls time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(loop):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return statistics.median(cuda_ms(graph.replay, torch)
                             for _ in range(REPS)) / loop


def device_breakdown(fn, torch, top: int = 4) -> str:
    """One call of ``fn`` under ``torch.profiler``: wall ms (host clock to
    a synchronize), the kernels' summed device ms and the device's busy
    share of the wall, the share of PyTorch's elementwise kernels, and the
    ``top`` kernels by device time.  "not measured" where the profiler
    records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    if not kernels:
        return f"wall {wall:.2f} ms; device time not measured (no kernels)"
    busy = sum(k[0] for k in kernels)
    elementwise = sum(k[0] for k in kernels if "elementwise_kernel" in k[2])
    return (f"wall {wall:.2f} ms, kernels {busy:.2f} ms ({busy / wall:.0%} "
            f"busy, {sum(k[1] for k in kernels)} launches; elementwise "
            f"{elementwise:.2f} ms, {elementwise / busy:.0%}); top: "
            + "; ".join(f"{name[:48]} x{n} {ms:.2f} ms"
                        for ms, n, name in kernels[:top]))


def max_abs_err(got, want) -> int:
    """Largest |difference| of two int32 uint32-pattern tensors."""
    from repro_torch.core.u32 import widen
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((widen(got) - widen(want)).abs().max()) if got.numel() else 0


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def oph_ops(nonzeros: int, n: int, k: int, four_u: bool, code_b: int) -> float:
    per_nz = OPS_4U if four_u else OPS_2U + OPS_SHIFT
    return nonzeros * (per_nz + OPS_SCATTER) + n * k * (OPS_CODE if code_b else 0)


def minhash_ops(nonzeros: int, n: int, k: int, four_u: bool, b: int,
                pack: bool) -> float:
    """2U in either variant (both shift once per (row, j)); 4U as a sum
    of powers shared across the k functions."""
    per_eval = (OPS_MH4U_EVAL if four_u else OPS_2U) + OPS_MIN
    per_nz = OPS_MH4U_STAGE if four_u else 0
    per_out = (0 if four_u else OPS_SHIFT) + (b > 0) + pack
    return nonzeros * (k * per_eval + per_nz) + n * k * per_out


def match_ops(nq: int, nc: int, k: int, code_bits: int,
              sentinel: bool) -> float:
    """Least lane-instructions of one packed-match call (see above)."""
    if 32 % code_bits == 0:
        words = (k * code_bits + 31) // 32
        return nq * nc * words * OPS_MATCH_WORD
    per_code = OPS_MATCH_CODE_SENT if sentinel else OPS_MATCH_CODE
    return nq * nc * k * per_code + (nq + nc) * k * OPS_EXTRACT


def minhash_bytes(nonzeros: int, n: int, k: int, four_u: bool,
                  pack_b: int = 0) -> float:
    """Indices and row counts read once, the coefficients read once, the
    (n, k) codes written once, and the packed words when ``pack_b``."""
    return (4 * nonzeros + 4 * n + 4 * k * (4 if four_u else 2) + 4 * n * k
            + n * k * pack_b // 8)


def oph_bytes(nonzeros: int, n: int, k: int, four_u: bool) -> float:
    """Indices and row counts read once, the one function's coefficients,
    the (n, k) bins written once."""
    return 4 * nonzeros + 4 * n + 4 * (4 if four_u else 2) + 4 * n * k


def match_bytes(nq: int, nc: int, words: int, sentinel: bool) -> float:
    """Query and corpus words read once, the count outputs written once."""
    return 4 * (nq + nc) * words + 4 * nq * nc * (2 if sentinel else 1)


def sigbag_bound(torch, tok, table) -> tuple:
    """``bound`` of one sigbag call: tokens read once, each table row these
    tokens touch read once (at 512 uniform rows ~221 of each slot's 256),
    the output written once; one float32 add per (row, slot, column).
    Returns (ms, "bytes" or "operations", rows touched)."""
    n, k = tok.shape
    two_b, d = table.shape[1], table.shape[2]
    flat = tok.to(torch.int64) + torch.arange(k, device=tok.device) * two_b
    rows_read = int(torch.unique(flat).numel())
    nbytes = (4 * n * k + rows_read * d * table.element_size()
              + n * d * table.element_size())
    return bound(nbytes, n * k * d) + (rows_read,)


def check_minhash4u_edges(torch, dev) -> int:
    """``minhash4u`` bit-exact against its plain version where the kernel's
    power-sum form and Horner's rule could part: rows of 1 to 5,000
    nonzeros holding the indices 0, 1, 2^31 - 2 and 2^31 - 1, three rows
    also holding indices >= 2^31 as uint32 (the block-wide Horner flag),
    and coefficient columns >= p (each thread's Horner flag) next to
    random ones < p; k = 128, b in {0, 8}, pack off and on, s in {24, 31}.
    Returns the number of cases; raises on any difference."""
    import numpy as np

    from repro_torch.core.u32 import from_numpy
    from repro_torch.kernels import minhash as kmin

    p = 2**31 - 1
    rng = np.random.default_rng(SEED + 31)
    rows = []
    for n in EDGE_ROWS:
        t = rng.integers(0, 2**31, n, dtype=np.int64)
        t[rng.choice(n, min(n, 4), replace=False)] = EDGE_T[:min(n, 4)]
        rows.append(t)
    for n in (3, 1_500, 5_000):
        t = rng.integers(0, 2**31, n, dtype=np.int64)
        t[rng.choice(n, 3, replace=False)] = (2**31, 2**32 - 1, 2**31 - 1)
        rows.append(t)
    width = -(-max(map(len, rows)) // 128) * 128
    idx = np.zeros((len(rows), width), np.uint32)
    for i, t in enumerate(rows):
        idx[i, :len(t)] = t
    idx = from_numpy(idx, dev)
    cnt = torch.tensor([len(t) for t in rows], dtype=torch.int32, device=dev)
    edge = np.array([[0, p - 1, p, p + 1, 5, 0],
                     [p - 1, p, p + 1, 0, 7, 0],
                     [p, p + 1, 1, p - 1, 9, p],
                     [p + 1, 0, p - 1, p, 2**31, 0]], np.int64)
    coefs = {
        "in-domain": rng.integers(0, p, (4, EDGE_K)),
        "out-of-domain": np.concatenate(
            [edge, rng.integers(0, p, (4, EDGE_K - edge.shape[1]))], axis=1),
    }
    cases = 0
    for label, a in coefs.items():
        a = from_numpy(a, dev)
        for s in (S, 31):
            for b, pack in ((0, False), (B, False), (B, True)):
                got = kmin.minhash4u_cuda(idx, cnt, a, s=s, b=b, pack=pack)
                want = kmin.minhash4u_plain(idx, cnt, a, s=s, b=b, pack=pack)
                pairs = zip(got, want) if pack else [(got, want)]
                err = max(max_abs_err(g, w) for g, w in pairs)
                if err:
                    raise AssertionError(
                        f"minhash4u edge chunk ({label} coefficients, s={s}, "
                        f"b={b}, pack={pack}): kernel != plain version "
                        f"(max |err| {err})")
                cases += 1
    return cases


def wrap_index(a1: int, a2: int, target: int) -> int:
    """The t with a1 + a2 * t == target (mod 2^32), for odd a2."""
    return (target - a1) * pow(a2, -1, 2**32) % 2**32


def check_minhash2u_edges(torch, dev) -> int:
    """``minhash2u`` bit-exact against its plain version where the
    kernel's running min of raw values and its one shift per (row, j)
    could part from a shift or mask per evaluation: rows of EDGE2_ROWS
    nonzeros (0 included), a row whose one nonzero hashes to 0xFFFFFFFF
    under column 0 (the non-empty maximum, unlike an empty row), indices
    whose a1 + a2 t wraps to 0xFFFFFFFF and to 0 under the first and last
    columns, a row of counts -3 and one of counts > nnz (data in every
    lane), coefficient columns (0, 1) and (2^32 - 1, 2^32 - 1); k in
    EDGE2_K, s in EDGE2_S, b in EDGE2_B, variants high and low, pack on
    where k is a multiple of 128 and b = 8.  Returns the number of cases;
    raises on any difference."""
    import numpy as np

    from repro_torch.core.u32 import from_numpy
    from repro_torch.kernels import minhash as kmin

    rng = np.random.default_rng(SEED + 33)
    cases = 0
    for k in EDGE2_K:
        a1 = rng.integers(0, 2**32, k, dtype=np.uint64)
        a2 = rng.integers(0, 2**32, k, dtype=np.uint64) | np.uint64(1)
        if k >= 3:
            a1[1], a2[1] = 0, 1
            a1[2], a2[2] = 2**32 - 1, 2**32 - 1
        wrap = [wrap_index(int(a1[j]), int(a2[j]), target)
                for j in sorted({0, k - 1}) for target in (2**32 - 1, 0)]
        rows = []
        for n in EDGE2_ROWS:
            t = rng.integers(0, 2**32, n, dtype=np.uint64)
            at = rng.choice(n, min(n, len(wrap)), replace=False)
            t[at] = wrap[:len(at)]
            rows.append(t)
        rows.append(np.array(wrap[:1], np.uint64))
        counts = [len(t) for t in rows]
        width = -(-max(counts) // 128) * 128
        rows += [rng.integers(0, 2**32, width, dtype=np.uint64)] * 2
        counts += [-3, 2 * width]
        idx = np.zeros((len(rows), width), np.uint32)
        for i, t in enumerate(rows):
            idx[i, :len(t)] = t
        idx = from_numpy(idx, dev)
        cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
        coef = (from_numpy(a1, dev), from_numpy(a2, dev))
        for s in EDGE2_S:
            for b in EDGE2_B:
                packs = ((False, True) if k % kmin.MINHASH_BLK_K == 0
                         and b == B else (False,))
                for variant in ("high", "low"):
                    for pack in packs:
                        kw = dict(s=s, b=b, variant=variant, pack=pack)
                        got = kmin.minhash2u_cuda(idx, cnt, *coef, **kw)
                        want = kmin.minhash2u_plain(idx, cnt, *coef, **kw)
                        pairs = zip(got, want) if pack else [(got, want)]
                        err = max(max_abs_err(g, w) for g, w in pairs)
                        if err:
                            raise AssertionError(
                                f"minhash2u edge chunk (k={k}, s={s}, b={b},"
                                f" {variant}, pack={pack}): kernel != plain "
                                f"version (max |err| {err})")
                        cases += 1
    return cases


def check_oph_edges(torch, dev) -> int:
    """``oph2u`` (variants high and low) and ``oph4u`` bit-exact against
    their plain versions on widths nnz in OPH_EDGE_NNZ (every nnz % 4, so
    rows start at every 4-byte offset of a 16-byte word, and 20,003
    lanes: several rounds of loads), with the batch at the allocation's
    base and one element past it (an unaligned base); counts 0 to nnz,
    -1 and past nnz; bin_bits in {0, 9}, code_b in {0, 8}, s = 24.
    Returns the number of cases; raises on any difference."""
    import numpy as np

    from repro_torch.core.u32 import from_numpy
    from repro_torch.kernels import oph as koph

    rng = np.random.default_rng(SEED + 35)
    a1 = from_numpy(rng.integers(0, 2**32, 1, dtype=np.uint64), dev)
    a2 = from_numpy(rng.integers(0, 2**32, 1, dtype=np.uint64) | np.uint64(1),
                    dev)
    a4 = from_numpy(rng.integers(0, 2**31 - 1, (4, 1)), dev)
    kinds = [  # label, kernel, plain version, coefficients, keywords
        ("oph2u high", koph.oph2u_cuda, koph.oph2u_plain, (a1, a2),
         {"variant": "high"}),
        ("oph2u low", koph.oph2u_cuda, koph.oph2u_plain, (a1, a2),
         {"variant": "low"}),
        ("oph4u", koph.oph4u_cuda, koph.oph4u_plain, (a4,), {}),
    ]
    cases = 0
    for nnz in OPH_EDGE_NNZ:
        counts = [0, 1, 2, 3, 4, 5, 6, 7, nnz - 1, nnz, nnz + 7, -1]
        if nnz > 4_096:
            counts += [4_095, 4_096, 4_097, 17_000]
        counts += list(rng.integers(0, nnz + 1, 12))
        n = len(counts)
        vals = from_numpy(rng.integers(0, 2**32, n * nnz, dtype=np.uint64),
                          dev)
        cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
        for off in (0, 1):
            buf = torch.zeros(n * nnz + off, dtype=torch.int32, device=dev)
            buf[off:] = vals
            idx = buf[off:].view(n, nnz)
            for bin_bits in (0, 9):
                for code_b in (0, B):
                    for label, cuda, plain, coef, kw in kinds:
                        kw = dict(kw, s=S, bin_bits=bin_bits, code_b=code_b)
                        err = max_abs_err(cuda(idx, cnt, *coef, **kw),
                                          plain(idx, cnt, *coef, **kw))
                        if err:
                            raise AssertionError(
                                f"{label} edge chunk (nnz={nnz}, offset "
                                f"{off}, bin_bits={bin_bits}, code_b="
                                f"{code_b}): kernel != plain version "
                                f"(max |err| {err})")
                        cases += 1
    return cases


def check_sigbag_edges(torch, dev) -> dict:
    """``sigbag`` bit-exact (``torch.equal``) against its plain version on
    SIGBAG_EDGES, float32 and bfloat16 tables, on both sides of the
    dispatch rule: the design the built kernel picks (``sigbag_plan``)
    must be the one ``staged_plan`` predicts, and each design must run in
    both types.  Returns {(design, dtype): cases}; raises on any
    difference."""
    import numpy as np

    from repro_torch.kernels import sigbag as ksig

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rng = np.random.default_rng(SEED + 37)
    cases = {}
    for n, k, two_b, d, dtype, off in SIGBAG_EDGES:
        tdt = dtypes[dtype]
        esize = torch.tensor([], dtype=tdt).element_size()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if n in ("bulk", "below"):
            rows = ksig.staged_plan(2**31 - 1, two_b, d, esize, 1).rows or 1024
            n = (sms * rows - rows // 2 + 3 if n == "bulk"
                 else (sms - 1) * rows)
        tok = rng.integers(0, two_b, n * k + off, dtype=np.int64)
        odd = rng.random(tok.shape) < 0.03
        tok[odd] = rng.choice([-1, two_b, 2**31 - 1], int(odd.sum()))
        tok = torch.from_numpy(tok.astype(np.int32)).to(dev)
        tok = tok[off:].view(n, k)
        tok[min(2, n - 1)] = -1
        table = torch.from_numpy(rng.standard_normal((k, two_b, d),
                                                     np.float32)).to(dev)
        table[0, 0] = -0.0
        table = table.to(tdt)
        plan, card_sms = ksig.sigbag_plan_cuda(tok, table)
        want_plan = ksig.staged_plan(n, two_b, d, esize, sms,
                                     table.data_ptr())
        if plan != want_plan or card_sms != sms:
            raise AssertionError(f"sigbag n={n} k={k} 2^b={two_b} d={d} "
                                 f"{dtype}: the kernel plans {plan} on "
                                 f"{card_sms} SMs, staged_plan {want_plan}")
        got = ksig.sigbag_cuda(tok, table)
        want = ksig.sigbag_plain(tok, table)
        if not torch.equal(got, want):
            bad = int((got.float() != want.float()).sum())
            raise AssertionError(
                f"sigbag edge n={n} k={k} 2^b={two_b} d={d} {dtype} token "
                f"offset {off} ({'staged' if plan.staged else 'direct'}): "
                f"kernel != plain version in {bad} elements")
        key = ("staged" if plan.staged else "direct", dtype)
        cases[key] = cases.get(key, 0) + 1
    for design in ("staged", "direct"):
        for dtype in dtypes:
            if not cases.get((design, dtype)):
                raise AssertionError(f"sigbag edge set: no {dtype} case took "
                                     f"the {design} design")
    return cases


def check_match_odd_shapes(torch, dev) -> int:
    """``packed_match`` bit-exact against its plain version at shapes that
    tile nothing: Q in {1, 257} x N in {1, 4,097} at k = 503, b = 8 (W =
    126, last word partial, rows not 16-byte aligned: 4-byte staging), the
    same at k = 512 (16-byte staging), both on a sentinel wire, and every
    other code width that divides 32.
    Returns the number of cases; raises on any difference."""
    import numpy as np

    from repro_torch.core.bbit import pack_codes
    from repro_torch.core.u32 import from_numpy
    from repro_torch.kernels import hamming as kham

    rng = np.random.default_rng(SEED + 41)
    cases = [(nq, nc, 503, B, False) for nq in (1, 257) for nc in (1, 4_097)]
    cases += [(257, 4_097, 512, B, False), (257, 4_097, 503, B, True),
              (257, 4_097, 512, B, True)]
    cases += [(257, 4_097, 77, cb, cb > 1) for cb in (1, 2, 4, 16, 32)]
    cases += [(257, 4_097, 77, cb, False) for cb in (2, 16)]

    def codes(n, k, cb, sentinel):
        top = (1 << cb) - 1
        c = rng.integers(0, min(top, 3) + 1, (n, k), dtype=np.int64)
        c[rng.random((n, k)) < 0.1] = top
        if sentinel:
            c[rng.random((n, k)) < 0.3] = 1 << (cb - 1)
        return c

    for nq, nc, k, cb, sent in cases:
        q, c = codes(nq, k, cb, sent), codes(nc, k, cb, sent)
        c[:min(nq, nc)] = q[:min(nq, nc)]          # exact self-matches
        qw = pack_codes(from_numpy(q, dev), cb)
        cw = pack_codes(from_numpy(c, dev), cb)
        got = kham.packed_match_cuda(qw, cw, k=k, code_bits=cb, sentinel=sent)
        want = kham.packed_match_plain(qw, cw, k=k, code_bits=cb,
                                       sentinel=sent)
        pairs = zip(got, want) if sent else [(got, want)]
        err = max(max_abs_err(g, w) for g, w in pairs)
        if err:
            raise AssertionError(
                f"packed_match Q={nq} N={nc} k={k} code_bits={cb} "
                f"sentinel={sent}: kernel != plain version (max |err| {err})")
    return len(cases)


def main() -> int:
    # cuBLAS is deterministic under torch.use_deterministic_algorithms
    # (phase 9's restarted DIN fit) only with a fixed workspace; it must be
    # set before the first product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from the root of a repository checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        return run(torch)
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)


def run(torch) -> int:
    from repro_torch.core.u32 import from_numpy, to_numpy
    from repro_torch.data.pipeline import SignatureStream, write_shards
    from repro_torch.data.preprocess import preprocess_shards
    from repro_torch.data.sigshard import read_sig_shard
    from repro_torch.data.sparse import from_lists
    from repro_torch.data.synthetic import DatasetSpec, generate_sets
    from repro_torch.kernels import batch_signatures, build
    from repro_torch.kernels import minhash as kmin
    from repro_torch.kernels import oph as koph
    from repro_torch.kernels.engine import oph_epilogue
    from repro_torch.kernels.pack import PackSpec, pack_device
    from repro_torch.train.online import (OnlineTrainer, SignatureCache,
                                          make_family)

    dev = torch.device("cuda")
    wrappers = {"oph2u": koph.oph2u_cuda, "oph4u": koph.oph4u_cuda,
                "minhash2u": kmin.minhash2u_cuda,
                "minhash4u": kmin.minhash4u_cuda}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    # -- phase 1: device and build --------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}  torch {torch.__version__} cuda {torch.version.cuda}"
        f"  count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    per_source = build.build_all()
    log(f"[build] nvcc sm_90a, parallel: {time.perf_counter() - t0:.2f} s "
        f"wall ({', '.join(f'{k} {v:.2f} s' for k, v in per_source.items())})")

    # -- data: webspam (trigram) width, rows cut to fit the time limit ----
    spec = DatasetSpec("webspam_trigram_width", n=50_000, D=2**24,
                       avg_nnz=3_728, n_prototypes=6, overlap=0.7, seed=7)
    t0 = time.perf_counter()
    (train_sets, y_train), (test_sets, y_test) = generate_sets(spec)
    nnz_mean = sum(map(len, train_sets)) / len(train_sets)
    log(f"[data] {spec.name}: {len(train_sets)} train + {len(test_sets)} test"
        f" rows, D=2^{spec.D.bit_length() - 1}, mean nnz {nnz_mean:.1f}, generated in "
        f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(SEED)
    fams = {
        "oph2u": make_family("oph", K_OPH, S, densify="rotation",
                             generator=gen, device=dev),
        "oph4u": make_family("oph-4u", K_OPH, S, densify="rotation",
                             generator=gen, device=dev),
        ("minhash2u", K_MIN): make_family("2u", K_MIN, S, generator=gen,
                                          device=dev),
        ("minhash4u", K_MIN): make_family("4u", K_MIN, S, generator=gen,
                                          device=dev),
        ("minhash2u", K_PAPER): make_family("2u", K_PAPER, S, generator=gen,
                                            device=dev),
        ("minhash4u", K_PAPER): make_family("4u", K_PAPER, S, generator=gen,
                                            device=dev),
    }

    # -- phase 2: every kernel against its plain version, one full chunk --
    chunk = from_lists(train_sets[:CHUNK], y_train[:CHUNK], device=dev)
    idx, cnt = chunk.indices, chunk.nnz_per_row()
    n, nnz = idx.shape
    total_nnz = int(cnt.sum())
    log(f"[chunk] n={n} nnz(padded)={nnz} nonzeros={total_nnz}")
    plain_out = {}
    rows = {}

    def check(label, name, kernel_fn, plain_fn, nbytes, ops, main):
        """``nbytes``: every input read once, every output written once."""
        got = kernel_fn()
        want = plain_fn()           # also the plain version's warm-up
        plain_ms = cuda_ms(plain_fn, torch)
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        err = max(max_abs_err(g, w) for g, w in pairs)
        if err:
            raise AssertionError(f"{label}: kernel != plain version "
                                 f"(max |err| {err})")
        ms = median_ms(kernel_fn, torch)
        how = f"median of {REPS} (CUDA events)"
        if name in LOOP_TIMED:
            single, ms = ms, graph_ms(kernel_fn, torch, KERNEL_LOOP)
            how = (f"median of {REPS} replays of a CUDA graph of "
                   f"{KERNEL_LOOP} launches; one launch by CUDA events "
                   f"{single:.4f} ms")
        b_ms, b_by = bound(nbytes, ops)
        log(f"[kernel] {label}: {ms:.4f} ms ({how}), "
            f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.1f} ms (1 call), "
            f"bit-exact on all {n} rows, launches {wrappers[name].launches}")
        if main:
            rows[name] = dict(name=name, route="cuda",
                              source=KERNEL_INFO[name][0],
                              replaces=KERNEL_INFO[name][1], launches=0,
                              max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by, library_ms=None)
        return want

    bin_bits = K_OPH.bit_length() - 1
    base2, base4 = fams["oph2u"].base, fams["oph4u"].base
    for code_b in (0, B):
        plain_out[("oph2u", code_b)] = check(
            f"oph2u k={K_OPH} s={S} code_b={code_b}", "oph2u",
            lambda: koph.oph2u_cuda(idx, cnt, base2.a1, base2.a2, s=S,
                                    bin_bits=bin_bits, code_b=code_b),
            lambda: koph.oph2u_plain(idx, cnt, base2.a1, base2.a2, s=S,
                                     bin_bits=bin_bits, code_b=code_b),
            oph_bytes(total_nnz, n, K_OPH, False),
            oph_ops(total_nnz, n, K_OPH, False, code_b),
            main=code_b == 0)
        plain_out[("oph4u", code_b)] = check(
            f"oph4u k={K_OPH} s={S} code_b={code_b}", "oph4u",
            lambda: koph.oph4u_cuda(idx, cnt, base4.a, s=S, bin_bits=bin_bits,
                                    code_b=code_b),
            lambda: koph.oph4u_plain(idx, cnt, base4.a, s=S,
                                     bin_bits=bin_bits, code_b=code_b),
            oph_bytes(total_nnz, n, K_OPH, True),
            oph_ops(total_nnz, n, K_OPH, True, code_b),
            main=code_b == 0)
    for k in (K_MIN, K_PAPER):
        for name in ("minhash2u", "minhash4u"):
            four_u = name == "minhash4u"
            fam = fams[(name, k)]
            coef = (fam.a1, fam.a2) if name == "minhash2u" else (fam.a,)
            cuda_fn = getattr(kmin, f"{name}_cuda")
            plain_fn = getattr(kmin, f"{name}_plain")
            packs = (False, True) if k % kmin.MINHASH_BLK_K == 0 else (False,)
            for pack in packs:
                plain_out[(name, k, pack)] = check(
                    f"{name} k={k} s={S} b={B} pack={pack}", name,
                    lambda: cuda_fn(idx, cnt, *coef, s=S, b=B, pack=pack),
                    lambda: plain_fn(idx, cnt, *coef, s=S, b=B, pack=pack),
                    minhash_bytes(total_nnz, n, k, four_u, B if pack else 0),
                    minhash_ops(total_nnz, n, k, four_u, B, pack),
                    main=k == K_PAPER)
    n_edge = check_minhash4u_edges(torch, dev)
    log(f"[kernel] minhash4u edge chunk: k={EDGE_K}, rows of {EDGE_ROWS[0]} "
        f"to {EDGE_ROWS[-1]} nonzeros with indices {EDGE_T} and >= 2^31, "
        f"coefficients < p and >= p: bit-exact in all {n_edge} cases")
    n_edge = check_minhash2u_edges(torch, dev)
    log(f"[kernel] minhash2u edge chunk: rows of {EDGE2_ROWS} nonzeros, "
        f"counts < 0 and > nnz, a1 + a2 t wrapping to 0xFFFFFFFF and 0, k in "
        f"{EDGE2_K}, s in {EDGE2_S}, b in {EDGE2_B}, variants high and low, "
        f"pack where k % 128 == 0: bit-exact in all {n_edge} cases")
    n_edge = check_oph_edges(torch, dev)
    log(f"[kernel] oph2u / oph4u edge chunk: nnz in {OPH_EDGE_NNZ}, aligned "
        f"and unaligned base, counts 0 to nnz, < 0 and > nnz, bin_bits in "
        f"(0, 9), code_b in (0, {B}): bit-exact in all {n_edge} cases")
    sig_edges = check_sigbag_edges(torch, dev)
    log(f"[kernel] sigbag edge set: k in (1, 33, 36, 64, 65, 128, 500), 2^b "
        f"in (16, 256, 1024), d in (1, 8, 31, 32, 33, 64, 128), rows not a "
        f"multiple of a block, tokens -1, 2^b, 2^31 - 1 and misaligned: "
        f"bit-exact in all {sum(sig_edges.values())} cases ("
        + ", ".join(f"{d} {t} {c}" for (d, t), c in sorted(sig_edges.items()))
        + ")")
    log(f"kernels checked: {', '.join(sorted(rows))}")

    # -- phase 3: the main path, online learning -------------------------
    raw_dir = SMOKE_DIR / "raw"
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    paths = write_shards(train_sets, y_train, str(raw_dir), 4)
    raw_bytes = sum(os.path.getsize(p) for p in paths)
    log(f"[shards] 4 binary shards, {raw_bytes} bytes, written in "
        f"{time.perf_counter() - t0:.1f} s")
    test = from_lists(test_sets, y_test, device=dev)

    class Recorder:
        """Pass-through source that keeps each epoch's packed words."""

        def __init__(self, source):
            self.source, self.epochs = source, []

        @property
        def cumulative_stats(self):
            return self.source.cumulative_stats

        def __iter__(self):
            self.epochs.append([])
            for sig, labels in self.source:
                self.epochs[-1].append(sig.data.clone())
                yield sig, labels

        def close(self):
            self.source.close()

    family = fams["oph2u"]
    reset_counts()
    t_main = time.perf_counter()
    stream = SignatureStream(paths, family, b=B, chunk_size=CHUNK, packed=True)
    cache = SignatureCache(stream, cache_dir=str(SMOKE_DIR / "cache"))
    source = Recorder(cache)
    sig_test = batch_signatures(test, family, b=B, packed=True)
    with OnlineTrainer(k=K_OPH, b=B, kind="svm", average=True, lam=1e-4,
                       eta0=0.5, batch_size=16, avg_start=100.0,
                       device=dev) as trainer:
        _, stats, evals = trainer.fit(
            source, 3, eval_fn=lambda tr: tr.evaluate(sig_test, test.labels))
        sig_paths = list(cache.paths)
        replay_words = [read_sig_shard(p)[0] for p in sig_paths]
        cache_stats = cache.stats
    main_s = time.perf_counter() - t_main
    path_counts = counts()
    for es, acc in zip(stats, evals):
        log(f"[epoch {es.epoch} {es.source}] load {es.load_s * 1e3:.1f} ms  "
            f"kernel {es.kernel_s * 1e3:.1f} ms  train {es.train_s * 1e3:.1f}"
            f" ms  read {es.bytes_read} B  examples {es.examples}  "
            f"test acc {acc:.4f}")
    log(f"[cache] raw {cache_stats.bytes_original} B -> .sig "
        f"{cache_stats.bytes_cached} B: reduction "
        f"{cache_stats.reduction():.2f}x ({cache_stats.shards} shards)")
    log(f"[main path] {main_s:.1f} s, launches {path_counts}")
    if path_counts["oph2u"] < 1:
        raise AssertionError("the online path never launched oph2u")
    if not evals[-1] > 0.5 + ACC_MARGIN:
        raise AssertionError(f"test accuracy {evals[-1]:.4f} is not above "
                             f"chance + {ACC_MARGIN}")
    epoch0 = [to_numpy(w) for w in source.epochs[0]]
    for e in (1, 2):
        if stats[e].source != "cache":
            raise AssertionError(f"epoch {e} did not replay the cache")
        replay = [to_numpy(w) for w in source.epochs[e]]
        if len(replay) != len(epoch0) or any(
                (a != r).any() for a, r in zip(epoch0, replay)):
            raise AssertionError(f"epoch {e} replay != epoch 0 words")
    if len(replay_words) != len(epoch0) or any(
            (a != r).any() for a, r in zip(epoch0, replay_words)):
        raise AssertionError(".sig shards do not decode to epoch 0's words")
    log(f"[main path] replayed .sig shards == epoch 0 words "
        f"({len(epoch0)} chunks); final ASGD test acc {evals[-1]:.4f}")

    # -- phase 4: the §3 batch entry point -------------------------------
    reset_counts()
    batch_cases = [
        ("2u", fams[("minhash2u", K_PAPER)],
         pack_device(plain_out[("minhash2u", K_PAPER, False)],
                     PackSpec(K_PAPER, B))),
        ("4u", fams[("minhash4u", K_PAPER)],
         pack_device(plain_out[("minhash4u", K_PAPER, False)],
                     PackSpec(K_PAPER, B))),
        ("oph-4u", fams["oph4u"],
         oph_epilogue(plain_out[("oph4u", 0)], k=K_OPH, s=S,
                      bin_bits=bin_bits, densify="rotation", b=B,
                      packed=True)),
    ]
    for scheme, fam, want_words in batch_cases:
        out_dir = SMOKE_DIR / f"sig_{scheme}"
        st = preprocess_shards(paths, str(out_dir), fam, b=B,
                               chunk_size=CHUNK)
        words, labels, meta = read_sig_shard(str(out_dir / "sig_00000.sig"))
        if not ((words == to_numpy(want_words)).all()
                and (labels == y_train[:CHUNK]).all()):
            raise AssertionError(f"preprocess_shards {scheme}: first .sig "
                                 "shard != plain path")
        log(f"[preprocess {scheme} k={fam.k} b={B}] {st.examples} rows: "
            f"{st.examples / (st.load_s + st.kernel_s + st.store_s):.0f} "
            f"rows/s end to end; load {st.load_s * 1e3:.1f} ms, kernel "
            f"{st.kernel_s * 1e3:.1f} ms, store {st.store_s * 1e3:.1f} ms; "
            f"kernel/load {st.kernel_s / st.load_s:.4f}; reduction "
            f"{st.reduction():.2f}x; first shard == plain path")
    batch_counts = counts()
    log(f"[preprocess] launches {batch_counts}")
    for name in ("oph4u", "minhash2u", "minhash4u"):
        if batch_counts[name] < 1:
            raise AssertionError(f"preprocess_shards never launched {name}")

    for name, row in rows.items():
        row["launches"] = path_counts[name] + batch_counts[name]

    # -- phase 5: retrieval ----------------------------------------------
    rows["packed_match"], served = retrieval(torch, dev, N_DOCS)

    # -- phase 6: recsys serving -----------------------------------------
    rows["sigbag"], minhash_launches = recsys_serving(torch, dev)
    rows["minhash2u"]["launches"] += minhash_launches

    # -- phase 7: the search server over phase 5's corpus -----------------
    rows["packed_match"]["launches"] += search_serving(torch, dev, served)

    # -- phase 8: batch learning, VW, dedup and Appendix A ---------------
    batch_launches = batch_learning(torch, dev, train_sets, y_train, test)
    for name, n_launch in batch_launches.items():
        rows[name]["launches"] += n_launch

    # -- phase 9: AutoInt, DIN, MIND and Wide & Deep in every cell -------
    for name, n_launch in recsys_family(torch, dev).items():
        rows[name]["launches"] += n_launch

    # -- phase 10: the LM family served (no kernel of ours on its path) ---
    lm_serving(torch, dev)

    # -- phase 11: the LM family trained (no kernel of ours either) -------
    lm_training(torch, dev)

    # -- phase 12: the GNN family trained (no kernel of ours on its path) -
    gnn_training(torch, dev)
    log(json.dumps({"kernels": [rows[k] for k in KERNEL_INFO]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def retrieval(torch, dev, n_docs: int) -> dict:
    """Phase 5: .sig -> .idx -> exact / LSH flushes -> 4 shards, on the
    card; returns the ``packed_match`` row of the kernels line."""
    import numpy as np

    from repro_torch.core.u32 import from_numpy, to_numpy
    from repro_torch.data.pipeline import write_shards
    from repro_torch.data.preprocess import preprocess_shards
    from repro_torch.data.sparse import from_lists
    from repro_torch.data.synthetic import DatasetSpec, generate_sets
    from repro_torch.index import (IndexSearcher, band_keys_packed,
                                   build_index, build_sharded,
                                   choose_band_config, load_index,
                                   load_sharded, resemblance_scores)
    from repro_torch.kernels import batch_signatures
    from repro_torch.kernels import hamming as kham
    from repro_torch.kernels.hamming import packed_match_plain
    from repro_torch.train.online import make_family

    kern = kham.packed_match_cuda
    t_phase = time.perf_counter()

    class PlainScored(IndexSearcher):
        """The same searcher, scoring through the plain version."""

        def match_counts(self, qwords, cwords):
            spec = self.index.spec
            return packed_match_plain(qwords, cwords, k=spec.k,
                                      code_bits=spec.code_bits,
                                      sentinel=spec.sentinel)

    # -- corpus: the train split is the corpus, the test split held out --
    n_rows = -(-n_docs * 5 // 4)
    spec = DatasetSpec("rcv1_docs", n=n_rows, D=2**S_IDX, avg_nnz=NNZ_DOCS,
                       n_prototypes=8, overlap=0.8, seed=SEED + 11)
    t0 = time.perf_counter()
    (docs, labels), (held, _) = generate_sets(spec)
    if len(docs) != n_docs:
        raise AssertionError(f"corpus has {len(docs)} rows, want {n_docs}")
    held = held[:N_QUERIES]
    raw = write_shards(docs, labels, str(SMOKE_DIR / "rcv1_raw"), RAW_SHARDS)
    nnz = sum(map(len, docs))
    del docs, labels
    log(f"[retrieval data] {spec.name}: {n_docs} docs, mean nnz "
        f"{nnz / n_docs:.1f}, D=2^{S_IDX}, {RAW_SHARDS} raw shards, "
        f"generated + written in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(SEED + 12)
    fams = {d: make_family("oph", K_IDX, S_IDX, densify=d, generator=gen,
                           device=dev) for d in ("rotation", "sentinel")}
    sig_dirs = {d: SMOKE_DIR / f"rcv1_sig_{d}" for d in fams}
    for d, paths in (("rotation", raw), ("sentinel", raw[:2])):
        st = preprocess_shards(paths, str(sig_dirs[d]), fams[d], b=B,
                               chunk_size=SIG_CHUNK)
        log(f"[retrieval preprocess {d}] {st.examples} docs: load "
            f"{st.load_s:.1f} s, kernel {st.kernel_s:.2f} s, store "
            f"{st.store_s:.1f} s")
    shutil.rmtree(SMOKE_DIR / "rcv1_raw")
    sig_paths = {d: sorted(str(p) for p in sig_dirs[d].glob("*.sig"))
                 for d in fams}

    # -- index build, load, corpus upload --------------------------------
    cfg = choose_band_config(K_IDX, B, threshold=0.5)
    idx_path = str(SMOKE_DIR / "rcv1.idx")
    t0 = time.perf_counter()
    meta = build_index(sig_paths["rotation"], idx_path, cfg, device=dev)
    build_s = time.perf_counter() - t0
    index = load_index(idx_path, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus = index.corpus
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    log(f"[retrieval index] {meta.n} docs, k={meta.k} b={meta.b} words="
        f"{meta.words}, bands {cfg.n_bands}x{cfg.rows_per_band}, "
        f"{meta.n_keys} buckets, .idx {os.path.getsize(idx_path)} B; build "
        f"{build_s:.1f} s; corpus H2D {meta.payload_bytes} B in "
        f"{h2d_s * 1e3:.1f} ms ({meta.payload_bytes / h2d_s / 1e9:.2f} GB/s)")
    if meta.n != n_docs or tuple(corpus.shape) != (n_docs, meta.words):
        raise AssertionError(f"index holds {tuple(corpus.shape)}")

    rng = np.random.default_rng(SEED + 13)
    picks = np.sort(rng.choice(n_docs, N_QUERIES, replace=False))
    exact_rows = [np.asarray(index.words_host[i]) for i in picks]
    held_sig = batch_signatures(from_lists(held, device=dev),
                                fams["rotation"], b=B, packed=True)
    held_rows = [held_sig[i:i + 1] for i in range(N_QUERIES)]
    q_exact = from_numpy(np.stack(exact_rows), dev)

    # -- the kernel against its plain version ----------------------------
    blk = corpus[:BLOCK]
    err, plain_corpus_ms = 0, 0.0
    for lo in range(0, n_docs, 16 * BLOCK):
        part, out = corpus[lo:lo + 16 * BLOCK], {}
        got = kern(q_exact, part, k=K_IDX, code_bits=B)
        plain_corpus_ms += cuda_ms(lambda: out.setdefault(
            "want", packed_match_plain(q_exact, part, k=K_IDX, code_bits=B)),
            torch)
        err = max(err, max_abs_err(got, out["want"]))
    if err:
        raise AssertionError(f"packed_match b={B}: kernel != plain version "
                             f"(max |err| {err})")
    n_odd = check_match_odd_shapes(torch, dev)
    log(f"[kernel] packed_match odd shapes: Q in (1, 257) x N in (1, 4097) "
        f"at k=503 b={B} (W=126), sentinel and code_bits 1-32: bit-exact in "
        f"all {n_odd} cases")
    # one 4,096-row launch is shorter than the wrapper's host time: its
    # device time comes from a graph of BLOCK_LOOP launches; eager launches
    # back to back, as an exact flush runs them, give the host's rate
    ms_blk = graph_ms(lambda: kern(q_exact, blk, k=K_IDX, code_bits=B),
                      torch, BLOCK_LOOP)
    eager_blk = median_ms(lambda: [kern(q_exact, blk, k=K_IDX, code_bits=B)
                                   for _ in range(BLOCK_LOOP)],
                          torch) / BLOCK_LOOP
    ms_all = median_ms(lambda: kern(q_exact, corpus, k=K_IDX, code_bits=B),
                       torch)
    packed_match_plain(q_exact, blk, k=K_IDX, code_bits=B)
    plain_blk = cuda_ms(lambda: packed_match_plain(q_exact, blk, k=K_IDX,
                                                   code_bits=B), torch)
    b_blk, by_blk = bound(match_bytes(N_QUERIES, BLOCK, meta.words, False),
                          match_ops(N_QUERIES, BLOCK, K_IDX, B, False))
    b_all, by_all = bound(match_bytes(N_QUERIES, n_docs, meta.words, False),
                          match_ops(N_QUERIES, n_docs, K_IDX, B, False))
    log(f"[kernel] packed_match b={B} Q={N_QUERIES} N={BLOCK}: {ms_blk:.4f} "
        f"ms (median of {REPS} replays of a CUDA graph of {BLOCK_LOOP} "
        f"launches; eager launches back to back {eager_blk:.4f} ms each), "
        f"bound {b_blk:.4f} ms ({by_blk}), plain {plain_blk:.1f} ms (1 call)")
    log(f"[kernel] packed_match b={B} Q={N_QUERIES} N={n_docs}: "
        f"{ms_all:.4f} ms median of {REPS}, bound {b_all:.4f} ms "
        f"({by_all}), plain {plain_corpus_ms:.1f} ms (in blocks of "
        f"{16 * BLOCK}); bit-exact on all {N_QUERIES} x {n_docs} pairs")

    # sentinel wire (9-bit codes straddle words): its own index
    sent_path = str(SMOKE_DIR / "rcv1_sentinel.idx")
    cfg_s = choose_band_config(K_IDX, B, code_bits=B + 1, threshold=0.5)
    meta_s = build_index(sig_paths["sentinel"], sent_path, cfg_s, device=dev)
    index_s = load_index(sent_path, device=dev)
    q_sent = batch_signatures(from_lists(held, device=dev),
                              fams["sentinel"], b=B, packed=True).data
    c_sent = index_s.corpus[:SENT_DOCS]
    got = kern(q_sent, c_sent, k=K_IDX, code_bits=B + 1, sentinel=True)
    want = packed_match_plain(q_sent, c_sent, k=K_IDX, code_bits=B + 1,
                              sentinel=True)
    err_s = max(max_abs_err(g, w) for g, w in zip(got, want))
    if err_s or not int(want[1].sum()):
        raise AssertionError(f"packed_match sentinel: kernel != plain "
                             f"(max |err| {err_s}) or no joint EMPTY")
    ms_s = median_ms(lambda: kern(q_sent, c_sent, k=K_IDX, code_bits=B + 1,
                                  sentinel=True), torch)
    plain_s = cuda_ms(lambda: packed_match_plain(
        q_sent, c_sent, k=K_IDX, code_bits=B + 1, sentinel=True), torch)
    b_s, by_s = bound(match_bytes(N_QUERIES, SENT_DOCS, meta_s.words, True),
                      match_ops(N_QUERIES, SENT_DOCS, K_IDX, B + 1, True))
    log(f"[kernel] packed_match sentinel b={B} (9-bit codes, words="
        f"{meta_s.words}) Q={N_QUERIES} N={SENT_DOCS}: {ms_s:.4f} ms median "
        f"of {REPS}, bound {b_s:.4f} ms ({by_s}), plain {plain_s:.1f} ms; "
        f"bit-exact, {int(want[1].sum())} jointly-EMPTY positions")

    # -- the main path: exact and LSH flushes ----------------------------
    def flush(searcher, rows, mode):
        for r in rows:
            searcher.submit(r)
        t0 = time.perf_counter()
        out = searcher.flush(TOPK, mode=mode)
        lat = time.perf_counter() - t0
        res = [out[t] for t in sorted(out)]
        return (np.concatenate([r.indices for r in res]),
                np.concatenate([r.scores for r in res]),
                None if res[0].n_candidates is None else
                np.concatenate([r.n_candidates for r in res]), lat)

    searcher = IndexSearcher(index, device=dev, corpus_block=BLOCK)
    plain = PlainScored(index, device=dev, corpus_block=BLOCK)
    launches, lat = {}, {}
    for mode, rows in (("exact", exact_rows), ("lsh", held_rows)):
        kern.launches = 0
        ids, sc, n_cand, first = flush(searcher, rows, mode)
        per_flush = kern.launches
        lat[mode] = sorted([first] + [flush(searcher, rows, mode)[3]
                                      for _ in range(FLUSH_REPS[mode])])
        launches[mode] = (kern.launches, per_flush)
        p_ids, p_sc, _, _ = flush(plain, rows, mode)
        if not (np.array_equal(ids, p_ids) and np.array_equal(sc, p_sc)):
            raise AssertionError(f"{mode} flush: kernel-scored results != "
                                 "plain-scored results")
        want_launches = -(-n_docs // BLOCK) if mode == "exact" else 1
        if per_flush != want_launches:
            raise AssertionError(f"{mode} flush launched packed_match "
                                 f"{per_flush} times, want {want_launches}")
        if mode == "exact":
            ids_exact, sc_exact = ids, sc
            hit = float(np.mean(ids[:, 0] == picks))
            if hit != 1.0:
                raise AssertionError(f"exact self-hit@1 {hit} != 1.0")
        else:
            ids_lsh, sc_lsh, cand_lsh = ids, sc, n_cand
        p50 = lat[mode][len(lat[mode]) // 2]
        log(f"[search {mode}] {N_QUERIES} queries, top-{TOPK}: flush p50 "
            f"{p50 * 1e3:.1f} ms (max {lat[mode][-1] * 1e3:.1f}) over "
            f"{len(lat[mode])} flushes, {N_QUERIES / p50:.0f} q/s; "
            f"packed_match launches {per_flush} per flush; ids and scores "
            f"== plain-scored searcher"
            + (f"; self-hit@1 {hit:.2f}" if mode == "exact" else ""))
    if min(n for n, _ in launches.values()) < 1:
        raise AssertionError("a flush never launched packed_match")

    # LSH recall against exact, and where an LSH flush's time goes
    ids_he, _, _, _ = flush(searcher, held_rows, "exact")
    recall = np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / TOPK
                      for a, b in zip(ids_lsh, ids_he)])
    t0 = time.perf_counter()
    qkeys = to_numpy(band_keys_packed(held_sig.data, index.spec, cfg))
    t_keys = time.perf_counter() - t0
    t0 = time.perf_counter()
    cand = index.candidates_batch(qkeys)
    t_cand = time.perf_counter() - t0
    union = np.unique(np.concatenate(cand)).size
    log(f"[search lsh] recall@{TOPK} vs exact {recall:.4f}; candidates per "
        f"query mean {cand_lsh.mean():.0f} ({cand_lsh.mean() / n_docs:.3f} "
        f"of the corpus), union {union}; band keys {t_keys * 1e3:.1f} ms, "
        f"host candidate generation {t_cand * 1e3:.1f} ms")

    # where an exact flush's time goes: kernel, + scores, the rest merge
    def blocks(score):
        for lo in range(0, n_docs, BLOCK):
            m = kern(q_exact, corpus[lo:lo + BLOCK], k=K_IDX, code_bits=B)
            if score:
                resemblance_scores(m, None, K_IDX, B)
    t_kern, t_score = (median_ms(lambda: blocks(sc_on), torch)
                       for sc_on in (False, True))
    p50 = lat["exact"][len(lat["exact"]) // 2] * 1e3
    log(f"[search exact] per flush: kernel {t_kern:.2f} ms "
        f"({-(-n_docs // BLOCK)} eager launches, CUDA events: paced by the "
        f"host), kernel + scores {t_score:.2f} ms, top-k merge and host the "
        f"rest of the {p50:.1f} ms p50")

    # -- 4 shards, sequential fan-out, against the single index ----------
    os.remove(idx_path)        # frees its disk; the open mmaps stay valid
    t0 = time.perf_counter()
    build_sharded(sig_paths["rotation"], str(SMOKE_DIR / "rcv1_shards"), cfg,
                  n_shards=N_SHARDS, device=dev)
    shard_s = time.perf_counter() - t0
    router = load_sharded(str(SMOKE_DIR / "rcv1_shards"), device=dev,
                          corpus_block=BLOCK)
    for s in router.searchers:          # upload the shard corpora first
        s.index.corpus
    torch.cuda.synchronize()
    for mode, rows, ids, sc in (("exact", exact_rows, ids_exact, sc_exact),
                                ("lsh", held_rows, ids_lsh, sc_lsh)):
        r_ids, r_sc, _, r_lat = flush(router, rows, mode)
        if not (np.array_equal(r_ids, ids) and np.array_equal(r_sc, sc)):
            raise AssertionError(f"{N_SHARDS} shards != 1 index ({mode})")
        log(f"[shards {mode}] {N_SHARDS} shards (build {shard_s:.1f} s): "
            f"flush {r_lat * 1e3:.1f} ms, ids and scores == single index")

    total = sum(n for n, _ in launches.values())
    log(f"[retrieval] {time.perf_counter() - t_phase:.1f} s; packed_match "
        f"launches on the main path {total} ({launches})")
    row = dict(name="packed_match", route="cuda",
               source=KERNEL_INFO["packed_match"][0],
               replaces=KERNEL_INFO["packed_match"][1], launches=total,
               max_abs_err=max(err, err_s), ms=ms_blk, plain_ms=plain_blk,
               bound_ms=b_blk, bound_by=by_blk, library_ms=None)
    # what phase 7 serves: this corpus, its shards, and these answers
    ctx = dict(index=index, router=router, cfg=cfg,
               shard_dir=str(SMOKE_DIR / "rcv1_shards"),
               sig_paths=sig_paths["rotation"],
               exact_rows=np.stack(exact_rows), ids_exact=ids_exact,
               sc_exact=sc_exact, held=to_numpy(held_sig.data))
    return row, ctx


def plain_frontend_model():
    """``RecsysModel`` with its frontend through the plain versions."""
    from repro_torch.kernels import minhash as kmin
    from repro_torch.kernels.sigbag import sigbag_plain
    from repro_torch.models.recsys import RecsysModel

    class PlainFrontend(RecsysModel):
        """The same model, its frontend through the plain versions."""

        def signatures(self, set_ids, set_counts):
            return kmin.minhash2u_plain(set_ids, set_counts.reshape(-1),
                                        self.a1, self.a2,
                                        s=self.cfg.minhash_s,
                                        b=self.cfg.minhash_b)

        def signature_bag(self, sig, table):
            return sigbag_plain(sig, table)

    return PlainFrontend


def recsys_serving(torch, dev) -> tuple:
    """Phase 6: the published Wide & Deep served on the card, cells
    ``serve_p99`` and ``serve_bulk``; returns the ``sigbag`` row of the
    kernels line and the ``minhash2u`` launches of the served paths."""
    import torch.nn.functional as F

    from repro_torch.kernels import minhash as kmin
    from repro_torch.kernels.sigbag import (sigbag_cuda, sigbag_plain,
                                            sigbag_plan_cuda)
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_cell, init_inputs

    kern, mh = sigbag_cuda, kmin.minhash2u_cuda
    t_phase = time.perf_counter()
    PlainFrontend = plain_frontend_model()

    # -- build the full-width model straight on the card ------------------
    prog = build_cell("wide-deep", "serve_p99", smoke=False, device=dev)
    cfg = prog.config
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = prog.init_params(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    log(f"[recsys model] {cfg.arch_id}: {cfg.n_fields} fields x "
        f"{cfg.vocab:,} rows x d={cfg.embed_dim}, MLP {cfg.mlp_dims}, "
        f"frontend k={cfg.minhash_k} b={cfg.minhash_b} s={cfg.minhash_s} "
        f"nnz {cfg.set_nnz}; parameters {param_bytes:,} B, initialised on "
        f"the card in {init_s:.2f} s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated():,} B")

    # -- sigbag against its plain version -----------------------------------
    k, two_b, d = cfg.minhash_k, 1 << cfg.minhash_b, cfg.embed_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    tables = {"float32": model.minhash_table.detach(),
              "bfloat16": model.minhash_table.detach().to(torch.bfloat16)}
    n_req = prog.input_specs["set_ids"].shape[0]
    err, row = 0.0, None
    for dtype, n in (("float32", n_req), ("bfloat16", n_req),
                     ("float32", BULK_ROWS)):
        table = tables[dtype]
        tok = torch.randint(0, two_b, (n, k), dtype=torch.int32,
                            generator=gen, device=dev)
        plan, _ = sigbag_plan_cuda(tok, table)
        if plan.staged != (n == BULK_ROWS):
            raise AssertionError(f"sigbag {dtype} n={n} plans {plan}")
        got = kern(tok, table)
        want = sigbag_plain(tok, table)
        if not torch.equal(got, want):
            raise AssertionError(f"sigbag {dtype} n={n}: kernel != plain "
                                 "version")
        err = max(err, float((got.float() - want.float()).abs().max()))
        flat = tok.to(torch.int64) + torch.arange(k, device=dev) * two_b
        weight = table.reshape(k * two_b, d)
        if n == n_req:
            # a 512-row launch is shorter than the wrapper's host time:
            # its device time comes from a graph of SIGBAG_LOOP launches;
            # eager launches back to back give the host's launch rate
            ms = graph_ms(lambda: kern(tok, table), torch, SIGBAG_LOOP)
            lib_ms = graph_ms(lambda: F.embedding_bag(flat, weight,
                                                      mode="sum"),
                              torch, SIGBAG_LOOP)
            eager = median_ms(lambda: [kern(tok, table)
                                       for _ in range(SIGBAG_LOOP)],
                              torch) / SIGBAG_LOOP
            how = (f"median of {REPS} replays of a CUDA graph of "
                   f"{SIGBAG_LOOP} launches; eager launches back to back "
                   f"{eager:.4f} ms each")
        else:
            ms = median_ms(lambda: kern(tok, table), torch)
            lib_ms = median_ms(lambda: F.embedding_bag(flat, weight,
                                                       mode="sum"), torch)
            # one launch by events also holds the host's launch time; a
            # graph of SIGBAG_LOOP launches gives the device's alone
            dev_ms = graph_ms(lambda: kern(tok, table), torch, SIGBAG_LOOP)
            how = (f"median of {REPS}, CUDA events around one launch; "
                   f"{dev_ms:.4f} ms a launch in a CUDA graph of "
                   f"{SIGBAG_LOOP}")
        plain_ms = cuda_ms(lambda: sigbag_plain(tok, table), torch)
        b_ms, b_by, rows_read = sigbag_bound(torch, tok, table)
        design = (f"staged, {plan.rows} rows a block, {plan.stages} stages"
                  if plan.staged else "direct gather")
        log(f"[kernel] sigbag {dtype} n={n} k={k} 2^b={two_b} d={d} "
            f"({design}): {ms:.4f} ms ({how}), bound {b_ms:.4f} ms ({b_by}; "
            f"{rows_read} of {k * two_b} table rows touched), plain "
            f"{plain_ms:.2f} ms (1 call), F.embedding_bag {lib_ms:.4f} ms "
            f"(timed alike); bit-exact")
        if row is None:
            row = dict(name="sigbag", route="cuda",
                       source=KERNEL_INFO["sigbag"][0],
                       replaces=KERNEL_INFO["sigbag"][1], launches=0,
                       max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    row["max_abs_err"] = err

    # -- minhash2u at the frontend's shape ----------------------------------
    inputs = init_inputs(prog, torch.Generator(device=dev).manual_seed(SEED))
    ids, cnt = inputs["set_ids"], inputs["set_counts"]
    mh_args = (ids, cnt, model.a1, model.a2)
    mh_kw = dict(s=cfg.minhash_s, b=cfg.minhash_b)
    got, want = mh(*mh_args, **mh_kw), kmin.minhash2u_plain(*mh_args, **mh_kw)
    mh_err = max_abs_err(got, want)
    if mh_err:
        raise AssertionError(f"minhash2u k={k}: kernel != plain version "
                             f"(max |err| {mh_err})")
    total_nnz = int(cnt.sum())
    mh_ms = graph_ms(lambda: mh(*mh_args, **mh_kw), torch, SIGBAG_LOOP)
    mh_plain = cuda_ms(lambda: kmin.minhash2u_plain(*mh_args, **mh_kw), torch)
    mb_ms, mb_by = bound(minhash_bytes(total_nnz, n_req, k, False),
                         minhash_ops(total_nnz, n_req, k, False,
                                     cfg.minhash_b, False))
    log(f"[kernel] minhash2u frontend n={n_req} nnz={ids.shape[1]} "
        f"(nonzeros {total_nnz}) k={k} s={cfg.minhash_s} b={cfg.minhash_b}: "
        f"{mh_ms:.4f} ms (median of {REPS} replays of a CUDA graph of "
        f"{SIGBAG_LOOP} launches), bound {mb_ms:.4f} ms ({mb_by}), plain {mh_plain:.2f} ms;"
        f" bit-exact")

    # -- the served path ----------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    for _ in range(WARMUP_REQUESTS):
        prog.step(model, init_inputs(prog, gen))
    torch.cuda.synchronize()
    batches = [init_inputs(prog, gen) for _ in range(N_REQUESTS)]
    kern.launches = mh.launches = 0
    lat = []
    for batch in batches:
        t0 = time.perf_counter()
        scores = prog.step(model, batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = {"minhash2u": mh.launches, "sigbag": kern.launches}
    for name, count in launches.items():
        if count != N_REQUESTS:
            raise AssertionError(f"{N_REQUESTS} requests launched {name} "
                                 f"{count} times, want one per request")
    if scores.shape != (n_req,) or not bool(
            ((scores > 0) & (scores < 1)).all()):
        raise AssertionError(f"scores {tuple(scores.shape)} not in (0, 1)")
    lat.sort()
    p50 = lat[len(lat) // 2]
    p99 = lat[-(-len(lat) * 99 // 100) - 1]
    # device time of one request, with and without host gaps
    b0 = batches[0]
    frontend = lambda: model.signature_bag(
        model.signatures(b0["set_ids"], b0["set_counts"]),
        model.minhash_table)
    step_ms = graph_ms(lambda: prog.step(model, b0), torch)
    front_ms = graph_ms(frontend, torch)
    step_ev = statistics.median(cuda_ms(lambda: prog.step(model, b_), torch)
                                for b_ in batches)
    front_ev = statistics.median(cuda_ms(
        lambda: model.signature_bag(model.signatures(b_["set_ids"],
                                                     b_["set_counts"]),
                                    model.minhash_table),
        torch) for b_ in batches)
    log(f"[serve wide-deep] {N_REQUESTS} requests x batch {n_req}: p50 "
        f"{p50:.3f} ms, p99 {p99:.3f} ms, max {lat[-1]:.3f} ms (host clock "
        f"to a synchronize), {n_req * N_REQUESTS / (sum(lat) / 1e3):.0f} "
        f"rows/s; launches per request: 1 minhash2u + 1 sigbag")
    log(f"[serve wide-deep] device time of a request (CUDA graph replay) "
        f"{step_ms:.4f} ms, of it the frontend (minhash2u + sigbag) "
        f"{front_ms:.4f} ms ({front_ms / step_ms:.1%}); the device is busy "
        f"{step_ms / p50:.1%} of the p50 request. Eager, CUDA events "
        f"(median over the requests): request {step_ev:.4f} ms, frontend "
        f"{front_ev:.4f} ms")

    # -- the same batch through the plain versions --------------------------
    plain_model = PlainFrontend(cfg, model.params(), model.a1, model.a2)
    want = prog.step(plain_model, batches[0])
    got = prog.step(model, batches[0])
    if not torch.equal(got, want):
        raise AssertionError("served scores: kernels != plain versions")
    log(f"[serve wide-deep] {n_req} scores through the kernels == through "
        f"the plain versions, bit for bit")

    # -- serve_bulk: the same model, 262,144 rows a request ----------------
    bprog = build_cell("wide-deep", "serve_bulk", smoke=False, device=dev)
    n_bulk = bprog.input_specs["set_ids"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    bprog.step(model, init_inputs(bprog, gen))               # warm-up
    torch.cuda.synchronize()
    bulk = [init_inputs(bprog, gen) for _ in range(BULK_REQUESTS)]
    kern.launches = mh.launches = 0
    blat = []
    for batch in bulk:
        t0 = time.perf_counter()
        scores = bprog.step(model, batch)
        torch.cuda.synchronize()
        blat.append((time.perf_counter() - t0) * 1e3)
    bulk_launches = {"minhash2u": mh.launches, "sigbag": kern.launches}
    for name, count in bulk_launches.items():
        if count != BULK_REQUESTS:
            raise AssertionError(f"{BULK_REQUESTS} serve_bulk requests "
                                 f"launched {name} {count} times, want one "
                                 "per request")
    if scores.shape != (n_bulk,) or not bool(
            ((scores > 0) & (scores < 1)).all()):
        raise AssertionError(f"serve_bulk scores {tuple(scores.shape)} not "
                             "in (0, 1)")
    b0 = bulk[0]
    sig = model.signatures(b0["set_ids"], b0["set_counts"])
    plan, _ = sigbag_plan_cuda(sig, model.minhash_table)
    if not plan.staged:
        raise AssertionError(f"serve_bulk's sigbag plans {plan}, not the "
                             "staged design")
    step_ms = statistics.median(cuda_ms(lambda: bprog.step(model, b_), torch)
                                for b_ in bulk)
    front_ms = statistics.median(cuda_ms(
        lambda: model.signature_bag(model.signatures(b_["set_ids"],
                                                     b_["set_counts"]),
                                    model.minhash_table),
        torch) for b_ in bulk)
    bag_ms = statistics.median(cuda_ms(
        lambda: model.signature_bag(sig, model.minhash_table), torch)
        for _ in range(REPS))
    want = bprog.step(plain_model, b0)
    if not torch.equal(bprog.step(model, b0), want):
        raise AssertionError("serve_bulk scores: kernels != plain versions")
    log(f"[serve wide-deep serve_bulk] {BULK_REQUESTS} requests x batch "
        f"{n_bulk}: {', '.join(f'{x:.1f}' for x in blat)} ms (host clock to "
        f"a synchronize), {n_bulk * BULK_REQUESTS / (sum(blat) / 1e3):.0f} "
        f"rows/s; launches per request: 1 minhash2u + 1 sigbag (staged, "
        f"{plan.rows} rows a block)")
    log(f"[serve wide-deep serve_bulk] device time of a request (CUDA "
        f"events, median of {BULK_REQUESTS}) {step_ms:.3f} ms, of it the "
        f"frontend {front_ms:.3f} ms ({front_ms / step_ms:.1%}; sigbag "
        f"{bag_ms:.4f} ms); {n_bulk} scores through the kernels == through "
        f"the plain versions, bit for bit")

    # -- a small model on the CPU (plain versions) and on the card ----------
    sprog = build_cell("wide-deep", "serve_p99", smoke=True, device="cpu")
    smodel = sprog.init_params(torch.Generator().manual_seed(SEED))
    sin = init_inputs(sprog, torch.Generator().manual_seed(SEED + 1))
    s_sig = smodel.signatures(sin["set_ids"], sin["set_counts"])
    s_want = sprog.step(smodel, sin)
    smodel.to(dev)
    sin = {key: v.to(dev) for key, v in sin.items()}
    if not torch.equal(smodel.signatures(sin["set_ids"], sin["set_counts"]),
                       s_sig.to(dev)):
        raise AssertionError("smoke signatures: card != CPU")
    torch.testing.assert_close(sprog.step(smodel, sin).cpu(), s_want,
                               rtol=1e-5, atol=1e-6)
    log(f"[serve wide-deep-smoke] card == CPU plain path (signatures bit "
        f"for bit, scores within rtol 1e-5 / atol 1e-6)")

    # -- the launcher ---------------------------------------------------------
    del model, plain_model, batches, bulk, sig, want, scores
    torch.cuda.empty_cache()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "wide-deep", "--no-smoke", "--requests",
                    str(CLI_REQUESTS)])
    line = out.getvalue().strip().splitlines()[-1]
    if not re.fullmatch(rf"{CLI_REQUESTS} requests, batch {n_req}: "
                        r"p50=\d+\.\dms p99=\d+\.\dms", line):
        raise AssertionError(f"serve --arch wide-deep printed {line!r}")
    log(f"[serve CLI] python -m repro_torch.launch.serve --arch wide-deep "
        f"--no-smoke --requests {CLI_REQUESTS}: {line}")
    log(f"[recsys] {time.perf_counter() - t_phase:.1f} s; launches on the "
        f"served paths: serve_p99 {launches}, serve_bulk {bulk_launches}")
    row["launches"] = launches["sigbag"] + bulk_launches["sigbag"]
    return row, launches["minhash2u"] + bulk_launches["minhash2u"]


def open_loop(server, rows, arrivals, at_third=None):
    """Submit ``rows`` at their arrival offsets (seconds) to a started
    server; ``at_third`` runs in a thread once a third are submitted.
    Returns (handles, results, wall seconds)."""
    import threading

    side = None
    with server:
        t0 = time.monotonic()
        handles = []
        for i, (r, at) in enumerate(zip(rows, arrivals)):
            lag = at - (time.monotonic() - t0)
            if lag > 0:
                time.sleep(lag)
            handles.append(server.submit(r))
            if at_third is not None and i == len(rows) // 3:
                side = threading.Thread(target=at_third)
                side.start()
        results = [h.result(timeout=300.0) for h in handles]
        elapsed = time.monotonic() - t0
        if side is not None:
            side.join(timeout=300.0)
            if side.is_alive():
                raise AssertionError("the side task never finished")
    return handles, results, elapsed


def search_serving(torch, dev, ctx) -> int:
    """Phase 7: ``SearchServer`` over phase 5's 4 shards (1 and 2 dispatch
    workers, each on its own stream), the streamed exact scan, LSH
    sub-batches, a live append with a spill under traffic, the socket
    transport behind the resilience wrappers, and the port's ``/metrics``
    and trace; returns the ``packed_match`` launches of the served paths."""
    import urllib.request

    import numpy as np

    from repro_torch.index import (IndexSearcher, build_sharded,
                                   load_sharded)
    from repro_torch.index.builder import read_manifest
    from repro_torch.index.resilience import (ResiliencePolicy,
                                              resilient_client_factory)
    from repro_torch.index.transport import ShardService, SocketShardClient
    from repro_torch.kernels import hamming as kham
    from repro_torch.launch import serve
    from repro_torch.launch.server import SearchServer, ZipfianTraffic
    from repro_torch.obs import get_registry, get_tracer, start_http_exporter
    from repro_torch.roofline.hardware import HBM_BW

    kern = kham.packed_match_cuda
    t_phase = time.perf_counter()
    router, index = ctx["router"], ctx["index"]
    n_docs = router.n
    bounds = list(router.offsets) + [n_docs]

    def doc_row(i: int):
        s = int(np.searchsorted(bounds, i, side="right")) - 1
        return np.asarray(router.searchers[s].index.words_host[i - bounds[s]])

    def same(a, b) -> bool:
        return (np.array_equal(a.indices, b.indices)
                and np.array_equal(a.scores, b.scores))

    per_flush = sum(-(-s.index.n // BLOCK) for s in router.searchers)
    launches = {}
    reg = get_registry()

    # -- 1: the server equals direct search, 1 and 2 workers -------------
    traffic = ZipfianTraffic(n_docs, alpha=1.1, seed=1)
    ids = traffic.ids(SERVE_REQUESTS)
    arrivals = traffic.arrival_offsets(SERVE_REQUESTS, SERVE_QPS)
    rows = np.stack([doc_row(int(i)) for i in ids])
    direct = router.search(rows, TOPK)
    servers = []
    for workers in (1, 2):
        srv = SearchServer(router, max_batch=SERVE_MAX_BATCH,
                           max_delay_s=SERVE_DELAY_S, topk=TOPK,
                           num_workers=workers)
        kern.launches = 0
        handles, results, elapsed = open_loop(srv, rows, arrivals)
        n_launch = kern.launches
        snap = srv.stats.snapshot()
        got_i = np.concatenate([r.indices for r in results])
        got_s = np.concatenate([r.scores for r in results])
        if not (np.array_equal(got_i, direct.indices)
                and np.array_equal(got_s, direct.scores)):
            raise AssertionError(f"server ({workers} workers) != direct "
                                 "router.search on the same rows")
        hit = float(np.mean(got_i[:, 0] == ids))
        if hit != 1.0:
            raise AssertionError(f"served self-hit@1 {hit} != 1.0")
        if snap["errors"] or snap["requests"] != SERVE_REQUESTS:
            raise AssertionError(f"server ({workers} workers): {snap}")
        if n_launch != snap["batches"] * per_flush:
            raise AssertionError(
                f"server ({workers} workers) launched packed_match "
                f"{n_launch} times, {snap['batches']} flushes x "
                f"{per_flush} imply {snap['batches'] * per_flush}")
        launches[f"serve w{workers}"] = n_launch
        gauges = reg.values()
        pred = gauges["serve_roofline_predicted_seconds"]
        if abs(pred - gauges["serve_roofline_predicted_bytes"] / HBM_BW) \
                > 1e-12 * max(pred, 1.0) or HBM_BW != 3.35e12:
            raise AssertionError("the roofline gauge does not read the "
                                 "H100's 3.35e12 B/s")
        occ = ", ".join(f"{o:.3f}" for o in snap["worker_occupancy"])
        log(f"[serve exact] {workers} worker(s), 4 shards, "
            f"{SERVE_REQUESTS} Zipf requests offered at {SERVE_QPS:.0f} "
            f"q/s: achieved {SERVE_REQUESTS / elapsed:.0f} q/s in "
            f"{snap['batches']} flushes (mean batch {snap['mean_batch']:.1f}"
            f"); latency p50 {snap['latency_p50_ms']:.1f} ms p99 "
            f"{snap['latency_p99_ms']:.1f} ms, queue-wait p50 "
            f"{snap['queue_wait_p50_ms']:.1f} ms, flush p50 "
            f"{snap['flush_p50_ms']:.1f} ms; worker occupancy [{occ}]; "
            f"roofline gap {gauges['serve_roofline_gap']:.1f} "
            f"({gauges['serve_roofline_achieved_gbps']:.1f} GB/s against "
            f"{HBM_BW / 1e9:.0f}); triggers full {snap['flush_full']} aged "
            f"{snap['flush_aged']}; packed_match launches {n_launch} == "
            f"{snap['batches']} x {per_flush}; ids and scores == "
            f"router.search, self-hit@1 {hit:.2f}")
        servers.append(srv)

    # -- 2: the streamed scan equals the in-core scan ---------------------
    q = ctx["exact_rows"]
    streamed = IndexSearcher(index, device=dev, corpus_block=BLOCK,
                             max_device_bytes=STREAM_WINDOW)
    incore = IndexSearcher(index, device=dev, corpus_block=BLOCK)
    plan = streamed.stream_plan()
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kern.launches = 0
    res = streamed.search(q, TOPK)
    n_launch = kern.launches
    peak = torch.cuda.max_memory_allocated()
    stats = streamed.last_window_stats
    if not (np.array_equal(res.indices, ctx["ids_exact"])
            and np.array_equal(res.scores, ctx["sc_exact"])):
        raise AssertionError("streamed exact scan != in-core exact scan")
    if not 1 <= stats.high_water <= plan.inflight or stats.alive:
        raise AssertionError(f"streamed scan held {stats.high_water} "
                             f"windows, plan allows {plan.inflight}")
    want = -(-n_docs // plan.block)
    if n_launch != want:
        raise AssertionError(f"streamed flush launched {n_launch}, want "
                             f"{want}")
    launches["streamed"] = n_launch

    def flush_ms(searcher) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        searcher.search(q, TOPK)
        return (time.perf_counter() - t0) * 1e3
    t_stream = sorted(flush_ms(streamed) for _ in range(3))[1]
    t_incore = sorted(flush_ms(incore) for _ in range(3))[1]
    stats = streamed.last_window_stats
    log(f"[serve streamed] {N_QUERIES} queries through a "
        f"{STREAM_WINDOW >> 20} MiB window over the {index.meta.payload_bytes}"
        f" B payload: {stats.windows} windows of {plan.window} rows "
        f"(block {plan.block}, prefetch {plan.prefetch}), high-water "
        f"{stats.high_water} <= inflight {plan.inflight}; flush {t_stream:.1f}"
        f" ms against in-core {t_incore:.1f} ms (medians of 3); H2D "
        f"{stats.bytes / max(stats.h2d_ms, 1e-9) / 1e6:.2f} GB/s (copy-stream events, "
        f"{stats.h2d_ms:.1f} ms for {stats.bytes} B); allocator peak "
        f"{peak / 2**20:.1f} MiB, {(peak - held_before) / 2**20:.1f} MiB "
        f"above the {held_before / 2**20:.1f} MiB held before; ids and "
        f"scores == in-core, packed_match launches {n_launch}")

    # -- 3: LSH sub-batches equal one batch -------------------------------
    held = ctx["held"][:LSH_QUERIES]
    one = incore.search(held, TOPK, mode="lsh")
    subbed = IndexSearcher(index, device=dev, corpus_block=BLOCK,
                           lsh_batch=LSH_SUB)
    kern.launches = 0
    t0 = time.perf_counter()
    sub = subbed.search(held, TOPK, mode="lsh")
    t_sub = time.perf_counter() - t0
    n_launch = kern.launches
    if not (same(sub, one)
            and np.array_equal(sub.n_candidates, one.n_candidates)):
        raise AssertionError(f"lsh_batch={LSH_SUB} != one batch")
    if n_launch != -(-LSH_QUERIES // LSH_SUB):
        raise AssertionError(f"lsh_batch flush launched {n_launch}")
    launches["lsh sub-batches"] = n_launch
    log(f"[serve lsh] {LSH_QUERIES} held-out queries in sub-batches of "
        f"{LSH_SUB}: {t_sub * 1e3:.1f} ms, {n_launch} launches; ids, scores "
        f"and candidate counts == one batch")

    # -- 4: live append with a spill, under traffic -----------------------
    grow = str(SMOKE_DIR / "rcv1_grow")
    sig = ctx["sig_paths"]
    t0 = time.perf_counter()
    build_sharded(sig[:-1], grow, ctx["cfg"], n_shards=N_SHARDS, device=dev)
    grow_build_s = time.perf_counter() - t0
    man = read_manifest(grow)
    last_n = man["n"] - man["offsets"][-1]
    g_router = load_sharded(grow, device=dev, corpus_block=BLOCK,
                            max_shard_docs=last_n)
    n_old = g_router.n
    # traffic over the corpus as it will be: a query of a document still to
    # come is answered differently before and after the append
    traffic = ZipfianTraffic(n_docs, alpha=1.1, seed=2)
    a_ids = traffic.ids(APPEND_REQUESTS)
    a_arr = traffic.arrival_offsets(APPEND_REQUESTS, APPEND_QPS)
    a_rows = np.stack([doc_row(int(i)) for i in a_ids])
    pre = g_router.search(a_rows, TOPK)
    post = router.search(a_rows, TOPK)       # the whole corpus, same ids
    appended = {}

    def do_append():
        t = time.perf_counter()
        appended["touched"] = g_router.append([sig[-1]])
        appended["s"] = time.perf_counter() - t

    tracer = get_tracer()
    tracer.reset(enabled=True)
    srv = SearchServer(g_router, max_batch=SERVE_MAX_BATCH,
                       max_delay_s=SERVE_DELAY_S, topk=TOPK, num_workers=2)
    kern.launches = 0
    handles, results, elapsed = open_loop(srv, a_rows, a_arr,
                                          at_third=do_append)
    n_launch = kern.launches
    trace_path = str(SMOKE_DIR / "serve_trace.json")
    n_events = tracer.export(trace_path)
    spans = sum(1 for e in tracer.events() if e["name"] == "worker_flush")
    tracer.reset(enabled=False)
    n_diff = n_pre = n_post = 0
    for j, r in enumerate(results):
        a = (np.array_equal(r.indices[0], pre.indices[j])
             and np.array_equal(r.scores[0], pre.scores[j]))
        b = (np.array_equal(r.indices[0], post.indices[j])
             and np.array_equal(r.scores[0], post.scores[j]))
        if not (a or b):
            raise AssertionError(f"request {j} during the append matches "
                                 "neither corpus: a torn read")
        if a != b:                      # the two corpora answer it apart
            n_diff += 1
            n_pre += a
            n_post += b
    if (g_router.generation, srv.generation, g_router.n_shards,
            g_router.n) != (1, 1, N_SHARDS + 1, n_docs):
        raise AssertionError(f"after the append: generation "
                             f"{g_router.generation}, {g_router.n_shards} "
                             f"shards, {g_router.n} docs")
    if srv.stats.errors or srv.stats.requests != APPEND_REQUESTS:
        raise AssertionError(f"served during the append: {srv.stats}")
    fresh = load_sharded(grow, device=dev, corpus_block=BLOCK)
    a, b = g_router.search(q, TOPK), fresh.search(q, TOPK)
    if not same(a, b):
        raise AssertionError("appended router != a fresh load_sharded")
    if not (np.array_equal(a.indices, ctx["ids_exact"])
            and np.array_equal(a.scores, ctx["sc_exact"])):
        raise AssertionError("appended router != phase 5's single index")
    if spans < 1:
        raise AssertionError("the trace holds no worker_flush span")
    launches["append"] = n_launch
    snap = srv.stats.snapshot()
    log(f"[serve append] 4 shards of {len(sig) - 1} .sig files (build "
        f"{grow_build_s:.1f} s, {n_old} docs); {APPEND_REQUESTS} requests "
        f"at {APPEND_QPS:.0f} q/s over 2 workers while "
        f"{os.path.basename(sig[-1])} was appended with max_shard_docs="
        f"{last_n}: append wall {appended['s']:.2f} s, spilled into shard "
        f"{g_router.n_shards - 1} "
        f"({[os.path.basename(p) for p, _ in appended['touched']]}), "
        f"generation {g_router.generation}; of the {n_diff} requests the "
        f"two corpora answer apart, {n_pre} were served from the old, "
        f"{n_post} from the new, none torn; latency "
        f"p50 {snap['latency_p50_ms']:.1f} ms p99 "
        f"{snap['latency_p99_ms']:.1f} ms; results == fresh load_sharded "
        f"== phase 5's single index; trace {n_events} events, {spans} "
        f"worker_flush spans")

    # -- 5: socket transport with resilience == in-process ---------------
    services = [ShardService(s) for s in router.searchers]
    try:
        addrs = iter([svc.address for svc in services])
        fac = resilient_client_factory(
            ResiliencePolicy(),
            inner_factory=lambda s: SocketShardClient(next(addrs)))
        sock = load_sharded(ctx["shard_dir"], device=dev, corpus_block=BLOCK,
                            client_factory=fac)
        local = router.search(q, TOPK)
        t0 = time.perf_counter()
        router.search(q, TOPK)
        t_local = time.perf_counter() - t0
        kern.launches = 0
        t0 = time.perf_counter()
        got = sock.search(q, TOPK)
        t_sock = time.perf_counter() - t0
        lsh_q = ctx["held"][:SOCKET_LSH_QUERIES]
        got_lsh = sock.search(lsh_q, TOPK, mode="lsh")
        n_launch = kern.launches
    finally:
        for svc in services:
            svc.close()
    if not (same(got, local)
            and same(got_lsh, router.search(lsh_q, TOPK, mode="lsh"))):
        raise AssertionError("socket + resilient router != in-process")
    launches["socket"] = n_launch
    log(f"[serve socket] {N_SHARDS} ShardServices on loopback behind "
        f"SocketShardClient + ResilientShardClient: exact {N_QUERIES} "
        f"queries in {t_sock * 1e3:.1f} ms (in process {t_local * 1e3:.1f}"
        f" ms), LSH {SOCKET_LSH_QUERIES}; ids "
        f"and scores == the in-process router; packed_match launches "
        f"{n_launch}")

    # -- 6: /metrics of this process -------------------------------------
    with start_http_exporter(port=0) as exp:
        with urllib.request.urlopen(exp.url + "/metrics", timeout=30) as r:
            text = r.read().decode()
    fams = {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}
    need = {"serve_requests_total", "serve_latency_seconds",
            "serve_worker_occupancy", "serve_roofline_gap",
            "index_generation", "index_docs", "index_shards"}
    if not need <= fams:
        raise AssertionError(f"/metrics lacks {sorted(need - fams)}")
    log(f"[serve metrics] /metrics on 127.0.0.1:{exp.port}: {len(fams)} "
        f"families ({sum(f.startswith('serve_') for f in fams)} serve_*, "
        f"{sum(f.startswith('index_') for f in fams)} index_*)")
    del servers, srv

    # -- the launcher at its defaults -------------------------------------
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--index", "--serve"])
    lines = out.getvalue().strip().splitlines()
    if not any(re.match(r"served 64 requests in \d+ micro-batches", ln)
               for ln in lines):
        raise AssertionError(f"serve --index --serve printed {lines}")
    log(f"[serve CLI] python -m repro_torch.launch.serve --index --serve: "
        + " | ".join(lines[1:]))

    total = sum(launches.values())
    log(f"[serving] {time.perf_counter() - t_phase:.1f} s; packed_match "
        f"launches on the served paths {total} ({launches})")
    if min(launches.values()) < 1:
        raise AssertionError("a served path never launched packed_match")
    return total


def batch_learning(torch, dev, train_sets, y_train, test) -> dict:
    """Phase 8: the paper's batch-learning path on phase 3's rows --
    permutations vs 2U vs 4U (Fig. 4, and their storage), the VW
    baseline (Figs 10-12), a restarted fit, ``online_epochs``, offline
    dedup (§1) and the Appendix-A estimator.  Returns the ``minhash2u`` /
    ``minhash4u`` launches of the path."""
    import numpy as np

    from repro_torch.core.bbit import (lowest_bits, storage_bits,
                                       vw_storage_bits)
    from repro_torch.core.estimator import (empirical_p_hat,
                                            estimate_resemblance,
                                            theoretical_variance)
    from repro_torch.core.hashing import (Hash2U, Hash4U, PermutationFamily,
                                          family_storage_bytes)
    from repro_torch.core.lsh import LSHConfig, band_keys, candidate_pairs, dedup
    from repro_torch.core.minhash import minhash_signatures
    from repro_torch.core.u32 import to_numpy
    from repro_torch.core.vw import VWHasher
    from repro_torch.data.sparse import from_lists
    from repro_torch.data.synthetic import TABLE5_PAIRS, word_pair_sets
    from repro_torch.kernels import minhash as kmin
    from repro_torch.models.linear import (LinearModel, accuracy, asgd_model,
                                           make_loss_fn, sgd_svm_init,
                                           sgd_svm_step)
    from repro_torch.optim import adamw, constant
    from repro_torch.train import (TrainState, Trainer, make_train_step,
                                   online_epochs)

    wrappers = {"minhash2u": kmin.minhash2u_cuda,
                "minhash4u": kmin.minhash4u_cuda}
    calls = dict.fromkeys(wrappers, 0)      # launches the code below makes
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    train = from_lists(train_sets, y_train, device=dev)
    n_rows = train.n + test.n
    cpu_gen = torch.Generator().manual_seed(SEED + 8)
    dev_gen = torch.Generator(device=dev).manual_seed(SEED + 8)

    def signatures(batch, fam):
        if isinstance(fam, Hash2U):
            calls["minhash2u"] += 1
        elif isinstance(fam, Hash4U) and fam.use_bitmod:
            calls["minhash4u"] += 1
        return minhash_signatures(batch.indices, batch.mask, fam)

    def timed(fn):
        """(fn(), ms): host clock around work that ends in a sync."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # -- families, their storage, and signatures ---------------------------
    for w in wrappers.values():
        w.launches = 0
    perm, perm_ms = timed(lambda: PermutationFamily.create(
        K_BATCH, 1 << S, generator=dev_gen, device=dev))
    fams = {"perm": perm,
            "2u": Hash2U.create(K_BATCH, S, generator=cpu_gen, device=dev),
            "4u": Hash4U.create(K_BATCH, S, generator=cpu_gen, device=dev)}
    log(f"[batch] family storage, k={K_BATCH}, D=2^{S}: permutations "
        f"{family_storage_bytes(perm):,} B (a (D, k) int32 table, drawn on "
        f"the card in {perm_ms:.0f} ms) vs 2U "
        f"{family_storage_bytes(fams['2u']):,} B vs 4U "
        f"{family_storage_bytes(fams['4u']):,} B")
    nonzeros = int(train.nnz_per_row().sum()) + int(test.nnz_per_row().sum())
    # the gather's bound: indices read once, one 4k-byte table row a
    # nonzero, the signatures written once
    perm_bound, perm_by = bound(4 * nonzeros * (1 + K_BATCH)
                                + 4 * n_rows * K_BATCH, 0)
    sigs = {}
    for name, fam in fams.items():
        sigs[name], ms = timed(lambda: (signatures(train, fam),
                                        signatures(test, fam)))
        log(f"[batch] {name} signatures of {n_rows} rows through "
            f"minhash_signatures: {ms * 1e4 / n_rows:.3f} ms per 10,000 rows"
            + (f" (bound {perm_bound * 1e4 / n_rows:.3f} ms, {perm_by})"
               if name == "perm" else ""))
    del fams["perm"], perm                  # 13.4 GB back before training
    mod = Hash4U(a=fams["4u"].a, s=S, use_bitmod=False)
    head = slice(0, CHECK_ROWS)
    mod_sig, ms = timed(lambda: minhash_signatures(
        train.indices[head], train.mask[head], mod))
    if not torch.equal(mod_sig, sigs["4u"][0][head]):
        raise AssertionError("4U Mod signatures != 4U BitMod signatures")
    log(f"[batch] 4U Mod (plain PyTorch) on {CHECK_ROWS} rows: "
        f"{ms * 1e4 / CHECK_ROWS:.1f} ms per 10,000 rows, == BitMod bit "
        f"for bit")

    # -- Fig. 4: batch SVM for b in BATCH_BITS and each family -------------
    def fit(feats, y, b, fkind, dim, ckpt_dir=None, fail_at=None):
        loss = make_loss_fn("svm", fkind, b, C=1.0)
        opt = adamw(constant(0.05))
        state = TrainState.create(LinearModel.create(dim, dev), opt)
        step = make_train_step(lambda p, batch: loss(p, *batch), opt)
        if fail_at is not None:
            armed, inner = [True], step

            def step(st, batch):
                if armed[0] and int(st.step) == fail_at:
                    armed[0] = False
                    raise RuntimeError("injected node failure")
                return inner(st, batch)

        trainer = Trainer(step, ckpt_dir=ckpt_dir, ckpt_every=CKPT_EVERY,
                          max_failures=1)
        state = trainer.fit(state, lambda: iter([(feats, y)] * BATCH_STEPS),
                            BATCH_STEPS)
        return state, statistics.median(trainer.heartbeat.history) * 1e3

    # the gather's backward is a scatter-add: deterministic mode makes each
    # step bit-reproducible, so the restarted fit must equal the unfailed one
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        accs, step_ms, kept = {}, [], {}
        for b in BATCH_BITS:
            for name in sigs:
                tr_b, te_b = (lowest_bits(x, b) for x in sigs[name])
                state, ms = fit(tr_b, train.labels, b, "hashed",
                                K_BATCH << b)
                step_ms.append(ms)
                accs[(b, name)] = float(accuracy(
                    state.params, te_b, test.labels, feature_kind="hashed",
                    b=b))
                if (b, name) == (8, "2u"):
                    kept = dict(state=state, feats=tr_b)
            got = [accs[(b, n)] for n in sigs]
            log(f"[batch fig4] b={b}: test acc " + ", ".join(
                f"{n} {accs[(b, n)]:.4f}" for n in sigs)
                + f"; spread {max(got) - min(got):.4f}")
        low = {key: a for key, a in accs.items() if not a > 0.5 + ACC_MARGIN}
        if low:
            raise AssertionError(f"not above chance + {ACC_MARGIN}: {low}")
        log(f"[batch fig4] {len(accs)} fits x {BATCH_STEPS} full-batch steps "
            f"of {train.n} rows: {statistics.median(step_ms):.3f} ms a step "
            f"(median; deterministic algorithms)")
        ckpt_dir = str(SMOKE_DIR / "batch_ckpt")
        restarted, _ = fit(kept["feats"], train.labels, 8, "hashed",
                           K_BATCH << 8, ckpt_dir=ckpt_dir, fail_at=FAIL_AT)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
    want = kept["state"]
    if not (int(restarted.step) == BATCH_STEPS
            and torch.equal(restarted.params.w, want.params.w)
            and torch.equal(restarted.params.bias, want.params.bias)):
        raise AssertionError("restarted fit != the unfailed fit")
    log(f"[batch restart] 2u b=8, failure injected at step {FAIL_AT}, "
        f"checkpoints every {CKPT_EVERY}: restored and finished; weights == "
        f"the unfailed fit's, bit for bit")

    # -- Figs 10-12: the VW baseline ---------------------------------------
    for m_bits in VW_BITS:
        vw = VWHasher.create(m_bits, "u2", generator=cpu_gen, device=dev)
        (x_tr, x_te), vw_ms = timed(lambda: (vw(train.indices, train.mask),
                                             vw(test.indices, test.mask)))
        state, ms = fit(x_tr, train.labels, 0, "dense", vw.m)
        acc = float(accuracy(state.params, x_te, test.labels,
                             feature_kind="dense"))
        if not np.isfinite(acc):
            raise AssertionError(f"VW m=2^{m_bits}: accuracy {acc}")
        log(f"[batch vw] m=2^{m_bits}: hashing {n_rows} rows {vw_ms:.1f} ms"
            f", ({train.n}, {vw.m}) float32 {x_tr.numel() * 4:,} B, "
            f"{ms:.3f} ms a step, test acc {acc:.4f}; "
            f"{vw_storage_bits(vw.m):,} bits an example vs b-bit "
            f"{storage_bits(K_BATCH, 8):,} (k={K_BATCH}, b=8), b-bit acc "
            f"{accs[(8, '2u')]:.4f}")
        del x_tr, x_te

    # -- online_epochs over the 2U b=8 signatures --------------------------
    tr8, te8 = (lowest_bits(x, 8) for x in sigs["2u"])

    def epoch():
        for i in range(0, train.n, ONLINE_BATCH):
            yield tr8[i:i + ONLINE_BATCH], train.labels[i:i + ONLINE_BATCH]

    final, times, evals = online_epochs(
        lambda st, bt: sgd_svm_step(st, bt[0], bt[1], lam=1e-4, eta0=0.5,
                                    b=8, average=True),
        sgd_svm_init(K_BATCH << 8, avg_start=100.0, device=dev), epoch,
        ONLINE_EPOCHS, eval_fn=lambda st: accuracy(
            st.model, te8, test.labels, feature_kind="hashed", b=8))
    for e, (et, acc) in enumerate(zip(times, evals)):
        log(f"[batch online] epoch {e}: EpochTimes(load_s={et.load_s:.4f}, "
            f"train_s={et.train_s:.4f}), {-(-train.n // ONLINE_BATCH)} "
            f"mini-batches of {ONLINE_BATCH}, test acc {acc:.4f}")
    if not evals[-1] > 0.5 + ACC_MARGIN:
        raise AssertionError(f"online SGD accuracy {evals[-1]:.4f}")
    log(f"[batch online] ASGD (averaged from step 100) test acc "
        f"{float(accuracy(asgd_model(final), te8, test.labels, feature_kind='hashed', b=8)):.4f}")

    # -- offline dedup (§1) -------------------------------------------------
    rng = np.random.default_rng(DEDUP_SEED)
    corpus = [np.unique(r) for r in
              rng.integers(0, 1 << S, (DEDUP_SETS, DEDUP_NNZ))]
    for i in range(DEDUP_DUPS):
        s_i = corpus[i].copy()
        pos = rng.choice(s_i.size, int(DEDUP_SWAP * s_i.size), replace=False)
        s_i[pos] = rng.integers(0, 1 << S, pos.size)
        corpus.append(np.unique(s_i))
    docs = from_lists(corpus, device=dev)
    cfg = LSHConfig(DEDUP_BANDS, DEDUP_ROWS, 8)
    fam = Hash2U.create(cfg.k, S, generator=cpu_gen, device=dev)
    def run_dedup():
        sig_b = lowest_bits(signatures(docs, fam), cfg.b)
        return sig_b, dedup(sig_b, [len(c) for c in corpus], 1 << S, cfg,
                            threshold=DEDUP_THRESHOLD)

    (sig_docs, found), dedup_ms = timed(run_dedup)
    n_cand = len(candidate_pairs(to_numpy(band_keys(sig_docs, cfg))))
    planted = {(i, DEDUP_SETS + i) for i in range(DEDUP_DUPS)}
    got = {(i, j) for i, j, _ in found}
    if got != planted:
        raise AssertionError(f"dedup: {len(planted - got)} planted pairs "
                             f"missed, {len(got - planted)} others found")
    r_hat = [r for _, _, r in found]
    log(f"[batch dedup] {len(corpus)} sets: {n_cand} candidate pairs "
        f"({cfg.n_bands} bands x {cfg.rows_per_band} rows, b={cfg.b}), "
        f"{len(found)} pairs at R_hat >= {DEDUP_THRESHOLD} == the "
        f"{DEDUP_DUPS} planted (R_hat {min(r_hat):.3f}-{max(r_hat):.3f}); "
        f"signatures + dedup {dedup_ms:.1f} ms")

    # -- Appendix A ----------------------------------------------------------
    D = 1 << APPX_D_BITS
    pairs = [(name, f1, f2, word_pair_sets(D, f1, f2, R, seed=1))
             for name, f1, f2, R in TABLE5_PAIRS if f1 + f2 <= D // 2]
    words = from_lists([s_ for *_, ab in pairs for s_ in ab], device=dev)
    ratios = []
    for b in APPX_BITS:
        fam = Hash2U.create(APPX_REPS * APPX_K, APPX_D_BITS,
                            generator=cpu_gen, device=dev)
        sig = lowest_bits(signatures(words, fam), b).reshape(
            words.n, APPX_REPS, APPX_K)
        for p, (name, f1, f2, (s1, s2)) in enumerate(pairs):
            true_r = len(np.intersect1d(s1, s2)) / len(np.union1d(s1, s2))
            r_hat = estimate_resemblance(
                empirical_p_hat(sig[2 * p], sig[2 * p + 1]), f1, f2, D, b)
            mse = float(((r_hat - true_r) ** 2).mean())
            th = float(theoretical_variance(true_r, f1, f2, D, b, APPX_K))
            ratios.append(mse / th)
            log(f"[batch appendix A] {name:<16} R={true_r:.3f} b={b}: "
                f"MSE {mse:.6f} theory {th:.6f} ratio {mse / th:.2f}")
    log(f"[batch appendix A] {len(ratios)} (pair, b) cells, {APPX_REPS} "
        f"repetitions: MSE / theory median {statistics.median(ratios):.2f}, "
        f"range {min(ratios):.2f}-{max(ratios):.2f}")

    launches = {name: w.launches for name, w in wrappers.items()}
    if launches != calls:
        raise AssertionError(f"launches {launches} != calls {calls}")

    # -- kernels against their plain versions, off the counted path --------
    idx, cnt = train.indices[head], train.nnz_per_row()[head]
    f2, f4 = fams["2u"], fams["4u"]
    nz_train = int(train.nnz_per_row().sum())
    for name, got, plain, kern in (
            ("minhash2u", sigs["2u"][0][head],
             lambda: kmin.minhash2u_plain(idx, cnt, f2.a1, f2.a2, s=S),
             lambda: kmin.minhash2u_cuda(train.indices, train.nnz_per_row(),
                                         f2.a1, f2.a2, s=S)),
            ("minhash4u", sigs["4u"][0][head],
             lambda: kmin.minhash4u_plain(idx, cnt, f4.a, s=S),
             lambda: kmin.minhash4u_cuda(train.indices, train.nnz_per_row(),
                                         f4.a, s=S))):
        want, plain_ms = timed(plain)
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} b=0: kernel != plain (max |err| {err})")
        ms = median_ms(kern, torch)
        four_u = name == "minhash4u"
        b_ms, b_by = bound(minhash_bytes(nz_train, train.n, K_BATCH, four_u),
                           minhash_ops(nz_train, train.n, K_BATCH, four_u,
                                       0, False))
        log(f"[batch] {name} k={K_BATCH} b=0: bit-exact against its plain "
            f"version on {CHECK_ROWS} rows; per 10,000 rows the kernel alone "
            f"{ms * 1e4 / train.n:.4f} ms ({train.n} rows, CUDA events, "
            f"median of {REPS}), bound {b_ms * 1e4 / train.n:.4f} ms "
            f"({b_by}), plain {plain_ms * 1e4 / CHECK_ROWS:.1f} ms (1 call "
            f"on {CHECK_ROWS} rows)")
    log(f"[batch] {time.perf_counter() - t_phase:.1f} s; launches {launches} "
        f"== the calls made; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated():,} B ({held:,} B held before "
        f"the phase)")
    return launches


def recsys_family(torch, dev) -> dict:
    """Phase 9: AutoInt, DIN and MIND at their published widths in all
    four recsys cells, and Wide & Deep in ``retrieval_cand`` and
    ``train_batch``: ``sigbag`` at AutoInt's d = 16 in both designs and
    ``minhash2u`` at its frontend against their plain versions, served
    requests, 1,000,000 candidates scored in chunks, 20 fused Adafactor
    steps an arch, the frontend table's gradient, a restarted DIN fit and
    both launchers.  Returns the ``minhash2u`` / ``sigbag`` launches of
    the paths it drives."""
    import torch.nn.functional as F

    from repro_torch.kernels import minhash as kmin
    from repro_torch.kernels.sigbag import (sigbag_cuda, sigbag_plain,
                                            sigbag_plan_cuda)
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.steps import build_cell, init_inputs
    from repro_torch.models.recsys import (RETRIEVAL_CHUNK, RecsysModel,
                                           recsys_logits, recsys_loss)
    from repro_torch.train import TrainState, Trainer
    from repro_torch.tree import path_leaves, tree_map

    kern, mh = sigbag_cuda, kmin.minhash2u_cuda
    launches = {"minhash2u": 0, "sigbag": 0}
    PlainFrontend = plain_frontend_model()
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # full float32 products
    held = torch.cuda.memory_allocated()

    def sync_ms(t0):
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def path(fn, per_call: int, calls: int, label: str):
        """``fn()`` with every launch count at 0 before it; the frontend
        kernels must launch ``per_call`` times for each of ``calls``."""
        kern.launches = mh.launches = 0
        out = fn()
        got = {"minhash2u": mh.launches, "sigbag": kern.launches}
        if any(v != per_call * calls for v in got.values()):
            raise AssertionError(f"{label}: launches {got}, want "
                                 f"{per_call} x {calls} each")
        for name, count in got.items():
            launches[name] += count
        return out

    def rows_of(batch):
        """Rows of a batch of inputs (or of input specs)."""
        return next(iter(batch.values())).shape[0]

    def frontend_kernels(model, cfg):
        """sigbag at d = 16 (both designs) and minhash2u at the frontend's
        shapes, bit-exact against the plain versions; timed."""
        table = model.minhash_table.detach()
        k, two_b, d = table.shape
        gen = torch.Generator(device=dev).manual_seed(SEED + 34)
        weight = table.reshape(k * two_b, d)
        for n in (512, TRAIN_ROWS, BULK_ROWS):
            tok = torch.randint(0, two_b, (n, k), dtype=torch.int32,
                                generator=gen, device=dev)
            plan, sms = sigbag_plan_cuda(tok, table)
            if plan.staged != (n == BULK_ROWS):
                raise AssertionError(f"sigbag d={d} n={n} plans {plan} on "
                                     f"{sms} SMs")
            if not torch.equal(kern(tok, table), sigbag_plain(tok, table)):
                raise AssertionError(f"sigbag d={d} n={n}: kernel != plain")
            flat = tok.to(torch.int64) + torch.arange(k, device=dev) * two_b
            bag = lambda: F.embedding_bag(flat, weight, mode="sum")
            ms = graph_ms(lambda: kern(tok, table), torch, SIGBAG_LOOP)
            if n == 512:
                lib_ms = graph_ms(bag, torch, SIGBAG_LOOP)
                how = f"a CUDA graph of {SIGBAG_LOOP}, median of {REPS}"
            else:
                ev_ms = median_ms(lambda: kern(tok, table), torch)
                lib_ms = median_ms(bag, torch)
                how = (f"a CUDA graph of {SIGBAG_LOOP}, median of {REPS}; "
                       f"one launch by events {ev_ms:.4f} ms")
            plain_ms = cuda_ms(lambda: sigbag_plain(tok, table), torch)
            b_ms, b_by, rows_read = sigbag_bound(torch, tok, table)
            design = (f"staged, {plan.rows} rows a block, {plan.stages} "
                      f"stages" if plan.staged else "direct gather")
            log(f"[kernel] sigbag autoint n={n} k={k} 2^b={two_b} d={d} "
                f"float32 ({design}): {ms:.4f} ms ({how}), bound "
                f"{b_ms:.4f} ms ({b_by}; {rows_read} of {k * two_b} rows "
                f"touched), plain {plain_ms:.2f} ms, F.embedding_bag "
                f"{lib_ms:.4f} ms; bit-exact")
        for cell in ("serve_p99", "train_batch"):
            cprog = build_cell("autoint", cell, smoke=False, device=dev)
            b = init_inputs(cprog, gen)
            ids, cnt = b["set_ids"], b["set_counts"]
            args = (ids, cnt, model.a1, model.a2)
            kw = dict(s=cfg.minhash_s, b=cfg.minhash_b)
            err = max_abs_err(mh(*args, **kw),
                              kmin.minhash2u_plain(*args, **kw))
            if err:
                raise AssertionError(f"minhash2u autoint {cell}: kernel != "
                                     f"plain (max |err| {err})")
            n, nz = ids.shape[0], int(cnt.sum())
            ms = graph_ms(lambda: mh(*args, **kw), torch, SIGBAG_LOOP)
            plain_ms = cuda_ms(lambda: kmin.minhash2u_plain(*args, **kw),
                               torch)
            b_ms, b_by = bound(minhash_bytes(nz, n, k, False),
                               minhash_ops(nz, n, k, False, cfg.minhash_b,
                                           False))
            log(f"[kernel] minhash2u autoint frontend n={n} nnz="
                f"{ids.shape[1]} (nonzeros {nz}) k={k} s={cfg.minhash_s} "
                f"b={cfg.minhash_b}: {ms:.4f} ms (a CUDA graph of "
                f"{SIGBAG_LOOP}, median of {REPS}), bound {b_ms:.4f} ms "
                f"({b_by}), plain {plain_ms:.2f} ms; bit-exact")

    def served(arch, model, cfg, frontend):
        gen = torch.Generator(device=dev).manual_seed(SEED + 31)
        for cell, n_req in (("serve_p99", FAMILY_REQUESTS),
                            ("serve_bulk", FAMILY_BULK)):
            cprog = build_cell(arch, cell, smoke=False, device=dev)
            cprog.step(model, init_inputs(cprog, gen))           # warm-up
            torch.cuda.synchronize()
            reqs = [init_inputs(cprog, gen) for _ in range(n_req)]

            def serve_all():
                lat = []
                for batch in reqs:
                    t0 = time.perf_counter()
                    scores = cprog.step(model, batch)
                    lat.append(sync_ms(t0))
                return scores, lat

            scores, lat = path(serve_all, frontend, n_req, f"{arch} {cell}")
            n = rows_of(reqs[0])
            if scores.shape != (n,) or not bool(
                    ((scores > 0) & (scores < 1)).all()):
                raise AssertionError(f"{arch} {cell}: scores "
                                     f"{tuple(scores.shape)} not in (0, 1)")
            if frontend:
                plain = PlainFrontend(cfg, model.params(), model.a1, model.a2)
                if not torch.equal(cprog.step(plain, reqs[0]),
                                   cprog.step(model, reqs[0])):
                    raise AssertionError(f"{arch} {cell}: scores through the "
                                         "kernels != the plain versions'")
                check = "== through the plain versions, bit for bit"
            elif cell == "serve_p99":
                m64 = RecsysModel(cfg, tree_map(lambda t: t.detach().double(),
                                                model.params()))
                with torch.inference_mode():
                    z32 = recsys_logits(model, reqs[0]).double()
                    z64 = recsys_logits(m64, reqs[0])
                err = float((z32 - z64).abs().max())
                top = float(z64.abs().max())
                if not bool(((z32 - z64).abs() <= F64_RTOL * z64.abs()
                             + F64_ATOL_SHARE * top).all()):
                    raise AssertionError(f"{arch}: float32 logits != float64"
                                         f" (max |err| {err:.3e}, max "
                                         f"|logit| {top:.3e})")
                del m64
                check = (f"logits == float64 within rtol {F64_RTOL} / atol "
                         f"{F64_ATOL_SHARE} x max (max |err| {err:.3e} at "
                         f"max |logit| {top:.3e})")
            else:
                check = "scores in (0, 1)"
            lat.sort()
            timing = (f"p50 {lat[len(lat) // 2]:.3f} ms, p99 "
                      f"{lat[-(-len(lat) * 99 // 100) - 1]:.3f} ms"
                      if n_req > FAMILY_BULK
                      else ", ".join(f"{x:.1f}" for x in lat) + " ms")
            log(f"[family {arch} {cell}] {n_req} requests x batch {n}: "
                f"{timing} (host clock to a synchronize), "
                f"{n * n_req / (sum(lat) / 1e3):.0f} rows/s; launches a "
                f"request: {frontend} minhash2u + {frontend} sigbag; {check}")
            log(f"[family {arch} {cell}] profile of a request: "
                + device_breakdown(lambda: cprog.step(model, reqs[0]),
                                   torch))

    def retrieval(arch, model, cfg, frontend):
        rprog = build_cell(arch, "retrieval_cand", smoke=False, device=dev)
        n_cand = rprog.n_candidates
        chunks = -(-n_cand // RETRIEVAL_CHUNK)
        gen = torch.Generator(device=dev).manual_seed(SEED + 32)
        queries = [init_inputs(rprog, gen)
                   for _ in range(RETRIEVAL_QUERIES + 1)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rprog.step(model, queries[0])                            # warm-up

        def run():
            outs, lat = [], []
            for q in queries[1:]:
                t0 = time.perf_counter()
                outs.append(rprog.step(model, q))
                lat.append(sync_ms(t0))
            return outs, lat

        outs, lat = path(run, frontend * chunks, RETRIEVAL_QUERIES,
                         f"{arch} retrieval_cand")
        peak = torch.cuda.max_memory_allocated()
        got = outs[-1]
        if got.shape != (n_cand,) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{arch} retrieval: {tuple(got.shape)} or "
                                 "not finite")
        q = queries[-1]
        m = min(RETRIEVAL_CHECK, n_cand)
        rows = {key: v.expand(m, *v.shape[1:]).contiguous()
                for key, v in q.items()}
        cand = torch.arange(m, dtype=torch.int32, device=dev)
        if "target_id" in rows:
            rows["target_id"] = cand % cfg.item_vocab
        else:
            rows["field_ids"][:, -1] = cand % cfg.vocab
        with torch.inference_mode():
            want = recsys_logits(model, rows)
        diff = (got[:m] - want).abs()
        top = float(want.abs().max())
        if not bool((diff <= CHUNK_RTOL * want.abs()
                     + CHUNK_ATOL_SHARE * top).all()):
            raise AssertionError(f"{arch} retrieval: candidates 0..{m - 1} "
                                 f"!= the explicit rows (max |err| "
                                 f"{float(diff.max()):.3e})")
        log(f"[family {arch} retrieval_cand] {RETRIEVAL_QUERIES} queries x "
            f"{n_cand:,} candidates in {chunks} chunks of {RETRIEVAL_CHUNK:,}"
            f": {', '.join(f'{x:.1f}' for x in lat)} ms (host clock to a "
            f"synchronize), {n_cand * RETRIEVAL_QUERIES / (sum(lat) / 1e3):,.0f}"
            f" candidates/s; max_memory_allocated {peak:,} B ({peak - base:,}"
            f" B above the model); candidates 0..{m - 1} == the explicit "
            f"rows within rtol {CHUNK_RTOL} (max |err| {float(diff.max()):.3e})"
            f"; launches a query: {frontend * chunks} minhash2u + "
            f"{frontend * chunks} sigbag")
        log(f"[family {arch} retrieval_cand] profile of a query: "
            + device_breakdown(lambda: rprog.step(model, q), torch))

    def training(arch, model, cfg, frontend):
        tprog = build_cell(arch, "train_batch", smoke=False, device=dev)
        params = model.params()
        gen = torch.Generator(device=dev).manual_seed(SEED + 33)
        batches = [init_inputs(tprog, gen) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def run():
            p, o, losses, ms = params, tprog.optimizer.init(params), [], []
            for b in batches:
                t0 = time.perf_counter()
                p, o, loss = tprog.step(model, p, o, b)
                ms.append(sync_ms(t0))
                losses.append(float(loss))
            return p, o, losses, ms

        new, o_last, losses, ms = path(run, frontend, TRAIN_STEPS,
                                       f"{arch} train_batch")
        peak = torch.cuda.max_memory_allocated()
        if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
            raise AssertionError(f"{arch} train: losses {losses}")
        still = [key for (key, a), (_, b) in zip(path_leaves(params),
                                                 path_leaves(new))
                 if torch.equal(a, b)]
        if still:
            raise AssertionError(f"{arch} train: {still} did not change")
        log(f"[family {arch} train_batch] {TRAIN_STEPS} fused Adafactor "
            f"steps x {rows_of(batches[0]):,} rows: first {ms[0]:.1f} ms, "
            f"then {statistics.median(ms[1:]):.2f} ms a step (median, host "
            f"clock to a synchronize); loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}; every parameter leaf changed; "
            f"max_memory_allocated {peak:,} B ({peak - base:,} B above the "
            f"model); launches a step: {frontend} minhash2u + {frontend} "
            f"sigbag")
        log(f"[family {arch} train_batch] profile of a step: "
            + device_breakdown(lambda: tprog.step(model, new, o_last,
                                                  batches[0]), torch))
        del new, o_last
        if frontend:
            b = batches[0]

            def table_grad(m):
                live = tree_map(lambda t: t.detach().requires_grad_(True),
                                m.params())
                loss = recsys_loss(m, b, live)
                return torch.autograd.grad(loss, [live["minhash_table"]])[0]

            g_kern = table_grad(model)
            g_plain = table_grad(PlainFrontend(cfg, model.params(), model.a1,
                                               model.a2))
            err = float((g_kern - g_plain).abs().max())
            top = float(g_plain.abs().max())
            if not top > 0 or err > GRAD_ATOL_SHARE * top:
                raise AssertionError(f"{arch}: minhash_table gradient through"
                                     f" the kernel != through sigbag_plain "
                                     f"(max |err| {err:.3e} of {top:.3e})")
            log(f"[family {arch} train_batch] minhash_table gradient at "
                f"{rows_of(b):,} rows, sigbag kernel + scatter-add backward "
                f"== autograd through sigbag_plain within "
                f"{GRAD_ATOL_SHARE} x max (max |err| {err:.3e} of "
                f"{top:.3e})")
            del g_kern, g_plain
        if arch == "din":
            restart(tprog, model, batches[:RESTART_STEPS])

    def restart(tprog, model, batches):
        """A DIN fit restarted from its checkpoint after a failure ==
        the unfailed fit, bit for bit, under deterministic algorithms."""
        def fit(ckpt_dir=None, fail_at=None):
            armed = [fail_at is not None]

            def step(st, batch):
                if armed[0] and int(st.step) == fail_at:
                    armed[0] = False
                    raise RuntimeError("injected node failure")
                p, o, loss = tprog.step(model, st.params, st.opt_state, batch)
                return (TrainState(params=p, opt_state=o, step=st.step + 1),
                        {"loss": loss})

            params = model.params()
            state = TrainState(params=params,
                               opt_state=tprog.optimizer.init(params),
                               step=torch.zeros((), dtype=torch.int32,
                                                device=dev))
            trainer = Trainer(step, ckpt_dir=ckpt_dir,
                              ckpt_every=RESTART_EVERY, max_failures=1)
            return trainer.fit(state, lambda: iter(batches), len(batches))

        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            unfailed = fit()
            restarted = fit(str(SMOKE_DIR / "din_ckpt"), RESTART_FAIL_AT)
        finally:
            torch.use_deterministic_algorithms(was)
        same = [torch.equal(a, b) for (_, a), (_, b) in zip(
            path_leaves(unfailed), path_leaves(restarted))]
        if int(restarted.step) != len(batches) or not all(same):
            raise AssertionError("din: restarted fit != the unfailed fit")
        log(f"[family din restart] {len(batches)} steps, failure injected at "
            f"step {RESTART_FAIL_AT}, checkpoints every {RESTART_EVERY}: "
            f"restored and finished; parameters and Adafactor state == the "
            f"unfailed fit's, bit for bit (deterministic algorithms)")

    for arch in FAMILY:
        prog = build_cell(arch, "serve_p99", smoke=False, device=dev)
        cfg = prog.config
        frontend = int(cfg.use_minhash_frontend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = prog.init_params(torch.Generator(device=dev).manual_seed(
            SEED + 30))
        init_ms = sync_ms(t0)
        nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
        log(f"[family {arch}] {cfg.interaction}: parameters {nbytes:,} B, "
            f"drawn on the card in {init_ms:.0f} ms"
            + (f"; frontend k={cfg.minhash_k} b={cfg.minhash_b} d="
               f"{cfg.embed_dim}" if frontend else ""))
        if arch == "autoint":
            frontend_kernels(model, cfg)
        if arch != "wide-deep":                 # phase 6 serves it
            served(arch, model, cfg, frontend)
        retrieval(arch, model, cfg, frontend)
        training(arch, model, cfg, frontend)
        del model
        torch.cuda.empty_cache()

    # -- the launchers ------------------------------------------------------
    n_req = rows_of(build_cell("autoint", "serve_p99", smoke=False,
                               device=dev).input_specs)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "autoint", "--no-smoke", "--requests",
                    str(CLI_REQUESTS)])
    line = out.getvalue().strip().splitlines()[-1]
    if not re.fullmatch(rf"{CLI_REQUESTS} requests, batch {n_req}: "
                        r"p50=\d+\.\dms p99=\d+\.\dms", line):
        raise AssertionError(f"serve --arch autoint printed {line!r}")
    log(f"[family CLI] python -m repro_torch.launch.serve --arch autoint "
        f"--no-smoke --requests {CLI_REQUESTS}: {line}")
    torch.cuda.empty_cache()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli.main(["--arch", "din", "--no-smoke", "--steps",
                        str(CLI_TRAIN_STEPS)])
    lines = out.getvalue().strip().splitlines()
    if not (re.fullmatch(r"din/train_batch: [\d,]+ params, "
                         r"optimizer=fused-adafactor", lines[0])
            and re.fullmatch(rf"loss: first=\d+\.\d{{4}} last=\d+\.\d{{4}} "
                             rf"\({CLI_TRAIN_STEPS} steps from step 0, \d+ "
                             r"stragglers\)", lines[-1])):
        raise AssertionError(f"train --arch din printed {lines!r}")
    log(f"[family CLI] python -m repro_torch.launch.train --arch din "
        f"--no-smoke --steps {CLI_TRAIN_STEPS}: {' | '.join(lines)}")
    torch.cuda.empty_cache()
    log(f"[family] {time.perf_counter() - t_phase:.1f} s; launches on the "
        f"driven paths {launches}; {held:,} B held before the phase")
    return launches



class replayed_routing:
    """Within ``with replayed_routing(moe_lib) as r:``, ``moe_lib.route``
    records each call's expert ids; after ``r.replay()`` the calls, made
    in the same order, route to the recorded experts, each token weighted
    by this call's own router scores there, normalised as ``route`` does.
    ``r.flips`` counts the token-layers whose free choice differed."""

    def __init__(self, moe_lib):
        self.moe, self.route = moe_lib, moe_lib.route
        self.ids, self.at, self.flips = [], None, 0

    def __enter__(self):
        self.moe.route = self._route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def replay(self):
        self.at = 0

    def _route(self, params, x, cfg):
        import torch
        topv, topi = self.route(params, x, cfg)
        if self.at is None:
            self.ids.append(topi)
            return topv, topi
        ids = self.ids[self.at]
        self.at += 1
        self.flips += int((topi.sort(-1).values != ids.sort(-1).values)
                          .any(-1).sum())
        logits = x.float() @ params["router"]
        scores = (torch.sigmoid(logits) if cfg.router == "sigmoid"
                  else torch.softmax(logits, dim=-1))
        v = scores.gather(-1, ids)
        return v / v.sum(-1, keepdim=True).clamp(min=1e-9), ids


def as_float32(model, fn):
    """``fn()`` with every parameter of ``model`` widened to float32 (exact),
    then each returned to its own type."""
    types = [p.dtype for p in model.parameters()]
    for p in model.parameters():
        p.data = p.data.float()
    try:
        return fn()
    finally:
        for p, t in zip(model.parameters(), types):
            p.data = p.data.to(t)


def lm_prefill_flops(cfg, batch: int, seq: int) -> float:
    """Matmul FLOPs of one ``forward`` as the reference computes it: every
    projection, every expert on its whole capacity buffer (empty rows
    included), and every attention block, masked ones too (Q.K and P.V
    over all S x S pairs).  The output projection is not part of a
    prefill."""
    from repro_torch.models.moe import _capacity
    T, d, H = batch * seq, cfg.d_model, cfg.n_heads
    if cfg.attention == "mla":
        dqk, dv = cfg.qk_nope + cfg.qk_rope, cfg.v_head
        proj = (d * cfg.q_lora + cfg.q_lora * H * dqk + d * cfg.kv_lora
                + cfg.kv_lora * H * (cfg.qk_nope + dv) + d * cfg.qk_rope
                + H * dv * d)
    else:
        dqk = dv = cfg.head_dim
        proj = 2 * d * H * dqk + 2 * d * cfg.n_kv * dqk
    attn = 2 * T * proj + 2 * batch * H * seq * seq * (dqk + dv)
    n_dense = cfg.n_dense_layers if cfg.is_moe else cfg.n_layers
    total = (cfg.n_layers * attn
             + n_dense * 2 * T * 3 * d * (cfg.d_ff_dense or cfg.d_ff))
    if cfg.is_moe:
        m = cfg.moe
        total += (cfg.n_layers - cfg.n_dense_layers) * (
            2 * T * d * m.n_experts
            + 2 * m.n_experts * _capacity(T, m) * 3 * d * m.d_ff
            + 2 * T * 3 * d * m.d_ff * m.n_shared)
    return float(total)


def lm_serving(torch, dev) -> None:
    """Phase 10: the LM family served at its published widths in bfloat16,
    depth and batch cut as ``LM_RUNS`` says: per arch a timed prefill and
    a timed greedy decode through ``build_cell`` / ``init_inputs`` /
    ``step``, each beside its bound; then, at depth 2, the card's checks
    -- bfloat16 against the same weights in float32, prefill against
    decode in float32, every decode step writing the cache at pos - 1 and
    nowhere else, deepseek-v3's MoE dispatch against a per-token loop --
    and ``python -m repro_torch.launch.serve --arch`` for each arch at its
    smoke config.  No kernel of ours runs here: the reference computes
    attention, MLA and the MoE dispatch in plain jnp."""
    import dataclasses

    from repro_torch.configs import get_arch, get_cell
    from repro_torch.configs.base import InputSpec
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_cell, init_inputs
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import swiglu
    from repro_torch.tree import path_leaves, tree_map

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # full float32 checks
    held = torch.cuda.memory_allocated()
    i32 = torch.int32

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def cut(arch, cell, depth, batch, seq):
        """``build_cell(arch, cell)`` at ``depth`` layers, ``batch`` rows
        and ``seq`` positions (prefill tokens, or the decode cache)."""
        prog = build_cell(arch, cell, smoke=False, device=dev)
        cfg = prog.config
        # an MoE arch keeps its MoE stack: deepseek-v3 at depth 2 is one
        # dense layer and one MoE layer
        cfg = dataclasses.replace(cfg, n_layers=depth, n_dense_layers=min(
            cfg.n_dense_layers, depth - 1 if cfg.is_moe else 0))
        if prog.kind == "lm_prefill":
            specs = {"tokens": InputSpec((batch, seq), i32)}
        else:
            cache = {key: {name: InputSpec(tuple(t.shape), t.dtype)
                           for name, t in stack.items()}
                     for key, stack in tfm.cache_shapes(cfg, batch,
                                                        seq).items()}
            specs = {"cache": cache, "tokens": InputSpec((batch,), i32),
                     "pos": InputSpec((), i32)}
        return dataclasses.replace(prog, config=cfg, input_specs=specs)

    def timed(arch, depth, seq, dec_cell, dec_batch, steps):
        """The cut model's timed prefill and decode; returns the rows of
        the phase's summary."""
        gen = torch.Generator(device=dev).manual_seed(SEED + 50)
        pre = cut(arch, "prefill_32k", depth, 1, seq)
        cfg = pre.config
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = pre.init_params(gen)
        init_s = sync_s(t0)
        w_bytes = nbytes(model.parameters())
        log(f"[lm {arch}] {depth} of {get_arch(arch).config.n_layers} "
            f"layers, d={cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv}, "
            f"{cfg.attention}{', window %d' % cfg.local_window if cfg.local_window else ''}"
            f"{', %d experts top-%d' % (cfg.moe.n_experts, cfg.moe.top_k) if cfg.is_moe else ''}"
            f", {str(cfg.param_dtype)[6:]}: weights {w_bytes:,} B drawn on "
            f"the card in "
            f"{init_s:.1f} s")
        inputs = init_inputs(pre, gen)
        pre.step(model, {"tokens": inputs["tokens"][:, :LM_WARMUP_SEQ]})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = pre.step(model, inputs)
        pre_s = sync_s(t0)
        if h.shape != (1, seq, cfg.d_model) or not bool(
                torch.isfinite(h).all()):
            raise AssertionError(f"{arch} prefill: {tuple(h.shape)}, "
                                 "or not finite")
        flops = lm_prefill_flops(cfg, 1, seq)
        pre_b = w_bytes + nbytes([inputs["tokens"], h])
        pre_bound = max((flops / BF16_DENSE_FLOPS * 1e3, "operations"),
                        (pre_b / HBM_BYTES_PER_S * 1e3, "bytes"))
        log(f"[lm {arch}] prefill 1 x {seq:,}: {pre_s * 1e3:.1f} ms "
            f"({seq / pre_s:,.0f} tokens/s; host clock to a synchronize, "
            f"after an untimed {LM_WARMUP_SEQ:,}-token prefill), bound "
            f"{pre_bound[0]:.1f} ms ({pre_bound[1]}: {flops:.4e} FLOP at "
            f"{BF16_DENSE_FLOPS:.3e}/s), {pre_bound[0] / (pre_s * 1e3):.1%}"
            f" of it")
        if arch == "deepseek-7b":
            short = {"tokens": inputs["tokens"][:, :LM_PROFILE_SEQ]}
            log(f"[lm {arch}] prefill 1 x {LM_PROFILE_SEQ:,} under the "
                f"profiler: "
                + device_breakdown(lambda: pre.step(model, short), torch))
        del h, inputs

        L = get_cell(arch, dec_cell).dims["seq"]
        dec = cut(arch, dec_cell, depth, dec_batch, L)
        inputs = init_inputs(dec, gen)
        cache, tokens = inputs["cache"], inputs["tokens"]
        pos = torch.ones((), dtype=i32, device=dev)
        tokens, cache = dec.step(model, {"cache": cache, "tokens": tokens,
                                         "pos": pos})       # warm-up step
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps - 1):
            pos = pos + 1
            tokens, cache = dec.step(model, {"cache": cache,
                                             "tokens": tokens, "pos": pos})
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / (steps - 1)
        if not (tokens.dtype == i32 and 0 <= int(tokens.min())
                and int(tokens.max()) < cfg.vocab):
            raise AssertionError(f"{arch} decode: tokens {tokens}")
        for path, leaf in path_leaves(cache):
            written = leaf[:, :, :steps].flatten(3).abs().amax(-1) > 0
            # per (layer, row): a contiguous slab, read without a copy
            rest = torch.stack([leaf[i, b, steps:].any()
                                for i in range(leaf.shape[0])
                                for b in range(leaf.shape[1])])
            if bool(rest.any()) or not bool(written.all()):
                raise AssertionError(f"{arch} decode: cache {path} not "
                                     f"written at exactly 0..{steps - 1}")
        cache_b = nbytes(t for _, t in path_leaves(cache))
        embed = model.params()["embed"]
        dec_b = (w_bytes - nbytes([embed]) + cache_b
                 + dec_batch * cfg.d_model * embed.element_size())
        dec_bound = dec_b / HBM_BYTES_PER_S * 1e3
        log(f"[lm {arch}] decode {dec_cell} batch {dec_batch} x {L:,} "
            f"(cache {cache_b:,} B): {step_ms:.2f} ms a step "
            f"({dec_batch / step_ms * 1e3:,.1f} tokens/s; CUDA events over "
            f"{steps - 1} steps after a warm-up step), bound "
            f"{dec_bound:.2f} ms (bytes: {dec_b:,} B of weights and the "
            f"whole cache at {HBM_BYTES_PER_S:.3e} B/s), "
            f"{dec_bound / step_ms:.1%} of it")
        if arch == "deepseek-7b":
            nxt = {"cache": cache, "tokens": tokens, "pos": pos + 1}
            log(f"[lm {arch}] one decode step under the profiler: "
                + device_breakdown(lambda: dec.step(model, nxt), torch))
        peak = torch.cuda.max_memory_allocated()
        log(f"[lm {arch}] max_memory_allocated {peak:,} B")
        return dict(prefill_ms=pre_s * 1e3, prefill_bound=pre_bound[0],
                    decode_ms=step_ms, decode_bound=dec_bound, peak=peak)

    def moe_check(p, mcfg, d):
        """deepseek-v3's MoE layer (float32) on CHECK_TOKENS tokens, 24 of
        them copies of token 0, which overflow its experts' capacity:
        ``_moe_ffn_dense`` against a loop over each token's kept
        assignments, and the same dropped set."""
        T, E, k = CHECK_TOKENS, mcfg.n_experts, mcfg.top_k
        g = torch.Generator(device=dev).manual_seed(SEED + 52)
        x = torch.randn((T, d), generator=g, device=dev)
        x[40:] = x[0]
        got = moe_lib._moe_ffn_dense(p, x, mcfg)
        C = moe_lib._capacity(T, mcfg)
        topv, topi = moe_lib.route(p, x, mcfg)
        dp = moe_lib.dispatch(topv, topi, E, C)
        kernel_drops = {(int(t), int(o) % k) for t, o, kept in
                        zip(dp.tok.tolist(), dp.order.tolist(),
                            dp.keep.tolist()) if not kept}
        seen, drops = [0] * E, set()
        want = swiglu(x, p["shared"]["w_gate"], p["shared"]["w_up"],
                      p["shared"]["w_down"])
        for t, experts in enumerate(topi.tolist()):
            for j, e in enumerate(experts):
                if seen[e] >= C:
                    drops.add((t, j))
                else:
                    want[t] += topv[t, j] * swiglu(
                        x[t:t + 1], p["w_gate"][e], p["w_up"][e],
                        p["w_down"][e])[0]
                seen[e] += 1
        if kernel_drops != drops or not drops:
            raise AssertionError(f"MoE dispatch dropped {len(kernel_drops)}"
                                 f" assignments, the loop {len(drops)}")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= MOE_ATOL_SHARE * scale:
            raise AssertionError(f"MoE dispatch vs the loop: max |err| "
                                 f"{err:.3e} of {scale:.3e}")
        log(f"[lm deepseek-v3-671b] MoE dispatch ({E} experts top-{k}, "
            f"shared expert, capacity {C}) on {T} tokens == a per-token "
            f"loop: the same {len(drops)} dropped assignments, max |err| "
            f"{err:.3e} of {scale:.3e} (float32)")

    def checks(arch):
        """Depth 2, CHECK_TOKENS tokens: bfloat16 vs float32 on the same
        weights; prefill == decode in float32 with every decode step
        writing the cache at pos - 1 only; deepseek-v3's MoE dispatch."""
        gen = torch.Generator(device=dev).manual_seed(SEED + 51)
        pre = cut(arch, "prefill_32k", CHECK_DEPTH, 1, CHECK_TOKENS)
        model = pre.init_params(gen)
        tokens = init_inputs(pre, gen)["tokens"]
        cfg32 = dataclasses.replace(pre.config, param_dtype=torch.float32)
        with replayed_routing(moe_lib) as routing:
            h32 = as_float32(model, lambda: dataclasses.replace(
                pre, config=cfg32).step(model, {"tokens": tokens}))
            routing.replay()
            h16 = pre.step(model, {"tokens": tokens}).float()
        flips = routing.flips
        for p in model.parameters():             # float32 from here on
            p.data = p.data.float()
        rel = ((h16 - h32).norm(dim=-1) / h32.norm(dim=-1))[0]  # per token
        med, worst = float(rel.median()), float(rel.max())
        if not (med < BF16_REL_L2 and worst < BF16_REL_MAX):
            raise AssertionError(f"{arch}: bfloat16 vs float32 hidden "
                                 f"states, per-token relative L2 median "
                                 f"{med:.3e}, max {worst:.3e}")
        if cfg32.is_moe:
            if arch == "deepseek-v3-671b":       # its layer 1, the MoE one
                moe_check(tree_map(lambda t: t[0],
                                   model.params()["layers"]["ffn"]),
                          cfg32.moe, cfg32.d_model)
            # for the prefill == decode check only: capacity n_experts /
            # top_k, so that neither path drops an assignment
            cfg32 = dataclasses.replace(cfg32, moe=dataclasses.replace(
                cfg32.moe,
                capacity_factor=cfg32.moe.n_experts / cfg32.moe.top_k))
        h = dataclasses.replace(pre, config=cfg32).step(
            model, {"tokens": tokens})[0]
        logits = h @ model.params()["out"]                   # (S, V)
        top2 = logits.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > LOGIT_MARGIN
        dec = dataclasses.replace(
            cut(arch, "decode_32k", CHECK_DEPTH, 1, CHECK_TOKENS),
            config=cfg32)
        cache = init_inputs(dec, gen)["cache"]
        got = []
        for t in range(CHECK_TOKENS):
            before = {path: c.clone() for path, c in path_leaves(cache)}
            nxt, cache = dec.step(model, {"cache": cache,
                                          "tokens": tokens[:, t],
                                          "pos": t + 1})
            for path, leaf in path_leaves(cache):
                changed = (leaf != before[path]).flatten(3).any(-1)
                want = torch.zeros_like(changed)
                want[:, :, t] = True          # every layer and row, pos - 1
                if not torch.equal(changed, want):
                    raise AssertionError(f"{arch} decode step {t + 1}: "
                                         f"cache {path} changed elsewhere")
            got.append(nxt)
        got = torch.cat(got)
        agree = (got == logits.argmax(-1).to(i32))[clear]
        if not bool(agree.all()):
            raise AssertionError(f"{arch}: decode != prefill argmax at "
                                 f"{int((~agree).sum())} positions")
        log(f"[lm {arch}] checks at depth {CHECK_DEPTH}, {CHECK_TOKENS} "
            f"tokens, max_memory_allocated {torch.cuda.max_memory_allocated():,}"
            f" B: bfloat16 vs float32 per-token relative L2 median "
            f"{med:.3e} (bound {BF16_REL_L2}), max {worst:.3e} (bound "
            f"{BF16_REL_MAX})"
            + (f", bfloat16 routed as float32 chose (free bfloat16 routing "
               f"would send {flips} token-layers to other experts)"
               if cfg32.is_moe else "")
            + f"; float32 decode == prefill argmax at all "
            f"{int(clear.sum())} positions with a top-2 margin > "
            f"{LOGIT_MARGIN}; each step wrote the cache at pos - 1 only, "
            f"every layer ({', '.join(p for p, _ in path_leaves(cache))})")

    summary = {}
    for arch, run in LM_RUNS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        summary[arch] = timed(arch, *run)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        checks(arch)
    torch.cuda.empty_cache()

    pattern = (r"decoded 16 tokens x batch 2 in \d+\.\d\ds \(\d+\.\d tok/s\);"
               r" first sequence: \[(\d+, ){7}\d+\]")
    for arch in LM_RUNS:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serve.main(["--arch", arch])
        line = out.getvalue().strip().splitlines()[-1]
        if not re.fullmatch(pattern, line):
            raise AssertionError(f"serve --arch {arch} printed {line!r}")
        log(f"[lm CLI] python -m repro_torch.launch.serve --arch {arch}: "
            f"{line}")
    log(f"[lm] {time.perf_counter() - t_phase:.1f} s, {held:,} B held "
        f"before the phase (peaks include it); " + "; ".join(
        f"{a}: prefill {r['prefill_ms']:.1f} ms (bound "
        f"{r['prefill_bound']:.1f}), decode {r['decode_ms']:.2f} ms a step "
        f"(bound {r['decode_bound']:.2f}), peak {r['peak']:,} B"
        for a, r in summary.items()))

def lm_train_flops(cfg, seq: int) -> float:
    """Matmul FLOPs of one microbatch of one sequence as the train step
    computes it: the forward's products (``lm_prefill_flops``) three times
    (the forward, and a backward of twice its products), once more where
    ``cfg.remat`` recomputes each layer in the backward, and the output
    head: 2·T·d·V forward, 4·T·d·V backward and 2·T·d·V again where the
    loss chunks are recomputed."""
    fwd = lm_prefill_flops(cfg, 1, seq)
    return (4 if cfg.remat else 3) * fwd + 8 * seq * cfg.d_model * cfg.vocab


def prune(tree: dict, frozen, prefix: str = "") -> dict:
    """``tree`` without the leaves whose paths are in ``frozen``."""
    return {k: prune(v, frozen, f"{prefix}{k}/") if isinstance(v, dict)
            else v for k, v in tree.items() if f"{prefix}{k}" not in frozen}


def merged(part, full):
    """``full`` with the leaves ``part`` (``full`` pruned) holds taken from
    ``part``."""
    if isinstance(full, dict):
        return {k: merged(part[k], v) if k in part else v
                for k, v in full.items()}
    if isinstance(full, list):
        return [merged(a, b) for a, b in zip(part, full)]
    return part


def lm_training(torch, dev) -> None:
    """Phase 11: the LM family trained at its published widths in bfloat16,
    depth, batch and (deepseek-v3) sequence cut as ``LM_TRAIN_RUNS`` says:
    per arch, steps of the ``train_4k`` cell through ``build_cell`` /
    ``init_inputs`` / ``step`` with the published config's optimizer and
    microbatch count, timed beside their FLOP bound, the first loss against
    ln V + 0.5, a profiler breakdown of a deepseek-7b step; then the card's
    checks -- ``matmul_f32``'s bfloat16 backward against autograd through
    float32-widened operands, and at depth 2: bfloat16 against float32 on
    the same weights (routing replayed), the microbatched gradient against
    the one-batch gradient, remat against none, and an optimizer step moving
    every leaf with a gradient -- and ``python -m repro_torch.launch.train
    --arch`` for each arch at its smoke config, one run resumed from its
    checkpoints equal to the unbroken run.  No kernel of ours runs here."""
    import dataclasses
    import math

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import InputSpec
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.steps import (_make_train_step, build_cell,
                                          init_inputs)
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.base import Optimizer
    from repro_torch.tree import path_leaves, tree_leaves

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # full float32 checks
    held = torch.cuda.memory_allocated()
    i32 = torch.int32

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def cell(arch, depth, batch, seq, **changes):
        """``build_cell(arch, "train_4k")`` at ``depth`` layers (an MoE
        arch keeps an MoE layer) and ``batch`` x ``seq`` tokens; the
        optimizer and microbatch count stay the published config's."""
        prog = build_cell(arch, "train_4k", smoke=False, device=dev)
        cfg = prog.config
        cfg = dataclasses.replace(cfg, n_layers=depth, n_dense_layers=min(
            cfg.n_dense_layers, depth - 1 if cfg.is_moe else 0), **changes)
        specs = {k: InputSpec((batch, seq), i32) for k in ("tokens",
                                                             "labels")}
        return dataclasses.replace(prog, config=cfg, input_specs=specs)

    def opt_name(prog, state):
        if not prog.fused:
            return "AdamW"
        return ("Adafactor, momentum 0.9" if "m" in state
                else "Adafactor, momentum-free")

    def timed(arch, depth, seq):
        t_arch = time.perf_counter()
        m = get_arch(arch).config.microbatch
        prog = cell(arch, depth, m, seq)
        cfg = prog.config
        gen = torch.Generator(device=dev).manual_seed(SEED + 60)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = prog.init_params(gen)
        params = model.params()
        opt_state = prog.optimizer.init(params)
        init_s = sync_s(t0)
        w_b, s_b = nbytes(tree_leaves(params)), nbytes(tree_leaves(opt_state))
        name = opt_name(prog, opt_state)
        batches = [init_inputs(prog, gen) for _ in range(TRAIN_TIMED + 1)]
        t0 = time.perf_counter()
        params, opt_state, loss = prog.step(model, params, opt_state,
                                            batches[0])
        first_s = sync_s(t0)
        loss0, want = float(loss), math.log(cfg.vocab) + 0.5
        if not (math.isfinite(loss0) and abs(loss0 - want) <= 1.0):
            raise AssertionError(f"{arch} train: loss at step 0 {loss0}, "
                                 f"not within 1.0 of ln V + 0.5 = {want:.4f}")
        losses = []
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        t0 = time.perf_counter()
        for batch in batches[1:]:
            params, opt_state, loss = prog.step(model, params, opt_state,
                                                batch)
            losses.append(loss)
        step_s = sync_s(t0) / TRAIN_TIMED
        retries = torch.cuda.memory_stats().get("num_alloc_retries",
                                                0) - retries
        if not all(math.isfinite(float(x)) for x in losses):
            raise AssertionError(f"{arch} train: losses {losses}")
        flops = m * lm_train_flops(cfg, seq)
        bound_ms = flops / BF16_DENSE_FLOPS * 1e3
        peak = torch.cuda.max_memory_allocated()
        log(f"[lm train {arch}] {depth} of {get_arch(arch).config.n_layers} "
            f"layers at published widths, bfloat16, batch 256 -> {m} "
            f"microbatches of 1 x {seq:,}"
            f"{' (sequence cut from 4,096)' if seq != 4_096 else ''}, "
            f"{name} (the published config's), remat {cfg.remat}: weights "
            f"{w_b:,} B and optimizer state {s_b:,} B drawn in {init_s:.1f} "
            f"s; loss at step 0 {loss0:.4f} (ln V + 0.5 = {want:.4f}), then "
            + ", ".join(f"{float(x):.4f}" for x in losses)
            + f"; first step {first_s * 1e3:.1f} ms; {step_s * 1e3:.1f} ms a"
            f" step ({m * seq / step_s:,.0f} tokens/s; host clock to a "
            f"synchronize over {TRAIN_TIMED} steps), bound {bound_ms:.1f} ms "
            f"(operations: {flops:.4e} FLOP at {BF16_DENSE_FLOPS:.3e}/s), "
            f"{bound_ms / (step_s * 1e3):.1%} of it; max_memory_allocated "
            f"{peak:,} B, {retries} allocator retries (cache freed to "
            f"allocate) in the timed steps ({time.perf_counter() - t_arch:.1f}"
            f" s)")
        if arch == "deepseek-7b":
            log(f"[lm train {arch}] one step under the profiler: "
                + device_breakdown(lambda: prog.step(
                    model, params, opt_state, batches[1]), torch, top=6))
        return dict(step_ms=step_s * 1e3, bound_ms=bound_ms, peak=peak,
                    tokens_s=m * seq / step_s, depth=depth, seq=seq, m=m,
                    optimizer=name)

    def matmul_check():
        """``matmul_f32``'s bfloat16 backward on the card (``MatmulF32``
        over ``aten::bmm.dtype``) against autograd through float32-widened
        operands: rounding the cotangent moves each term by 2^-9 of it,
        each result rounds to bfloat16 once on either side, and the two
        float32 sums of K terms may round in other orders, so |got - want|
        <= (3 * 2^-9 + 2K * 2^-24) * (|dC| @ |B|ᵀ) (dA; dB likewise)."""
        g = torch.Generator(device=dev).manual_seed(SEED + 61)
        a = torch.randn((8, 512, 128), generator=g, device=dev).bfloat16()
        b = torch.randn((8, 128, 1024), generator=g, device=dev).bfloat16()
        dc = torch.randn((8, 512, 1024), generator=g, device=dev) * 100
        a1, b1 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        out = attn.matmul_f32(a1, b1)
        if not isinstance(out.grad_fn, attn.MatmulF32._backward_cls):
            raise AssertionError(f"matmul_f32 on bfloat16 CUDA operands: "
                                 f"grad_fn {out.grad_fn}")
        out.backward(dc)
        a2, b2 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        torch.bmm(a2.float(), b2.float()).backward(dc)
        worst = []
        for got, want, ref, k in (
                (a1.grad, a2.grad, torch.bmm(dc.abs(), b.float().abs()
                                             .transpose(1, 2)), 1024),
                (b1.grad, b2.grad, torch.bmm(a.float().abs().transpose(1, 2),
                                             dc.abs()), 512)):
            if got.dtype != torch.bfloat16:
                raise AssertionError(f"matmul_f32 gradient {got.dtype}")
            share = (got.float() - want.float()).abs() / (
                (3 * 2**-9 + 2 * k * 2**-24) * ref)
            worst.append(float(share.max()))
        if not max(worst) <= 1.0:
            raise AssertionError(f"matmul_f32 backward: {worst} of its bound")
        log(f"[lm train] matmul_f32's CUDA route: a bfloat16 backward "
            f"(8 x 512 x 128 @ 8 x 128 x 1024) through MatmulF32 over "
            f"aten::bmm.dtype, the cotangent rounded to bfloat16; dA, dB "
            f"against autograd through float32-widened operands within "
            f"(3 * 2^-9 + 2K * 2^-24) * (|dC| @ |B|^T): largest share "
            f"{worst[0]:.3f}, {worst[1]:.3f} of it")

    capture = Optimizer(lambda p: {}, lambda g, s, p: (g, s))

    def grads(cfg, params, inputs, frozen, micro=1):
        """The gradient of every leaf but ``frozen`` and the loss, through
        ``_make_train_step`` with an optimizer that hands the gradients
        back."""
        step = _make_train_step(
            lambda p, x: tfm.train_loss(merged(p, tfm.per_layer(params)), x,
                                        cfg), capture, micro,
            split=tfm.per_layer)
        g, _, loss = step(prune(params, frozen), {}, inputs)
        return dict(path_leaves(g)), float(loss)

    def compare(got, want, bound, what, arch):
        """Each leaf's ||got - want|| / ||want|| (floored at 1e-3 of the
        largest leaf's); raises past ``bound``; (median, worst, its leaf)."""
        norms = {k: float(w.float().norm()) for k, w in want.items()}
        diffs = {k: float((got[k].float() - w.float()).norm())
                 for k, w in want.items()}
        floor = 1e-3 * max(norms.values())
        rel = {k: diffs[k] / max(norms[k], floor) for k in want}
        worst = max(rel, key=rel.get)
        if sorted(got) != sorted(want) or not rel[worst] <= bound:
            raise AssertionError(f"{arch}: {what}, leaf {worst} relative "
                                 f"L2 {rel[worst]:.3e} (bound {bound})")
        return statistics.median(rel.values()), rel[worst], worst

    def exact_checks(arch, params, batch, one, frozen, cfg32, m):
        """Float32: (3) the microbatched gradient against the one-batch
        gradient (an MoE arch: against the mean of its slices' gradients,
        since a microbatch's expert capacity follows its own token count,
        as the reference's does), (4) remat against none."""
        g_mb, _ = grads(cfg32, params, batch, frozen, micro=m)
        if cfg32.is_moe:
            want = None
            for i in range(m):
                g_i, _ = grads(cfg32, params,
                               {k: v[i:i + 1] for k, v in batch.items()},
                               frozen)
                if want is None:
                    want = g_i
                else:
                    for k in want:
                        want[k].add_(g_i[k])
                del g_i
            for v in want.values():
                v.div_(m)
        else:
            want, _ = grads(cfg32, params, batch, frozen)
        med_mb, worst_mb, _ = compare(want, g_mb, MICRO_REL,
                                      f"microbatch {m} vs one batch", arch)
        del want, g_mb
        # (4) remat vs none
        g_plain, _ = grads(cfg32, params, one, frozen)
        g_remat, _ = grads(dataclasses.replace(cfg32, remat=True), params,
                           one, frozen)
        med_r, worst_r, _ = compare(g_remat, g_plain, REMAT_REL,
                                    "remat vs none", arch)
        moved_from = {k: float(v.norm()) > 0 for k, v in g_remat.items()}
        del g_remat, g_plain
        return med_mb, worst_mb, med_r, worst_r, moved_from

    def checks(arch):
        t_checks = time.perf_counter()
        m = get_arch(arch).config.microbatch
        prog = cell(arch, CHECK_DEPTH, m, TRAIN_CHECK_SEQ,
                    attn_blk=TRAIN_CHECK_BLK, ce_chunk=TRAIN_CHECK_BLK,
                    remat=False)
        gen = torch.Generator(device=dev).manual_seed(SEED + 62)
        model = prog.init_params(gen)
        batch = init_inputs(prog, gen)
        one = {k: v[:1] for k, v in batch.items()}
        frozen = TRAIN_FROZEN.get(arch, ())
        cfg16 = prog.config
        cfg32 = dataclasses.replace(cfg16, param_dtype=torch.float32)
        # (2) bfloat16 vs float32, the float32 pass first
        with replayed_routing(moe_lib) as routing:
            g32, l32 = as_float32(model, lambda: grads(
                cfg32, model.params(), one, frozen))
            routing.replay()
            g16, l16 = grads(cfg16, model.params(), one, frozen)
        loss_rel = abs(l16 - l32) / abs(l32)
        if not loss_rel <= TRAIN_BF16_LOSS:
            raise AssertionError(f"{arch}: bfloat16 loss {l16} vs float32 "
                                 f"{l32}")
        med16, worst16, leaf16 = compare(g16, g32, TRAIN_BF16_GRAD,
                                         "bfloat16 vs float32 gradient",
                                         arch)
        del g16, g32
        for p in model.parameters():             # float32 from here on
            p.data = p.data.float()
        params = model.params()
        # (3) and (4) under deterministic algorithms: the MoE combine's
        # atomic adds would otherwise sum in another order on every run
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            med_mb, worst_mb, med_r, worst_r, moved_from = exact_checks(
                arch, params, batch, one, frozen, cfg32, m)
        finally:
            torch.use_deterministic_algorithms(was)
        # (5) one step of the published optimizer at its peak rate moves
        # every leaf that has a gradient
        part = prune(params, frozen)
        before = {k: t.clone() for k, t in path_leaves(part)}
        state = prog.optimizer.init(part)
        state["count"].fill_(200)
        step = _make_train_step(
            lambda p, x: tfm.train_loss(merged(p, tfm.per_layer(params)), x,
                                        cfg32), prog.optimizer, 1,
            prog.fused, split=tfm.per_layer)
        new, state, _ = step(part, state, one)
        still = [k for k, t in path_leaves(new)
                 if moved_from[k] and torch.equal(t, before[k])]
        if still or not any(moved_from.values()):
            raise AssertionError(f"{arch}: {opt_name(prog, state)} left "
                                 f"{still} unchanged")
        log(f"[lm train {arch}] checks at depth {CHECK_DEPTH}, {m} x "
            f"{TRAIN_CHECK_SEQ} tokens, blocks and loss chunks of "
            f"{TRAIN_CHECK_BLK}"
            + (f", gradients of all leaves but {', '.join(frozen)}"
               if frozen else "")
            + f", max_memory_allocated {torch.cuda.max_memory_allocated():,}"
            f" B: bfloat16 vs float32 (1 x {TRAIN_CHECK_SEQ}"
            + (f", routed as float32 chose; free bfloat16 routing would "
               f"send {routing.flips} token-layers elsewhere"
               if cfg16.is_moe else "")
            + f") loss {l16:.5f} vs {l32:.5f} (relative {loss_rel:.2e}, "
            f"bound {TRAIN_BF16_LOSS}), gradient relative L2 median "
            f"{med16:.3e}, max {worst16:.3e} ({leaf16}; bound "
            f"{TRAIN_BF16_GRAD}); float32 microbatch {m} vs "
            + ("the mean of its slices' gradients" if cfg32.is_moe
               else "one batch")
            + f": median {med_mb:.2e}, max {worst_mb:.2e} (bound "
            f"{MICRO_REL}); remat vs none: median {med_r:.2e}, max "
            f"{worst_r:.2e} (bound {REMAT_REL}); one {opt_name(prog, state)} "
            f"step at count 200 moved all {sum(moved_from.values())} leaves "
            f"with a gradient ({time.perf_counter() - t_checks:.1f} s)")

    summary = {}
    matmul_check()
    for arch, run in LM_TRAIN_RUNS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        summary[arch] = timed(arch, *run)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        checks(arch)
    torch.cuda.empty_cache()

    first = re.compile(r"(\S+)/train_4k: [\d,]+ params, "
                       r"optimizer=fused-adafactor")
    last = re.compile(rf"loss: first=\d+\.\d{{4}} last=\d+\.\d{{4}} "
                      rf"\((\d+) steps from step (\d+), \d+ stragglers\)")

    def train_run(arch, steps, ckpt_dir=None):
        out = io.StringIO()
        argv = ["--arch", arch, "--steps", str(steps), "--seed", str(SEED)]
        if ckpt_dir:
            argv += ["--ckpt-dir", ckpt_dir, "--ckpt-every", "2"]
        with contextlib.redirect_stdout(out):
            state = train_cli.main(argv)
        lines = out.getvalue().strip().splitlines()
        if not (first.fullmatch(lines[0]) and last.fullmatch(lines[-1])):
            raise AssertionError(f"train --arch {arch} printed {lines!r}")
        return state, lines

    for arch in LM_TRAIN_RUNS:
        _, lines = train_run(arch, TRAIN_CLI_STEPS)
        log(f"[lm train CLI] python -m repro_torch.launch.train --arch {arch}"
            f" --steps {TRAIN_CLI_STEPS}: {' | '.join(lines)}")
    straight, resumed = SMOKE_DIR / "lm_straight", SMOKE_DIR / "lm_resumed"
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a, _ = train_run("yi-34b", TRAIN_CLI_STEPS, str(straight))
        train_run("yi-34b", TRAIN_CLI_STEPS // 2, str(resumed))
        b, lines = train_run("yi-34b", TRAIN_CLI_STEPS, str(resumed))
    finally:
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(straight, ignore_errors=True)
        shutil.rmtree(resumed, ignore_errors=True)
    same = [torch.equal(x, y) for (_, x), (_, y) in zip(
        path_leaves(a), path_leaves(b))]
    if (int(b.step) != TRAIN_CLI_STEPS or not all(same)
            or f"from step {TRAIN_CLI_STEPS // 2}" not in lines[-1]):
        raise AssertionError("train --arch yi-34b: resumed run != the "
                             "unbroken run")
    log(f"[lm train CLI] --arch yi-34b --steps {TRAIN_CLI_STEPS} resumed "
        f"from its step-{TRAIN_CLI_STEPS // 2} checkpoint ({lines[-1]}) == "
        f"the unbroken run: parameters and AdamW state bit for bit "
        f"(deterministic algorithms)")
    log(f"[lm train] {time.perf_counter() - t_phase:.1f} s, {held:,} B held "
        f"before the phase (peaks include it); " + "; ".join(
        f"{a}: {r['depth']} layers, {r['m']} x {r['seq']:,}, {r['optimizer']}"
        f": {r['step_ms']:.1f} ms a step ({r['tokens_s']:,.0f} tokens/s; "
        f"bound {r['bound_ms']:.1f}), peak {r['peak']:,} B"
        for a, r in summary.items()))


def gnn_bound(hw, cfg, n: int, e: int) -> tuple:
    """The least time of one GatedGCN train step on ``n`` nodes and ``e``
    edges: the larger of (a) the layer's own products, 2·d²·(4E + N) a
    layer forward (A, B, C and V on the edge rows, U on the node rows), x 4
    with remat (the forward, its recompute, and a backward of twice its
    products), at the float32 FMA peak (TF32 off), and (b) the edge
    tensors' least traffic: each layer's forward, run twice with remat,
    reads e and writes e' (2 x 4d B an edge each time), its backward reads
    e and the gradient of e' and writes the gradient of e (3 x 4d B), and
    each of the three reads src, dst and the edge mask (12 B an edge):
    L·E·(28d + 36) B, at the HBM rate.  Input embedding and head left out
    (a lower bound still).  Returns (ms, "operations" | "bytes", FLOPs,
    bytes)."""
    d, L = cfg.d_hidden, cfg.n_layers
    flops = L * 2 * d * d * (4 * e + n) * (4 if cfg.remat else 3)
    nbytes = L * e * (28 * d + 36)
    t_ops = flops / hw.PEAK_FLOPS_F32 * 1e3
    t_bytes = nbytes / hw.HBM_BW * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes
            else (t_bytes, "bytes")) + (flops, nbytes)


def gnn_oracle(np, n, src, dst, h, e, lp):
    """``tests/test_gnn.py``'s dense oracle of one GatedGCN layer in
    float64 numpy (``np.add.at`` for the scatters): (h', e')."""
    hs, hd = h[src], h[dst]
    e_np = hd @ lp["A"] + hs @ lp["B"] + e @ lp["C"]
    gate = 1 / (1 + np.exp(-e_np))
    gate_sum = np.zeros((n, h.shape[1]))
    np.add.at(gate_sum, dst, gate)
    msg = gate / (gate_sum[dst] + 1e-6) * (hs @ lp["V"])
    agg = np.zeros((n, h.shape[1]))
    np.add.at(agg, dst, msg)

    def norm(x, w):
        return x / np.sqrt(np.mean(x * x, -1, keepdims=True) + 1e-6) * w

    return (h + np.maximum(norm(h @ lp["U"] + agg, lp["ln_h"]), 0),
            e + np.maximum(norm(e_np, lp["ln_e"]), 0))


def gnn_training(torch, dev) -> None:
    """Phase 12: GatedGCN trained at its published config in its four
    cells through ``build_cell`` / ``init_inputs`` / ``step`` -- full_graph_sm
    and molecule as ``init_inputs`` draws them, minibatch_lg on subgraphs
    that ``neighbor_sample`` draws from a reddit-size CSR graph on the card
    (its time and invariants checked), ogb_products cut by ``OGB_CUT`` --
    each timed beside its bound (``gnn_bound``) and the reference's
    ``model_flops_for``, with its allocator peak, a profiler breakdown and
    its loss in default mode against deterministic algorithms; then the
    layer against a float64 oracle, remat against none bit for bit, a step
    moving every leaf, and ``python -m repro_torch.launch.train --arch
    gatedgcn`` in three cells, a resumed run == the unbroken one.  No
    kernel of ours runs here: the reference's segment_sum is plain jnp."""
    import dataclasses
    import math

    import numpy as np

    from repro_torch.configs.base import InputSpec, _pad512, get_cell
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.steps import build_cell, init_inputs
    from repro_torch.models import gnn
    from repro_torch.roofline import hardware as hw
    from repro_torch.roofline.analysis import model_flops_for
    from repro_torch.tree import path_leaves, tree_map

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # full float32
    held = torch.cuda.memory_allocated()
    i32, f32 = torch.int32, torch.float32

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    @contextlib.contextmanager
    def deterministic():
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(was)

    # -- the layer against a float64 oracle (tests/test_gnn.py's graph) --
    rng = np.random.default_rng(0)
    adj = rng.random((12, 12)) < 0.4
    np.fill_diagonal(adj, False)
    src, dst = (a.astype(np.int32) for a in np.nonzero(adj))
    worst = 0.0
    for d in (8, 70):
        cfg1 = gnn.GNNConfig("oracle", 1, d, d, 2)
        model = gnn.init_gnn_params(cfg1, torch.Generator(
            device=dev).manual_seed(SEED + 70 + d))
        lp = {k: v[0] for k, v in model.params()["layers"].items()}
        gen = torch.Generator(device=dev).manual_seed(SEED + 71 + d)
        h = torch.randn((12, d), generator=gen, device=dev)
        e = torch.randn((len(src), d), generator=gen, device=dev)
        got = gnn.gatedgcn_layer(lp, h, e, torch.from_numpy(src).to(dev),
                                 torch.from_numpy(dst).to(dev),
                                 torch.ones(len(src), device=dev), 12)
        want = gnn_oracle(np, 12, src, dst, h.double().cpu().numpy(),
                          e.double().cpu().numpy(),
                          {k: v.double().cpu().numpy()
                           for k, v in lp.items()})
        for g, w in zip(got, want):
            err = float(np.abs(g.double().cpu().numpy() - w).max()
                        / max(1.0, float(np.abs(w).max())))
            worst = max(worst, err)
    if not worst <= GNN_ORACLE_TOL:
        raise AssertionError(f"gatedgcn_layer vs float64 oracle: {worst}")
    log(f"[gnn] gatedgcn_layer (float32, the card) vs a float64 dense "
        f"oracle on tests/test_gnn.py's 12-node graph ({len(src)} edges) "
        f"at d = 8 and 70: largest |diff| / max(1, |oracle|) {worst:.2e} "
        f"(bound {GNN_ORACLE_TOL})")

    def loss_gap(prog, model, batch):
        """The loss in default mode and under deterministic algorithms,
        the same weights and batch: their relative difference."""
        with torch.no_grad():
            a = float(gnn.gnn_loss(model.params(), batch, prog.config))
            with deterministic():
                b = float(gnn.gnn_loss(model.params(), batch, prog.config))
        gap = abs(a - b) / abs(b)
        if not gap <= GNN_DET_REL:
            raise AssertionError(f"{prog.cell_name}: default-mode loss {a} "
                                 f"vs deterministic {b}")
        return gap

    def timed(name, prog, batches, note):
        """Untimed step, then ``GNN_TIMED`` timed ones, on ``batches``
        (one more for the profiled step), weights from a seed."""
        t_cell = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = prog.config
        model = prog.init_params(torch.Generator(device=dev).manual_seed(
            SEED + 80))
        params = model.params()
        state = prog.optimizer.init(params)
        b0 = batches[0]
        n_nodes = b0["node_feats"].shape[0]
        n_edges = int(b0["edge_mask"].sum())
        gap = loss_gap(prog, model, b0)
        t0 = time.perf_counter()
        params, state, loss = prog.step(model, params, state, b0)
        first_s = sync_s(t0)
        loss0 = float(loss)
        if not math.isfinite(loss0):
            raise AssertionError(f"gatedgcn/{name}: loss at step 0 {loss0}")
        losses = []
        t0 = time.perf_counter()
        for batch in batches[1:GNN_TIMED + 1]:
            params, state, loss = prog.step(model, params, state, batch)
            losses.append(loss)
        step_s = sync_s(t0) / GNN_TIMED
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(float(x)) for x in losses):
            raise AssertionError(f"gatedgcn/{name}: losses {losses}")
        bound_ms, by, flops, nbytes = gnn_bound(hw, cfg, n_nodes, n_edges)
        specs = {k: InputSpec(tuple(v.shape), v.dtype) for k, v in b0.items()}
        ref_flops = model_flops_for(dataclasses.replace(prog,
                                                        input_specs=specs))
        profile = device_breakdown(lambda: prog.step(
            model, params, state, batches[-1]), torch, top=4)
        step_ms = step_s * 1e3
        log(f"[gnn {name}] {note}; {cfg.n_layers} layers, d "
            f"{cfg.d_hidden}, remat {cfg.remat}, {str(cfg.param_dtype)[6:]}, "
            f"AdamW: "
            f"loss at step 0 {loss0:.4f}, then "
            + ", ".join(f"{float(x):.4f}" for x in losses)
            + f"; first step {first_s * 1e3:.1f} ms; {step_ms:.2f} ms a step "
            f"({n_nodes / step_s:,.0f} nodes/s, {n_edges / step_s:,.0f} "
            f"edges/s; host clock to a synchronize over {GNN_TIMED} steps), "
            f"bound {bound_ms:.3f} ms ({by}: {flops:.4e} FLOP at "
            f"{hw.PEAK_FLOPS_F32:.3e}/s, {nbytes:.4e} B at {hw.HBM_BW:.3e} "
            f"B/s), {bound_ms / step_ms:.1%} of it; the reference's "
            f"model_flops_for {ref_flops:.4e}, the layer's products without "
            f"remat {flops * 3 / 4:.4e} ({flops * 3 / 4 / ref_flops:.1f}x "
            f"it); "
            f"max_memory_allocated {peak:,} B; default-mode loss vs "
            f"deterministic: relative {gap:.2e} (bound {GNN_DET_REL}); "
            f"profiled step: {profile} "
            f"({time.perf_counter() - t_cell:.1f} s)")
        return dict(step_ms=step_ms, bound_ms=bound_ms, peak=peak,
                    edges_s=n_edges / step_s, gap=gap)

    summary = {}
    for name in ("full_graph_sm", "molecule"):
        prog = build_cell("gatedgcn", name, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 81)
        batches = [init_inputs(prog, gen) for _ in range(GNN_TIMED + 2)]
        shapes = (tuple(batches[0]["node_feats"].shape),
                  tuple(batches[0]["edge_index"].shape))
        summary[name] = timed(name, prog, batches,
                              f"init_inputs batches, node_feats "
                              f"{shapes[0]}, edge_index {shapes[1]}, no cut")
        del batches

    # -- the sampler on a reddit-size CSR graph on the card --------------
    t_graph = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 82)
    N, E = REDDIT_NODES, REDDIT_EDGES
    zero = torch.zeros(N, dtype=torch.bool, device=dev)
    zero[::97] = True                   # zero-degree nodes, the last one too
    zero[-1] = True
    owners = (~zero).nonzero()[:, 0]
    deg = torch.zeros(N, dtype=torch.int64, device=dev)
    for start in range(0, E, 1 << 25):
        part = min(1 << 25, E - start)
        deg += torch.bincount(owners[torch.randint(
            0, len(owners), (part,), generator=gen, device=dev)],
            minlength=N)
    indptr = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    indptr[1:] = deg.cumsum(0)
    graph = gnn.CSRGraph(indptr=indptr.to(i32), indices=torch.randint(
        0, N, (E,), dtype=i32, generator=gen, device=dev))
    cell = get_cell("gatedgcn", "minibatch_lg")
    d_feat, n_classes = cell.dims["d_feat"], cell.dims["n_classes"]
    table = torch.randn((N, d_feat), generator=gen, device=dev)
    node_labels = torch.randint(0, n_classes, (N,), dtype=i32,
                                generator=gen, device=dev)
    graph_s = sync_s(t_graph)
    fanouts = (cell.dims["fanout1"], cell.dims["fanout2"])
    n_seeds = cell.dims["batch_nodes"]
    prog = build_cell("gatedgcn", "minibatch_lg", device=dev)
    subs, sample_ms = [], []
    for i in range(GNN_TIMED + 2 + REPS):
        seeds = torch.randperm(N, generator=gen, device=dev)[:n_seeds].to(i32)
        seeds[:2] = torch.tensor([0, N - 1], device=dev)   # zero degree
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sub = gnn.neighbor_sample(gen, graph, seeds, fanouts)
        sample_ms.append(sync_s(t0) * 1e3)
        if i < GNN_TIMED + 2:
            subs.append(sub)
    # invariants of the first subgraph: shapes, CSR membership, masking
    sub = subs[0]
    n_sub, e_sub = gnn.subgraph_sizes(n_seeds, fanouts)
    if (tuple(sub["nodes"].shape) != (n_sub,)
            or tuple(sub["edge_index"].shape) != (2, e_sub)
            or (n_sub, e_sub) != (prog.input_specs["node_feats"].shape[0],
                                  prog.input_specs["edge_index"].shape[1])):
        raise AssertionError(f"neighbor_sample shapes {sub['nodes'].shape} "
                             f"{sub['edge_index'].shape} vs {n_sub, e_sub}")
    nodes = sub["nodes"].long()
    s_glob = nodes[sub["edge_index"][0].long()]
    d_glob = nodes[sub["edge_index"][1].long()]
    d_deg = deg[d_glob]
    if not torch.equal(sub["edge_mask"], d_deg > 0):
        raise AssertionError("neighbor_sample: edge_mask != the frontier "
                             "node has a neighbor")
    masked = int((~sub["edge_mask"]).sum())
    trailing = int((d_glob == N - 1).sum())
    if not (masked and trailing):
        raise AssertionError("neighbor_sample: no zero-degree frontier node "
                             "to check")
    valid = sub["edge_mask"].nonzero()[:, 0]
    max_deg = int(deg.max())
    found = torch.zeros(len(valid), dtype=torch.bool, device=dev)
    for lo in range(0, len(valid), 8_192):
        sel = valid[lo:lo + 8_192]
        k = torch.arange(max_deg, device=dev)
        at = indptr[d_glob[sel]][:, None] + k
        inside = k < d_deg[sel][:, None]
        nbrs = graph.indices[torch.where(inside, at, 0)].long()
        found[lo:lo + 8_192] = ((nbrs == s_glob[sel][:, None])
                                & inside).any(1)
    if not bool(found.all()):
        raise AssertionError(f"neighbor_sample: {int((~found).sum())} "
                             "valid edges whose source is not a CSR "
                             "neighbor of their destination")
    del found
    sample_med = statistics.median(sample_ms[GNN_TIMED + 2:])
    log(f"[gnn sampler] reddit-size CSR on the card: {N:,} nodes "
        f"({int(zero.sum()):,} of degree 0, the last among them), "
        f"{E:,} edges (int32 indices {E * 4:,} B; degrees up to {max_deg}), "
        f"a ({N:,}, {d_feat}) float32 feature table ({N * d_feat * 4:,} B), "
        f"built in {graph_s:.2f} s; neighbor_sample of {n_seeds:,} seeds at "
        f"fanouts {fanouts}: {sample_med:.3f} ms (median of {REPS} after "
        f"{GNN_TIMED + 2}; host clock to a synchronize); shapes == "
        f"subgraph_sizes {n_sub:,} nodes, {e_sub:,} edges; all "
        f"{len(valid):,} valid edges' sources are CSR neighbors of their "
        f"destinations; {masked:,} edges of zero-degree frontier nodes "
        f"masked ({trailing} of them the last node's)")
    batches = []
    for sub in subs:
        nodes = sub["nodes"].long()
        node_mask = torch.zeros(n_sub, dtype=f32, device=dev)
        node_mask[:n_seeds] = 1.0               # the loss over the seeds
        batches.append({"node_feats": table[nodes],
                        "edge_index": sub["edge_index"],
                        "edge_mask": sub["edge_mask"].to(f32),
                        "labels": node_labels[nodes],
                        "node_mask": node_mask})
    del subs, table, graph, indptr, deg, zero, owners
    summary["minibatch_lg"] = timed(
        "minibatch_lg", prog, batches,
        f"sampled subgraphs ({n_sub:,} x {e_sub:,}, features gathered from "
        f"the table, the loss over the {n_seeds:,} seeds), no cut")
    del batches
    summary["minibatch_lg"]["sample_ms"] = sample_med

    # -- ogb_products, nodes and edges cut by OGB_CUT --------------------
    cell = get_cell("gatedgcn", "ogb_products")
    n = round(cell.dims["n_nodes"] / OGB_CUT)
    e = round(cell.dims["n_edges"] / OGB_CUT)
    N, E = _pad512(n), _pad512(e)
    prog = build_cell("gatedgcn", "ogb_products", device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 83)
    batch = {"node_feats": torch.randn((N, cell.dims["d_feat"]),
                                       generator=gen, device=dev),
             "edge_index": torch.randint(0, n, (2, E), dtype=i32,
                                         generator=gen, device=dev),
             "edge_mask": (torch.arange(E, device=dev) < e).to(f32),
             "labels": torch.randint(0, cell.dims["n_classes"], (N,),
                                     dtype=i32, generator=gen, device=dev),
             "node_mask": (torch.arange(N, device=dev) < n).to(f32)}
    summary["ogb_products"] = timed(
        "ogb_products", prog, [batch] * (GNN_TIMED + 2),
        f"cut 1/{OGB_CUT}: {n:,} nodes, {e:,} edges (padded {N:,} x {E:,}; "
        f"mean degree {e / n:.2f}, d_feat {cell.dims['d_feat']}, "
        f"{cell.dims['n_classes']} classes), from {cell.dims['n_nodes']:,} "
        f"x {cell.dims['n_edges']:,}")
    del batch
    torch.cuda.empty_cache()

    # -- remat == none, and one step moving every leaf (full_graph_sm) ---
    prog = build_cell("gatedgcn", "full_graph_sm", device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 84)
    model = prog.init_params(gen)
    batch = init_inputs(prog, gen)
    grads = {}
    with deterministic():
        for remat in (False, True):
            cfg = dataclasses.replace(prog.config, remat=remat)
            p = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                         model.params())
            loss = gnn.gnn_loss(p, batch, cfg)
            loss.backward()
            grads[remat] = [("loss", loss.detach())] + [
                (k, t.grad) for k, t in path_leaves(p)]
    differ = [k for (k, a), (_, b) in zip(grads[False], grads[True])
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"gatedgcn remat vs none differ at {differ}")
    params = model.params()
    before = {k: t.clone() for k, t in path_leaves(params)}
    state = prog.optimizer.init(params)
    state["count"].fill_(200)
    params, state, _ = prog.step(model, params, state, batch)
    still = [k for k, t in path_leaves(params) if torch.equal(t, before[k])]
    if still:
        raise AssertionError(f"gatedgcn: an AdamW step left {still}")
    log(f"[gnn checks] full_graph_sm at the published config: remat vs none "
        f"(deterministic algorithms): the loss and all {len(before)} "
        f"gradient leaves bit for bit; one AdamW step at count 200 moved "
        f"all {len(before)} leaves")

    # -- the launcher --------------------------------------------------------
    first = re.compile(r"gatedgcn/(\S+): [\d,]+ params, "
                       r"optimizer=fused-adafactor")
    last = re.compile(r"loss: first=\d+\.\d{4} last=\d+\.\d{4} "
                      r"\((\d+) steps from step (\d+), \d+ stragglers\)")

    def train_run(name, steps, ckpt_dir=None):
        out = io.StringIO()
        argv = ["--arch", "gatedgcn", "--cell", name, "--no-smoke",
                "--steps", str(steps), "--seed", str(SEED)]
        if ckpt_dir:
            argv += ["--ckpt-dir", ckpt_dir, "--ckpt-every", "2"]
        with contextlib.redirect_stdout(out):
            state = train_cli.main(argv)
        lines = out.getvalue().strip().splitlines()
        if not (first.fullmatch(lines[0]) and last.fullmatch(lines[-1])):
            raise AssertionError(f"train --cell {name} printed {lines!r}")
        return state, lines

    for name in ("full_graph_sm", "molecule", "minibatch_lg"):
        t0 = time.perf_counter()
        _, lines = train_run(name, GNN_CLI_STEPS)
        log(f"[gnn CLI] python -m repro_torch.launch.train --arch gatedgcn "
            f"--cell {name} --no-smoke --steps {GNN_CLI_STEPS}: "
            f"{' | '.join(lines)} ({time.perf_counter() - t0:.1f} s)")
    straight, resumed = SMOKE_DIR / "gnn_straight", SMOKE_DIR / "gnn_resumed"
    try:
        with deterministic():
            a, _ = train_run("full_graph_sm", GNN_CLI_STEPS, str(straight))
            train_run("full_graph_sm", GNN_CLI_STEPS // 2, str(resumed))
            b, lines = train_run("full_graph_sm", GNN_CLI_STEPS,
                                 str(resumed))
    finally:
        shutil.rmtree(straight, ignore_errors=True)
        shutil.rmtree(resumed, ignore_errors=True)
    pairs = list(zip(path_leaves(a), path_leaves(b)))
    if (int(b.step) != GNN_CLI_STEPS or not pairs
            or not all(ka == kb and torch.equal(x, y)
                       for (ka, x), (kb, y) in pairs)
            or f"from step {GNN_CLI_STEPS // 2}" not in lines[-1]):
        raise AssertionError("train --arch gatedgcn: resumed run != the "
                             "unbroken run")
    log(f"[gnn CLI] --cell full_graph_sm --no-smoke --steps "
        f"{GNN_CLI_STEPS} resumed from its step-{GNN_CLI_STEPS // 2} "
        f"checkpoint ({lines[-1]}) == the unbroken run: all {len(pairs)} "
        f"parameter and AdamW state leaves bit for bit (deterministic "
        f"algorithms)")
    log(f"[gnn] {time.perf_counter() - t_phase:.1f} s, {held:,} B held "
        f"before the phase (peaks include it); " + "; ".join(
        f"{c}: {r['step_ms']:.2f} ms a step ({r['edges_s']:,.0f} edges/s; "
        f"bound {r['bound_ms']:.3f}), peak {r['peak']:,} B"
        for c, r in summary.items())
        + f"; sampler {summary['minibatch_lg']['sample_ms']:.3f} ms")


if __name__ == "__main__":
    sys.exit(main())
