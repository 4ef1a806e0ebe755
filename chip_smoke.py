#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tmgcn_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure exits
non-zero, and nothing falls back to the CPU:

  1. card    — the card's name and power limit, as nvidia-smi gives them;
  2. build   — compile every CUDA kernel from tmgcn_torch/kernels/csrc, and
               beside them the native host runtime (tmgcn_torch/native);
  3. K1      — the windowed segment matmul against its plain PyTorch
               version on the card: random packings (F = 2, 6, 128, with
               and without init, with empty windows), the chess
               train-window packing at F = 2 (forward and autograd
               backward) and the chess readout-plan packing at F = 6
               (zero init), two launches bitwise equal; times at both
               chess shapes (kernel, plain version, torch.sparse.mm
               yardstick) and the bound the card's memory rate sets; then
               the same at chess_wdgcn_lp's readout plan (2E = 1,545,040
               endpoint rows of the train window's model edges into 79 x
               7,301 rows, F = 6, zero init), K1's launch in each of that
               path's training steps; then at the KW-GCN 2-layer epoch's
               layer-2 SpMM (the chess train window of C, F = 6), the
               forward packing and the transposed one (the backward), and
               the operator's autograd backward;
  4. K2      — the lane-major twin against its plain version: random
               packings (F = 2, 6, 128, with and without init, with empty
               windows, windows of 256 and 2,048 rows), K1 transposed
               bitwise, and the chess readout plan forced lane-major
               (forward and backward against the plain gather), two
               launches bitwise equal; times at the WD-GCN scale shape (1M
               labelled edges into 500k x 64 rows), with K1 timed on the
               same packing (its (J, C, F) slab made outside the timed
               region) and the readout backward's other device work there
               (the padded gather, the permute copy, the zero init);
  5. K1 bf16 and the restricted operators — K1's bf16-gather tier against
               its plain version (random packings; the chess_tmgcn2_cls
               train window's restricted layer-2 operator, forward and
               backward; the chess cached-propagation shape), bitwise
               repeat; times of both K1 tiers at the restricted forward and
               backward shapes; the restricted operator as K1 (f32, bf16)
               and as block-dense on cuBLAS (exact, bf16), forward and
               forward + backward, held against each other;
  6. K3      — the tile-dedup kernel, float32 and bf16 tiers, against its
               plain version: random tiled packings (F = 2, 6, 128, small
               ut_cap cuts, repeated entries, empty windows) and the chess
               train window's tiled packing at F = 2 (forward and operator
               backward), bitwise repeat; times beside the bound and
               torch.sparse.mm;
  6b. fast   — K1's and K3's fast tiers (float32 input at the TPU's DEFAULT
               matrix precision) against their plain versions: random
               packings (F = 2, 6, 128; K1 with and without init, empty
               windows; K3 with small ut_cap cuts), K3 fast bitwise K3 bf16
               on the blocks cast to bf16, both fast operators' forward and
               autograd backward, bitwise repeat; then two main paths, each
               with every launch count set to 0 just before it and read just
               after: ``tmgcn_torch.utils.spmm_bench.main(["--case", "all"])``
               in process (every record of the JAX script, no error record;
               K1 f32 294 and K1 fast 210 launches), and at spmm_bench's r1
               workload (1M nnz, F = 128) the tiled fast operator's forward
               and backward (2 K3 fast launches); at both workloads (r1,
               F = 128; chess2, F = 8) K1 f32 and fast against their plain
               versions on every (chunk, window) packing of spmm_bench, and
               the c256_w256 operator's autograd backward (K1 on the
               transposed packing, the _fwdbwd record's); K1 f32 and fast
               timed at both workloads and K3 fast and K3 f32 at r1's tiled
               packing, beside bound and torch.sparse.mm;
  6c. scan  — WD-GCN's LSTM scan kernel pair (tmgcn_torch/kernels/
               csrc/lstm_scan.cu) at the chess shape (T 80, F 6, N 7,301)
               against its plain version, the eager scan on the card
               (hoisted and rematerialised), on the main path's strided
               inputs (Y a view of (F, T, N) memory, dZ a transpose): Z
               and the gradients of Y, W, U, b, a bitwise repeat; forward
               + backward and the evaluation forward timed beside the
               eager scan and the byte bound. Its launches are counted on
               the main paths (7), as the K kernels' are;
  7. paths   — the main paths, each with every launch count set to 0 just
               before it and read just after. Every training step on the
               card is a replay of one captured CUDA graph (train/loop.py);
               the paths marked "vs eager" run again through the loop's
               eager chunks, and the rows and launch counts must be
               bitwise the same:
               a. ``run_experiment`` of chess_tmgcn_cls, spmm_impl="pallas",
                  200 epochs: 3 K1 launches (the cached propagation), then
                  the same run warm (same rows), vs eager, and 5 epochs
                  against the CPU's plain path;
               b. ``run_experiment`` of chess_wdgcn_cls (the preset's
                  spmm_impl "jnp"), 200 epochs: 200 K1 launches (the
                  readout plan's backward, one per step), 0 K2; the LSTM
                  scan's forward, backward and reduction once a step and
                  its forward for val and test at each of the 2
                  evaluations (204, 200, 200; so too in c; every other
                  WD-GCN path one backward and reduction a step, every
                  other family none); warm rerun
                  with the same rows; vs eager; 5 epochs against the CPU's
                  plain path;
               c. ``python -m tmgcn_torch.cli run chess_wdgcn_cls
                  --spmm-impl pallas --epochs 200`` (in process): 203 K1
                  launches (3 for the cached propagation);
               d. the WD-GCN, then the EvolveGCN scale run of
                  ``tmgcn_torch.utils.scale_bench`` on the same inputs
                  (500,000 nodes x 64 slices, 1,000,000 labelled edges,
                  nnz_per_slice cut from 2,000,000 to 250,000): one K2
                  launch per training step (the readout plan's lane-major
                  backward; EvolveGCN's slice one-hot is over its
                  gather-free budget, so it runs the generic path with the
                  plan), no K1; then, each, outside the
                  counts, 3 more warm steps traced with torch.profiler:
                  device ms per step, busy share, launch calls per step,
                  the top kernels' device ms; then on the same adapter the
                  steps eager and captured from the same parameters (losses
                  bitwise the counted run's), each side's peak device
                  memory, and both timed in turns (ms per step);
               e. ``run_experiment`` of chess_tmgcn2_cls, spmm_impl="pallas",
                  200 epochs: 407 K1 launches (3 cached propagations, the
                  restricted layer 2 forward and backward per step, val and
                  test forwards at 2 evaluation epochs); a warm rerun with
                  the same rows; vs eager; 5 epochs against the CPU's plain
                  path;
               f. the same with "pallas_bf16": 407 bf16 K1 launches;
               g. "pallas_tiled" and "pallas_tiled_bf16", 5 epochs each: 3
                  K3 launches of the tier (the cached propagations; layer 2
                  is "auto": block-dense on chess, no K1);
               h. the preset as it stands ("jnp": auto, block-dense), 200
                  epochs: no hand-written kernel launched; vs eager;
               i. ``run_experiment`` of chess_tmgcn_lp (link prediction,
                  772,520 training edges, (epochs, 9) MAP-MRR rows), 200
                  epochs: with spmm_impl="pallas" 3 K1 launches (the cached
                  propagation of the three 79-slice windows), a warm rerun
                  with the same rows, 5 epochs against the CPU's plain path;
                  with the preset's "jnp" no kernel, 5 epochs against the
                  CPU;
               j. ``run_experiment`` of chess_wdgcn_lp (the preset's "jnp"),
                  200 epochs: 200 K1 launches (the readout plan's backward,
                  one per training step), a warm rerun with the same rows,
                  vs eager, 5 epochs against the CPU's plain path; then, for
                  both LP
                  presets, the host scoring of one evaluation epoch (MAP,
                  MRR and loss of the three windows) timed alone;
               k. KW-GCN: chess_gcn_cls with "pallas" (3 K1 launches, the
                  cached propagation) and its preset ("jnp", none); the
                  2-layer model, hidden (6, 6, 3), with "pallas", vs eager:
                  607 K1 launches (3 cached propagations, layer 2's forward
                  and backward and the readout plan's backward per step, a
                  val and a test forward at 2 evaluation epochs);
                  chess_gcn_lp with "pallas" (3 K1);
               l. EvolveGCN-H, each vs eager: chess_evolvegcn_cls (the
                  gather-free path, no kernel), chess_evolvegcn2_cls (the
                  restricted layer 2 on the operator ``auto`` picks, printed
                  with its ratio by window: K1 launches only where it picks
                  K1), chess_evolvegcn_lp (the generic path: 200 K1, one per
                  step, in the readout plan's backward). Their val and test
                  F1 against the CPU are held to the range the CPU's
                  evaluation logits allow once their tied edges go either
                  way (the GRU's saturated weights cancel some logits
                  exactly);
               m. regression and SBM: K1 at seir_wdgcn_reg_tuned's packing
                  (the SEIR train window's Ct, 80 x 200 rows, F = 5)
                  against its plain version, the operator against the
                  plain spmm and torch.sparse.mm, timed beside its bound;
                  then ``run_experiment`` of seir_tmgcn_reg_tuned (3 K1,
                  the cached propagation), seir_evolvegcn_reg_tuned (no
                  kernel) and seir_wdgcn_reg_tuned (302 K1: its
                  propagation once a step and for val and test), 300
                  epochs each, losses and val/test L1 finite, a warm rerun
                  and the eager loop bitwise equal, the first 5 epochs'
                  losses against the CPU's plain path (rtol 1e-4) and a
                  5-epoch run's L1 and L1 ratio against the CPU's (rtol
                  1e-3); sbm_tmgcn_lp_tuned (3 K1) and
                  sbm_evolvegcn_lp_tuned (the generic path: K1 in the
                  readout plan's backward once a step) at full width (1,000
                  nodes, 50 slices, every LP edge), 300 epochs cut to 100,
                  each with a warm rerun, vs eager, 5 epochs against the
                  CPU; the host scoring of one SBM evaluation epoch;
               n. resume: checkpoint -> resume -> predict (train/checkpoint.py,
                  ``cli predict``), checkpoints under build/ and removed
                  after: chess_tmgcn2_cls with "pallas", its experiment built
                  once, 200 epochs without and (a) with checkpoints (rows
                  bitwise; 404 K1 each), (b) 101 epochs saving at 0 and 100
                  (206), (c) a resume of (b) to 200 (200 K1: 2 x 99 steps and
                  one evaluation's val and test; train columns from 101 on
                  bitwise (a)'s); ``cli predict --window val`` from (a)'s
                  checkpoint of epoch 100 (5 K1: 3 cached propagations, the
                  train and val forwards): its val F1 is row 100's, within
                  its logits' tie range; seir_wdgcn_reg_tuned 300 epochs, 200
                  saving at 99 and 199, resumed to 300 (102 K1): losses and
                  val/test L1 bitwise; chess_evolvegcn_lp 5 epochs saving
                  (5 K1), then predict threading its carry: MAP and MRR in
                  [0, 1]; each checkpoint save, load and in-place restore
                  timed, beside the card's name and power limit; every
                  counted run of the phase adds to the kernels line;
               o. the streamed restricted layer 2 (l2_stream_chunks = 4:
                  one K1 operator per group of time slices; a group with
                  no endpoint entry launches nothing) and the generic
                  1-layer TM-GCN: chess_tmgcn2_cls / pallas with one
                  operator (407 K1, its evaluation logits kept), then
                  streamed, 200 epochs (3 + 2 x 200 x g_train + 2 x
                  (g_val + g_test) K1, g the groups with entries, reckoned
                  on the host), warm rerun, vs eager, 5 epochs against the
                  CPU, losses within rtol 1e-4 of the one operator's
                  (their weight gradients round differently; the max
                  relative difference printed) and val/test F1 within its
                  logits' tie range; pallas_bf16 streamed, 5 epochs (bf16
                  K1); the tmgcn2 scale family on
                  the shared scale inputs as in d, once on the operator the
                  restricted rule picks (printed with its ratio and the
                  packing's entries against its slots; 2 K1 a step if K1)
                  and once streamed (2 K1 a step in each group with
                  entries), the streamed losses within rtol 1e-5 of the one
                  operator's, each side's peak memory (steps, and a
                  forward alone) and the gathered chunks a K1 call needs;
                  K1 at both scale forward packings
                  against its plain version and torch.sparse.mm, timed
                  beside its bound; chess_tmgcn_cls / pallas with
                  condensed_W=False and with use_Minv=True (203 K1 each: 3
                  cached propagations, the readout plan's backward a
                  step), 200 epochs, warm rerun, vs eager, 5 epochs against
                  the CPU;
               p. the (graph x time) mesh (tmgcn_torch/parallel) on NCCL at
                  1 x 1, the one mesh one card allows: ``run_experiment(
                  mesh_shape=(1, 1))`` of chess_tmgcn_cls (pallas; the
                  sharded path ignores the impl), chess_tmgcn2_cls with
                  layer 2 "gather" and "blockdense", chess_tmgcn_lp and
                  chess_gcn_cls, 200 epochs each: no kernel of ours (0
                  launches: the shard-local SpMM is the segment sum, layer
                  2's block-dense operator cuBLAS), captured vs eager on the
                  same adapter (rows bitwise), against the unsharded run on
                  the card (train loss rtol 1e-4; F1 within 1e-3 or the
                  unsharded logits' tie range; MAP/MRR rtol 1e-3); ``torchrun
                  --standalone --nproc-per-node 1 -m tmgcn_torch.cli run
                  chess_tmgcn_cls --mesh graph=1,time=1 --epochs 20`` beside
                  them: exit 0 and the in-process run's rows, bitwise; then
                  chess_tmgcn_cls's set-up seconds, the collectives of one
                  evaluation and one plain step, plain epochs sharded and
                  unsharded, captured and eager, timed in turns, and a traced
                  captured chunk of each (NCCL kernels per epoch), beside the
                  card's name and power limit;
               q. the recurrent families and regression on the 1 x 1 NCCL
                  mesh: ``run_experiment(mesh_shape=(1, 1))`` of
                  chess_wdgcn_cls, chess_evolvegcn_cls, chess_evolvegcn2_cls
                  (the distributed top-k), chess_evolvegcn_lp,
                  seir_tmgcn_reg_tuned, seir_wdgcn_reg_tuned and
                  seir_evolvegcn_reg_tuned, 50 epochs each: 0 launches of
                  our kernels, captured vs eager on the same adapter (rows
                  or results bitwise), against the unsharded run (train
                  loss rtol 1e-4; F1 within 1e-3 or the unsharded logits'
                  tie range; MAP/MRR rtol 1e-3; val/test L1 and L1 ratio
                  rtol 1e-3); chess_tmgcn_cls at 1 x 1 with checkpoints,
                  101 epochs saving at 0 and 100, resumed to 200: train
                  columns bitwise the uninterrupted sharded run's;
               r. the 32 presets of the registry's other datasets
                  (bitcoin_otc, bitcoin_alpha, reddit, amlsim edge
                  classification; bitcoin_otc, bitcoin_alpha, reddit, uci
                  link prediction; TM-GCN, KW-GCN, EvolveGCN-H, WD-GCN) on
                  copies of their stand-ins in data/synthetic/ under build/,
                  at the presets' widths and windows, 200 epochs at the first
                  alpha, TM-GCN and KW-GCN on "pallas": each experiment built
                  with the native host runtime (tmgcn_torch/native), counted
                  with its run (K1: 3 at set-up; uci_tmgcn_lp's full-row
                  layer 2 3 a step and 2 an evaluation, 607; WD-GCN 200, the
                  readout plan's backward; EvolveGCN-H none, gather-free;
                  each family's operator checked apart), the TM-GCN presets
                  (a dataset's first, so each parses, samples and packs)
                  again with the numpy plain versions (set-up seconds side
                  by side, the same data and K1 packings); the eager loop on
                  the same adapter (all 200 epochs; the recurrent families
                  their first 20, the phase's one cut: rows bitwise,
                  launches exact); the first 5 epochs against the CPU's
                  plain path, computed in a process of its own while the
                  card runs (losses rtol 1e-4, F1 within 1e-3 or
                  EvolveGCN-H's tie range, MAP/MRR rtol 1e-3);
                  uci_tmgcn_lp diverges, as the JAX package does from the
                  same variables: its loss finite up to one epoch and
                  non-finite after; one preset per (family, task) timed captured
                  against eager in turns; K1 at uci_tmgcn_lp's full-row
                  layer 2, forward and transposed, against its plain version
                  and torch.sparse.mm beside its bound; ``cli run
                  bitcoin_otc_tmgcn_cls --epochs 20`` over its 21 alphas
                  (seconds per alpha, graph captures per sweep); ``cli run
                  seir_tmgcn_reg --debug-nans`` in a subprocess beside the
                  paths (exit non-zero, FloatingPointError) and ``cli run
                  chess_tmgcn_cls --debug-nans --epochs 20`` (exit 0, the
                  rows of the run without the flag);
               s. the full-row auto operator (ops.spmm.make_auto_operator,
                  its constants fitted on this card by utils/kernel_probe):
                  chess_tmgcn_cls, uci_tmgcn_lp and seir_wdgcn_reg_tuned
                  with spmm_impl "auto", seir_wdgcn_reg_tuned with
                  "auto_bf16", each built and run 200 epochs through
                  run_experiment, counted: each window's pick and both
                  ratios printed; the launches each pick predicts (K1 or K3
                  in the pick's tier, none for block-dense); the train
                  window's pick, forward and backward at the widths the path
                  applies it at, against the rule's other two candidates and
                  the plain segment sum (float32 1e-5 * max(1, |ref|), bf16
                  2e-2 of the scale); the rows against the same preset's
                  pallas (pallas_bf16) run at 7r's tolerances (uci_tmgcn_lp:
                  where that loss is finite and under 1e6, then finite and
                  non-finite); the phase within AUTO_BUDGET_S;
  8. capture — chess_tmgcn_cls (pallas), chess_tmgcn2_cls (pallas and the
               preset's jnp), chess_wdgcn_cls, chess_wdgcn_lp,
               chess_evolvegcn_cls, chess_evolvegcn2_cls,
               chess_evolvegcn_lp, seir_wdgcn_reg_tuned,
               seir_tmgcn_reg_tuned and seir_evolvegcn_reg_tuned: plain
               epochs captured and eager, timed in turns as bench.py times
               a chunk (a warm chunk, the chunk grown until a round covers
               0.25 s, the median of 5 rounds, with best, max and spread),
               then a warm captured chunk of 21 epochs traced (device ms per
               epoch, busy share), each beside the card's name and power
               limit;
  9. a JSON line {"kernels": [...]} with every ported kernel's numbers;
 10. last line: {"ok": true, "device": {...}}.

Without CUDA, or outside a checkout, it exits non-zero and prints no
result. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import pickle
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

try:  # the card's data-sheet peaks: float32 outside the tensor cores, HBM3
    from tmgcn_torch.utils.profiling import PEAK_FLOPS_F32 as PEAK_F32_FLOP_PER_S
    from tmgcn_torch.utils.profiling import PEAK_HBM_BYTES as PEAK_BYTES_PER_S
except ImportError as e:
    sys.exit(f"chip_smoke: FAIL: run from the root of a tmgcn checkout ({e})")
# Float32 sums taken in another order; scaled by max(1, |ref|). The bf16
# tiers too: their plain versions round each product to bf16 as the
# kernels do, so only the order of the float32 sums differs.
ATOL = 1e-5
EPOCHS = 200
REF_EPOCHS = 5
DATA_DIR = "data/chess"
SOURCE = "tmgcn_torch/kernels/csrc/windowed_segment_matmul.cu"
K3_SOURCE = "tmgcn_torch/kernels/csrc/windowed_tiled_segment_matmul.cu"
K1_REPLACES = "tmgcn_tpu/kernels/spmm_pallas.py:650"
K2_REPLACES = "tmgcn_tpu/kernels/spmm_pallas.py:761"
K3_REPLACES = "tmgcn_tpu/kernels/spmm_pallas.py:560"
# Launch counters, in the order of the kernels line: (wrapper name, counter).
COUNTERS = (
    ("windowed_segment_matmul", "launches"),
    ("windowed_segment_matmul", "launches_bf16"),
    ("windowed_segment_matmul_t", "launches"),
    ("windowed_tiled_segment_matmul", "launches"),
    ("windowed_tiled_segment_matmul", "launches_bf16"),
    ("windowed_segment_matmul", "launches_fast"),
    ("windowed_tiled_segment_matmul", "launches_fast"),
)
COUNTED = "(K1, K1 bf16, K2, K3, K3 bf16, K1 fast, K3 fast)"
BF16_RTOL = 1e-3  # losses of the bf16 paths against the CPU's plain path
DEVICE = "cuda"
# The scale runs: tools/bench_scale.py's inputs, host build cut.
SCALE = {"n_nodes": 500_000, "n_slices": 64, "nnz_per_slice": 250_000,
         "n_edges": 1_000_000, "band": 20}
SCALE_N_TIMED = 12  # -> 3 warm-up and 3 timed steps (scale_bench's rule)
SCALE_TRACED_STEPS = 3
# The SBM presets' 300 epochs cut to 100: each evaluation epoch scores some
# 6.6M LP edges on the host (seconds), and eval_every is 50.
SBM_EPOCHS = 100
# Phase 7p: the 1 x 1 mesh's runs, and the launched CLI's (beside them).
MESH_EPOCHS = 200
MESH_CLI_EPOCHS = 20
MESH_CLI_TIMEOUT_S = 300
# Phase 7q: the recurrent families and regression at 1 x 1, each path's
# epochs cut (EvolveGCN-2's eager epoch is ~133 ms; chess evaluates at 0,
# SEIR scores val and test after its one chunk).
MESH_RECURRENT_PRESETS = (
    "chess_wdgcn_cls", "chess_evolvegcn_cls", "chess_evolvegcn2_cls", "chess_evolvegcn_lp",
    "seir_tmgcn_reg_tuned", "seir_wdgcn_reg_tuned", "seir_evolvegcn_reg_tuned",
)
MESH_RECURRENT_EPOCHS = 50
# Phase 7r: the 32 presets of the registry's other datasets, on copies of
# their in-repo stand-ins (data/synthetic/<name>/) under the build directory
# git ignores, at the presets' widths and windows; 10,000 epochs (LP 1,000)
# cut to 200 at the preset's eval_every (evaluations at 0 and 100). The
# recurrent families' eager reference runs their first REGISTRY_EAGER_EPOCHS
# (an eager epoch of 30-75 ms); TM-GCN and KW-GCN run "pallas", so K1 runs at
# their packings. The CPU references run in a process of their own with
# REGISTRY_CPU_THREADS threads while the card runs the phase.
REGISTRY_DATASETS = ("bitcoin_otc", "bitcoin_alpha", "reddit", "amlsim", "uci")
REGISTRY_DIR = "build/chip_smoke_registry"
REGISTRY_EPOCHS = 200
REGISTRY_EAGER_EPOCHS = 20
REGISTRY_CPU_THREADS = 4
REGISTRY_CPU_TIMEOUT_S = 600
# Timed captured against eager: one preset per (family, task).
REGISTRY_TIMED = ("bitcoin_otc_tmgcn_cls", "amlsim_gcn_cls", "bitcoin_alpha_evolvegcn_cls",
                  "reddit_wdgcn_cls", "uci_tmgcn_lp", "bitcoin_alpha_gcn_lp",
                  "reddit_evolvegcn_lp", "uci_wdgcn_lp")
# Diverges within 200 epochs (lr 0.01 on the 2-layer TM-GCN with M^2 and
# M^3): from the same variables both packages' losses pass 1e12 at epoch 5
# on the CPU (tests/test_torch_registry_uci_divergence.py).
REGISTRY_DIVERGING = ("uci_tmgcn_lp",)
# Phase 7s: the full-row auto operator (ops.spmm.make_auto_operator) as the
# JAX package reaches it, spmm_impl "auto" on a preset through run_experiment;
# epochs cut as 7r's. Each preset's pick is held on its train window against
# the other two candidates and the plain segment sum; the raw copies live
# under the build directory git ignores.
AUTO_PATHS = (("chess_tmgcn_cls", "auto"), ("uci_tmgcn_lp", "auto"),
              ("seir_wdgcn_reg_tuned", "auto"), ("seir_wdgcn_reg_tuned", "auto_bf16"))
AUTO_DIR = "build/chip_smoke_auto"
AUTO_EPOCHS = 200
AUTO_BUDGET_S = 60
SWEEP_PRESET, SWEEP_EPOCHS = "bitcoin_otc_tmgcn_cls", 20  # its whole 21-alpha sweep
DEBUG_NANS_EPOCHS = 20
DEBUG_NANS_TIMEOUT_S = 300


@contextlib.contextmanager
def _data_loaded_once():
    """``configs.build.build_data`` memoized, in this process, by the fields
    of the config that it reads: each chess data variant (the windows of Ct
    or of C, the LP edge set) is built or loaded from its .mat cache once
    (3-4 s a load on that machine's host), not once per run. Only a path's
    first run of a variant reports the load in its ``data`` seconds."""
    from tmgcn_torch.configs import build

    loaded = {}
    build_data = build.build_data

    def once(cfg, data_dir=None, artifact=None):
        key = (cfg.dataset, cfg.method == "tmgcn", cfg.task, cfg.same_block_size, cfg.seed,
               cfg.beta1, cfg.beta2, cfg.cutoff, cfg.standardize_features, str(data_dir),
               str(artifact), cfg.sbm_n_nodes, cfg.sbm_n_slices, cfg.sbm_node_change,
               cfg.sbm_normalize, cfg.sbm_features, cfg.seir_n_nodes, cfg.seir_n_slices,
               cfg.seir_out_idx, cfg.seir_normalize)
        if key not in loaded:
            loaded[key] = build_data(cfg, data_dir=data_dir, artifact=artifact)
        return loaded[key]

    with mock.patch.object(build, "build_data", once):
        yield


@contextlib.contextmanager
def _timed(phase: str):
    """Print the host seconds a phase took (the run's budget is 1,200 s)."""
    t0 = time.perf_counter()
    yield
    print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")


def check(cond: bool, msg: str) -> None:
    if not cond:
        sys.exit(f"chip_smoke: FAIL: {msg}")


def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(line)
    return line


def phase_build() -> None:
    """The CUDA kernels (nvcc, a process a source) and, beside them, the
    native host runtime (g++)."""
    from concurrent.futures import ThreadPoolExecutor

    from tmgcn_torch import native
    from tmgcn_torch.kernels.build import build_all

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(lambda: (native.load(), time.perf_counter() - t0)[1])
        paths = build_all(verbose=True)
        t_kernels = time.perf_counter() - t0
        t_native = host.result()
    print(f"build: {len(paths)} kernel libraries in {t_kernels:.3f} s; the native host runtime "
          f"(g++, beside them) in {t_native:.3f} s")


def _max_err(out, ref) -> tuple[float, float]:
    """(max |out - ref|, the tolerance for ref's scale)."""
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    return err, ATOL * max(1.0, ref.abs().max().item() if ref.numel() else 0.0)


def _check_same(torch, run_kernel, run_plain, what: str) -> float:
    """Kernel vs plain version on the same card inputs; bitwise repeat."""
    out = run_kernel()
    again = run_kernel()
    ref = run_plain()
    torch.cuda.synchronize()
    err, tol = _max_err(out, ref)
    check(err <= tol, f"{what}: max abs err {err} > {tol}")
    check(torch.equal(out, again), f"{what}: two launches differ")
    return err


def _check_kernel(torch, kernel, plain, packed, gathered, init_fn, what: str) -> float:
    """K1/K2 vs plain version, float32 out, with init_fn()'s output store."""
    f32 = torch.float32
    return _check_same(
        torch, lambda: kernel(packed, gathered, out_dtype=f32, init=init_fn()),
        lambda: plain(packed, gathered, out_dtype=f32, init=init_fn()), what,
    )


def _check_operator_backward(torch, tk, op, X, what: str) -> float:
    """Autograd backward (K1 on the transposed packing) vs the plain version."""
    T, N, F = X.shape
    Xg = X.clone().requires_grad_(True)
    G = torch.randn(X.shape, device=X.device, generator=torch.Generator(device=X.device).manual_seed(1))
    (op(Xg) * G).sum().backward()
    pt = op.packed_t
    gathered = G.reshape(T * N, F)[pt.cols.long().reshape(-1)].reshape(pt.n_chunks, pt.chunk, F)
    ref = tk.windowed_segment_matmul_reference(pt, gathered)[: T * N].reshape(T, N, F)
    torch.cuda.synchronize()
    err, tol = _max_err(Xg.grad, ref)
    check(err <= tol, f"K1 backward {what}: max abs err {err} > {tol}")
    return err


def _random_stream(np, seed: int, n_out: int):
    """Row-sorted entries over n_out rows; a third of the windows empty."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_out, 60_000)
    rows = np.sort(rows[(rows // 256) % 3 != 1])
    cols = rng.integers(0, n_out, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows, cols, vals


def _time_ms(torch, fn, reps: int = 25) -> float:
    """Median ms of fn on the card (CUDA events), L2 flushed before each."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound_ms(bytes_moved: int, flops: int) -> tuple[float, str]:
    """The larger of the bytes over the memory rate and the operations
    over the float32 rate, in ms, and which of the two it is."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _bound(p, F: int, n_real: int, with_init: bool, itemsize: int = 4) -> tuple[float, str, int, int]:
    """The least time for K1/K2's function on these inputs.

    The function needs only the real entries (a row id, a value and F
    gathered features of ``itemsize`` bytes each; the padding slots of the
    packing are not counted), the window offsets, and each float32 output
    element it writes, once. Without an init it writes every window; with
    one (the caller's zeros) it writes only the windows that own a chunk,
    and leaves the rest alone.
    """
    if with_init:
        wp = p.window_ptr
        n_written = int((wp[1:] > wp[:-1]).sum()) * p.window
    else:
        n_written = p.n_rows_out
    bytes_moved = 4 * (2 * n_real + p.window_ptr.numel() + n_written * F) + itemsize * n_real * F
    flops = 2 * n_real * F
    return (*_bound_ms(bytes_moved, flops), bytes_moved, flops)


def _slot_csr(torch, p, n_real_mask):
    """The (n_rows_out, J*C) CSR matrix of a packing's real slots: the same
    sums as K1/K2 as one torch.sparse.mm (a yardstick; the port never calls it)."""
    J, C = p.rows.shape
    W = p.window
    slot = torch.arange(J * C, device=p.rows.device)
    out_row = (p.window_id.long()[:, None] * W + p.rows.long()).reshape(-1)
    keep = n_real_mask.reshape(-1)
    return torch.sparse_coo_tensor(
        torch.stack([out_row[keep], slot[keep]]), p.vals.reshape(-1)[keep],
        (p.n_rows_out, J * C),
    ).coalesce().to_sparse_csr()


def _time_shape(torch, kernel, plain, p, gathered, F, n_real, init_shape, lib_fn, what: str) -> dict:
    """Kernel, plain and library times at one shape, with the bound."""
    # A zero init is the caller's (allocated once per step on the path),
    # so both versions write into one kept buffer: each call rewrites the
    # same visited windows with the same sums.
    init = torch.zeros(init_shape, device=gathered.device) if init_shape is not None else None
    ms = _time_ms(torch, lambda: kernel(p, gathered, init=init))
    plain_ms = _time_ms(torch, lambda: plain(p, gathered, init=init))
    library_ms = _time_ms(torch, lib_fn)
    bound_ms, bound_by, nbytes, flops = _bound(p, F, n_real, init is not None)
    print(f"{what}: J={p.n_chunks} C={p.chunk} W={p.window} F={F} nnz={n_real} "
          f"n_rows_out={p.n_rows_out}")
    print(f"{what}: kernel ms (median, CUDA events, L2 flushed): {ms:.6f}")
    print(f"{what}: plain version ms: {plain_ms:.6f}")
    print(f"{what}: bound ms: {bound_ms:.6f} ({bound_by}: {nbytes} bytes, {flops} operations)")
    print(f"{what}: library ms (torch.sparse.mm, CSR): {library_ms:.6f}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _report(torch, what: str, kernel_fn, plain_fn, lib_fn, bound) -> dict:
    """Kernel, plain and library times of one shape, beside its bound."""
    ms = _time_ms(torch, kernel_fn)
    plain_ms = _time_ms(torch, plain_fn)
    library_ms = _time_ms(torch, lib_fn)
    bound_ms, bound_by, nbytes, flops = bound
    print(f"{what}: kernel ms (median, CUDA events, L2 flushed): {ms:.6f}")
    print(f"{what}: plain version ms: {plain_ms:.6f}")
    print(f"{what}: bound ms: {bound_ms:.6f} ({bound_by}: {nbytes} bytes, {flops} operations)")
    print(f"{what}: library ms (torch.sparse.mm, CSR): {library_ms:.6f}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _packing_csr(torch, p, n_in: int, transpose: bool = False):
    """The (n_rows_out, n_in) CSR matrix of a K1 packing's real entries
    (global row, column id, value): torch.sparse.mm of it and the input
    rows computes the operator's function, gather included (a yardstick;
    the port never calls it)."""
    out_row = (p.window_id.long()[:, None] * p.window + p.rows.long()).reshape(-1)
    keep = (p.vals != 0).reshape(-1)
    idx = torch.stack([out_row[keep], p.cols.long().reshape(-1)[keep]])
    shape = (p.n_rows_out, n_in)
    if transpose:
        idx, shape = idx.flip(0), shape[::-1]
    return torch.sparse_coo_tensor(idx, p.vals.reshape(-1)[keep], shape).coalesce().to_sparse_csr()


@functools.cache
def _chess_wdgcn_train_edges():
    from tmgcn_torch.configs.build import build_data
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.tasks.windows import split_edges_classification

    cfg = get_preset("chess_wdgcn_cls")
    data = build_data(cfg, data_dir=DATA_DIR)
    split = split_edges_classification(
        data.edge_index, data.edge_values, data.spec, n_classes=cfg.n_classes
    )["train"]
    return split.edges, data.spec.s_train, data.adj["train"].n_nodes


def phase_k1(torch, np) -> tuple[dict, int]:
    from tmgcn_torch.configs.build import build_data
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.core.sparse import TemporalCOO
    from tmgcn_torch.kernels import spmm_cuda as tk
    from tmgcn_torch.ops.edge_readout import make_readout_plan
    from tmgcn_torch.ops.mtransform import m_transform
    from tmgcn_torch.tasks.windows import split_edges_classification

    dev = torch.device(DEVICE)
    k1, k1p = tk.windowed_segment_matmul, tk.windowed_segment_matmul_reference
    max_err = 0.0
    for F in (2, 6, 128):
        for use_init in (False, True):
            rows, cols, vals = _random_stream(np, F, 20_000)
            p = tk.pack_windowed_flat(
                rows, cols, vals, 20_000, sort_cols=True, all_windows=not use_init
            ).to(dev)
            g = torch.randn(p.n_chunks, p.chunk, F, device=dev)

            def init_fn(p=p, F=F, use_init=use_init):
                return torch.zeros(p.n_rows_out, F, device=dev) if use_init else None

            max_err = max(max_err, _check_kernel(torch, k1, k1p, p, g, init_fn,
                                                 f"K1 F={F} init={use_init}"))
        # Operator backward on a random temporal graph at this width.
        rng = np.random.default_rng(F)
        dense = (rng.random((4, 300, 300)) < 0.05) * rng.random((4, 300, 300))
        op = tk.make_operator(TemporalCOO.from_dense(dense)).to(dev)
        X = torch.randn(4, 300, F, device=dev)
        max_err = max(max_err, _check_operator_backward(torch, tk, op, X, f"F={F}"))
    print(f"K1 random packings: ok (max abs err {max_err:.3e})")

    # The chess train window at the TM-GCN path's width (F = 2 degree features).
    cfg = dataclasses.replace(get_preset("chess_tmgcn_cls"), spmm_impl="pallas")
    t0 = time.perf_counter()
    data = build_data(cfg, data_dir=DATA_DIR)
    t_data = time.perf_counter() - t0
    Ct = data.adj["train"]
    t0 = time.perf_counter()
    op = tk.make_operator(Ct).to(dev)
    t_pack = time.perf_counter() - t0
    e_train = split_edges_classification(
        data.edge_index, data.edge_values, data.spec, n_classes=cfg.n_classes
    )["train"].target.size
    print(f"chess data build: {t_data:.3f} s; K1 packing (train window, both directions): "
          f"{t_pack:.3f} s")
    T, N = op.T, op.N
    M = torch.as_tensor(data.M, dtype=torch.float32, device=dev)
    X = torch.as_tensor(data.feats["train"], dtype=torch.float32, device=dev)
    flat = m_transform(M, X).reshape(T * N, -1)
    F = flat.shape[1]
    p = op.packed
    gathered = flat[p.cols.long().reshape(-1)].reshape(p.n_chunks, p.chunk, F).contiguous()
    chess_err = _check_kernel(torch, k1, k1p, p, gathered, lambda: None, "K1 chess train window")
    chess_err = max(chess_err, _check_operator_backward(torch, tk, op, flat.reshape(T, N, F), "chess"))
    max_err = max(max_err, chess_err)
    # torch.sparse.mm of the block-diagonal (T*N, T*N) CSR matrix: the
    # operator-level yardstick (gather included).
    nnz = torch.as_tensor(Ct.nnz).long()
    real = torch.arange(Ct.capacity)[None, :] < nnz[:, None]
    offs = (torch.arange(T) * N)[:, None]
    idx = torch.stack([
        (torch.as_tensor(Ct.rows).long() + offs)[real],
        (torch.as_tensor(Ct.cols).long() + offs)[real],
    ])
    A_csr = torch.sparse_coo_tensor(
        idx, torch.as_tensor(Ct.vals)[real], (T * N, T * N), check_invariants=True
    ).coalesce().to_sparse_csr().to(dev)
    lib_out = torch.sparse.mm(A_csr, flat)
    k1_out = k1(p, gathered)[: T * N]
    torch.cuda.synchronize()
    err, tol = _max_err(k1_out, lib_out)
    check(err <= tol, f"K1 vs torch.sparse.mm at the chess shape: {err} > {tol}")
    train_window = _time_shape(
        torch, k1, k1p, p, gathered, F, int(nnz.sum()), None, lambda: torch.sparse.mm(A_csr, flat),
        "K1 chess train window",
    )
    del op, p, gathered, A_csr

    # The chess readout plan of chess_wdgcn_cls: 2E = 78,384 endpoint rows
    # into T*N = 584,080, F = 6, zero init — K1's launch in every step.
    edges, T, N = _chess_wdgcn_train_edges()
    plan = make_readout_plan(edges, T, N).to(dev)
    check(not plan.lane_major, "the chess readout plan picked the lane-major layout")
    p, F = plan.packed, 6
    g = torch.randn(p.n_chunks, p.chunk, F, device=dev)
    err = _check_kernel(torch, k1, k1p, p, g,
                        lambda: torch.zeros(p.n_rows_out, F, device=dev), "K1 chess readout plan")
    S = _slot_csr(torch, p, p.vals != 0)
    g_flat = g.reshape(-1, F)
    lib_out = torch.sparse.mm(S, g_flat)
    k1_out = k1(p, g, init=torch.zeros(p.n_rows_out, F, device=dev))
    torch.cuda.synchronize()
    lib_err, tol = _max_err(k1_out, lib_out)
    check(lib_err <= tol, f"K1 vs torch.sparse.mm at the readout shape: {lib_err} > {tol}")
    max_err = max(max_err, err)
    readout = _time_shape(torch, k1, k1p, p, g, F, 2 * edges.shape[1], (p.n_rows_out, F),
                          lambda: torch.sparse.mm(S, g_flat), "K1 chess readout plan")
    print(f"K1 max abs err over every check: {max_err:.3e}")
    # The per-epoch path's shape heads the row; the train window's follows.
    return {
        "name": "windowed_segment_matmul",
        "route": "cuda",
        "source": SOURCE,
        "replaces": K1_REPLACES,
        "max_abs_err": max_err,
        **readout,
        "shape": "chess readout plan (F=6, 78,384 entries, zero init)",
        "train_window": train_window,
    }, e_train


@functools.cache
def _chess_lp_data():
    """chess_wdgcn_lp's data (its LP edges are chess_tmgcn_lp's: one edge
    list, one seed), built once."""
    from tmgcn_torch.configs.build import build_data
    from tmgcn_torch.configs.presets import get_preset

    return build_data(get_preset("chess_wdgcn_lp"), data_dir=DATA_DIR)


def _chess_lp_splits(same_block: bool):
    from tmgcn_torch.tasks.windows import split_data_link_prediction

    data = _chess_lp_data()
    spec = dataclasses.replace(data.spec, same_block_size=same_block)
    return split_data_link_prediction(data.lp_edges, data.lp_labels, spec)


def _chess_wdgcn_lp_train_edges():
    """chess_wdgcn_lp's train-window model edges (the readout plan's input),
    T = s_train - 1 model slices, N."""
    data = _chess_lp_data()
    edges = _chess_lp_splits(False)["train"].model_edges
    return edges, data.spec.s_train - 1, data.adj["train"].n_nodes


def _lp_eval_seconds(np, splits: dict) -> dict:
    """Host seconds of one LP evaluation epoch's scoring (map_mrr and the
    loss of the train window's model edges and of val's and test's scored
    edges), on logits made from a seed: the part of an evaluation epoch that
    runs on the host after the logits are fetched."""
    from tmgcn_torch.tasks import metrics as M

    rng = np.random.default_rng(0)
    out = {}
    for w, s in splits.items():
        if w == "train" or s.n_eval_tail is None:
            keep = s.edges[0] != 0
            tgt, e = s.target[keep], s.edges[:, keep]
        else:
            tgt, e = s.target[-s.n_eval_tail:], s.edges[:, -s.n_eval_tail:]
        logits = rng.standard_normal((tgt.size, 2)).astype(np.float32)
        t0 = time.perf_counter()
        M.map_mrr(logits, tgt, e)
        M.weighted_ce_loss_np(logits, tgt, np.array([0.9, 0.1]))
        out[w] = time.perf_counter() - t0
    return out


def phase_k1_lp(torch, np) -> tuple[dict, float]:
    """K1 at chess_wdgcn_lp's readout-plan packing: against its plain
    version and torch.sparse.mm, bitwise repeat, times beside the bound."""
    from tmgcn_torch.kernels import spmm_cuda as tk
    from tmgcn_torch.ops.edge_readout import make_readout_plan

    dev = torch.device(DEVICE)
    k1, k1p = tk.windowed_segment_matmul, tk.windowed_segment_matmul_reference
    edges, T, N = _chess_wdgcn_lp_train_edges()
    t0 = time.perf_counter()
    plan = make_readout_plan(edges, T, N).to(dev)
    t_plan = time.perf_counter() - t0
    check(not plan.lane_major, "the chess LP readout plan picked the lane-major layout")
    p, F = plan.packed, 6
    print(f"K1 chess LP readout plan built in {t_plan:.3f} s: {2 * edges.shape[1]} entries in "
          f"{p.n_chunks} chunks of {p.chunk} slots into {p.n_rows_out} rows")
    g = torch.randn(p.n_chunks, p.chunk, F, device=dev)
    err = _check_kernel(torch, k1, k1p, p, g,
                        lambda: torch.zeros(p.n_rows_out, F, device=dev), "K1 chess LP readout plan")
    S = _slot_csr(torch, p, p.vals != 0)
    g_flat = g.reshape(-1, F)
    lib_out = torch.sparse.mm(S, g_flat)
    k1_out = k1(p, g, init=torch.zeros(p.n_rows_out, F, device=dev))
    torch.cuda.synchronize()
    lib_err, tol = _max_err(k1_out, lib_out)
    check(lib_err <= tol, f"K1 vs torch.sparse.mm at the LP readout shape: {lib_err} > {tol}")
    timing = _time_shape(torch, k1, k1p, p, g, F, 2 * edges.shape[1], (p.n_rows_out, F),
                         lambda: torch.sparse.mm(S, g_flat), "K1 chess LP readout plan")
    del plan, p, g, S, g_flat, lib_out, k1_out
    torch.cuda.empty_cache()
    timing["shape"] = (f"chess_wdgcn_lp readout plan (F=6, {2 * edges.shape[1]:,} entries into "
                       f"{T} x {N} rows, zero init)")
    return timing, err


def phase_k1_kwgcn(torch, np) -> tuple[dict, float]:
    """K1 at the KW-GCN 2-layer epoch's layer-2 SpMM: the chess train window
    of the untransformed C (80 disjoint slices, the prepacked operator of
    spmm_impl="pallas"), F = 6, the forward packing and the transposed one
    (the backward): against the plain version and torch.sparse.mm, the
    operator's autograd backward, bitwise repeat, times beside the bound."""
    from tmgcn_torch.configs.build import build_data
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.kernels import spmm_cuda as tk

    dev = torch.device(DEVICE)
    k1, k1p = tk.windowed_segment_matmul, tk.windowed_segment_matmul_reference
    C = build_data(get_preset("chess_gcn_cls"), data_dir=DATA_DIR).adj["train"]
    t0 = time.perf_counter()
    op = tk.make_operator(C).to(dev)
    t_pack = time.perf_counter() - t0
    T, N, F = op.T, op.N, 6
    n_real = int(np.asarray(C.nnz).sum())
    print(f"K1 KW-GCN 2-layer (chess train window of C, {T} x {N}, {n_real} entries): packing "
          f"(both directions) {t_pack:.3f} s")
    Y = torch.randn(T * N, F, device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    max_err = _check_operator_backward(torch, tk, op, Y.reshape(T, N, F), "KW-GCN 2-layer")
    out = {}
    for what, p in (("forward", op.packed), ("backward", op.packed_t)):
        gathered = Y[p.cols.long().reshape(-1)].reshape(p.n_chunks, p.chunk, F).contiguous()
        name = f"K1 KW-GCN 2-layer {what}"
        max_err = max(max_err, _check_kernel(torch, k1, k1p, p, gathered, lambda: None, name))
        csr = _packing_csr(torch, p, T * N)
        lib_out = torch.sparse.mm(csr, Y)
        err, tol = _max_err(k1(p, gathered)[: T * N], lib_out[: T * N])
        check(err <= tol, f"{name} vs torch.sparse.mm: {err} > {tol}")
        out[f"kwgcn2_{what}"] = {
            **_time_shape(torch, k1, k1p, p, gathered, F, n_real, None,
                          lambda csr=csr: torch.sparse.mm(csr, Y), name),
            "shape": f"chess_gcn_cls 2-layer layer-2 {what} (F=6, {n_real:,} entries into "
                     f"{T} x {N} rows; library gather included)",
        }
    del op, Y
    torch.cuda.empty_cache()
    return out, max_err


def phase_k2(torch, np, scale_edges) -> dict:
    from tmgcn_torch.kernels import spmm_cuda as tk
    from tmgcn_torch.ops.edge_readout import apply_readout, edge_readout, make_readout_plan

    dev = torch.device(DEVICE)
    k2, k2p = tk.windowed_segment_matmul_t, tk.windowed_segment_matmul_t_reference
    max_err = 0.0
    for F in (2, 6, 128):
        for use_init in (False, True):
            for window in (256, 2048):  # past the old kernel's 1,024-row cap
                rows, cols, vals = _random_stream(np, 100 + F, 20_000)
                p = tk.pack_windowed_flat(
                    rows, cols, vals, 20_000, window=window, sort_cols=True,
                    all_windows=not use_init,
                ).to(dev)
                g = torch.randn(p.n_chunks, F, p.chunk, device=dev)

                def init_fn(p=p, F=F, use_init=use_init):
                    return torch.zeros(F, p.n_rows_out, device=dev) if use_init else None

                what = f"K2 F={F} init={use_init} window={window}"
                max_err = max(max_err, _check_kernel(torch, k2, k2p, p, g, init_fn, what))
                # The same sums as K1, bitwise: same order, same rounding.
                k1_out = tk.windowed_segment_matmul(p, g.transpose(1, 2).contiguous(),
                                                    init=None if init_fn() is None
                                                    else torch.zeros(p.n_rows_out, F, device=dev))
                check(torch.equal(k2(p, g, init=init_fn()), k1_out.T),
                      f"{what} is not K1 transposed")
    print(f"K2 random packings: ok (max abs err {max_err:.3e})")

    # The chess readout plan of chess_wdgcn_cls forced lane-major, forward
    # and backward, against the plain gather's autograd on the card.
    edges, T, N = _chess_wdgcn_train_edges()
    E = edges.shape[1]
    gen = torch.Generator(device=dev).manual_seed(3)
    Y = torch.randn(T, N, 6, device=dev, generator=gen)
    U = torch.randn(12, 3, device=dev, generator=gen)
    G = torch.randn(E, 3, device=dev, generator=gen)
    e_dev = torch.as_tensor(edges, device=dev)
    Yr, Ur = Y.clone().requires_grad_(True), U.clone().requires_grad_(True)
    ref = edge_readout(Yr, e_dev, Ur)
    (ref * G).sum().backward()
    plan = make_readout_plan(edges, T, N, lane_major=True).to(dev)
    grads = []
    for _ in range(2):
        Yk, Uk = Y.clone().requires_grad_(True), U.clone().requires_grad_(True)
        before = k2.launches
        out = apply_readout(plan, Yk, Uk)
        (out * G).sum().backward()
        torch.cuda.synchronize()
        check(k2.launches == before + 1, "the lane-major plan's backward did not launch K2")
        grads.append(Yk.grad)
        for what, a, b in (("logits", out, ref), ("dY", Yk.grad, Yr.grad), ("dU", Uk.grad, Ur.grad)):
            err, tol = _max_err(a, b)
            check(err <= tol, f"K2 chess lane-major plan {what}: max abs err {err} > {tol}")
            max_err = max(max_err, err)
    check(torch.equal(*grads), "K2 chess lane-major plan: two backward passes differ")
    print(f"K2 chess readout plan forced lane-major: forward and backward ok, "
          f"backward bitwise repeatable (max abs err {max_err:.3e})")
    del Y, Yr, Yk, plan, grads

    # The WD-GCN scale shape: 2M endpoint rows into T*N = 32M, F = 6.
    t0 = time.perf_counter()
    plan = make_readout_plan(scale_edges, SCALE["n_slices"], SCALE["n_nodes"]).to(dev)
    t_plan = time.perf_counter() - t0
    check(plan.lane_major, "the scale readout plan did not pick the lane-major layout")
    p, F = plan.packed, 6
    print(f"K2 scale plan built in {t_plan:.3f} s: {p.n_chunks} chunks of {p.chunk} slots for "
          f"{2 * scale_edges.shape[1]} entries ({2 * scale_edges.shape[1] / (p.n_chunks * p.chunk):.4f} "
          f"occupancy); the padded (J, F, C) chunks take "
          f"{p.n_chunks * F * p.chunk * 4} bytes")
    g = torch.randn(p.n_chunks, F, p.chunk, device=dev)
    err = _check_kernel(torch, k2, k2p, p, g,
                        lambda: torch.zeros(F, p.n_rows_out, device=dev), "K2 scale plan")
    max_err = max(max_err, err)
    S = _slot_csr(torch, p, p.vals != 0)
    g_flat = g.transpose(1, 2).reshape(-1, F).contiguous()  # (J*C, F); layout change not timed
    lib_out = torch.sparse.mm(S, g_flat)
    k2_out = k2(p, g, init=torch.zeros(F, p.n_rows_out, device=dev))
    torch.cuda.synchronize()
    lib_err, tol = _max_err(k2_out.T, lib_out)
    check(lib_err <= tol, f"K2 vs torch.sparse.mm at the scale shape: {lib_err} > {tol}")
    del lib_out
    timing = _time_shape(torch, k2, k2p, p, g, F, 2 * scale_edges.shape[1], (F, p.n_rows_out),
                         lambda: torch.sparse.mm(S, g_flat), "K2 WD-GCN scale plan")
    del S, g_flat
    # K1 on the same packing and sums: (J, C, F) slab and (n_rows_out, F)
    # zero init made outside the timed region. The two layouts' times at
    # one shape are what LANE_MAJOR_BYTES is to be set from.
    g_k1 = g.transpose(1, 2).contiguous()
    init_k1 = torch.zeros(p.n_rows_out, F, device=dev)
    check(torch.equal(tk.windowed_segment_matmul(p, g_k1, init=init_k1), k2_out.T),
          "K2 at the scale shape is not K1 transposed")
    k1_ms = _time_ms(torch, lambda: tk.windowed_segment_matmul(p, g_k1, init=init_k1))
    print(f"K1 at the scale packing ((J, C, F) in, (n_rows_out, F) out, zero init): kernel ms "
          f"{k1_ms:.6f} (K2 {timing['ms']:.6f}, bound {timing['bound_ms']:.6f} for both)")
    del g_k1, init_k1, k2_out
    ops = _time_readout_backward_ops(torch, plan, F, scale_edges.shape[1])
    print(f"K2 max abs err over every check: {max_err:.3e}")
    del plan, p, g
    torch.cuda.empty_cache()
    return {
        "name": "windowed_segment_matmul_t",
        "route": "cuda",
        "source": SOURCE,
        "replaces": K2_REPLACES,
        "max_abs_err": max_err,
        **timing,
        "shape": "WD-GCN scale readout plan (F=6, 2,000,000 entries into 32,000,000 rows)",
        "k1_at_scale_packing_ms": k1_ms,
        "readout_backward_ops_ms": ops,
    }


def _time_readout_backward_ops(torch, plan, F: int, E: int) -> dict:
    """The lane-major readout backward's device work around K2 at this plan's
    shape (ops/edge_readout.py): the gather of the (F, 2E) gradient rows into
    padded chunk order, the permute copy to (J, F, C), and the (F, n_rows_out)
    zero init. Each moves the padded slab or the whole output, not the 2E
    real rows."""
    p = plan.packed
    d_both_t = torch.randn(F, 2 * E, device=plan.sort_cols.device)
    sel = d_both_t.index_select(1, plan.sort_cols)
    ops = {
        "index_select": _time_ms(torch, lambda: d_both_t.index_select(1, plan.sort_cols)),
        "permute_copy": _time_ms(
            torch, lambda: sel.reshape(F, p.n_chunks, p.chunk).permute(1, 0, 2).contiguous()),
        "zero_init": _time_ms(
            torch, lambda: torch.zeros((F, p.n_rows_out), device=plan.sort_cols.device)),
    }
    slab = 4 * F * p.n_chunks * p.chunk
    print(f"readout backward at the scale shape, ms (CUDA events, L2 flushed): padded gather "
          f"{ops['index_select']:.6f} ({slab} bytes written), permute copy "
          f"{ops['permute_copy']:.6f} ({2 * slab} bytes moved), zero init {ops['zero_init']:.6f} "
          f"({4 * F * p.n_rows_out} bytes)")
    return ops


@functools.cache
def _chess2():
    """chess_tmgcn2_cls's data and train split (the chess windows of the
    TM-GCN presets), built once."""
    from tmgcn_torch.configs.build import build_data
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.tasks.windows import split_edges_classification

    cfg = get_preset("chess_tmgcn2_cls")
    data = build_data(cfg, data_dir=DATA_DIR)
    split = split_edges_classification(
        data.edge_index, data.edge_values, data.spec, n_classes=cfg.n_classes
    )["train"]
    return data, split


def _chess_propagation_input(torch, data):
    """The train window's Ct (host) and M ×₁ X flattened on the card, (T*N, 2)."""
    from tmgcn_torch.ops.mtransform import m_transform

    dev = torch.device(DEVICE)
    M = torch.as_tensor(data.M, dtype=torch.float32, device=dev)
    X = torch.as_tensor(data.feats["train"], dtype=torch.float32, device=dev)
    flat = m_transform(M, X)
    return data.adj["train"], flat.reshape(-1, flat.shape[-1])


def phase_restricted(torch, np) -> tuple[dict, dict]:
    """K1's bf16 tier, both K1 tiers at the restricted shapes, and the
    restricted operator as K1 and as block-dense."""
    from tmgcn_torch.kernels import spmm_cuda as tk
    from tmgcn_torch.ops.spmm_blockdense import estimate
    from tmgcn_torch.tasks.adapters import _build_restricted_layer2

    dev = torch.device(DEVICE)
    k1, k1p = tk.windowed_segment_matmul, tk.windowed_segment_matmul_reference
    f32, bf16 = torch.float32, torch.bfloat16

    def k1_run(p, g, init_fn=lambda: None):
        return lambda: k1(p, g, out_dtype=f32, init=init_fn())

    def k1p_run(p, g, init_fn=lambda: None):
        return lambda: k1p(p, g, out_dtype=f32, init=init_fn())

    max_err = 0.0
    for F in (2, 6, 128):
        for use_init in (False, True):
            rows, cols, vals = _random_stream(np, 200 + F, 20_000)
            p = tk.pack_windowed_flat(
                rows, cols, vals, 20_000, chunk=512, sort_cols=True, all_windows=not use_init
            ).to(dev)
            g = torch.randn(p.n_chunks, p.chunk, F, device=dev).to(bf16)

            def init_fn(p=p, F=F, use_init=use_init):
                return torch.zeros(p.n_rows_out, F, device=dev) if use_init else None

            max_err = max(max_err, _check_same(torch, k1_run(p, g, init_fn), k1p_run(p, g, init_fn),
                                               f"K1 bf16 F={F} init={use_init}"))
    print(f"K1 bf16 random packings: ok (max abs err {max_err:.3e})")

    # The restricted layer-2 operator of chess_tmgcn2_cls's train window.
    data, split = _chess2()
    Ct = data.adj["train"]
    T, N = Ct.n_slices, Ct.n_nodes
    cached = torch.zeros(T, N, 2, device=dev)  # the operators do not read it
    ops, shape = {}, None
    for operator in ("pallas", "pallas_bf16", "blockdense", "blockdense_bf16"):
        bundle = {"cached": cached}
        t0 = time.perf_counter()
        uniq, used = _build_restricted_layer2(bundle, Ct, split.edges, False, operator)
        t_build = time.perf_counter() - t0
        ops[operator] = op = bundle["l2op"]
        if operator == "pallas":
            p, pt = op.packed, op.packed_t
            nnz = int((p.vals != 0).sum())
            est = estimate(*_host_stream(np, p))
            shape = (f"{len(uniq)} endpoint rows x {len(used)} used rows, nnz {nnz}, "
                     f"{p.n_chunks} forward / {pt.n_chunks} backward chunks of {p.chunk}, "
                     f"{est['n_blocks']} blocks of 128^2, estimate ratio {est['ratio']:.4f}")
            print(f"restricted train operator: {shape}")
        print(f"restricted operator {operator}: built in {t_build:.3f} s")
    n_in, n_out = len(used), len(uniq)
    gen = torch.Generator(device=dev).manual_seed(5)
    Y = torch.randn(n_in, 6, device=dev, generator=gen)
    G = torch.randn(n_out, 6, device=dev, generator=gen)

    # Both K1 tiers at the restricted forward (A) and backward (Aᵀ) shapes.
    op = ops["pallas"]
    timings = {}
    for tier, dtype in (("f32", f32), ("bf16", bf16)):
        for direction, p, x, n_x in (("forward", op.packed, Y, n_in),
                                     ("backward", op.packed_t, G, n_out)):
            g = tk.gather_chunks(x.to(dtype), p)
            what = f"K1 {tier} restricted {direction}"
            max_err = max(max_err, _check_same(torch, k1_run(p, g), k1p_run(p, g), what))
            S = _packing_csr(torch, p, n_x)
            x32 = x.to(dtype).float()
            lib_out = torch.sparse.mm(S, x32)
            err, tol = _max_err(k1(p, g, out_dtype=f32), lib_out)
            check(tier == "bf16" or err <= tol, f"{what} vs torch.sparse.mm: {err} > {tol}")
            print(f"{what}: J={p.n_chunks} C={p.chunk} W={p.window} F=6 nnz={nnz}")
            timings[(tier, direction)] = _report(
                torch, what, k1_run(p, g), k1p_run(p, g), lambda S=S, x32=x32: torch.sparse.mm(S, x32),
                _bound(p, 6, nnz, False, itemsize=2 if tier == "bf16" else 4),
            )

    # The restricted operator, four ways, forward and forward + backward.
    outs, comparison = {}, {}
    for name, o in ops.items():
        Yg = Y.clone().requires_grad_(True)
        out = o(Yg)
        (dY,) = torch.autograd.grad(out, Yg, G)
        outs[name] = (out.detach(), dY)

        def fwd_bwd(o=o, Yg=Yg):
            torch.autograd.grad(o(Yg), Yg, G)

        comparison[name] = {"forward_ms": _time_ms(torch, lambda o=o: o(Y)),
                            "forward_backward_ms": _time_ms(torch, fwd_bwd)}
        print(f"restricted operator {name}: forward {comparison[name]['forward_ms']:.6f} ms, "
              f"forward + backward {comparison[name]['forward_backward_ms']:.6f} ms")
    for name, rel in (("blockdense", ATOL), ("pallas_bf16", 2e-2), ("blockdense_bf16", 3e-2)):
        for i, what in enumerate(("forward", "backward")):
            ref = outs["pallas"][i]
            err = (outs[name][i] - ref).abs().max().item()
            tol = rel * max(1.0, ref.abs().max().item())
            check(err <= tol, f"restricted {name} {what} vs K1: {err} > {tol}")
    print("restricted operators agree with K1 (blockdense 1e-5, pallas_bf16 2e-2, "
          "blockdense_bf16 3e-2 of the scale)")

    # K1 bf16 at the chess cached-propagation shape (pallas_bf16's packing).
    Ct, flat = _chess_propagation_input(torch, data)
    prop = tk.make_operator(Ct, chunk=512, window=256, gather_dtype="bfloat16",
                            sort_cols=True).to(dev)
    p = prop.packed
    g = tk.gather_chunks(flat.to(bf16), p)
    nnz_prop = int((p.vals != 0).sum())
    max_err = max(max_err, _check_same(torch, k1_run(p, g), k1p_run(p, g),
                                       "K1 bf16 chess cached propagation"))
    S = _packing_csr(torch, p, flat.shape[0])
    f32_in = flat.to(bf16).float()
    print(f"K1 bf16 chess cached propagation: J={p.n_chunks} C={p.chunk} W={p.window} F=2 "
          f"nnz={nnz_prop}")
    prop_timing = _report(torch, "K1 bf16 chess cached propagation", k1_run(p, g), k1p_run(p, g),
                          lambda: torch.sparse.mm(S, f32_in), _bound(p, 2, nnz_prop, False, 2))
    print(f"K1 bf16 max abs err over every check: {max_err:.3e}")
    del prop, p, g, S, f32_in, flat
    k1_bf16 = {
        "name": "windowed_segment_matmul_bf16",
        "route": "cuda",
        "source": SOURCE,
        "replaces": K1_REPLACES,
        "max_abs_err": max_err,
        **timings[("bf16", "forward")],
        "shape": f"chess_tmgcn2_cls restricted train forward, F=6 ({shape})",
        "restricted_backward": timings[("bf16", "backward")],
        "cached_propagation": prop_timing,
    }
    restricted = {
        "shape": shape,
        "k1_f32_forward": timings[("f32", "forward")],
        "k1_f32_backward": timings[("f32", "backward")],
        "operators": comparison,
    }
    return k1_bf16, restricted


def _host_stream(np, p):
    """A K1 packing's real (global row, column) ids on the host."""
    rows = (p.window_id.long()[:, None] * p.window + p.rows.long()).cpu().numpy().ravel()
    cols = p.cols.cpu().numpy().ravel()
    keep = (p.vals != 0).cpu().numpy().ravel()
    return rows[keep], cols[keep]


def _tiled_stream(np, seed: int, n_out: int):
    """Row-sorted entries, every (row, col) pair twice, columns crowded into
    few tiles, a third of the windows empty."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_out, 30_000)
    rows = rows[(rows // 256) % 3 != 1]
    cols = rng.integers(0, 4_000, rows.size)
    order = np.argsort(np.r_[rows, rows], kind="stable")
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return np.r_[rows, rows][order], np.r_[cols, cols][order], np.r_[vals, vals][order]


def _tiled_bound(torch, p, F: int, itemsize: int) -> tuple[float, str, int, int]:
    """The least time for K3's function on these inputs: each real entry's
    row id, tile index and value (12 bytes), the F features of each distinct
    row of the tile blocks that a real entry reads (the other rows of a tile
    do not change the sums), the window offsets, and the float32 output
    (every window), once."""
    real = p.vals != 0
    n_real = int(real.sum())
    block_row = torch.arange(p.n_chunks, device=p.uidx.device)[:, None] * (8 * p.ut_cap) + p.uidx
    n_rows_read = torch.unique(block_row[real]).numel()
    nbytes = 12 * n_real + itemsize * F * n_rows_read + 4 * (p.window_ptr.numel() + p.n_rows_out * F)
    return (*_bound_ms(nbytes, 2 * n_real * F), nbytes, 2 * n_real * F)


def _tiled_csr(torch, p):
    """The (n_rows_out, J * ut_cap * 8) CSR matrix from each real entry to
    its row of the gathered tile blocks: torch.sparse.mm of it and the
    blocks computes K3's sums (a yardstick; the port never calls it)."""
    J, C = p.rows.shape
    U8 = 8 * p.ut_cap
    out_row = (p.window_id.long()[:, None] * p.window + p.rows.long()).reshape(-1)
    block_row = (torch.arange(J, device=p.rows.device)[:, None] * U8 + p.uidx.long()).reshape(-1)
    keep = (p.vals != 0).reshape(-1)
    return torch.sparse_coo_tensor(
        torch.stack([out_row[keep], block_row[keep]]), p.vals.reshape(-1)[keep],
        (p.n_rows_out, J * U8),
    ).coalesce().to_sparse_csr()


def phase_k3(torch, np) -> tuple[dict, dict]:
    from tmgcn_torch.kernels import spmm_cuda as tk

    dev = torch.device(DEVICE)
    k3, k3p = tk.windowed_tiled_segment_matmul, tk.windowed_tiled_segment_matmul_reference
    f32, bf16 = torch.float32, torch.bfloat16
    max_err = {f32: 0.0, bf16: 0.0}
    for F, ut_cap in ((2, 4), (6, 64), (128, 8)):
        rows, cols, vals = _tiled_stream(np, F, 20_000)
        p = tk.pack_windowed_tiled_flat(rows, cols, vals, 20_000, 512, 256, ut_cap,
                                        all_windows=F == 2).to(dev)
        for dtype in (f32, bf16):
            g = torch.randn(p.n_chunks, 8 * ut_cap, F, device=dev).to(dtype)
            max_err[dtype] = max(max_err[dtype], _check_same(
                torch, lambda p=p, g=g: k3(p, g, out_dtype=f32),
                lambda p=p, g=g: k3p(p, g, out_dtype=f32), f"K3 {dtype} F={F} ut_cap={ut_cap}"))
    print(f"K3 random tiled packings: ok (max abs err f32 {max_err[f32]:.3e}, "
          f"bf16 {max_err[bf16]:.3e})")

    # The chess train window's tiled packing (pallas_tiled's), F = 2.
    data, _ = _chess2()
    Ct, flat = _chess_propagation_input(torch, data)
    T, N = Ct.n_slices, Ct.n_nodes
    t0 = time.perf_counter()
    op = tk.make_operator(Ct, chunk=512, window=256, tile_dedup=True)
    t_pack = time.perf_counter() - t0
    op = op.to(dev)
    p = op.packed
    real = p.vals != 0
    n_tiles = int(torch.where(real, p.uidx // 8 + 1, 0).amax(dim=1).sum())
    shape = (f"chess train window tiled, F=2: {p.n_chunks} chunks of {p.chunk} "
             f"(ut_cap {p.ut_cap}), {int(real.sum())} entries, {n_tiles / p.n_chunks:.2f} "
             f"distinct tiles per chunk")
    print(f"{shape}; packed (both directions) in {t_pack:.3f} s")
    entries = {}
    for tier, dtype in (("f32", f32), ("bf16", bf16)):
        tier_op = dataclasses.replace(op, gather_dtype="bfloat16" if tier == "bf16" else None)
        g = tk.gather_chunks(flat.to(dtype), p)
        what = f"K3 {tier} chess train window"
        max_err[dtype] = max(max_err[dtype], _check_same(
            torch, lambda g=g: k3(p, g, out_dtype=f32), lambda g=g: k3p(p, g, out_dtype=f32), what))
        # The operator's backward: K3 over the transposed tiled packing.
        X = flat.reshape(T, N, 2).clone().requires_grad_(True)
        G = torch.randn(X.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(7))
        (tier_op(X) * G).sum().backward()
        pt = op.packed_t
        ref = k3p(pt, tk.gather_chunks(G.reshape(T * N, 2).to(dtype), pt), out_dtype=f32)[: T * N]
        err, tol = _max_err(X.grad.reshape(T * N, 2), ref)
        check(err <= tol, f"K3 {tier} chess operator backward: {err} > {tol}")
        max_err[dtype] = max(max_err[dtype], err)
        S = _tiled_csr(torch, p)
        g32 = g.float().reshape(-1, 2)
        lib_out = torch.sparse.mm(S, g32)
        err, tol = _max_err(k3(p, g, out_dtype=f32), lib_out)
        # The library sums unrounded float32 products: bf16 differs there.
        check(tier == "bf16" or err <= tol, f"{what} vs torch.sparse.mm: {err} > {tol}")
        entries[tier] = {
            "name": "windowed_tiled_segment_matmul" + ("_bf16" if tier == "bf16" else ""),
            "route": "cuda",
            "source": K3_SOURCE,
            "replaces": K3_REPLACES,
            "max_abs_err": max_err[dtype],
            **_report(torch, what, lambda g=g: k3(p, g, out_dtype=f32),
                      lambda g=g: k3p(p, g, out_dtype=f32),
                      lambda S=S, g32=g32: torch.sparse.mm(S, g32),
                      _tiled_bound(torch, p, 2, 2 if tier == "bf16" else 4)),
            "shape": shape,
        }
        del S, g32, lib_out, X, G
    print(f"K3 max abs err over every check: f32 {max_err[f32]:.3e}, bf16 {max_err[bf16]:.3e}")
    torch.cuda.empty_cache()
    return entries["f32"], entries["bf16"]


def _plain_operator(tk, p, flat, fast: bool):
    """The plain version of a K1/K3 operator's sums over packing p, on flat's device."""
    g = tk.gather_chunks(flat, p)
    if isinstance(p, tk.PackedTiled):
        return tk.windowed_tiled_segment_matmul_reference(p, g, flat.dtype, fast)
    return tk.windowed_segment_matmul_reference(p, g, flat.dtype, fast=fast)


def _bench_tags() -> list[str]:
    """The records of tmgcn_tpu/utils/spmm_bench.py for one case (neither
    --quick nor --fwd-only), in its order."""
    tags = ["gather_only", "jnp_flat"]
    tags += [f"rowsplit_k{k}{s}" for k in (8, 16, 32, 64) for s in ("", "_fwdbwd")]
    tags += ["pallas_c256_w256", "pallas_c256_w256_fwdbwd", "pallas_c256_w256_fast"]
    tags += [f"pallas_c{c}_w{w}{s}" for c, w in ((512, 256), (1024, 256), (512, 512), (1024, 512))
             for s in ("", "_fast")]
    return tags


def phase_fast(torch, np, tk) -> tuple[dict, dict, dict, dict]:
    """K1's and K3's fast tiers: against their plain versions on the card,
    K3 fast as K3 bf16 on bf16-cast blocks, the operators' backward; the
    spmm_bench path (counted), then both K1 tiers on each of its packings
    against their plain versions; both K1 tiers, K3 fast and K3 f32 timed
    at spmm_bench's two workloads beside their bounds and torch.sparse.mm."""
    from tmgcn_torch.core.sparse import TemporalCOO
    from tmgcn_torch.utils import profile_slice, spmm_bench

    dev = torch.device(DEVICE)
    k1, k1p = tk.windowed_segment_matmul, tk.windowed_segment_matmul_reference
    k3, k3p = tk.windowed_tiled_segment_matmul, tk.windowed_tiled_segment_matmul_reference
    f32, bf16 = torch.float32, torch.bfloat16
    err = {"k1": 0.0, "k3": 0.0}
    for F in (2, 6, 128):
        for use_init in (False, True):
            rows, cols, vals = _random_stream(np, 300 + F, 20_000)
            p = tk.pack_windowed_flat(
                rows, cols, vals, 20_000, sort_cols=True, all_windows=not use_init
            ).to(dev)
            g = torch.randn(p.n_chunks, p.chunk, F, device=dev)

            def init_fn(p=p, F=F, use_init=use_init):
                return torch.zeros(p.n_rows_out, F, device=dev) if use_init else None

            what = f"K1 fast F={F} init={use_init}"
            err["k1"] = max(err["k1"], _check_same(
                torch, lambda p=p, g=g, i=init_fn: k1(p, g, f32, i(), fast=True),
                lambda p=p, g=g, i=init_fn: k1p(p, g, f32, i(), fast=True), what))
            check(not torch.equal(k1(p, g, f32, init_fn(), fast=True), k1(p, g, f32, init_fn())),
                  f"{what} gave the float32 tier's sums")
    for F, ut_cap in ((2, 4), (6, 64), (128, 8)):
        rows, cols, vals = _tiled_stream(np, 300 + F, 20_000)
        p = tk.pack_windowed_tiled_flat(rows, cols, vals, 20_000, 512, 256, ut_cap,
                                        all_windows=F == 2).to(dev)
        g = torch.randn(p.n_chunks, 8 * ut_cap, F, device=dev)
        what = f"K3 fast F={F} ut_cap={ut_cap}"
        err["k3"] = max(err["k3"], _check_same(
            torch, lambda p=p, g=g: k3(p, g, f32, fast=True),
            lambda p=p, g=g: k3p(p, g, f32, fast=True), what))
        check(torch.equal(k3(p, g, f32, fast=True), k3(p, g.to(bf16), f32)),
              f"{what} is not K3 bf16 on the blocks cast to bf16")
    print(f"fast tiers, random packings: ok, K3 fast bitwise K3 bf16 on bf16-cast blocks "
          f"(max abs err K1 {err['k1']:.3e}, K3 {err['k3']:.3e})")

    # The operators' autograd backward (the kernel on the transposed packing).
    rng = np.random.default_rng(9)
    dense = (rng.random((4, 300, 300)) < 0.05) * rng.random((4, 300, 300))
    for kernel, kwargs in (("k1", {}), ("k3", {"tile_dedup": True, "chunk": 512})):
        op = tk.make_operator(TemporalCOO.from_dense(dense), fast=True, **kwargs).to(dev)
        X = torch.randn(4, 300, 6, device=dev)
        G = torch.randn(4, 300, 6, device=dev)
        grads = []
        for _ in range(2):
            Xg = X.clone().requires_grad_(True)
            out = op(Xg)
            (out * G).sum().backward()
            grads.append(Xg.grad)
        torch.cuda.synchronize()
        check(torch.equal(*grads), f"{kernel} fast operator: two backward passes differ")
        for what, got, ref in (
            ("forward", out.reshape(-1, 6), _plain_operator(tk, op.packed, X.reshape(-1, 6), True)),
            ("backward", grads[0].reshape(-1, 6),
             _plain_operator(tk, op.packed_t, G.reshape(-1, 6), True)),
        ):
            e, tol = _max_err(got, ref[: got.shape[0]])
            check(e <= tol, f"{kernel} fast operator {what}: max abs err {e} > {tol}")
            err[kernel] = max(err[kernel], e)
    print("fast operators (K1, K3): forward and backward ok, backward bitwise repeatable")

    # The spmm_bench path, every record of the JAX script's --case all.
    t0 = time.perf_counter()
    records, launches = _counted(tk, lambda: spmm_bench.main(["--case", "all"]))
    t_bench = time.perf_counter() - t0
    names = [name for name, _ in spmm_bench.CASES.values()]
    check([(r["case"], r["impl"]) for r in records] == [(n, t) for n in names for t in _bench_tags()],
          f"spmm_bench records {[(r['case'], r['impl']) for r in records]}")
    check(all("error" not in r and r["ms"] > 0 for r in records), "spmm_bench: an error record")
    # Each record calls its function once warm and 20 times timed; per case 5
    # float32 forwards and one forward + backward, and 5 fast forwards.
    calls = 21 * len(names)
    expected = (7 * calls, 0, 0, 0, 0, 5 * calls, 0)
    check(launches == expected, f"spmm_bench --case all: {COUNTED} launched {launches} times, "
          f"expected {expected}")
    print(f"spmm_bench --case all (in process): {len(records)} records in {t_bench:.3f} s, "
          f"{COUNTED} launches {launches}")

    # At spmm_bench's two workloads, every packing of its path: K1 f32 and
    # fast against their plain versions, and the pallas_c256_w256_fwdbwd
    # record's backward (K1 on the transposed packing). Then K1 f32 and fast
    # timed on the c256_w256 packing's forward chunks, and at r1 K3 fast and
    # K3 f32 on the tiled packing.
    timings, counts = {}, {"spmm_bench --case all": launches}
    for case, (name, shape) in spmm_bench.CASES.items():
        A, X = spmm_bench.make_workload(**shape)
        F = shape["F"]
        flat = X.reshape(-1, F).to(dev)
        nnz = int(A.nnz.sum())
        for chunk, window in spmm_bench.PALLAS_CONFIGS:
            t0 = time.perf_counter()
            op = tk.make_operator(A, chunk=chunk, window=window).to(dev)
            p = op.packed
            g = tk.gather_chunks(flat, p)
            print(f"{name} c{chunk}_w{window}: K1 packing (both directions) and gather "
                  f"{time.perf_counter() - t0:.3f} s; J={p.n_chunks} C={p.chunk} W={p.window} "
                  f"F={F} nnz={nnz} n_rows_out={p.n_rows_out}")
            for tier, fast in (("f32", False), ("fast", True)):
                err["k1"] = max(err["k1"], _check_same(
                    torch, lambda p=p, g=g, fast=fast: k1(p, g, fast=fast),
                    lambda p=p, g=g, fast=fast: k1p(p, g, fast=fast),
                    f"K1 {tier} {name} c{chunk}_w{window}"))
            if (chunk, window) != spmm_bench.PALLAS_CONFIGS[0]:
                del op, p, g
                continue
            err["k1"] = max(err["k1"], _check_operator_backward(
                torch, tk, op, X.to(dev), f"{name} c{chunk}_w{window} operator"))
            keep = op
        op, p = keep, keep.packed
        g = tk.gather_chunks(flat, p)
        S = _slot_csr(torch, p, p.vals != 0)
        g_flat = g.reshape(-1, F)
        e, tol = _max_err(k1(p, g), torch.sparse.mm(S, g_flat))
        check(e <= tol, f"K1 vs torch.sparse.mm at {name}: {e} > {tol}")
        timings[case] = {}
        for tier, fast in (("f32", False), ("fast", True)):
            timings[case][tier] = _report(
                torch, f"K1 {tier} {name}", lambda fast=fast: k1(p, g, fast=fast),
                lambda fast=fast: k1p(p, g, fast=fast), lambda: torch.sparse.mm(S, g_flat),
                _bound(p, F, nnz, False))
        # Where the record's time goes: its call, o(x).sum(), 20 times traced.
        Xd = X.to(dev)
        traced, _ = profile_slice.trace(lambda: [op(Xd).sum() for _ in range(20)], 20, top=6)
        timings[case]["record_trace"] = traced
        print(f"{name} pallas_c256_w256 record's call, 20 traced: device "
              f"{traced['device_ms_per_profiled_epoch']:.6f} ms a call, busy share "
              f"{traced['device_busy_share']:.4f}, wall {traced['profiled_wall_ms'] / 20:.6f} ms a "
              f"call, {traced['launch_calls_per_profiled_epoch']:.1f} launch calls a call; device "
              f"ms by kernel over the 20 {json.dumps(traced['device_ms_by_kernel'])}")
        del op, keep, p, g, S, g_flat, Xd
        if case == "r1":
            # The tiled fast operator, forward and backward: K3 fast's path.
            t0 = time.perf_counter()
            op = tk.make_operator(A, chunk=512, window=256, tile_dedup=True, fast=True).to(dev)
            t_pack = time.perf_counter() - t0
            Xg = X.to(dev).requires_grad_(True)
            G = torch.randn(X.shape, device=dev)

            def fwd_bwd(op=op, Xg=Xg, G=G):
                (op(Xg) * G).sum().backward()
                return Xg.grad

            dX, tiled_launches = _counted(tk, fwd_bwd)
            counts["r1 tiled fast operator (forward + backward)"] = tiled_launches
            check(tiled_launches == (0, 0, 0, 0, 0, 0, 2),
                  f"r1 tiled fast operator: {COUNTED} launched {tiled_launches}, expected one "
                  f"K3 fast launch each way")
            e, tol = _max_err(dX.reshape(-1, F), _plain_operator(tk, op.packed_t, G.reshape(-1, F),
                                                                  True)[: flat.shape[0]])
            check(e <= tol, f"r1 tiled fast operator backward: {e} > {tol}")
            p = op.packed
            real = p.vals != 0
            n_tiles = int(torch.where(real, p.uidx // 8 + 1, 0).amax(dim=1).sum())
            shape_k3 = (f"{name} tiled, F={F}: {p.n_chunks} chunks of {p.chunk} (ut_cap "
                        f"{p.ut_cap}), {int(real.sum())} entries, {n_tiles / p.n_chunks:.2f} "
                        f"distinct tiles per chunk")
            print(f"{shape_k3}; packed (both directions) in {t_pack:.3f} s")
            g = tk.gather_chunks(flat, p)
            err["k3"] = max(err["k3"], _check_same(
                torch, lambda: k3(p, g, fast=True), lambda: k3p(p, g, fast=True), f"K3 fast {name}"))
            check(torch.equal(k3(p, g, fast=True), k3(p, g.to(bf16), f32)),
                  f"K3 fast at {name} is not K3 bf16 on the blocks cast to bf16")
            S = _tiled_csr(torch, p)
            g32 = g.reshape(-1, F)
            timings[case]["k3_fast"] = _report(
                torch, f"K3 fast {name}", lambda: k3(p, g, fast=True), lambda: k3p(p, g, fast=True),
                lambda: torch.sparse.mm(S, g32), _tiled_bound(torch, p, F, 4))
            timings[case]["k3_fast"]["shape"] = shape_k3
            # K3 f32 on the same packing and blocks, beside K3 fast.
            err["k3_f32"] = _check_same(
                torch, lambda: k3(p, g), lambda: k3p(p, g), f"K3 f32 {name}")
            timings[case]["k3_f32"] = _report(
                torch, f"K3 f32 {name}", lambda: k3(p, g), lambda: k3p(p, g),
                lambda: torch.sparse.mm(S, g32), _tiled_bound(torch, p, F, 4))
            del op, p, g, S, g32, Xg, G, dX
        torch.cuda.empty_cache()
    print(f"fast tiers, max abs err over every check: K1 {err['k1']:.3e}, K3 {err['k3']:.3e}")
    shapes = {case: f"spmm_bench {name} c256_w256 forward, F={shape['F']}"
              for case, (name, shape) in spmm_bench.CASES.items()}
    k1_fast = {
        "name": "windowed_segment_matmul_fast",
        "route": "cuda",
        "source": SOURCE,
        "replaces": K1_REPLACES,
        "max_abs_err": err["k1"],
        **timings["r1"]["fast"],
        "shape": shapes["r1"],
        "spmm_bench_chess2": {**timings["chess2"]["fast"], "shape": shapes["chess2"]},
    }
    k3_fast = {
        "name": "windowed_tiled_segment_matmul_fast",
        "route": "cuda",
        "source": K3_SOURCE,
        "replaces": K3_REPLACES,
        "max_abs_err": err["k3"],
        **timings["r1"]["k3_fast"],
        "k3_f32_same_packing": {**timings["r1"]["k3_f32"], "max_abs_err": err["k3_f32"]},
    }
    k1_f32 = {f"spmm_bench_{case}": {**timings[case]["f32"], "shape": shapes[case],
                                     "record_trace": timings[case]["record_trace"]}
              for case in spmm_bench.CASES}
    return k1_fast, k3_fast, k1_f32, counts


def _scan_grads(torch, fn, p, h0, c0, Yt, G) -> list:
    """The scan's output and the gradients of Y and every gate's W, U, b."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    Y = Yt.clone().requires_grad_(True)
    out = fn(leaves, h0, c0, Y)
    (out * G).sum().backward()
    return [out.detach(), Y.grad, *(leaves[k].grad for k in sorted(leaves))]


def phase_lstm_scan(torch) -> dict:
    """WD-GCN's LSTM scan kernel pair at the chess shape against its plain
    version, the eager scan on the card, on the inputs the main path gives
    it: Y the GCN layer's (T, F, N) view of (F, T, N) memory, dZ the
    readout's transposed gradient. Timed beside the eager scan."""
    from tmgcn_torch.kernels import scan_cuda
    from tmgcn_torch.models import wdgcn as twd

    T, F, N = 80, 6, 7301
    dev = torch.device(DEVICE)
    p, bufs = twd._init_lstm(torch.Generator().manual_seed(0), F, torch.float32)
    p = {k: v.to(dev) for k, v in p.items()}
    h0, c0 = bufs["h_init"].to(dev), bufs["c_init"].to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    Yt = torch.relu(torch.randn(F, T, N, device=dev, generator=gen)).transpose(0, 1)
    G = torch.randn(T, N, F, device=dev, generator=gen)
    dZ = G.transpose(1, 2)  # the gradient of lstm_scan_t's (T, N, F) output, as it arrives
    check(not Yt.is_contiguous() and not dZ.is_contiguous(),
          "LSTM scan: Y and dZ are expected to be strided views")
    got = _scan_grads(torch, twd.lstm_scan_t, p, h0, c0, Yt, G)
    again = _scan_grads(torch, twd.lstm_scan_t, p, h0, c0, Yt, G)
    check(all(torch.equal(a, b) for a, b in zip(got, again)), "LSTM scan: two runs differ")
    max_err = 0.0
    with mock.patch.object(twd, "_on_kernel", lambda *a: False):
        for remat in (False, True):
            plain = functools.partial(twd.lstm_scan_t, remat=remat)
            want = _scan_grads(torch, plain, p, h0, c0, Yt, G)
            torch.cuda.synchronize()
            for name, a, b in zip(["Z", "dY", *sorted(p)], got, want):
                err, tol = _max_err(a, b)
                check(err <= tol, f"LSTM scan {name} (eager remat={remat}): max abs err "
                                  f"{err} > {tol}")
                max_err = max(max_err, err)
    print(f"LSTM scan at T={T} F={F} N={N}, Y a view of (F, T, N) memory and dZ a transpose: "
          f"Z and the gradients of Y and each gate's W, U, b within {ATOL} * max(1, |ref|) of "
          f"the eager scan (hoisted and remat), max abs err {max_err:.3e}; two runs bitwise equal")

    weights = twd._stacked_weights(p, torch.float32)

    def kernels():  # the forward that keeps C, the backward and its reduction
        Z, C = scan_cuda._forward(Yt, *weights, h0, c0, cells=True)
        scan_cuda._backward(Yt, *weights, h0, c0, Z, C, dZ)

    ms = _time_ms(torch, kernels)
    with torch.no_grad():
        eval_ms = _time_ms(torch, lambda: scan_cuda.lstm_scan_cuda(Yt, *weights, h0, c0))
    with mock.patch.object(twd, "_on_kernel", lambda *a: False):
        plain_ms = _time_ms(torch, lambda: _scan_grads(torch, twd.lstm_scan_t, p, h0, c0, Yt, G))
    # Each (T, F, N) tensor crosses device memory once: the forward reads Y
    # and writes Z and C, the backward reads Y, Z, C, dZ and writes dY.
    # Operations: the forward's two F x 4F dots a node-step; the backward
    # recomputes them and adds dY, dh and the dW, dU sums.
    plane = 4 * T * F * N
    nbytes, flops = 8 * plane, 4 * 2 * (2 * F * 4 * F) * T * N
    bound_ms, bound_by = _bound_ms(nbytes, flops)
    fwd_bound_ms, _ = _bound_ms(2 * plane, 2 * (2 * F * 4 * F) * T * N)
    print(f"LSTM scan forward + backward: kernels ms (median, CUDA events, L2 flushed) {ms:.6f}, "
          f"plain version (the eager scan of wdgcn.py, hoisted, with autograd) {plain_ms:.6f}, "
          f"bound {bound_ms:.6f} ({bound_by}: {nbytes} bytes, {flops} operations)")
    print(f"LSTM scan forward alone (no gradient, no cell states): {eval_ms:.6f} ms, bound "
          f"{fwd_bound_ms:.6f}")
    return {"name": "LSTM scan forward + backward + reduction", "route": "cuda",
            "source": "tmgcn_torch/kernels/csrc/lstm_scan.cu",
            "replaces": "none (lax.scan in tmgcn_tpu/models/wdgcn.py)",
            "shape": f"T={T} F={F} N={N}", "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "forward_ms": eval_ms}


def _check_rows(np, res, what: str) -> None:
    check(res.shape[1] == 12, f"{what}: results are not (epochs, 12)")
    check(bool(np.all(np.isfinite(res[:, [3, 7, 11]]))), f"{what}: a loss is not finite")
    for col in (2, 6, 10):  # train / val / test F1
        f1, prec, rec = res[:, col], res[:, col - 2], res[:, col - 1]
        finite = np.isfinite(f1)
        check(bool(np.all((f1[finite] >= 0) & (f1[finite] <= 1))), f"{what}: F1 outside [0, 1]")
        # F1 is undefined (NaN) exactly when no class-0 edge is found
        # (tp = 0): then precision and recall are 0 or undefined.
        undefined = ~finite
        check(bool(np.all(~(prec[undefined] > 0) & ~(rec[undefined] > 0))),
              f"{what}: F1 NaN with a true positive")


def _check_lp_rows(np, res, what: str) -> None:
    """(epochs, 9) MAP-MRR rows: losses finite, MAP and MRR in [0, 1] or NaN
    (NaN where a window slice keeps no row with a fake edge)."""
    check(res.shape[1] == 9, f"{what}: results are not (epochs, 9)")
    check(bool(np.all(np.isfinite(res[:, [2, 5, 8]]))), f"{what}: a loss is not finite")
    rates = res[:, [0, 1, 3, 4, 6, 7]]
    check(bool(np.all(np.isnan(rates) | ((rates >= 0) & (rates <= 1)))),
          f"{what}: MAP or MRR outside [0, 1]")


class Launches(tuple):
    """One path's launch counts in COUNTERS order, equal to the plain tuple
    of them; ``.scan`` holds its LSTM scan launches (SCAN_COUNTERS order)."""

    scan = (0, 0, 0)


# The LSTM scan pair's counters on scan_cuda.lstm_scan_cuda: the forward,
# the backward scan and the backward's reduction.
SCAN_COUNTERS = ("launches", "launches_backward", "launches_reduce")


def _counted(tk, fn):
    """Run fn with every launch count set to 0, the LSTM scan's too;
    (result, the counts in COUNTERS order: K1, K1 bf16, K2, K3, K3 bf16,
    K1 fast, K3 fast, as a Launches whose ``.scan`` is the scan's)."""
    from tmgcn_torch.kernels.scan_cuda import lstm_scan_cuda as scan

    for fn_name, counter in COUNTERS:
        setattr(getattr(tk, fn_name), counter, 0)
    for counter in SCAN_COUNTERS:
        setattr(scan, counter, 0)
    out = fn()
    launches = Launches(getattr(getattr(tk, fn_name), counter) for fn_name, counter in COUNTERS)
    launches.scan = tuple(getattr(scan, counter) for counter in SCAN_COUNTERS)
    return out, launches


@contextlib.contextmanager
def _eager_loop():
    """The training loop's eager chunks in place of the captured ones: the
    reference the captured loop is held to on the card."""
    from tmgcn_torch.train import loop

    with mock.patch.object(loop, "_chunks", loop._EagerChunks):
        yield


@contextlib.contextmanager
def _recorded_evals(logits: list):
    """The training loop with the logits of its evaluation forwards (val,
    then test, at each evaluation epoch) appended to ``logits`` as numpy."""
    from tmgcn_torch.train import loop

    train_chunks = loop.train_chunks

    def recording(*args, **kwargs):
        chunks, eval_forward, variables = train_chunks(*args, **kwargs)

        def recorded(window, carry):
            out, carry = eval_forward(window, carry)
            logits.append(out.cpu().numpy())
            return out, carry

        return chunks, recorded, variables

    with mock.patch.object(loop, "train_chunks", recording):
        yield


def _f1_range(np, logits, target, rel: float = 1e-5) -> list:
    """Class-0 F1 with every tied edge predicted right and every one wrong.
    An edge is tied when its class-0 logit is within ``rel`` (of the logits'
    scale) of the best other class: its prediction is float rounding."""
    from tmgcn_torch.tasks.metrics import precision_recall_f1

    other = np.max(logits[:, 1:], axis=1)
    tied = np.abs(logits[:, 0] - other) <= rel * max(1.0, float(np.abs(logits).max()))
    guess = np.argmax(logits, axis=1)
    return [precision_recall_f1(np.where(tied, np.where(target == 0, a, b), guess), target)[2]
            for a, b in ((0, 1), (1, 0))]


def _check_eval_f1_in_tie_range(np, cfg, got, ref_res, ref_logits, name: str,
                                ref: str = "the CPU plain path", data_dir=DATA_DIR) -> None:
    """Val and test F1 of the card's first epochs against the range the
    reference run's (the CPU's) evaluation logits allow once their tied
    edges go either way (1e-3 beyond it); train F1 within 1e-3 of the
    reference's."""
    from tmgcn_torch.configs.build import build_data
    from tmgcn_torch.tasks.windows import split_edges_classification

    data = build_data(cfg, data_dir=data_dir)
    splits = split_edges_classification(data.edge_index, data.edge_values, data.spec,
                                        n_classes=cfg.n_classes)
    same_nan = np.isnan(got[:, 2]) == np.isnan(ref_res[:, 2])
    close = np.nan_to_num(np.abs(got[:, 2] - ref_res[:, 2]), nan=0.0) <= 1e-3
    check(bool(np.all(same_nan & close)), f"{name}: train F1 differs from {ref}")
    n_tied = []
    for ep in range(got.shape[0]):
        i = ep // cfg.eval_every  # the evaluation whose rows epoch ep carries
        for j, (w, col) in enumerate((("val", 6), ("test", 10))):
            s = splits[w]
            logits = ref_logits[2 * i + j][s.eval_mask]
            lo, hi = _f1_range(np, logits, s.target[s.eval_mask])
            finite = [v for v in (lo, hi) if not np.isnan(v)]
            v = got[ep, col]
            ok = (np.isnan(v) and len(finite) < 2) or (
                bool(finite) and min(finite) - 1e-3 <= v <= max(finite) + 1e-3)
            check(ok, f"{name}: {w} F1 {v} at epoch {ep} outside the tie range of {ref}'s "
                      f"logits [{lo}, {hi}]")
            n_tied.append(int(np.sum(np.abs(logits[:, 0] - np.max(logits[:, 1:], axis=1))
                                     <= 1e-5 * max(1.0, float(np.abs(logits).max())))))
    print(f"{name}: val/test F1 within the tie range of {ref}'s logits (tied edges by "
          f"evaluation window: {n_tied[:2]})")


def _run_slice(torch, np, tk, cfg, e_train: int, expected: tuple, epochs: int = EPOCHS,
               warm: bool = True, rtol: float = 1e-4, vs_eager: bool = False,
               f1_ties: bool = False, name: str | None = None, rows: list | None = None) -> tuple:
    """Epochs on cuda (counted), a warm rerun, with ``vs_eager`` the same
    run through the loop's eager chunks (rows bitwise equal, the same
    launches), 5 epochs against the CPU. ``f1_ties``: the model's logits
    can tie exactly in exact arithmetic (EvolveGCN's saturated GRU
    weights cancel), so val and test F1 are held to the range the CPU
    run's evaluation logits allow (``_check_eval_f1_in_tie_range``).
    ``rows``: the counted run's rows are appended to it."""
    from tmgcn_torch.configs.build import run_experiment

    name = name or f"{cfg.name} ({cfg.spmm_impl})"
    out, launches = _counted(tk, lambda: run_experiment(
        cfg, data_dir=DATA_DIR, n_epochs=epochs, verbose=False, device=DEVICE))
    check(launches == expected,
          f"{name}: {COUNTED} launched {launches} times on the main path, expected {expected}")
    (res,) = out["results"].values()
    if rows is not None:
        rows.append(res)
    lp = cfg.task == "link_pred"
    width = 9 if lp else 12
    check(res.shape == (epochs, width), f"{name}: results shape {res.shape}")
    (_check_lp_rows if lp else _check_rows)(np, res, f"{name} cuda run")
    sec = out["seconds"]
    print(f"slice {name} cuda, first run: {epochs} epochs, {COUNTED} launches {launches}; "
          f"data {sec['data']:.3f} s (0 once the variant is loaded), adapter "
          f"{sec['adapter']:.3f} s, "
          f"train {sec['train']:.3f} s ({1e3 * sec['train'] / epochs:.6f} ms/epoch with the "
          f"process's first launches)")
    if lp:
        print(f"slice {name} final row: train MAP {res[-1, 0]:.4f} MRR {res[-1, 1]:.6f} loss "
              f"{res[-1, 2]:.6f} | val MAP {res[-1, 3]:.4f} MRR {res[-1, 4]:.6f} | test MAP "
              f"{res[-1, 6]:.4f} MRR {res[-1, 7]:.6f}")
    else:
        print(f"slice {name} final row: train f1 {res[-1, 2]:.4f} loss {res[-1, 3]:.6f} | "
              f"val f1 {res[-1, 6]:.4f} | test f1 {res[-1, 10]:.4f}")
    if warm:
        # The same run again, warm: the steady-state epoch time.
        again = run_experiment(cfg, data_dir=DATA_DIR, n_epochs=epochs, verbose=False,
                               device=DEVICE)
        (warm_res,) = again["results"].values()
        check(np.array_equal(warm_res, res, equal_nan=True),
              f"{name}: a repeated run gave other rows")
        t_warm = again["seconds"]["train"]
        print(f"slice {name} warm run: {1e3 * t_warm / epochs:.6f} ms/epoch, "
              f"{e_train * epochs / t_warm:.1f} {'training' if lp else 'labelled'} edges/s "
              f"({e_train} training edges, {epochs} epochs, "
              f"{-(-epochs // cfg.eval_every)} evaluation epochs)")
    if vs_eager:
        # The same run with every step issued from Python: the captured
        # loop replays exactly what the eager one runs.
        with _eager_loop():
            eager, eager_launches = _counted(tk, lambda: run_experiment(
                cfg, data_dir=DATA_DIR, n_epochs=epochs, verbose=False, device=DEVICE))
        (eager_res,) = eager["results"].values()
        check(np.array_equal(eager_res, res, equal_nan=True),
              f"{name}: the captured loop's rows differ from the eager loop's: max abs diff "
              f"{np.nanmax(np.abs(eager_res - res))}")
        check(eager_launches == launches,
              f"{name}: the eager loop launched {eager_launches}, the captured {launches}")
        print(f"slice {name} captured vs eager loop, {epochs} epochs: rows bitwise equal, "
              f"{COUNTED} launches {eager_launches} in both; eager train "
              f"{1e3 * eager['seconds']['train'] / epochs:.6f} ms/epoch")

    # Reference: the same run on the CPU's plain path, first epochs.
    ref_logits = []
    with _recorded_evals(ref_logits):
        ref = run_experiment(cfg, data_dir=DATA_DIR, n_epochs=REF_EPOCHS, verbose=False,
                             device="cpu")
    (ref_res,) = ref["results"].values()
    got = res[:REF_EPOCHS]
    losses = [2, 5, 8] if lp else [3, 7, 11]
    check(bool(np.allclose(got[:, losses], ref_res[:, losses], rtol=rtol, atol=0)),
          f"{name}: losses differ from the CPU plain path: {got[:, losses]} vs {ref_res[:, losses]}")
    if lp:
        # MAP and MRR within rtol 1e-3, NaN only where the CPU path has NaN.
        rates = [0, 1, 3, 4, 6, 7]
        same_nan = np.isnan(got[:, rates]) == np.isnan(ref_res[:, rates])
        close = np.nan_to_num(np.abs(got[:, rates] - ref_res[:, rates])
                              - 1e-3 * np.abs(ref_res[:, rates]), nan=0.0) <= 0
        check(bool(np.all(same_nan & close)),
              f"{name}: MAP/MRR differ from the CPU plain path: {got[:, rates]} vs "
              f"{ref_res[:, rates]}")
        print(f"slice {name} vs CPU plain path, {REF_EPOCHS} epochs: losses within rtol {rtol}, "
              f"MAP and MRR within rtol 1e-3")
        return launches
    if f1_ties:
        _check_eval_f1_in_tie_range(np, cfg, got, ref_res, ref_logits, name)
        print(f"slice {name} vs CPU plain path, {REF_EPOCHS} epochs: losses within rtol {rtol}")
        return launches
    f1s = [2, 6, 10]
    same_nan = np.isnan(got[:, f1s]) == np.isnan(ref_res[:, f1s])
    close = np.nan_to_num(np.abs(got[:, f1s] - ref_res[:, f1s]), nan=0.0) <= 1e-3
    check(bool(np.all(same_nan & close)), f"{name}: F1 differs from the CPU plain path")
    print(f"slice {name} vs CPU plain path, {REF_EPOCHS} epochs: losses within rtol {rtol}, "
          f"F1 within 1e-3")
    return launches


def phase_tmgcn(torch, np, tk, e_train: int) -> tuple[int, int]:
    from tmgcn_torch.configs.presets import get_preset

    cfg = dataclasses.replace(get_preset("chess_tmgcn_cls"), spmm_impl="pallas")
    return _run_slice(torch, np, tk, cfg, e_train, (3, 0, 0, 0, 0, 0, 0), vs_eager=True)


def phase_wdgcn_chess(torch, np, tk, e_train: int) -> dict[str, tuple[int, int]]:
    from tmgcn_torch import cli
    from tmgcn_torch.configs.presets import get_preset

    cfg = get_preset("chess_wdgcn_cls")
    check(cfg.spmm_impl == "jnp", "chess_wdgcn_cls is expected to name spmm_impl jnp")
    counts = {"chess_wdgcn_cls": _run_slice(torch, np, tk, cfg, e_train,
                                            (EPOCHS, 0, 0, 0, 0, 0, 0), vs_eager=True)}
    # The CLI, with the CUDA propagation: 3 more K1 launches at set-up.
    argv = ["run", "chess_wdgcn_cls", "--data-dir", DATA_DIR, "--spmm-impl", "pallas",
            "--epochs", str(EPOCHS), "--quiet"]
    t0 = time.perf_counter()
    rc, launches = _counted(tk, lambda: cli.main(argv))
    check(rc == 0, f"cli {' '.join(argv)} exited {rc}")
    expected = (EPOCHS + 3, 0, 0, 0, 0, 0, 0)
    check(launches == expected,
          f"cli run chess_wdgcn_cls --spmm-impl pallas: launched {launches} times, "
          f"expected {expected}")
    print(f"cli run chess_wdgcn_cls --spmm-impl pallas: {EPOCHS} epochs in "
          f"{time.perf_counter() - t0:.3f} s, {COUNTED} launches {launches}")
    counts["cli chess_wdgcn_cls --spmm-impl pallas"] = launches
    # The LSTM scan pair: a forward, a backward and a reduction a step, and
    # a forward for val and one for test at each evaluation epoch.
    n_evals = -(-EPOCHS // cfg.eval_every)
    scan = (EPOCHS + 2 * n_evals, EPOCHS, EPOCHS)
    for path, launches in counts.items():
        check(launches.scan == scan,
              f"{path}: LSTM scan launches (forward, backward, reduction) {launches.scan}, "
              f"expected {scan} ({EPOCHS} steps, {n_evals} evaluations)")
    print(f"chess_wdgcn_cls {EPOCHS} epochs (and the CLI's): LSTM scan launches forward "
          f"{scan[0]} ({EPOCHS} steps, {2 * n_evals} evaluation forwards), backward {scan[1]}, "
          f"reduction {scan[2]}")
    return counts


# The scale families run here: (scale_bench family, label).
SCALE_FAMILIES = (("wdgcn", "WD-GCN"), ("evolvegcn", "EvolveGCN"))


def _k2_per_step(adapter) -> tuple:
    """The WD-GCN and EvolveGCN scale steps: K2 once (the readout plan's
    lane-major backward), no K1."""
    return (0, 0, 1, 0, 0, 0, 0)


def phase_scale(torch, np, tk, fam: str, inputs, t_build: float, card: str,
                label: str | None = None, l2_stream: int | None = None,
                per_step=_k2_per_step, probe=None) -> tuple[tuple, dict]:
    """One family of the scale run on the shared inputs: the launches of
    its steps (``per_step(adapter)``: each kernel's launches in one step),
    traced warm steps, and captured against eager steps (losses bitwise,
    peak memory, times). ``l2_stream``: tmgcn2's streamed layer 2.
    ``probe(adapter)`` runs before the adapter is freed. Returns the
    launches and {"losses", "memory", "probe"}."""
    from tmgcn_torch.utils import profile_slice, scale_bench

    label = label or dict(SCALE_FAMILIES)[fam]
    key = scale_bench._NAMES[fam]
    torch.cuda.reset_peak_memory_stats()
    out, launches = _counted(
        tk, lambda: scale_bench.run_family(fam, inputs, SCALE_N_TIMED, DEVICE, l2_stream))
    counted_peak = torch.cuda.max_memory_allocated()
    steps = out["steps"]
    expected = tuple(steps * n for n in per_step(out["adapter"]))
    check(launches == expected,
          f"{label} scale: {COUNTED} launched {launches} times in {steps} steps, "
          f"expected {expected}")
    losses = out["losses"]
    check(losses.shape == (steps,) and bool(np.all(np.isfinite(losses))),
          f"{label} scale: losses not finite: {losses}")
    kernel = "K1" if fam == "tmgcn2" else "K2"
    traced = _trace_scale_steps(torch, out["run"], label, kernel)
    cut = ("for this family the cut also shrinks the per-step work: the restricted layer 2's "
           "entries are a share of the adjacency's" if fam == "tmgcn2" else
           "only the set-up depends on it")
    print(f"{label} scale ({SCALE['n_nodes']} nodes x {SCALE['n_slices']} slices, "
          f"{SCALE['n_edges']} labelled edges, nnz_per_slice {SCALE['nnz_per_slice']} — cut from "
          f"2000000 to shorten the host build; {cut}): host build "
          f"{t_build:.3f} s, adapter build {out[f'{key}_build_s']:.3f} s, first {steps // 2} steps "
          f"(warm-up step and capture included) {out[f'{key}_first_run_s']:.3f} s, "
          f"{out[f'{key}_ms_per_epoch']:.6f} ms/epoch, "
          f"{out[f'{key}_edges_per_s']:.1f} labelled edges/s; launches {launches} in "
          f"{steps} steps; peak device memory of the build and the counted steps "
          f"{counted_peak} bytes; losses {losses.tolist()} [{card}]")
    print(f"{label} scale traced warm, {traced['profiled_epochs']} captured steps (outside the "
          f"counts): device {traced['device_ms_per_profiled_epoch']:.6f} ms per step (the "
          f"profiler's kernel time; CUDA events around the steps "
          f"{traced['event_ms_per_profiled_epoch']:.6f}), busy share "
          f"{traced['device_busy_share']:.4f}, wall "
          f"{traced['profiled_wall_ms'] / traced['profiled_epochs']:.6f} ms per step, "
          f"{traced['launch_calls_per_profiled_epoch']:.1f} kernel and "
          f"{traced['graph_launches_per_profiled_epoch']:.1f} graph launch calls per step; device "
          f"ms by kernel (top 12, over the {traced['profiled_epochs']} steps) "
          f"{json.dumps(traced['device_ms_by_kernel'])}; device ms per step of {kernel} and of "
          f"the operators that launch the gathers, copies and fills (every call of each) "
          f"{json.dumps(traced['device_ms_per_step_named'])} [{card}]")

    # Captured against eager on the same adapter: the same losses, each
    # side's peak device memory (eager first, so that no graph pool is
    # held while it runs), then both timed in turns.
    adapter = out.pop("adapter")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    n = max(SCALE_N_TIMED // 4, 3)
    runs, memory = {}, {}
    for name, ctx in (("eager", _eager_loop), ("captured", contextlib.nullcontext)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with ctx():
            _, _, side_losses, runs[name] = scale_bench.timed_epochs(
                adapter, scale_bench.labelled_edges(inputs), inputs[5], n)
        torch.cuda.synchronize()
        memory[name] = {"peak_bytes": torch.cuda.max_memory_allocated(), "before_bytes": base,
                        "after_bytes": torch.cuda.memory_allocated()}
        check(np.array_equal(side_losses, losses),
              f"{label} scale: the {name} steps' losses {side_losses.tolist()} differ from the "
              f"counted run's {losses.tolist()}")
    print(f"{label} scale captured vs eager, {2 * n} steps each from the same parameters: losses "
          f"bitwise equal; peak device memory (torch.cuda.max_memory_allocated, adapter "
          f"included) {json.dumps(memory)} [{card}]")
    times = profile_slice.timed_chunks(runs, n)
    _print_times(f"{label} scale steps,", times, card, unit="step")
    del runs
    probed = probe(adapter) if probe is not None else None
    del adapter
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"losses": losses, "memory": memory, "probe": probed}


def _trace_scale_steps(torch, run, label: str, kernel: str = "K2") -> dict:
    """SCALE_TRACED_STEPS more warm scale steps, traced as profile_slice
    traces a chess epoch. ``kernel``: the name of the row walk's kernel in
    the step (K1 and K2 share ``row_segment_matmul_kernel``)."""
    from tmgcn_torch.utils import profile_slice

    losses = []
    traced, avg = profile_slice.trace(lambda: losses.append(run(SCALE_TRACED_STEPS)),
                                      SCALE_TRACED_STEPS, top=12)
    check(bool(torch.isfinite(losses[0]).all()), f"{label} scale traced steps: a loss is not finite")
    check(traced["device_ms_per_profiled_epoch"] > 0, f"{label} scale: the trace shows no device time")
    cuda = torch.autograd.DeviceType.CUDA

    def per_step(match, total) -> float:
        return sum(total(e) for e in avg if match(e)) / 1e3 / SCALE_TRACED_STEPS

    # K2 by its kernel; the readout backward's gather, permute copy and zero
    # fill by the operators that launch them, with the kernels of their
    # child operators (index_select's gather kernel runs under one). The
    # operators also serve other layers: phase 4 times each alone.
    traced["device_ms_per_step_named"] = {
        f"{kernel} (row_segment_matmul_kernel)": per_step(
            lambda e: e.device_type == cuda and "row_segment_matmul_kernel" in e.key,
            lambda e: e.self_device_time_total),
        **{op: per_step(lambda e, op=op: e.device_type != cuda and e.key == op,
                        lambda e: e.device_time_total)
           for op in ("aten::index_select", "aten::copy_", "aten::fill_")},
    }
    return traced


def phase_tmgcn2(torch, np, tk) -> dict[str, tuple]:
    """chess_tmgcn2_cls through run_experiment with every kernel impl, and
    the preset as it stands."""
    from tmgcn_torch.configs.presets import get_preset

    base = get_preset("chess_tmgcn2_cls")
    check(base.spmm_impl == "jnp", "chess_tmgcn2_cls is expected to name spmm_impl jnp")
    _, split = _chess2()
    e_train = split.target.size
    # 3 cached propagations, forward and backward per step, and a val and a
    # test forward at each of the 2 evaluation epochs (train/loop.py).
    k1_launches = 3 + 2 * EPOCHS + 4
    counts = {}
    cfg = dataclasses.replace(base, spmm_impl="pallas")
    counts["chess_tmgcn2_cls pallas"] = _run_slice(
        torch, np, tk, cfg, e_train, (k1_launches, 0, 0, 0, 0, 0, 0), vs_eager=True)
    cfg = dataclasses.replace(base, spmm_impl="pallas_bf16")
    counts["chess_tmgcn2_cls pallas_bf16"] = _run_slice(
        torch, np, tk, cfg, e_train, (0, k1_launches, 0, 0, 0, 0, 0), warm=False, rtol=BF16_RTOL)
    for impl, expected, rtol in (("pallas_tiled", (0, 0, 0, 3, 0, 0, 0), 1e-4),
                                 ("pallas_tiled_bf16", (0, 0, 0, 0, 3, 0, 0), BF16_RTOL)):
        cfg = dataclasses.replace(base, spmm_impl=impl)
        counts[f"chess_tmgcn2_cls {impl}"] = _run_slice(
            torch, np, tk, cfg, e_train, expected, epochs=REF_EPOCHS, warm=False, rtol=rtol)
    counts["chess_tmgcn2_cls preset (jnp: blockdense)"] = _run_slice(
        torch, np, tk, base, e_train, (0, 0, 0, 0, 0, 0, 0), vs_eager=True)
    return counts


def phase_lp(torch, np, tk) -> dict[str, tuple]:
    """chess_tmgcn_lp (pallas and the preset) and chess_wdgcn_lp through
    run_experiment: launch counts, warm reruns, the CPU plain path."""
    from tmgcn_torch.configs.presets import get_preset

    edges, _, _ = _chess_wdgcn_lp_train_edges()
    e_train = edges.shape[1]  # the train window's model edges, the same for both presets
    counts = {}
    base = get_preset("chess_tmgcn_lp")
    check(base.spmm_impl == "jnp", "chess_tmgcn_lp is expected to name spmm_impl jnp")
    counts["chess_tmgcn_lp pallas"] = _run_slice(
        torch, np, tk, dataclasses.replace(base, spmm_impl="pallas"), e_train,
        (3, 0, 0, 0, 0, 0, 0))
    counts["chess_tmgcn_lp preset (jnp)"] = _run_slice(
        torch, np, tk, base, e_train, (0, 0, 0, 0, 0, 0, 0), warm=False)
    wd = get_preset("chess_wdgcn_lp")
    check(wd.spmm_impl == "jnp", "chess_wdgcn_lp is expected to name spmm_impl jnp")
    counts["chess_wdgcn_lp"] = _run_slice(torch, np, tk, wd, e_train, (EPOCHS, 0, 0, 0, 0, 0, 0),
                                          vs_eager=True)
    for name, same_block in (("chess_tmgcn_lp", True), ("chess_wdgcn_lp", False)):
        sec = _lp_eval_seconds(np, _chess_lp_splits(same_block))
        print(f"{name}: host scoring of one evaluation epoch {sum(sec.values()):.3f} s "
              f"(map_mrr and loss; train {sec['train']:.3f}, val {sec['val']:.3f}, "
              f"test {sec['test']:.3f} s)")
    return counts


def phase_gcn(torch, np, tk, e_train: int) -> dict[str, tuple]:
    """KW-GCN through run_experiment: chess_gcn_cls with "pallas" (3 K1
    launches, the cached propagation of the three disjoint windows) and its
    preset ("jnp": none); the 2-layer model, hidden (6, 6, 3), with
    "pallas" (K1 in layer 2's forward and backward and in the readout
    plan's backward each step); chess_gcn_lp with "pallas" (3 K1)."""
    from tmgcn_torch.configs.presets import get_preset

    base = get_preset("chess_gcn_cls")
    check(base.spmm_impl == "jnp", "chess_gcn_cls is expected to name spmm_impl jnp")
    zeros = (0, 0, 0, 0, 0, 0, 0)
    counts = {"chess_gcn_cls pallas": _run_slice(
        torch, np, tk, dataclasses.replace(base, spmm_impl="pallas"), e_train,
        (3, 0, 0, 0, 0, 0, 0))}
    counts["chess_gcn_cls preset (jnp)"] = _run_slice(torch, np, tk, base, e_train, zeros,
                                                      warm=False)
    two = dataclasses.replace(base, name="chess_gcn_cls_2layer", n_layers=2,
                              hidden_feat=(6, 6, 3), spmm_impl="pallas")
    # 3 cached propagations; per step layer 2's forward and backward and the
    # readout backward; a val and a test forward at each evaluation epoch.
    n_evals = -(-EPOCHS // two.eval_every)
    counts["chess_gcn_cls 2-layer (6, 6, 3) pallas"] = _run_slice(
        torch, np, tk, two, e_train, (3 + 3 * EPOCHS + 2 * n_evals, 0, 0, 0, 0, 0, 0),
        vs_eager=True)
    lp = get_preset("chess_gcn_lp")
    edges, _, _ = _chess_wdgcn_lp_train_edges()  # the baselines' LP train window
    counts["chess_gcn_lp pallas"] = _run_slice(
        torch, np, tk, dataclasses.replace(lp, spmm_impl="pallas"), edges.shape[1],
        (3, 0, 0, 0, 0, 0, 0), warm=False)
    return counts


def _restricted_choices(cfg) -> dict:
    """The restricted layer-2 operator the ``auto`` rule picks for each
    window of ``cfg`` on the card, and the block-dense estimate's ratio."""
    from tmgcn_torch.configs.build import build_experiment

    exp = build_experiment(cfg, DATA_DIR, device=DEVICE)
    out = {w: exp.adapter.bundles[w]["l2op_choice"] for w in ("train", "val", "test")}
    del exp
    return out


def phase_evolvegcn(torch, np, tk, e_train: int) -> dict[str, tuple]:
    """EvolveGCN-H through run_experiment, each captured against the eager
    loop: chess_evolvegcn_cls (the gather-free path: no kernel),
    chess_evolvegcn2_cls (the restricted layer 2 on the operator ``auto``
    picks: block-dense on cuBLAS, or K1), chess_evolvegcn_lp (the generic
    path: K1 in the readout plan's backward once a step)."""
    from tmgcn_torch.configs.presets import get_preset

    zeros = (0, 0, 0, 0, 0, 0, 0)
    counts = {"chess_evolvegcn_cls": _run_slice(
        torch, np, tk, get_preset("chess_evolvegcn_cls"), e_train, zeros, vs_eager=True,
        f1_ties=True)}
    two = get_preset("chess_evolvegcn2_cls")
    choices = _restricted_choices(two)
    print(f"chess_evolvegcn2_cls: the restricted layer-2 operator auto picks on the card, by "
          f"window (block-dense below ratio 0.5): {json.dumps(choices)}")
    # K1 per window that picked it: forward and backward every training
    # step; a forward at each evaluation epoch for val and test.
    n_evals = -(-EPOCHS // two.eval_every)
    k1 = sum((2 * EPOCHS if w == "train" else n_evals) for w, c in choices.items()
             if c["operator"] == "pallas")
    counts["chess_evolvegcn2_cls"] = _run_slice(torch, np, tk, two, e_train,
                                                (k1, 0, 0, 0, 0, 0, 0), vs_eager=True,
                                                f1_ties=True)
    edges, _, _ = _chess_wdgcn_lp_train_edges()
    counts["chess_evolvegcn_lp"] = _run_slice(
        torch, np, tk, get_preset("chess_evolvegcn_lp"), edges.shape[1],
        (EPOCHS, 0, 0, 0, 0, 0, 0), vs_eager=True)
    return counts


def phase_k1_seir(torch, np) -> tuple[dict, float]:
    """K1 at seir_wdgcn_reg_tuned's packing: the SEIR train window's Ct (80
    slices x 200 nodes, the prepacked operator of spmm_impl="pallas") times
    the window's standardized features, F = 5: the kernel against its plain
    version and torch.sparse.mm, the operator against the plain spmm,
    bitwise repeat, times beside the bound. The path's backward never runs
    (the features are data)."""
    from tmgcn_torch.configs.build import build_data
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.kernels import spmm_cuda as tk
    from tmgcn_torch.ops.spmm import spmm

    dev = torch.device(DEVICE)
    k1, k1p = tk.windowed_segment_matmul, tk.windowed_segment_matmul_reference
    data = build_data(get_preset("seir_wdgcn_reg_tuned"))
    Ct = data.adj["train"]
    op = tk.make_operator(Ct).to(dev)
    X = torch.as_tensor(data.feats["train"], dtype=torch.float32, device=dev)
    T, N, F = X.shape
    n_real = int(np.asarray(Ct.nnz).sum())
    name = "K1 seir_wdgcn_reg_tuned propagation"
    ref = spmm(Ct.to(dev), X)
    err, tol = _max_err(op(X), ref)
    check(err <= tol, f"{name}: the operator against the plain spmm: {err} > {tol}")
    p = op.packed
    flat = X.reshape(T * N, F)
    gathered = flat[p.cols.long().reshape(-1)].reshape(p.n_chunks, p.chunk, F).contiguous()
    max_err = max(err, _check_kernel(torch, k1, k1p, p, gathered, lambda: None, name))
    csr = _packing_csr(torch, p, T * N)
    err, tol = _max_err(k1(p, gathered)[: T * N], torch.sparse.mm(csr, flat)[: T * N])
    check(err <= tol, f"{name} vs torch.sparse.mm: {err} > {tol}")
    out = {
        **_time_shape(torch, k1, k1p, p, gathered, F, n_real, None,
                      lambda: torch.sparse.mm(csr, flat), name),
        "shape": f"seir_wdgcn_reg_tuned propagation (F={F}, {n_real:,} entries into {T} x {N} "
                 f"rows; library gather included)",
    }
    del op, X, gathered, csr
    torch.cuda.empty_cache()
    return out, max(max_err, err)


REG_KEYS = ("train_loss", "val_l1", "val_l1_ratio", "test_l1", "test_l1_ratio")


def _same_regression(np, a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k], equal_nan=True) for k in REG_KEYS)


def _run_regression_slice(torch, np, tk, cfg, expected: tuple) -> tuple:
    """A regression preset's own epochs on cuda (counted): losses and val/test
    L1 finite; a warm rerun and the eager loop with the same result, bitwise
    (the eager loop with the same launches); the first 5 epochs' losses
    against the CPU's plain path (rtol 1e-4), and a 5-epoch run's L1 and L1
    ratio against the CPU's (rtol 1e-3)."""
    from tmgcn_torch.configs.build import run_experiment

    name = f"{cfg.name} ({cfg.spmm_impl})"
    epochs = cfg.n_epochs

    def run(n, device=DEVICE):
        out = run_experiment(cfg, n_epochs=n, verbose=False, device=device)
        check(list(out["results"]) == [(0, None)], f"{name}: results keyed {list(out['results'])}")
        return out["results"][(0, None)], out["seconds"]

    (res, sec), launches = _counted(tk, lambda: run(epochs))
    check(launches == expected,
          f"{name}: {COUNTED} launched {launches} times on the main path, expected {expected}")
    check(res["train_loss"].shape == (epochs,) and bool(np.all(np.isfinite(res["train_loss"]))),
          f"{name}: a training loss is not finite")
    check(all(np.isfinite(res[k]) for k in REG_KEYS[1:]), f"{name}: a val/test L1 is not finite")
    print(f"slice {name} cuda, first run: {epochs} epochs, {COUNTED} launches {launches}; data "
          f"{sec['data']:.3f} s, adapter {sec['adapter']:.3f} s, train {sec['train']:.3f} s "
          f"({1e3 * sec['train'] / epochs:.6f} ms/epoch with the process's first launches)")
    print(f"slice {name} result: train loss {res['train_loss'][0]:.6f} -> "
          f"{res['train_loss'][-1]:.6f} | val L1 {res['val_l1']:.6f} ratio "
          f"{res['val_l1_ratio']:.6f} | test L1 {res['test_l1']:.6f} ratio "
          f"{res['test_l1_ratio']:.6f}")
    again, sec = run(epochs)
    check(_same_regression(np, again, res), f"{name}: a repeated run gave another result")
    print(f"slice {name} warm run: {1e3 * sec['train'] / epochs:.6f} ms/epoch ({epochs} epochs, "
          f"val and test scored once)")
    with _eager_loop():
        (eager, sec), eager_launches = _counted(tk, lambda: run(epochs))
    check(_same_regression(np, eager, res),
          f"{name}: the captured loop's result differs from the eager loop's")
    check(eager_launches == launches,
          f"{name}: the eager loop launched {eager_launches}, the captured {launches}")
    print(f"slice {name} captured vs eager loop, {epochs} epochs: results bitwise equal, "
          f"{COUNTED} launches {eager_launches} in both; eager train "
          f"{1e3 * sec['train'] / epochs:.6f} ms/epoch")
    ref, _ = run(REF_EPOCHS, "cpu")
    short, _ = run(REF_EPOCHS)
    check(bool(np.allclose(res["train_loss"][:REF_EPOCHS], ref["train_loss"], rtol=1e-4, atol=0)),
          f"{name}: losses differ from the CPU plain path: {res['train_loss'][:REF_EPOCHS]} vs "
          f"{ref['train_loss']}")
    for k in REG_KEYS[1:]:
        check(bool(np.isclose(short[k], ref[k], rtol=1e-3, atol=0)),
              f"{name}: {k} {short[k]} of a {REF_EPOCHS}-epoch run differs from the CPU's {ref[k]}")
    print(f"slice {name} vs CPU plain path, {REF_EPOCHS} epochs: losses within rtol 1e-4, "
          f"val/test L1 and L1 ratio within rtol 1e-3")
    return launches


def _sbm_splits(cfg):
    from tmgcn_torch.configs.build import build_data
    from tmgcn_torch.tasks.windows import split_data_link_prediction

    data = build_data(cfg)
    return split_data_link_prediction(data.lp_edges, data.lp_labels, data.spec)


def phase_synthetic(torch, np, tk) -> dict[str, tuple]:
    """The three SEIR regression presets (_tuned: "pallas" where the model
    takes an impl) and the two SBM link-prediction _tuned presets, through
    run_experiment: launch counts, warm reruns, the eager loop, the CPU's
    plain path; the host scoring of one SBM evaluation epoch."""
    from tmgcn_torch.configs.presets import get_preset

    counts = {}
    # K1: TM-GCN's cached propagation of the three windows; EvolveGCN none
    # (the plain spmm); WD-GCN its propagation once a step and once for each
    # of val and test.
    for name, k1 in (("seir_tmgcn_reg_tuned", 3), ("seir_evolvegcn_reg_tuned", 0),
                     ("seir_wdgcn_reg_tuned", None)):
        cfg = get_preset(name)
        if k1 is None:
            k1 = cfg.n_epochs + 2
        counts[name] = _run_regression_slice(torch, np, tk, cfg, (k1, 0, 0, 0, 0, 0, 0))
    # K1: sbm_tmgcn_lp_tuned's cached propagation of the three windows;
    # sbm_evolvegcn_lp_tuned's readout plan backward once a step (its slice
    # one-hot is far over the gather-free budget: the generic path).
    for name, k1 in (("sbm_tmgcn_lp_tuned", 3), ("sbm_evolvegcn_lp_tuned", SBM_EPOCHS)):
        cfg = get_preset(name)
        check(cfg.spmm_impl == "pallas", f"{name} is expected to name spmm_impl pallas")
        splits = _sbm_splits(cfg)
        counts[name] = _run_slice(torch, np, tk, cfg, splits["train"].model_edges.shape[1],
                                  (k1, 0, 0, 0, 0, 0, 0), epochs=SBM_EPOCHS, vs_eager=True)
    sec = _lp_eval_seconds(np, _sbm_splits(get_preset("sbm_tmgcn_lp_tuned")))
    print(f"sbm_*_lp_tuned: host scoring of one evaluation epoch {sum(sec.values()):.3f} s "
          f"(map_mrr and loss; train {sec['train']:.3f}, val {sec['val']:.3f}, "
          f"test {sec['test']:.3f} s)")
    return counts


# Checkpoints of the resume phase: inside the checkout, under the build
# directory git ignores; removed when the phase ends.
CKPT_DIR = "build/chip_smoke_checkpoints"
RESUME_SAVED = 101  # the interrupted chess run's epochs: it saves at 0 and 100
SEIR_SAVED = 200  # the interrupted SEIR run's epochs: it saves at 99 and 199
CARRY_EPOCHS = 5  # chess_evolvegcn_lp's checkpoint for predict with a carry


@contextlib.contextmanager
def _timed_checkpoints(torch, times: dict):
    """Every checkpoint save, load and in-place restore of the training
    loop and ``cli predict``, timed on the host clock after a synchronize,
    into ``times`` ({"save", "load", "restore"}: lists of seconds; a
    lookup that finds no checkpoint is not timed)."""
    from tmgcn_torch.train import checkpoint, loop

    def timed(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            if out is not None or name == "save":  # not the lookups of an empty directory
                times.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return call

    Ck = checkpoint.RunCheckpointer
    with mock.patch.object(Ck, "save", timed("save", Ck.save)), \
            mock.patch.object(Ck, "restore", timed("load", Ck.restore)), \
            mock.patch.object(loop, "_restore", timed("restore", loop._restore)):
        yield


def _predict(tk, argv: list, out_path):
    """``cli predict`` in process, counted: (its .npz, the launch counts)."""
    import numpy as np

    from tmgcn_torch import cli

    argv = [*argv, "--device", DEVICE, "--out", str(out_path)]
    rc, launches = _counted(tk, lambda: cli.main(argv))
    check(rc == 0, f"cli {' '.join(argv)} exited {rc}")
    return np.load(out_path), launches


def phase_resume(torch, np, tk, card: str) -> dict[str, tuple]:
    """Checkpoint -> resume -> predict on the card, through the loops and
    the CLI (train/checkpoint.py, cli predict). chess_tmgcn2_cls with
    "pallas" (K1 in the restricted layer 2's forward and backward, each
    step a replay of the captured graph), its experiment built once: a
    200-epoch run without checkpoints; (a) the same with a checkpoint
    directory (rows bitwise equal: saving changes nothing); (b) 101 epochs
    into a second directory (saves at 0 and 100); (c) a resume of (b) to
    200 epochs: its state copied into the step's tensors before the
    capture, an evaluation epoch at 101, then 98 replays; its train columns
    from 101 on bitwise (a)'s, its first 101 rows (a)'s; K1 launches exact.
    ``cli predict --window val`` from (a)'s directory (the checkpoint of
    epoch 100, the newest): its val F1 is row 100's, within the tie range
    of its logits. seir_wdgcn_reg_tuned (K1 once a step): 300 epochs, then
    200 epochs that save at 99 and 199 and a resume to 300: losses and
    val/test L1 bitwise the uninterrupted run's. chess_evolvegcn_lp (a
    carry): a 5-epoch checkpoint, then predict: MAP and MRR in [0, 1]."""
    import shutil

    root = Path(CKPT_DIR)
    shutil.rmtree(root, ignore_errors=True)
    counts, times = {}, {}
    try:
        with _timed_checkpoints(torch, times):
            for part in (_resume_chess, _resume_seir, _predict_with_carry):
                counts.update(part(torch, np, tk, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in ("save", "load", "restore"):
        t = times.get(name, [])
        check(bool(t), f"resume: no checkpoint {name} was timed")
        print(f"resume: checkpoint {name} x{len(t)}: median {1e3 * statistics.median(t):.6f} ms, "
              f"max {1e3 * max(t):.6f} ms, each {[round(1e3 * x, 6) for x in t]} ms [{card}]")
    return counts


def _resume_chess(torch, np, tk, root) -> dict[str, tuple]:
    from tmgcn_torch.configs.build import build_experiment, run_trial, train_config
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.tasks import metrics as M
    from tmgcn_torch.train.checkpoint import RunCheckpointer

    cfg = dataclasses.replace(get_preset("chess_tmgcn2_cls"), spmm_impl="pallas")
    (alpha,) = cfg.alpha_vec
    exp = build_experiment(cfg, DATA_DIR, None, DEVICE)
    name = "chess_tmgcn2_cls (pallas)"

    def run(n, ck=None):
        gen = torch.Generator().manual_seed(cfg.seed)  # run_experiment's first run
        return _counted(tk, lambda: run_trial(exp, train_config(cfg, n), alpha, gen, ck))

    def k1(steps, evals):
        # The restricted layer 2's forward and backward a step; its forward
        # for val and for test at each evaluation epoch.
        return (2 * steps + 2 * evals, 0, 0, 0, 0, 0, 0)

    ev = cfg.eval_every
    counts = {}
    plain, launches = run(EPOCHS)
    check(launches == k1(EPOCHS, 2), f"{name}: launched {launches}, expected {k1(EPOCHS, 2)}")
    counts[f"resume: {name} {EPOCHS} epochs, no checkpoints"] = launches
    # run_experiment's layout, <dir>/<preset>/<run tag>, which predict reads.
    tag = f"tr0_w{round(alpha * 100)}"
    dir_a, dir_b = root / "a" / cfg.name / tag, root / "b" / cfg.name / tag
    t0 = time.perf_counter()
    rows_a, launches = run(EPOCHS, RunCheckpointer(dir_a))
    t_a = time.perf_counter() - t0
    check(launches == k1(EPOCHS, 2), f"{name} (a): launched {launches}")
    check(np.array_equal(rows_a, plain, equal_nan=True),
          f"{name}: a run with checkpoints gave other rows than one without")
    check(RunCheckpointer(dir_a).latest_epoch() == ev, f"{name} (a): newest checkpoint not {ev}")
    counts[f"resume: {name} (a) {EPOCHS} epochs, saving"] = launches
    rows_b, launches = run(RESUME_SAVED, RunCheckpointer(dir_b))
    check(launches == k1(RESUME_SAVED, 2), f"{name} (b): launched {launches}")
    check(RunCheckpointer(dir_b).latest_epoch() == RESUME_SAVED - 1,
          f"{name} (b): newest checkpoint not {RESUME_SAVED - 1}")
    counts[f"resume: {name} (b) {RESUME_SAVED} epochs"] = launches
    t0 = time.perf_counter()
    rows_c, launches = run(EPOCHS, RunCheckpointer(dir_b))
    t_c = time.perf_counter() - t0
    # The resume: an evaluation epoch at 101, then plain steps to 199.
    steps_c = EPOCHS - RESUME_SAVED
    expected = k1(steps_c, 1)
    check(launches == expected, f"{name} (c): launched {launches}, expected {expected} "
                                f"({steps_c} steps x 2 + 1 evaluation x 2)")
    counts[f"resume: {name} (c) resumed {RESUME_SAVED} -> {EPOCHS}"] = launches
    check(np.array_equal(rows_c[:RESUME_SAVED], rows_a[:RESUME_SAVED], equal_nan=True),
          f"{name} (c): the restored rows differ from (a)'s")
    same = np.array_equal(rows_c[RESUME_SAVED:, :4], rows_a[RESUME_SAVED:, :4], equal_nan=True)
    check(same, f"{name} (c): train columns from {RESUME_SAVED} on differ from (a)'s: max abs "
                f"diff {np.nanmax(np.abs(rows_c[:, :4] - rows_a[:, :4]))}")
    print(f"resume {name}: (a) {EPOCHS} epochs saving at 0 and {ev}, rows bitwise the run "
          f"without checkpoints, {t_a:.3f} s; (b) {RESUME_SAVED} epochs; (c) resumed at "
          f"{RESUME_SAVED} to {EPOCHS} in {t_c:.3f} s ({steps_c} steps, 1 evaluation): rows "
          f"0-{RESUME_SAVED - 1} (a)'s, train columns {RESUME_SAVED}-{EPOCHS - 1} bitwise (a)'s; "
          f"K1 launches {launches[0]} = 2 x {steps_c} steps + 2 x 1 evaluation")

    argv = ["predict", cfg.name, "--data-dir", DATA_DIR, "--spmm-impl", "pallas",
            "--checkpoint-dir", str(root / "a"), "--window", "val"]
    t0 = time.perf_counter()
    z, launches = _predict(tk, argv, root / "val.npz")
    t_p = time.perf_counter() - t0
    # 3 cached propagations; the train and the val forward.
    check(launches == (5, 0, 0, 0, 0, 0, 0), f"cli predict {cfg.name}: launched {launches}")
    counts[f"resume: cli predict {cfg.name} --spmm-impl pallas"] = launches
    check(int(z["epoch"]) == ev, f"predict restored epoch {int(z['epoch'])}, not {ev}")
    s = exp.splits["val"]
    logits, tgt = z["scores"][s.eval_mask], s.target[s.eval_mask]
    f1 = M.precision_recall_f1(np.argmax(logits, 1), tgt)[2]
    lo, hi = sorted(_f1_range(np, logits, tgt))
    row = rows_a[ev, 6]
    check(lo - 1e-12 <= row <= hi + 1e-12,
          f"predict's val F1 range [{lo}, {hi}] misses row {ev}'s val F1 {row}")
    print(f"cli predict {cfg.name} --window val (epoch {ev}): val F1 {f1:.6f}, row {ev}'s "
          f"{row:.6f} ({'equal' if f1 == row else 'within the tie range'} [{lo:.6f}, {hi:.6f}]); "
          f"{t_p:.3f} s with the experiment's build, K1 launches {launches[0]}")
    return counts


def _resume_seir(torch, np, tk, root) -> dict[str, tuple]:
    from tmgcn_torch.configs.build import build_experiment, run_trial, train_config
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.train.checkpoint import RunCheckpointer

    cfg = get_preset("seir_wdgcn_reg_tuned")
    exp = build_experiment(cfg, None, None, DEVICE)
    n, ev = cfg.n_epochs, cfg.eval_every
    name = f"{cfg.name} ({cfg.spmm_impl})"

    def run(epochs, ck=None):
        gen = torch.Generator().manual_seed(cfg.seed)
        return _counted(tk, lambda: run_trial(exp, train_config(cfg, epochs), None, gen, ck))

    counts = {}
    full, launches = run(n)
    check(launches == (n + 2, 0, 0, 0, 0, 0, 0), f"{name}: launched {launches}")
    counts[f"resume: {name} {n} epochs"] = launches
    ck = root / "seir"
    _, launches = run(SEIR_SAVED, RunCheckpointer(ck))
    check(launches == (SEIR_SAVED + 2, 0, 0, 0, 0, 0, 0), f"{name}: launched {launches}")
    check(RunCheckpointer(ck).latest_epoch() == SEIR_SAVED - 1,
          f"{name}: newest checkpoint not {SEIR_SAVED - 1}")
    counts[f"resume: {name} {SEIR_SAVED} epochs, saving"] = launches
    t0 = time.perf_counter()
    resumed, launches = run(n, RunCheckpointer(ck))
    t_r = time.perf_counter() - t0
    expected = (n - SEIR_SAVED + 2, 0, 0, 0, 0, 0, 0)
    check(launches == expected, f"{name} resumed: launched {launches}, expected {expected}")
    counts[f"resume: {name} resumed {SEIR_SAVED} -> {n}"] = launches
    check(_same_regression(np, resumed, full),
          f"{name}: the resumed run's result differs from the uninterrupted run's")
    print(f"resume {name}: {SEIR_SAVED} epochs saving at {ev - 1} and {SEIR_SAVED - 1}, resumed "
          f"to {n} in {t_r:.3f} s: losses and val/test L1 bitwise the uninterrupted run's; K1 "
          f"launches {launches[0]} = {n - SEIR_SAVED} steps + val + test")
    return counts


def _predict_with_carry(torch, np, tk, root) -> dict[str, tuple]:
    from tmgcn_torch.configs.build import build_experiment, run_trial, train_config
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.tasks import metrics as M
    from tmgcn_torch.train.checkpoint import RunCheckpointer

    cfg = get_preset("chess_evolvegcn_lp")
    (alpha,) = cfg.alpha_vec
    exp = build_experiment(cfg, DATA_DIR, None, DEVICE)
    gen = torch.Generator().manual_seed(cfg.seed)
    ck = root / "carry" / cfg.name / f"tr0_w{round(alpha * 100)}"
    _, launches = _counted(tk, lambda: run_trial(exp, train_config(cfg, CARRY_EPOCHS), alpha,
                                                   gen, RunCheckpointer(ck)))
    check(launches == (CARRY_EPOCHS, 0, 0, 0, 0, 0, 0), f"{cfg.name}: launched {launches}")
    counts = {f"resume: {cfg.name} {CARRY_EPOCHS} epochs, saving": launches}
    argv = ["predict", cfg.name, "--data-dir", DATA_DIR, "--checkpoint-dir",
            str(root / "carry"), "--window", "val"]
    t0 = time.perf_counter()
    z, launches = _predict(tk, argv, root / "carry.npz")
    t_p = time.perf_counter() - t0
    check(launches == (0, 0, 0, 0, 0, 0, 0), f"cli predict {cfg.name}: launched {launches}")
    s = exp.splits["val"]
    K = s.n_eval_tail
    scores = z["scores"]
    check(bool(np.all(np.isfinite(scores))), f"cli predict {cfg.name}: a score is not finite")
    if K is not None:
        mp, mr = M.map_mrr(scores[-K:], s.target[-K:], s.edges[:, -K:])
    else:
        keep = s.edges[0] != 0
        mp, mr = M.map_mrr(scores, s.target[keep], s.edges[:, keep])
    check(0 <= mp <= 1 and 0 <= mr <= 1, f"cli predict {cfg.name}: MAP {mp}, MRR {mr}")
    print(f"cli predict {cfg.name} --window val (epoch {int(z['epoch'])}, the carry threaded "
          f"train -> val): MAP {mp:.6f} MRR {mr:.6f}, {t_p:.3f} s with the experiment's build")
    return counts


# The streamed restricted layer 2's groups of time slices (phase 7o).
STREAM_CHUNKS = 4


def _stream_groups(np, A, edges, n_chunks: int = STREAM_CHUNKS) -> int:
    """The groups of the streamed layer 2 that launch K1, reckoned on the
    host from the data apart from the adapter: those with an adjacency
    entry in a labelled edge's endpoint row. A group without one gets an
    operator with no entry, which the apply does not call."""
    from tmgcn_torch.ops.spmm_rowsplit import flatten_stream

    T, N = A.n_slices, A.n_nodes
    e = np.asarray(edges, np.int64)
    g_rows = flatten_stream(A)[0]
    member = np.isin(g_rows, np.concatenate([e[0] * N + e[1], e[0] * N + e[2]]))
    return len(np.unique(g_rows[member] // N // -(-T // n_chunks)))


@contextlib.contextmanager
def _streamed(n_chunks: int = STREAM_CHUNKS):
    """``run_experiment`` with its edge adapters built with
    ``l2_stream_chunks``: the restricted 2-layer TM-GCN's layer 2 streamed."""
    from tmgcn_torch.configs import build
    from tmgcn_torch.tasks.adapters import make_edge_adapter

    with mock.patch.object(build, "make_edge_adapter",
                           functools.partial(make_edge_adapter, l2_stream_chunks=n_chunks)):
        yield


def _streamed_chess(torch, np, tk) -> dict[str, tuple]:
    """chess_tmgcn2_cls / pallas with its layer 2 streamed over
    STREAM_CHUNKS groups, held against the one-operator run of the same
    preset, then pallas_bf16 for 5 epochs."""
    from tmgcn_torch.configs.build import run_experiment
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.tasks.windows import split_edges_classification

    base = get_preset("chess_tmgcn2_cls")
    cfg = dataclasses.replace(base, spmm_impl="pallas")
    data, split = _chess2()
    splits = split_edges_classification(data.edge_index, data.edge_values, data.spec,
                                        n_classes=cfg.n_classes)
    groups = {w: _stream_groups(np, data.adj[w], splits[w].edges) for w in splits}

    def k1(epochs: int, evals: int) -> int:
        # 3 cached propagations; the forward and backward of each train
        # group with entries a step; the forward of each val and test group
        # with entries at each evaluation epoch.
        return 3 + 2 * epochs * groups["train"] + evals * (groups["val"] + groups["test"])

    T = data.adj["train"].n_slices
    print(f"streamed chess_tmgcn2_cls: {STREAM_CHUNKS} groups of {-(-T // STREAM_CHUNKS)} "
          f"slices; groups with entries by window {groups}; K1 reckoned {k1(EPOCHS, 2)} in "
          f"{EPOCHS} epochs (2 evaluations), {k1(REF_EPOCHS, 1)} in {REF_EPOCHS}")
    single_logits = []
    with _recorded_evals(single_logits):
        out, launches = _counted(tk, lambda: run_experiment(
            cfg, data_dir=DATA_DIR, n_epochs=EPOCHS, verbose=False, device=DEVICE))
    one = (3 + 2 * EPOCHS + 4, 0, 0, 0, 0, 0, 0)
    check(launches == one, f"chess_tmgcn2_cls (pallas), one operator: launched {launches}")
    counts = {"chess_tmgcn2_cls pallas, one operator (the streamed run's reference)": launches}
    (single,) = out["results"].values()
    name = f"chess_tmgcn2_cls (pallas, l2_stream_chunks={STREAM_CHUNKS})"
    rows = []
    with _streamed():
        counts[name] = _run_slice(torch, np, tk, cfg, split.target.size,
                                  (k1(EPOCHS, 2), 0, 0, 0, 0, 0, 0), vs_eager=True, name=name,
                                  rows=rows)
        (streamed,) = rows
        # The groups' weight gradients are summed per group, so the two runs
        # round differently; over 200 epochs the CPU's plain path drifts to
        # 1.01e-5 (train loss, epoch 74) and back: the suite's loss tolerance
        # between summation orders, rtol 1e-4, holds them.
        losses = [3, 7, 11]
        rel_by_epoch = np.nanmax(np.abs(streamed[:, losses] - single[:, losses])
                                 / np.abs(single[:, losses]), axis=1)
        rel = float(np.max(rel_by_epoch))
        check(bool(np.allclose(streamed[:, losses], single[:, losses], rtol=1e-4, atol=0)),
              f"{name}: losses differ from the one-operator run's by {rel} (rtol 1e-4)")
        _check_eval_f1_in_tie_range(np, cfg, streamed, single, single_logits, name,
                                    ref="the one-operator run")
        same = np.array_equal(streamed, single, equal_nan=True)
        print(f"{name} vs the one-operator run, {EPOCHS} epochs from the same parameters: losses "
              f"within rtol 1e-4 (max relative difference {rel:.3e} at epoch "
              f"{int(np.argmax(rel_by_epoch))}, {int(np.sum(rel_by_epoch > 1e-5))} epochs over "
              f"1e-5; first 5 epochs {rel_by_epoch[:5].tolist()}); rows "
              f"{'bitwise equal' if same else 'not bitwise equal'}")
        bf = dataclasses.replace(base, spmm_impl="pallas_bf16")
        name_bf = f"chess_tmgcn2_cls (pallas_bf16, l2_stream_chunks={STREAM_CHUNKS})"
        counts[name_bf] = _run_slice(torch, np, tk, bf, split.target.size,
                                     (0, k1(REF_EPOCHS, 1), 0, 0, 0, 0, 0), epochs=REF_EPOCHS,
                                     warm=False, rtol=BF16_RTOL, name=name_bf)
    return counts


def _gathered_bytes(op) -> dict:
    """The float32 (J, C, F1 = 6) chunks the operator gathers for its
    forward and for its backward: the transient each K1 call needs."""
    return {side: getattr(op, side).rows.numel() * 6 * 4 for side in ("packed", "packed_t")}


def _forward_peak(torch, adapter) -> int:
    """Peak device bytes, above what was allocated before it, of one
    forward of the train window without autograd: the layer-2 operators'
    gathered chunks live only then, one call at a time."""
    variables = adapter.init(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out, _ = adapter.apply(variables, adapter.bundles["train"], ())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def _k1_layer2_row(torch, tk, op, what: str) -> dict:
    """K1 at a restricted layer 2's forward packing (F = 6, random input
    rows) against its plain version and torch.sparse.mm, timed beside its
    bound."""
    dev = torch.device(DEVICE)
    p = op.packed
    Y = torch.randn(op.n_in, 6, device=dev, generator=torch.Generator(device=dev).manual_seed(7))
    g = tk.gather_chunks(Y, p)
    nnz = int(p.entry_order.numel())
    f32 = torch.float32

    def run():
        return tk.windowed_segment_matmul(p, g, out_dtype=f32)

    def plain():
        return tk.windowed_segment_matmul_reference(p, g, out_dtype=f32)

    err = _check_same(torch, run, plain, what)
    S = _packing_csr(torch, p, op.n_in)
    lib_err, tol = _max_err(run()[: op.n_out], torch.sparse.mm(S, Y)[: op.n_out])
    check(lib_err <= tol, f"{what} vs torch.sparse.mm: {lib_err} > {tol}")
    shape = (f"{op.n_out} endpoint rows x {op.n_in} used rows, F=6, nnz {nnz} in "
             f"{p.n_chunks} chunks of {p.chunk} ({p.rows.numel()} slots)")
    print(f"{what}: J={p.n_chunks} C={p.chunk} W={p.window} F=6 nnz={nnz} "
          f"n_rows_out={p.n_rows_out} ({shape})")
    row = _report(torch, what, run, plain, lambda: torch.sparse.mm(S, Y), _bound(p, 6, nnz, False))
    return {**row, "max_abs_err": err, "shape": shape}


def _tmgcn2_scale(torch, np, tk, inputs, t_build: float, card: str) -> tuple[dict, dict]:
    """The tmgcn2 scale family on the shared inputs: the restricted layer 2
    on the operator the rule picks, then streamed over STREAM_CHUNKS
    groups, each as phase_scale runs a family; the streamed losses against
    the one operator's; K1 timed at both forward packings."""
    from tmgcn_torch.tasks.adapters import _build_restricted_layer2
    from tmgcn_torch.utils.scale_bench import layer2_summary

    A, _, _, edges, _, _ = inputs
    groups = _stream_groups(np, A, edges)
    print(f"TM-GCN 2 scale: streamed over {STREAM_CHUNKS} groups of "
          f"{-(-A.n_slices // STREAM_CHUNKS)} slices, {groups} with entries (K1 reckoned "
          f"{2 * groups} a step); one operator: 2 K1 a step if the rule picks K1, else none")

    def single_per_step(adapter):
        b = adapter.bundles["train"]
        print(f"TM-GCN 2 scale, one operator: {layer2_summary(b)}")
        return (2 if isinstance(b["l2op"], tk.FlatPallasOperator) else 0, 0, 0, 0, 0, 0, 0)

    def streamed_per_step(adapter):
        print(f"TM-GCN 2 scale, streamed: {layer2_summary(adapter.bundles['train'])}")
        return (2 * groups, 0, 0, 0, 0, 0, 0)

    def probe_single(adapter):
        b = adapter.bundles["train"]
        op = b["l2op"]
        if not isinstance(op, tk.FlatPallasOperator):  # the rule chose block-dense
            packed = {"cached": b["cached"]}
            _build_restricted_layer2(packed, A, edges, False, "pallas")
            op = packed["l2op"]
        return (_k1_layer2_row(torch, tk, op, "K1 tmgcn2 scale, one restricted operator, forward"),
                {**_gathered_bytes(op), "forward_peak": _forward_peak(torch, adapter)})

    def probe_streamed(adapter):
        ops = adapter.bundles["train"]["l2s_op"]
        sizes = [_gathered_bytes(op) for op in ops]
        return (_k1_layer2_row(torch, tk, ops[0], "K1 tmgcn2 scale, streamed group 0, forward"),
                {**{side: max(s[side] for s in sizes) for side in ("packed", "packed_t")},
                 "forward_peak": _forward_peak(torch, adapter)})

    counts = {}
    launches, single = phase_scale(torch, np, tk, "tmgcn2", inputs, t_build, card,
                                   label="TM-GCN 2 (one operator)", per_step=single_per_step,
                                   probe=probe_single)
    counts["tmgcn2 scale 500k x 64, one operator"] = launches
    label = f"TM-GCN 2 (streamed, {STREAM_CHUNKS} groups)"
    launches, streamed = phase_scale(torch, np, tk, "tmgcn2", inputs, t_build, card, label=label,
                                     l2_stream=STREAM_CHUNKS, per_step=streamed_per_step,
                                     probe=probe_streamed)
    counts[f"tmgcn2 scale 500k x 64, streamed over {STREAM_CHUNKS} groups"] = launches
    a, b = single["losses"], streamed["losses"]
    rel = float(np.max(np.abs(b - a) / np.abs(a)))
    check(bool(np.allclose(b, a, rtol=1e-5, atol=0)),
          f"{label}: losses {b.tolist()} differ from the one operator's {a.tolist()} by {rel}")
    print(f"{label} vs one operator, from the same parameters: losses within rtol 1e-5 (max "
          f"relative difference {rel:.3e}, {'bitwise equal' if np.array_equal(a, b) else 'not bitwise'}); "
          f"gathered chunks a K1 call needs (float32, F = 6; streamed: the largest group) and "
          f"the peak bytes of a forward without autograd above what was allocated before it "
          f"{json.dumps({'one operator': single['probe'][1], 'streamed': streamed['probe'][1]})}; "
          f"peak device memory of the eager and captured steps, one operator "
          f"{json.dumps({k: v['peak_bytes'] - v['before_bytes'] for k, v in single['memory'].items()})}, "
          f"streamed {json.dumps({k: v['peak_bytes'] - v['before_bytes'] for k, v in streamed['memory'].items()})} "
          f"bytes above what was allocated before them [{card}]")
    return counts, {"restricted_scale_forward": single["probe"][0],
                    "streamed_group_scale_forward": streamed["probe"][0]}


def _generic_tmgcn1(torch, np, tk) -> dict[str, tuple]:
    """chess_tmgcn_cls / pallas with per-slice weights, then with M⁻¹: the
    generic 1-layer adapter (the model's layer on the cached propagation,
    the readout through the plan)."""
    from tmgcn_torch.configs.presets import get_preset

    base = dataclasses.replace(get_preset("chess_tmgcn_cls"), spmm_impl="pallas")
    e_train = _chess2()[1].target.size  # the TM-GCN chess presets' train split
    counts = {}
    for flags in ({"condensed_W": False}, {"use_Minv": True}):
        cfg = dataclasses.replace(base, **flags)
        name = f"chess_tmgcn_cls (pallas, {', '.join(f'{k}={v}' for k, v in flags.items())})"
        # 3 cached propagations, then the readout plan's backward once a step
        # (the evaluations' forwards launch nothing).
        counts[name] = _run_slice(torch, np, tk, cfg, e_train, (3 + EPOCHS, 0, 0, 0, 0, 0, 0),
                                  vs_eager=True, name=name)
    return counts


def phase_streamed(torch, np, tk, inputs, t_build: float, card: str) -> tuple[dict, dict]:
    """Phase 7o: the streamed restricted layer 2 on chess and at scale, and
    the generic 1-layer TM-GCN. Returns the launches by path and K1's rows
    at the two scale packings."""
    counts = _streamed_chess(torch, np, tk)
    scale_counts, k1_rows = _tmgcn2_scale(torch, np, tk, inputs, t_build, card)
    counts.update(scale_counts)
    counts.update(_generic_tmgcn1(torch, np, tk))
    return counts, k1_rows


# The paths timed captured against eager: (preset, spmm_impl or None for
# the preset's own).
TIMED_PATHS = (("chess_tmgcn_cls", "pallas"), ("chess_tmgcn2_cls", "pallas"),
               ("chess_tmgcn2_cls", "jnp"), ("chess_wdgcn_cls", None), ("chess_wdgcn_lp", None),
               ("chess_evolvegcn_cls", None), ("chess_evolvegcn2_cls", None),
               ("chess_evolvegcn_lp", None), ("seir_wdgcn_reg_tuned", None),
               ("seir_tmgcn_reg_tuned", None), ("seir_evolvegcn_reg_tuned", None))


TIMED_PROBE = 5


@contextlib.contextmanager
def _l2_impl(l2_impl: str | None):
    """The sharded adapter's layer 2 forced to ``l2_impl`` ("gather" or
    "blockdense"; None: its own ``auto`` rule)."""
    from tmgcn_torch.parallel import adapter

    if l2_impl is None:
        yield
        return
    make = adapter.make_sharded_edge_adapter
    with mock.patch.object(adapter, "make_sharded_edge_adapter",
                           functools.partial(make, l2_impl=l2_impl)):
        yield


@contextlib.contextmanager
def _experiments_built_once():
    """``configs.build.build_experiment`` memoized by (config, sharded or
    not): the eager rerun of a path and its unsharded reference then reuse
    the adapters built once (the 1 x 1 block-dense layer 2 packs some 14 GB
    of blocks on the host)."""
    from tmgcn_torch.configs import build

    built = {}
    build_experiment = build.build_experiment

    def once(cfg, data_dir=None, artifact=None, device=None, mesh=None):
        key = (cfg, mesh is None)
        if key not in built:
            built[key] = build_experiment(cfg, data_dir, artifact, device, mesh)
        return built[key]

    with mock.patch.object(build, "build_experiment", once):
        yield


def _mesh_rows_vs_unsharded(np, cfg, got, ref, ref_logits, name: str) -> None:
    """The 1 x 1 sharded rows against the unsharded run's on the card, at
    the JAX suite's tolerances for sharded against one device: train loss
    rtol 1e-4; F1 within 1e-3, or val/test F1 in the range the unsharded
    run's evaluation logits allow once their tied edges go either way;
    link prediction's MAP and MRR rtol 1e-3."""
    lp = cfg.task == "link_pred"
    loss_col = 2 if lp else 3
    rel = np.abs(got[:, loss_col] - ref[:, loss_col]) / np.abs(ref[:, loss_col])
    check(bool(np.all(rel <= 1e-4)), f"{name}: train loss differs from the unsharded run by "
                                     f"rtol {rel.max()} (epoch {int(rel.argmax())})")
    if lp:
        rates = [0, 1, 3, 4, 6, 7]
        same_nan = np.isnan(got[:, rates]) == np.isnan(ref[:, rates])
        close = np.nan_to_num(np.abs(got[:, rates] - ref[:, rates])
                              - 1e-3 * np.abs(ref[:, rates]), nan=0.0) <= 0
        check(bool(np.all(same_nan & close)), f"{name}: MAP/MRR differ from the unsharded run")
    else:
        f1s = [2, 6, 10]
        same_nan = np.isnan(got[:, f1s]) == np.isnan(ref[:, f1s])
        close = np.nan_to_num(np.abs(got[:, f1s] - ref[:, f1s]), nan=0.0) <= 1e-3
        if not bool(np.all(same_nan & close)):
            _check_eval_f1_in_tie_range(np, cfg, got, ref, ref_logits, name,
                                        ref="the unsharded run")
    print(f"{name} vs the unsharded run, {got.shape[0]} epochs: train loss within rtol "
          f"{rel.max():.3e} (<= 1e-4), {'MAP and MRR' if lp else 'F1'} within 1e-3")


def _mesh_regression_vs_unsharded(np, got: dict, ref: dict, name: str) -> None:
    """The 1 x 1 sharded regression result against the unsharded run's:
    train losses rtol 1e-4, val/test L1 and L1 ratio rtol 1e-3."""
    rel = np.abs(got["train_loss"] - ref["train_loss"]) / np.abs(ref["train_loss"])
    check(bool(np.all(rel <= 1e-4)), f"{name}: train loss differs from the unsharded run by "
                                     f"rtol {rel.max()} (epoch {int(rel.argmax())})")
    for k in REG_KEYS[1:]:
        check(bool(np.isclose(got[k], ref[k], rtol=1e-3, atol=0)),
              f"{name}: {k} {got[k]} differs from the unsharded run's {ref[k]}")
    print(f"{name} vs the unsharded run, {got['train_loss'].shape[0]} epochs: train loss within "
          f"rtol {rel.max():.3e} (<= 1e-4), val/test L1 and L1 ratio within rtol 1e-3")


def _mesh_path(torch, np, tk, cfg, l2_impl: str | None, name: str, unsharded: dict,
               epochs: int = MESH_EPOCHS) -> tuple:
    """One preset on the 1 x 1 mesh: the counted captured run (no kernel
    of ours: the sharded path's SpMMs are the segment sum and cuBLAS), the
    same through the loop's eager chunks on the same adapter (rows
    bitwise), and the rows against the unsharded run's
    (``unsharded[cfg.name]``, run once)."""
    from tmgcn_torch.configs.build import run_experiment

    regression = cfg.task == "regression"

    def run(**kw):
        with _l2_impl(l2_impl):
            return run_experiment(cfg, data_dir=DATA_DIR, n_epochs=epochs, verbose=False,
                                  device=DEVICE, **kw)

    def same(a, b):
        return _same_regression(np, a, b) if regression else np.array_equal(a, b, equal_nan=True)

    with _experiments_built_once():
        out, launches = _counted(tk, lambda: run(mesh_shape=(1, 1)))
        check(launches == (0,) * len(COUNTERS),
              f"{name}: the sharded path launched {COUNTED} {launches}; it runs no kernel "
              "of ours")
        (res,) = out["results"].values()
        if regression:
            check(bool(np.all(np.isfinite(res["train_loss"])))
                  and all(np.isfinite(res[k]) for k in REG_KEYS[1:]), f"{name}: not finite")
        else:
            (_check_lp_rows if cfg.task == "link_pred" else _check_rows)(np, res, name)
        with _eager_loop():
            eager = run(mesh_shape=(1, 1))
        (eager_res,) = eager["results"].values()
        check(same(eager_res, res), f"{name}: the captured loop's rows differ from the eager "
                                    "loop's")
        sec = out["seconds"]
        print(f"slice {name}: {epochs} epochs captured and eager (the same adapter), "
              f"rows bitwise equal; set-up data {sec['data']:.3f} s, adapter "
              f"{sec['adapter']:.3f} s; train captured {sec['train']:.3f} s, eager "
              f"{eager['seconds']['train']:.3f} s")
        if cfg.name not in unsharded:
            ref_logits = []
            with _recorded_evals(ref_logits):
                ref = run()
            unsharded[cfg.name] = (next(iter(ref["results"].values())), ref_logits)
    ref_res, ref_logits = unsharded[cfg.name]
    if regression:
        _mesh_regression_vs_unsharded(np, res, ref_res, name)
    else:
        _mesh_rows_vs_unsharded(np, cfg, res, ref_res, ref_logits, name)
    return launches


def _start_torchrun_cli(cfg, out_dir: str):
    """Start ``torchrun --standalone --nproc-per-node 1 -m tmgcn_torch.cli
    run <preset> --mesh graph=1,time=1`` in its own session (it runs while
    the phase's paths do); ``_check_torchrun_cli`` waits for it."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1", "-m", "tmgcn_torch.cli", "run", cfg.name,
            "--data-dir", DATA_DIR, "--mesh", "graph=1,time=1", "--epochs",
            str(MESH_CLI_EPOCHS), "--quiet", "--out", out_dir]
    return subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True), time.perf_counter()


def _check_torchrun_cli(np, cfg, started, out_dir: str, card: str) -> None:
    """Exit code 0 and the rows of the same 1 x 1 run in this process; the
    launched process group is killed past the timeout."""
    import pickle

    from tmgcn_torch.configs.build import run_experiment

    proc, t0 = started
    try:
        log, _ = proc.communicate(timeout=MESH_CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        check(False, f"torchrun {cfg.name}: no exit within {MESH_CLI_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"torchrun {cfg.name} exited {proc.returncode}:\n{log[-3000:]}")
    (pkl,) = Path(out_dir).glob("results_*.pkl")
    with open(pkl, "rb") as f:
        cli_rows = pickle.load(f)
    here = run_experiment(cfg, data_dir=DATA_DIR, n_epochs=MESH_CLI_EPOCHS, verbose=False,
                          device=DEVICE, mesh_shape=(1, 1))
    rows = next(iter(here["results"].values()))
    check(np.array_equal(cli_rows, rows, equal_nan=True),
          f"torchrun {cfg.name}: rows differ from the in-process 1 x 1 run: max abs diff "
          f"{np.nanmax(np.abs(cli_rows - rows))}")
    print(f"torchrun --nproc-per-node 1 cli run {cfg.name} --mesh graph=1,time=1 --epochs "
          f"{MESH_CLI_EPOCHS}: exit 0, {wall:.1f} s from its start (process start, data, "
          f"build, training; beside this phase's paths), rows bitwise the in-process "
          f"run's [{card}]")


def _mesh_step_profile(torch, cfg, card: str) -> None:
    """chess_tmgcn_cls at 1 x 1 against its unsharded path: set-up seconds
    (the mesh's groups, data, adapter); collectives issued by one eager
    evaluation step and one eager plain step; plain epochs captured and
    eager, sharded and unsharded, timed in turns; a traced captured chunk
    of each: device ms per epoch, and the NCCL kernels' count and device
    ms per epoch."""
    from tmgcn_torch.configs.build import build_experiment, train_config, trial_chunks
    from tmgcn_torch.parallel import collectives, distributed
    from tmgcn_torch.parallel.mesh import make_mesh
    from tmgcn_torch.train import loop
    from tmgcn_torch.utils import profile_slice

    t0 = time.perf_counter()
    mesh = make_mesh(1, 1, device=distributed.initialize(DEVICE))
    t_mesh = time.perf_counter() - t0
    sharded = build_experiment(cfg, DATA_DIR, device=DEVICE, mesh=mesh)
    plain = build_experiment(cfg, DATA_DIR, device=DEVICE)
    print(f"{cfg.name} 1 x 1 set-up: mesh groups {t_mesh:.3f} s, data "
          f"{sharded.seconds['data']:.3f} s, sharded adapter {sharded.seconds['adapter']:.3f} s "
          f"(unsharded {plain.seconds['adapter']:.3f} s) [{card}]")
    tcfg, alpha = train_config(cfg), cfg.alpha_vec[0]

    chunks = trial_chunks(sharded, tcfg, alpha, torch.Generator().manual_seed(0))
    eager = loop._EagerChunks(chunks.step, chunks.plain.step)
    calls = {}
    for what, plain_step in (("evaluation step", False), ("plain step", True)):
        collectives.CALLS.clear()
        eager(1, plain=plain_step)
        calls[what] = dict(collectives.CALLS)
    print(f"{cfg.name} 1 x 1 collectives issued a step: {json.dumps(calls)}")

    def runner(exp, eager=False):
        return profile_slice.chunk_runner(exp, tcfg, alpha, torch.Generator().manual_seed(0),
                                          eager)

    times = profile_slice.timed_chunks({
        "sharded captured": runner(sharded), "sharded eager": runner(sharded, eager=True),
        "unsharded captured": runner(plain), "unsharded eager": runner(plain, eager=True),
    }, TIMED_PROBE)
    _print_times(f"{cfg.name} 1 x 1 plain epochs,", times, card)
    n = profile_slice.TRACED_EPOCHS
    for what, exp in (("sharded", sharded), ("unsharded", plain)):
        run = runner(exp)
        run(n).cpu()  # the warm-up step and the capture
        traced, avg = profile_slice.trace(lambda: run(n).cpu(), n)
        check(traced["device_ms_per_profiled_epoch"] > 0, f"{what}: the trace shows no device time")
        nccl = [e for e in avg if "nccl" in e.key.lower()
                and e.device_type == torch.autograd.DeviceType.CUDA]
        print(f"{cfg.name} 1 x 1 {what} traced, {n} captured plain epochs: device "
              f"{traced['device_ms_per_profiled_epoch']:.6f} ms per epoch, busy share "
              f"{traced['device_busy_share']:.4f}, NCCL kernels "
              f"{sum(e.count for e in nccl) / n:.1f} per epoch "
              f"({sum(e.self_device_time_total for e in nccl) / 1e3 / n:.6f} ms); device ms by "
              f"kernel {json.dumps(traced['device_ms_by_kernel'])} [{card}]")


def phase_mesh(torch, np, tk, card: str) -> dict[str, tuple]:
    """7p: the (graph x time) mesh on one card, NCCL, 1 x 1."""
    from tmgcn_torch.configs.presets import get_preset

    counts, unsharded = {}, {}
    tm1 = dataclasses.replace(get_preset("chess_tmgcn_cls"), spmm_impl="pallas")
    paths = (
        (tm1, None, "chess_tmgcn_cls (pallas) 1 x 1"),
        (get_preset("chess_tmgcn2_cls"), "gather", "chess_tmgcn2_cls 1 x 1, layer 2 gather"),
        (get_preset("chess_tmgcn2_cls"), "blockdense",
         "chess_tmgcn2_cls 1 x 1, layer 2 blockdense"),
        (get_preset("chess_tmgcn_lp"), None, "chess_tmgcn_lp 1 x 1"),
        (get_preset("chess_gcn_cls"), None, "chess_gcn_cls 1 x 1"),
    )
    Path("build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as out_dir:
        cli = _start_torchrun_cli(tm1, out_dir)
        try:
            for cfg, l2_impl, name in paths:
                counts[name] = _mesh_path(torch, np, tk, cfg, l2_impl, name, unsharded)
                gc.collect()
                torch.cuda.empty_cache()
            _check_torchrun_cli(np, tm1, cli, out_dir, card)
        finally:
            if cli[0].poll() is None:  # a failed path: stop the launched run too
                os.killpg(cli[0].pid, signal.SIGKILL)
                cli[0].communicate()
    _mesh_step_profile(torch, tm1, card)
    return counts


def _mesh_resume(torch, np, tk) -> tuple:
    """chess_tmgcn_cls on the 1 x 1 mesh with checkpoints (rank 0, this
    process, writes; a barrier after each save): 200 epochs uninterrupted,
    101 saving at its evaluation epochs 0 and 100, then resumed to 200
    from the newest: rows 0-100 the uninterrupted run's, the train columns
    from 101 on bitwise; no kernel of ours in either run."""
    import shutil

    from tmgcn_torch.configs.build import run_experiment, run_tag
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.train.checkpoint import RunCheckpointer

    cfg = get_preset("chess_tmgcn_cls")
    name = "chess_tmgcn_cls 1 x 1, resumed"
    root = Path(CKPT_DIR) / "mesh"
    shutil.rmtree(root, ignore_errors=True)

    def run(n, ck=None):
        out, launches = _counted(tk, lambda: run_experiment(
            cfg, data_dir=DATA_DIR, n_epochs=n, verbose=False, device=DEVICE, mesh_shape=(1, 1),
            checkpoint_dir=ck))
        check(launches == (0,) * len(COUNTERS), f"{name}: launched {COUNTED} {launches}")
        return next(iter(out["results"].values())), launches

    try:
        with _experiments_built_once():
            full, launches = run(MESH_EPOCHS)
            part, _ = run(RESUME_SAVED, root)
            ck = RunCheckpointer(root / cfg.name / run_tag(0, cfg.alpha_vec[0]))
            check(ck.latest_epoch() == RESUME_SAVED - 1,
                  f"{name}: newest checkpoint {ck.latest_epoch()}, not {RESUME_SAVED - 1}")
            resumed, _ = run(MESH_EPOCHS, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(np.array_equal(part, full[:RESUME_SAVED], equal_nan=True),
          f"{name}: the interrupted run's rows differ from the uninterrupted run's")
    check(np.array_equal(resumed[:RESUME_SAVED], full[:RESUME_SAVED], equal_nan=True),
          f"{name}: the restored rows differ from the uninterrupted run's")
    check(np.array_equal(resumed[RESUME_SAVED:, :4], full[RESUME_SAVED:, :4], equal_nan=True),
          f"{name}: train columns from {RESUME_SAVED} on differ from the uninterrupted run's: "
          f"max abs diff {np.nanmax(np.abs(resumed[:, :4] - full[:, :4]))}")
    print(f"{name}: {RESUME_SAVED} epochs saving at 0 and {RESUME_SAVED - 1}, resumed to "
          f"{MESH_EPOCHS}: rows 0-{RESUME_SAVED - 1} and train columns {RESUME_SAVED}-"
          f"{MESH_EPOCHS - 1} bitwise the uninterrupted sharded run's; 0 kernel launches")
    return launches


def phase_mesh_recurrent(torch, np, tk) -> dict[str, tuple]:
    """7q: the recurrent families and regression on the 1 x 1 NCCL mesh,
    and a sharded run resumed from its checkpoint."""
    from tmgcn_torch.configs.presets import get_preset

    counts, unsharded = {}, {}
    for preset in MESH_RECURRENT_PRESETS:
        cfg = get_preset(preset)
        name = f"{preset} 1 x 1"
        counts[name] = _mesh_path(torch, np, tk, cfg, None, name, unsharded,
                                  epochs=MESH_RECURRENT_EPOCHS)
        gc.collect()
        torch.cuda.empty_cache()
    counts["chess_tmgcn_cls 1 x 1, resumed"] = _mesh_resume(torch, np, tk)
    return counts


def _registry_cfg(name: str):
    """The preset as phase 7r runs it: TM-GCN and KW-GCN on "pallas"."""
    from tmgcn_torch.configs.presets import get_preset

    cfg = get_preset(name)
    if cfg.method in ("tmgcn", "gcn"):
        cfg = dataclasses.replace(cfg, spmm_impl="pallas")
    return cfg


def _registry_launches(cfg, epochs: int, setup: bool = True) -> tuple:
    """The K1 launches of the set-up (without ``setup``: none) and a run of
    ``epochs`` (the other counters 0), by family: TM-GCN and KW-GCN 3 at
    set-up (each window's cached propagation), and uci_tmgcn_lp's full-row
    layer 2 3 a step (forward, backward on the transposed packing, the
    readout plan's backward) and a val and a test forward at each
    evaluation; WD-GCN the readout plan's backward once a step; EvolveGCN-H
    none (gather-free on every registry preset: ``_check_registry_path``)."""
    n_evals = -(-epochs // cfg.eval_every)
    k1 = {"tmgcn": 3 * setup + (3 * epochs + 2 * n_evals if cfg.n_layers == 2 else 0),
          "gcn": 3 * setup, "wdgcn": epochs, "evolvegcn": 0}[cfg.method]
    return (k1,) + (0,) * (len(COUNTERS) - 1)


def _check_registry_path(cfg, exp, path: str) -> None:
    """The operator each family's launches assume: K1's packing for TM-GCN
    and KW-GCN (uci_tmgcn_lp: full-row layer 2, not restricted), the
    readout plan for WD-GCN, the gather-free readout for EvolveGCN-H."""
    from tmgcn_torch.kernels.spmm_cuda import PallasSpmmOperator

    bundle = exp.adapter.bundles["train"]
    if cfg.method in ("tmgcn", "gcn"):
        ok = isinstance(bundle["adj"], PallasSpmmOperator) and "l2op" not in bundle \
            and "l2s_op" not in bundle
    else:
        ok = ("readout" in bundle) == (cfg.method == "wdgcn")
    check(ok, f"{path}: the adapter took another path than its launches assume "
              f"(bundle keys {sorted(bundle)})")


@contextlib.contextmanager
def _numpy_runtime():
    """The native host runtime's three entry points replaced by their numpy
    plain versions (``np.loadtxt``'s columns, the vectorised splitmix64
    stream, the numpy packer): the same set-up, for its seconds beside the
    native runtime's."""
    from tmgcn_torch import native
    from tmgcn_torch.kernels import spmm_cuda
    from tmgcn_torch.preprocess import datasets
    from tmgcn_torch.tasks import sampling

    with mock.patch.multiple(native, parse_edges=datasets.parse_edges_numpy,
                             pack_chunks=spmm_cuda.pack_chunks_numpy,
                             sample_negatives=sampling.sample_negatives_splitmix64):
        yield


def _same_setup(torch, np, a, b) -> bool:
    """Two experiments of one config built alike: the host data bitwise
    and each window's K1 packings (device tensors) equal."""
    from tmgcn_torch.kernels.spmm_cuda import PallasSpmmOperator

    da, db = a.data, b.data
    fields = ("M", "edge_index", "edge_values", "lp_edges", "lp_labels")
    same = all((getattr(da, f) is None and getattr(db, f) is None)
               or np.array_equal(getattr(da, f), getattr(db, f)) for f in fields)
    for w in ("train", "val", "test"):
        same &= np.array_equal(da.feats[w], db.feats[w])
        same &= all(np.array_equal(getattr(da.adj[w], f), getattr(db.adj[w], f))
                    for f in ("rows", "cols", "vals", "nnz"))
        op_a, op_b = a.adapter.bundles[w]["adj"], b.adapter.bundles[w]["adj"]
        if isinstance(op_a, PallasSpmmOperator):
            for side in ("packed", "packed_t"):
                pa, pb = getattr(op_a, side), getattr(op_b, side)
                same &= all(torch.equal(getattr(pa, f), getattr(pb, f))
                            for f in ("rows", "cols", "vals", "window_id", "entry_order"))
    return bool(same)


def _k1_full_row(torch, tk, op, side: str, what: str) -> dict:
    """K1 at a full-row layer 2's packing (``side`` "packed": the forward;
    "packed_t": the backward's transposed packing), F = 6 random input
    rows, against its plain version and torch.sparse.mm, timed beside its
    bound."""
    dev = torch.device(DEVICE)
    p = getattr(op, side)
    n = op.T * op.N
    Y = torch.randn(n, 6, device=dev, generator=torch.Generator(device=dev).manual_seed(11))
    g = tk.gather_chunks(Y, p)
    nnz = int(p.entry_order.numel())
    f32 = torch.float32

    def run():
        return tk.windowed_segment_matmul(p, g, out_dtype=f32)

    def plain():
        return tk.windowed_segment_matmul_reference(p, g, out_dtype=f32)

    err = _check_same(torch, run, plain, what)
    S = _packing_csr(torch, p, n)
    lib_err, tol = _max_err(run()[:n], torch.sparse.mm(S, Y)[:n])
    check(lib_err <= tol, f"{what} vs torch.sparse.mm: {lib_err} > {tol}")
    shape = (f"{op.T} x {op.N} rows, F=6, nnz {nnz} in {p.n_chunks} chunks of {p.chunk} "
             f"({p.rows.numel()} slots)")
    print(f"{what}: J={p.n_chunks} C={p.chunk} W={p.window} F=6 nnz={nnz} "
          f"n_rows_out={p.n_rows_out} ({shape})")
    row = _report(torch, what, run, plain, lambda: torch.sparse.mm(S, Y), _bound(p, 6, nnz, False))
    return {**row, "max_abs_err": err, "shape": shape}


def _check_diverging_lp_rows(np, res, what: str) -> None:
    """(epochs, 9) rows of a link-prediction run that diverges: the loss
    finite up to its first non-finite epoch (past the epochs held against
    the CPU) and non-finite from there on; MAP and MRR in [0, 1] or NaN in
    the rows before it (after it they score non-finite logits)."""
    loss = res[:, 2]
    bad = np.flatnonzero(~np.isfinite(loss))
    first = int(bad[0]) if len(bad) else len(loss)
    check(first >= REF_EPOCHS and bool(np.all(~np.isfinite(loss[first:]))),
          f"{what}: the loss is not finite up to one epoch and non-finite after it")
    rates = res[:, [0, 1, 3, 4, 6, 7]]
    ok = np.isnan(rates) | ((rates >= 0) & (rates <= 1))
    check(bool(np.all(ok[:first])), f"{what}: MAP or MRR outside [0, 1] before the divergence")
    print(f"{what}: the loss leaves float32's range at epoch {first} (epoch {first - 1}: "
          f"{loss[first - 1]:.6e}), as this preset diverges in both packages; MAP/MRR "
          f"after it in [{np.nanmin(rates[first:]) if first < len(loss) else 'none'}, "
          f"{np.nanmax(rates[first:]) if first < len(loss) else 'none'}]")


def _registry_cpu_refs(root: str, out: str) -> None:
    """Each phase-7r preset's first REF_EPOCHS on the CPU's plain path, at
    its first alpha, from the raw copies under ``root``: {name: (rows, the
    evaluation logits)} pickled to ``out``. Run by ``_start_registry_cpu_refs``
    in a process of its own, with no card."""
    import torch

    from tmgcn_torch.configs.build import run_experiment

    torch.set_num_threads(REGISTRY_CPU_THREADS)
    refs = {}
    for name in _registry_names():
        cfg = _registry_cfg(name)
        logits = []
        with _recorded_evals(logits):
            ref = run_experiment(cfg, data_dir=Path(root) / cfg.dataset, n_epochs=REF_EPOCHS,
                                 alpha_vec=cfg.alpha_vec[:1], verbose=False, device="cpu")
        (refs[name],) = ref["results"].values()
        refs[name] = (refs[name], logits)
    Path(out + ".tmp").write_bytes(pickle.dumps(refs))
    os.replace(out + ".tmp", out)


def _start_registry_cpu_refs(root: Path, out: Path):
    """``_registry_cpu_refs`` in a process of its own session that sees no
    card (it runs while the phase's paths do)."""
    code = "import sys, chip_smoke; chip_smoke._registry_cpu_refs(sys.argv[1], sys.argv[2])"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.Popen([sys.executable, "-c", code, str(root), str(out)], env=env,
                            cwd=os.getcwd(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)


def _registry_rows_vs_cpu(np, cfg, got, ref, data_dir, name: str) -> None:
    """The card's first REF_EPOCHS rows against the CPU plain path's
    (``ref``: rows and evaluation logits), at PERF.md §2's tolerances:
    losses rtol 1e-4; F1 within 1e-3 (EvolveGCN-H: val/test F1 in the tie
    range of the CPU's evaluation logits); MAP and MRR rtol 1e-3, NaN only
    where the CPU has NaN."""
    ref_res, ref_logits = ref
    got = got[:REF_EPOCHS]
    lp = cfg.task == "link_pred"
    losses = [2, 5, 8] if lp else [3, 7, 11]
    check(bool(np.allclose(got[:, losses], ref_res[:, losses], rtol=1e-4, atol=0)),
          f"{name}: losses differ from the CPU plain path: {got[:, losses]} vs "
          f"{ref_res[:, losses]}")
    if lp:
        rates = [0, 1, 3, 4, 6, 7]
        same_nan = np.isnan(got[:, rates]) == np.isnan(ref_res[:, rates])
        close = np.nan_to_num(np.abs(got[:, rates] - ref_res[:, rates])
                              - 1e-3 * np.abs(ref_res[:, rates]), nan=0.0) <= 0
        check(bool(np.all(same_nan & close)), f"{name}: MAP/MRR differ from the CPU plain path")
    elif cfg.method == "evolvegcn":
        _check_eval_f1_in_tie_range(np, cfg, got, ref_res, ref_logits, name, data_dir=data_dir)
    else:
        f1s = [2, 6, 10]
        same_nan = np.isnan(got[:, f1s]) == np.isnan(ref_res[:, f1s])
        close = np.nan_to_num(np.abs(got[:, f1s] - ref_res[:, f1s]), nan=0.0) <= 1e-3
        check(bool(np.all(same_nan & close)), f"{name}: F1 differs from the CPU plain path")


def _registry_names() -> list:
    """Phase 7r's presets, a dataset's TM-GCN presets first: they are the
    ones built again with the numpy plain versions, and the first build of
    a dataset parses its raw file on either side (the later ones load the
    .mat cache it writes)."""
    from tmgcn_torch.configs.presets import PRESETS

    return sorted((n for n, c in PRESETS.items() if c.dataset in REGISTRY_DATASETS),
                  key=lambda n: (PRESETS[n].dataset, PRESETS[n].method != "tmgcn", n))


def _registry_path(torch, np, tk, name: str, dirs: dict, card: str) -> tuple:
    """One preset of phase 7r: its experiment built with the native runtime
    (the one the runs use), and for TM-GCN again with the numpy plain
    versions (set-up seconds side by side, the two alike: a TM-GCN preset
    of each dataset and task runs the parser, the LP sampler and the
    packer); REGISTRY_EPOCHS captured epochs, counted; the eager loop on
    the same adapter (rows bitwise, launches exact); for REGISTRY_TIMED,
    plain epochs captured and eager timed in turns. Returns (launches, K1
    rows at uci_tmgcn_lp's full-row layer 2 or {}, the rows)."""
    from tmgcn_torch.configs import build
    from tmgcn_torch.utils import profile_slice

    cfg = _registry_cfg(name)
    data_dir = dirs["native"][cfg.dataset]
    path = f"{name} ({cfg.spmm_impl})"
    lp = cfg.task == "link_pred"
    build_plain = build.build_experiment
    k1_rows = {}
    with _experiments_built_once():
        def run(epochs):
            out = build.run_experiment(cfg, data_dir=data_dir, n_epochs=epochs,
                                       alpha_vec=cfg.alpha_vec[:1], verbose=False, device=DEVICE)
            (res,) = out["results"].values()
            return res, out["seconds"]["train"]

        # The set-up (the run reuses its experiment) and the run, counted.
        (exp, (res, t_train)), launches = _counted(tk, lambda: (
            build.build_experiment(cfg, data_dir, device=DEVICE), run(REGISTRY_EPOCHS)))
        _check_registry_path(cfg, exp, path)
        expected = _registry_launches(cfg, REGISTRY_EPOCHS)
        check(launches == expected, f"{path}: {COUNTED} launched {launches} times, expected "
                                    f"{expected}")
        if cfg.method == "tmgcn":
            with _numpy_runtime():
                plain = build_plain(cfg, dirs["numpy"][cfg.dataset], device=DEVICE)
            check(_same_setup(torch, np, exp, plain),
                  f"{path}: the native runtime's set-up differs from the numpy plain versions'")
            print(f"{path}: set-up s, native runtime / numpy plain versions: data "
                  f"{exp.seconds['data']:.6f} / {plain.seconds['data']:.6f}, adapter "
                  f"{exp.seconds['adapter']:.6f} / {plain.seconds['adapter']:.6f} (the same "
                  f"data and packings) [{card}]")
            del plain
        else:
            print(f"{path}: set-up s, native runtime: data {exp.seconds['data']:.6f}, adapter "
                  f"{exp.seconds['adapter']:.6f} (data 0 once its variant was built) [{card}]")
        check(res.shape[0] == REGISTRY_EPOCHS, f"{path}: results shape {res.shape}")
        if name in REGISTRY_DIVERGING:
            _check_diverging_lp_rows(np, res, f"{path} cuda run")
        else:
            (_check_lp_rows if lp else _check_rows)(np, res, f"{path} cuda run")
        n_eager = REGISTRY_EPOCHS if cfg.method in ("tmgcn", "gcn") else REGISTRY_EAGER_EPOCHS
        with _eager_loop():
            (eager, t_eager), eager_launches = _counted(tk, lambda: run(n_eager))
        check(np.array_equal(eager, res[:n_eager], equal_nan=True),
              f"{path}: the eager loop's rows differ from the captured loop's")
        check(eager_launches == _registry_launches(cfg, n_eager, setup=False),
              f"{path}: the eager loop launched {eager_launches}")
        print(f"slice {path}: {REGISTRY_EPOCHS} epochs captured, {COUNTED} launches {launches}; "
              f"train {t_train:.3f} s with the capture and {-(-REGISTRY_EPOCHS // cfg.eval_every)} "
              f"evaluations; eager {n_eager} epochs {t_eager:.3f} s, rows bitwise the captured "
              f"run's, launches {eager_launches}; final row "
              f"{np.array2string(res[-1], precision=6, max_line_width=400)} [{card}]")
        if name in REGISTRY_TIMED:
            alpha = cfg.alpha_vec[0]
            tcfg = build.train_config(cfg)

            def chunk(eager):
                return profile_slice.chunk_runner(exp, tcfg, alpha,
                                                  torch.Generator().manual_seed(cfg.seed), eager)

            times = profile_slice.timed_chunks({"captured": chunk(False), "eager": chunk(True)},
                                               TIMED_PROBE)
            _print_times(f"{path} plain epochs,", times, card)
        if name == "uci_tmgcn_lp":
            op = exp.adapter.bundles["train"]["adj"]
            k1_rows = {
                "uci_layer2_forward": _k1_full_row(torch, tk, op, "packed",
                                                   "K1 uci_tmgcn_lp full-row layer 2 forward"),
                "uci_layer2_backward": _k1_full_row(
                    torch, tk, op, "packed_t",
                    "K1 uci_tmgcn_lp full-row layer 2 backward (transposed packing)"),
            }
            # A forward a step and a val and a test forward an evaluation;
            # a backward a step.
            n_evals = -(-REGISTRY_EPOCHS // cfg.eval_every)
            k1_rows["uci_layer2_forward"]["launches_per_run"] = REGISTRY_EPOCHS + 2 * n_evals
            k1_rows["uci_layer2_backward"]["launches_per_run"] = REGISTRY_EPOCHS
        del exp
    gc.collect()
    torch.cuda.empty_cache()
    return launches, k1_rows, res


def _registry_sweep(torch, np, tk, dirs: dict, card: str) -> tuple:
    """``cli run`` of SWEEP_PRESET with its whole 21-alpha sweep at
    SWEEP_EPOCHS: a results pickle per alpha, seconds per alpha, and the
    CUDA graph captures of the sweep (the step is built, and captured, once
    per alpha)."""
    import shutil

    from tmgcn_torch import cli
    from tmgcn_torch.configs import build
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.train import loop

    cfg = get_preset(SWEEP_PRESET)
    seconds, captures = [], []
    run_trial, capture = build.run_trial, loop._CapturedChunks._capture

    def timed_trial(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_trial(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    def counted_capture(self):
        captures.append(1)
        return capture(self)

    out_dir = Path(REGISTRY_DIR) / "sweep_out"
    argv = ["run", SWEEP_PRESET, "--data-dir", str(dirs["native"][cfg.dataset]), "--epochs",
            str(SWEEP_EPOCHS), "--out", str(out_dir), "--quiet"]
    t0 = time.perf_counter()
    with mock.patch.object(build, "run_trial", timed_trial),             mock.patch.object(loop._CapturedChunks, "_capture", counted_capture):
        rc, launches = _counted(tk, lambda: cli.main(argv))
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli {' '.join(argv)} exited {rc}")
    pickles = sorted(out_dir.glob(f"results_{SWEEP_PRESET}_*.pkl"))
    check(len(pickles) == len(cfg.alpha_vec) == len(seconds) == 21,
          f"sweep: {len(pickles)} results and {len(seconds)} runs for {len(cfg.alpha_vec)} alphas")
    for pkl in pickles:
        _check_rows(np, pickle.loads(pkl.read_bytes()), f"sweep {pkl.name}")
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"sweep: cli run {SWEEP_PRESET} --epochs {SWEEP_EPOCHS}, {len(seconds)} alphas in "
          f"{wall:.3f} s (with the set-up): s per alpha median {statistics.median(seconds):.6f}, "
          f"first {seconds[0]:.6f}, max {max(seconds):.6f}; {len(captures)} CUDA graph captures "
          f"for the sweep (one per alpha: each run builds its step anew), {COUNTED} launches "
          f"{launches} [{card}]")
    return launches


def _start_debug_nans_cli():
    """``python -m tmgcn_torch.cli run seir_tmgcn_reg --debug-nans`` in its
    own session (it runs while the phase's paths do)."""
    argv = [sys.executable, "-m", "tmgcn_torch.cli", "run", "seir_tmgcn_reg", "--debug-nans",
            "--quiet"]
    return subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _check_debug_nans(torch, np, tk, proc, card: str) -> None:
    """The diverging preset's CLI exits non-zero with FloatingPointError at
    its first NaN (epoch 2 on the CPU, in both packages); then
    ``cli run chess_tmgcn_cls --debug-nans --epochs 20`` in process exits 0
    with the rows of the same run without the flag (captured)."""
    import shutil

    from tmgcn_torch import cli

    try:
        log, _ = proc.communicate(timeout=DEBUG_NANS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        check(False, f"cli run seir_tmgcn_reg --debug-nans ran past {DEBUG_NANS_TIMEOUT_S} s")
    tail = log.strip().splitlines()[-1] if log.strip() else ""
    check(proc.returncode != 0 and "FloatingPointError: NaN at epoch" in log,
          f"cli run seir_tmgcn_reg --debug-nans exited {proc.returncode}: {tail}")
    print(f"debug-nans: cli run seir_tmgcn_reg --debug-nans exited {proc.returncode}: {tail}")
    rows, times = {}, {}
    for flag in ([], ["--debug-nans"]):
        out_dir = Path(REGISTRY_DIR) / f"debug_nans_out{len(flag)}"
        argv = ["run", "chess_tmgcn_cls", "--data-dir", DATA_DIR, "--epochs",
                str(DEBUG_NANS_EPOCHS), "--out", str(out_dir), "--quiet", *flag]
        t0 = time.perf_counter()
        rc = cli.main(argv)
        times[bool(flag)] = time.perf_counter() - t0
        check(rc == 0, f"cli {' '.join(argv)} exited {rc}")
        (pkl,) = out_dir.glob("results_chess_tmgcn_cls_*.pkl")
        rows[bool(flag)] = pickle.loads(pkl.read_bytes())
        shutil.rmtree(out_dir, ignore_errors=True)
    check(np.array_equal(rows[True], rows[False], equal_nan=True),
          "cli run chess_tmgcn_cls --debug-nans: rows differ from the run without the flag")
    print(f"debug-nans: cli run chess_tmgcn_cls --epochs {DEBUG_NANS_EPOCHS} with --debug-nans "
          f"(eager, anomaly mode, a NaN check a step) exit 0 in {times[True]:.3f} s, rows bitwise "
          f"the captured run's ({times[False]:.3f} s) [{card}]")


def phase_registry(torch, np, tk, card: str) -> tuple[dict, dict]:
    """Phase 7r: the 32 presets of bitcoin_otc, bitcoin_alpha, reddit,
    amlsim (classification) and bitcoin_otc, bitcoin_alpha, reddit, uci
    (link prediction) x TM-GCN, KW-GCN, EvolveGCN-H, WD-GCN, each through
    ``_registry_path``, then their first epochs against the CPU's plain
    path; K1 at uci_tmgcn_lp's full-row layer 2; a bitcoin sweep through
    the CLI; ``--debug-nans``. The raw files are copied from data/synthetic/
    into REGISTRY_DIR three times (the native runtime's builds, the numpy
    plain versions' and the CPU references' write their .mat caches apart),
    and removed when the phase ends. Returns (launches by path, K1 rows)."""
    import shutil

    from tmgcn_torch.preprocess.datasets import REGISTRY

    names = _registry_names()
    check(len(names) == 32, f"registry presets: {len(names)}, expected 32")
    root = Path(REGISTRY_DIR)
    shutil.rmtree(root, ignore_errors=True)
    dirs = {}
    for side in ("native", "numpy", "cpu"):
        dirs[side] = {}
        for ds in REGISTRY_DATASETS:
            d = root / side / ds
            d.mkdir(parents=True)
            shutil.copy(Path("data/synthetic") / ds / REGISTRY[ds].filename, d)
            dirs[side][ds] = d
    counts, k1_rows, rows = {}, {}, {}
    refs_path = root / "cpu_refs.pkl"
    procs = [_start_registry_cpu_refs(root / "cpu", refs_path), _start_debug_nans_cli()]
    try:
        for name in names:
            launches, k1, rows[name] = _registry_path(torch, np, tk, name, dirs, card)
            counts[f"registry {name}"] = launches
            k1_rows.update(k1)
        counts["registry sweep"] = _registry_sweep(torch, np, tk, dirs, card)
        _check_debug_nans(torch, np, tk, procs[1], card)
        t0 = time.perf_counter()
        try:
            log, _ = procs[0].communicate(timeout=REGISTRY_CPU_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            check(False, f"the CPU references ran past {REGISTRY_CPU_TIMEOUT_S} s")
        check(procs[0].returncode == 0 and refs_path.exists(),
              f"the CPU references exited {procs[0].returncode}: {log[-4000:]}")
        print(f"registry: the CPU references (their own process, {REGISTRY_CPU_THREADS} threads) "
              f"done {time.perf_counter() - t0:.3f} s after the card's paths")
        refs = pickle.loads(refs_path.read_bytes())
        for name in names:
            cfg = _registry_cfg(name)
            path = f"{name} ({cfg.spmm_impl})"
            _registry_rows_vs_cpu(np, cfg, rows[name], refs[name], dirs["native"][cfg.dataset],
                                  path)
            print(f"slice {path} vs CPU plain path, {REF_EPOCHS} epochs: losses within rtol "
                  f"1e-4, " + ("MAP and MRR within rtol 1e-3" if cfg.task == "link_pred"
                               else "F1 within 1e-3 (or the tie range)"))
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        shutil.rmtree(root, ignore_errors=True)
    check(set(k1_rows) == {"uci_layer2_forward", "uci_layer2_backward"},
          "phase 7r: K1 was not timed at uci_tmgcn_lp's full-row layer 2")
    return counts, k1_rows


# The kernel counter (COUNTERS' index) of each branch of the full-row rule by
# precision class; block-dense is cuBLAS's and counts nothing.
AUTO_COUNTER = {("windowed", False): 0, ("windowed", True): 1, ("tiled", False): 3,
                ("tiled", True): 4, ("blockdense", False): None, ("blockdense", True): None}


def _auto_launches(cfg, exp, epochs: int) -> tuple:
    """The launches a run of ``epochs`` with the full-row auto operator
    makes, from each window's pick: TM-GCN propagates each window once at
    set-up; uci_tmgcn_lp's 2-layer model runs the train window's operator
    forward and backward a step (and the readout plan's K1 backward), and
    the val and test windows' forward at each evaluation; WD-GCN regression
    propagates the train window every step and val and test once."""
    counts = [0] * len(COUNTERS)
    b = {w: exp.adapter.bundles[w] for w in ("train", "val", "test")}
    n_evals = -(-epochs // cfg.eval_every)
    if cfg.task == "regression":
        per_window = {"train": epochs, "val": 1, "test": 1}
    elif cfg.n_layers == 2:
        per_window = {"train": 1 + 2 * epochs, "val": 1 + n_evals, "test": 1 + n_evals}
        counts[0] += epochs  # the readout plan's backward, K1 float32
    else:
        per_window = {"train": 1, "val": 1, "test": 1}
    for w, n in per_window.items():
        pick = b[w]["op_choice"]
        i = AUTO_COUNTER[(pick["branch"], pick["bf16"])]
        if i is not None:
            counts[i] += n
    return tuple(counts)


def _hold_auto_pick(torch, np, exp, name: str) -> float:
    """The train window's picked operator, forward and backward at the
    widths the path applies it at, against the rule's other two candidates
    (built here, in the pick's precision class) and the plain segment sum
    (``spmm`` "jnp", float32): float32 at 1e-5 * max(1, |ref|), the bf16
    tiers at 2e-2 of the output's scale. Returns the largest error."""
    from tmgcn_torch.ops.spmm import spmm
    from tmgcn_torch.utils import kernel_probe

    dev = torch.device(DEVICE)
    bundle = exp.adapter.bundles["train"]
    pick, op = bundle["op_choice"], bundle["adj"]
    A = exp.data.adj["train"]
    if exp.cfg.task == "link_pred":  # the model's input drops the last slice
        A = A.slice_window(0, A.n_slices - 1)
    sfx = "_bf16" if pick["bf16"] else ""
    others = {b: kernel_probe.candidate(A, c + sfx).to(dev)
              for b, c in (("windowed", "k1"), ("tiled", "k3"), ("blockdense", "blockdense"))
              if b != pick["branch"]}
    A_dev = A.to(dev)
    widths = sorted({int(bundle["X"].shape[-1])} | (
        {exp.cfg.hidden_feat[0]} if exp.cfg.n_layers == 2 else set()))
    worst = 0.0
    for F in widths:
        gen = torch.Generator(device=dev).manual_seed(F)
        X = torch.randn(A.n_slices, A.n_nodes, F, device=dev, generator=gen)
        G = torch.randn(A.n_slices, A.n_nodes, F, device=dev, generator=gen)

        def fwd_bwd(f):
            x = X.detach().requires_grad_(True)
            y = f(x)
            return y.detach(), torch.autograd.grad(y, x, G)[0]

        got = fwd_bwd(op)
        refs = {**{b: fwd_bwd(o) for b, o in others.items()},
                "plain segment sum": fwd_bwd(lambda x: spmm(A_dev, x))}
        for ref_name, ref in refs.items():
            for side, a, r in (("forward", got[0], ref[0]), ("backward", got[1], ref[1])):
                err = float((a - r).abs().max())
                scale = max(1.0, float(r.abs().max()))
                tol = (2e-2 if pick["bf16"] else ATOL) * scale
                check(err <= tol, f"{name}: the picked {pick['branch']} operator's {side} at "
                                  f"F = {F} differs from {ref_name}: {err} > {tol}")
                worst = max(worst, err)
        print(f"{name}: the picked {pick['branch']}{sfx} operator at F = {F}, forward and "
              f"backward, within tolerance of {', '.join(refs)} (train window, "
              f"{A.n_slices} x {A.n_nodes} rows)")
    del others, A_dev
    return worst


def _auto_rows_vs_pallas(np, cfg, got, ref, name: str) -> None:
    """The auto run's rows against the same preset's pallas run (7r's
    tolerances): losses rtol 1e-4; F1 within 1e-3; MAP and MRR rtol 1e-3;
    regression L1 and L1 ratio rtol 1e-3. A diverging preset is held where
    the pallas loss is finite and under 1e6 (the blow-up amplifies the two
    operators' rounding), and to "finite, then non-finite"."""
    if cfg.task == "regression":
        check(bool(np.allclose(got["train_loss"], ref["train_loss"], rtol=1e-4, atol=0)),
              f"{name}: losses differ from the pallas run's")
        for k in REG_KEYS[1:]:
            check(bool(np.isclose(got[k], ref[k], rtol=1e-3, atol=0)),
                  f"{name}: {k} {got[k]} differs from the pallas run's {ref[k]}")
        return
    lp = cfg.task == "link_pred"
    losses, rates = ([2, 5, 8], [0, 1, 3, 4, 6, 7]) if lp else ([3, 7, 11], [2, 6, 10])
    keep = np.all(np.isfinite(ref[:, losses]) & (np.abs(ref[:, losses]) < 1e6), axis=1)
    if name.split()[0] in REGISTRY_DIVERGING:
        _check_diverging_lp_rows(np, got, f"{name} cuda run")
        check(int(keep.sum()) >= REF_EPOCHS, f"{name}: fewer than {REF_EPOCHS} finite epochs")
    else:
        check(bool(keep.all()), f"{name}: the pallas run's losses are not all finite")
    g, r = got[keep], ref[keep]
    check(bool(np.allclose(g[:, losses], r[:, losses], rtol=1e-4, atol=0)),
          f"{name}: losses differ from the pallas run's")
    same_nan = np.isnan(g[:, rates]) == np.isnan(r[:, rates])
    diff = np.nan_to_num(np.abs(g[:, rates] - r[:, rates]), nan=0.0)
    close = diff - (1e-3 * np.abs(np.nan_to_num(r[:, rates])) if lp else 1e-3) <= 0
    check(bool(np.all(same_nan & close)),
          f"{name}: {'MAP/MRR' if lp else 'F1'} differ from the pallas run's")


def _auto_path(torch, np, tk, preset: str, impl: str, data_dir, card: str) -> tuple:
    """One path of phase 7s: the experiment built with spmm_impl ``impl``
    (counted from its set-up), its picks printed, the train window's pick
    held against the other candidates, AUTO_EPOCHS captured epochs with
    the launches each pick predicts, and the rows against the same
    preset's pallas (bf16: pallas_bf16) run. Returns (launches, the train
    window's pick, the largest error)."""
    from tmgcn_torch.configs import build
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.ops import spmm as spmm_ops
    from tmgcn_torch.tasks import adapters

    cfg = dataclasses.replace(get_preset(preset), spmm_impl=impl)
    name = f"{preset} ({impl})"

    def run(c):
        out = build.run_experiment(c, data_dir=data_dir, n_epochs=AUTO_EPOCHS,
                                   alpha_vec=c.alpha_vec[:1], verbose=False, device=DEVICE)
        (res,) = out["results"].values()
        return res

    with _experiments_built_once():
        (exp, res), launches = _counted(tk, lambda: (
            build.build_experiment(cfg, data_dir, device=DEVICE), run(cfg)))
        for w, b in adapters._unique_windows(exp.adapter.bundles):
            pick = b["op_choice"]
            check(pick["branch"] in ("windowed", "tiled", "blockdense"),
                  f"{name}: the {w} window's operator was not packed on the card ({pick})")
            print(f"{name} {w} window: picked {pick['branch']}"
                  f"{' bf16' if pick['bf16'] else ''}, block-dense ratio "
                  f"{pick['blockdense_ratio']:.6f} (limit {spmm_ops.AUTO_BLOCKDENSE_RATIO}), "
                  f"K3/K1 model ratio {pick['tiled_ratio']:.6f} (limit "
                  f"{spmm_ops.AUTO_TILED_RATIO})"
                  f"{', block tensor over its budget' if pick['over_budget'] else ''} [{card}]")
        expected = _auto_launches(cfg, exp, AUTO_EPOCHS)
        check(launches == expected, f"{name}: {COUNTED} launched {launches} times, expected "
                                    f"{expected} from the picks")
        err = _hold_auto_pick(torch, np, exp, name)
        pick = exp.adapter.bundles["train"]["op_choice"]
        ref_cfg = dataclasses.replace(cfg, spmm_impl="pallas_bf16" if impl == "auto_bf16"
                                      else "pallas")
        ref = run(ref_cfg)
        del exp
    _auto_rows_vs_pallas(np, cfg, res, ref, name)
    print(f"slice {name}: {AUTO_EPOCHS} epochs captured, {COUNTED} launches {launches} as the "
          f"picks predict; rows within 7r's tolerances of the {ref_cfg.spmm_impl} run's [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, pick, err


def phase_auto(torch, np, tk, card: str) -> tuple[dict, dict]:
    """Phase 7s: AUTO_PATHS through ``_auto_path``. Returns (launches by
    path, {path: the train window's pick})."""
    import shutil

    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.preprocess.datasets import REGISTRY

    t0 = time.perf_counter()
    root = Path(AUTO_DIR)
    shutil.rmtree(root, ignore_errors=True)
    (root / "uci").mkdir(parents=True)
    shutil.copy(Path("data/synthetic/uci") / REGISTRY["uci"].filename, root / "uci")
    dirs = {"chess": DATA_DIR, "uci": root / "uci", "seir": None}
    counts, picks, worst = {}, {}, 0.0
    try:
        for preset, impl in AUTO_PATHS:
            data_dir = dirs[get_preset(preset).dataset]
            launches, pick, err = _auto_path(torch, np, tk, preset, impl, data_dir, card)
            counts[f"auto {preset} ({impl})"] = launches
            picks[f"{preset} ({impl})"] = pick
            worst = max(worst, err)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    print(f"phase 7s: {len(AUTO_PATHS)} auto paths in {seconds:.1f} s (budget {AUTO_BUDGET_S} s); "
          f"largest error of a pick against the other candidates and the plain sum {worst:.3e}")
    check(seconds <= AUTO_BUDGET_S, f"phase 7s took {seconds:.1f} s, over {AUTO_BUDGET_S} s")
    return counts, picks


def _print_times(what: str, times: dict, card: str, unit: str = "epoch") -> None:
    for name, t in times.items():
        print(f"{what} {name}: {t['median_ms']:.6f} ms per {unit} (median of {t['rounds']} "
              f"rounds of {t['n_timed']}, {t['round_s']:.3f} s a round; best {t['best_ms']:.6f}, "
              f"max {t['max_ms']:.6f}, "
              f"spread {t['run_spread']:.4f}) [{card}]")


def phase_capture_timing(torch, card: str) -> dict:
    """Each timed path's plain epochs, captured (as the loop runs them) and
    eager (the loop's reference chunks), timed in turns in this process as
    bench.py times a chunk (profile_slice.timed_chunks); then a warm captured
    chunk traced as profile_slice traces it: device ms per epoch and the
    device's busy share. Returns {path: {"times", "trace"}}."""
    from tmgcn_torch.utils import profile_slice

    out = {}
    n = profile_slice.TRACED_EPOCHS
    for preset, impl in TIMED_PATHS:
        cfg, _, make_chunk = profile_slice.build_runner(preset, impl)
        path = f"{preset} ({cfg.spmm_impl})"
        # Rounds of at least 0.25 s from a probe of TIMED_PROBE epochs: the
        # slow eager sides (40-130 ms an epoch) need no longer probe.
        times = profile_slice.timed_chunks({"captured": make_chunk(),
                                            "eager": make_chunk(eager=True)}, TIMED_PROBE)
        _print_times(f"{path} plain epochs,", times, card)
        chunk = make_chunk()
        chunk(n).cpu()  # the warm-up step and the capture
        traced, _ = profile_slice.trace(lambda: chunk(n).cpu(), n)
        check(traced["device_ms_per_profiled_epoch"] > 0, f"{path}: the trace shows no device time")
        print(f"{path} traced, {n} captured plain epochs: device "
              f"{traced['device_ms_per_profiled_epoch']:.6f} ms per epoch (the profiler's "
              f"kernel time; CUDA events around the chunk "
              f"{traced['event_ms_per_profiled_epoch']:.6f}), busy share "
              f"{traced['device_busy_share']:.4f}, wall "
              f"{traced['profiled_wall_ms'] / n:.6f} ms per epoch, "
              f"{traced['launch_calls_per_profiled_epoch']:.1f} kernel and "
              f"{traced['graph_launches_per_profiled_epoch']:.1f} graph launch calls per epoch; "
              f"device ms by kernel {json.dumps(traced['device_ms_by_kernel'])} [{card}]")
        out[path] = {"times": times, "trace": traced}
        del chunk, make_chunk
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        sys.exit(f"chip_smoke: FAIL: {e}")
    check(torch.cuda.is_available(), "CUDA is not available: this smoke run needs an NVIDIA card")
    try:
        from tmgcn_torch.kernels import spmm_cuda as tk
        from tmgcn_torch.utils import scale_bench
    except ImportError as e:
        sys.exit(f"chip_smoke: FAIL: run from the root of a tmgcn checkout ({e})")
    check("jax" not in sys.modules, "jax was imported")
    with _data_loaded_once():
        return _phases(np, torch, tk, scale_bench)


def _phases(np, torch, tk, scale_bench) -> int:
    t_start = time.perf_counter()
    card = phase_card()
    with _timed("build"):
        phase_build()
    with _timed("K1"):
        k1, e_train = phase_k1(torch, np)
        k1["lp_readout_backward"], lp_err = phase_k1_lp(torch, np)
        kwgcn2, kw_err = phase_k1_kwgcn(torch, np)
        k1.update(kwgcn2)
        k1["seir_wdgcn_reg"], seir_err = phase_k1_seir(torch, np)
        k1["max_abs_err"] = max(k1["max_abs_err"], lp_err, kw_err, seir_err)
    t0 = time.perf_counter()
    inputs = scale_bench.build_inputs(**SCALE)
    t_scale_build = time.perf_counter() - t0
    with _timed("K2"):
        k2 = phase_k2(torch, np, inputs[3])
    with _timed("K1 bf16 and the restricted operators"):
        k1_bf16, restricted = phase_restricted(torch, np)
        k1.update(restricted_forward=restricted["k1_f32_forward"],
                  restricted_backward=restricted["k1_f32_backward"])
    with _timed("K3"):
        k3, k3_bf16 = phase_k3(torch, np)
    with _timed("fast tiers"):
        k1_fast, k3_fast, k1_spmm_bench, fast_counts = phase_fast(torch, np, tk)
        k1.update(k1_spmm_bench)
    with _timed("LSTM scan"):
        scan = phase_lstm_scan(torch)
    with _timed("paths: TM-GCN 1 layer, WD-GCN chess"):
        by_path = {"chess_tmgcn_cls pallas": phase_tmgcn(torch, np, tk, e_train)}
        by_path.update(phase_wdgcn_chess(torch, np, tk, e_train))
    for fam, _ in SCALE_FAMILIES:
        with _timed(f"paths: {fam} scale"):
            by_path[f"{fam} scale 500k x 64"], _ = phase_scale(torch, np, tk, fam, inputs,
                                                                t_scale_build, card)
    for name, phase in (("TM-GCN 2 layers", phase_tmgcn2), ("link prediction", phase_lp)):
        with _timed(f"paths: {name}"):
            by_path.update(phase(torch, np, tk))
    for name, phase in (("KW-GCN", phase_gcn), ("EvolveGCN", phase_evolvegcn)):
        with _timed(f"paths: {name}"):
            by_path.update(phase(torch, np, tk, e_train))
    with _timed("paths: regression and SBM"):
        by_path.update(phase_synthetic(torch, np, tk))
    with _timed("resume: checkpoints, resume and predict"):
        by_path.update(phase_resume(torch, np, tk, card))
    with _timed("streamed layer 2 and the generic 1-layer TM-GCN"):
        streamed_counts, k1_scale = phase_streamed(torch, np, tk, inputs, t_scale_build, card)
        by_path.update(streamed_counts)
        k1.update(k1_scale)
        k1["max_abs_err"] = max(k1["max_abs_err"], *(r["max_abs_err"] for r in k1_scale.values()))
    with _timed("mesh: 1 x 1 on NCCL"):
        by_path.update(phase_mesh(torch, np, tk, card))
    with _timed("mesh: recurrent families, regression and resume at 1 x 1"):
        by_path.update(phase_mesh_recurrent(torch, np, tk))
    with _timed("registry: the 32 presets of the other datasets"):
        registry_counts, k1_registry = phase_registry(torch, np, tk, card)
        by_path.update(registry_counts)
        k1.update(k1_registry)
        k1["max_abs_err"] = max(k1["max_abs_err"], *(r["max_abs_err"] for r in k1_registry.values()))
    with _timed("auto: the full-row auto operator"):
        auto_counts, auto_picks = phase_auto(torch, np, tk, card)
        by_path.update(auto_counts)
    by_path.update(fast_counts)
    with _timed("capture timing"):
        profiles = phase_capture_timing(torch, card)
    check("jax" not in sys.modules and "tmgcn_tpu" not in sys.modules,
          "the JAX package was imported")
    kernels = (k1, k1_bf16, k2, k3, k3_bf16, k1_fast, k3_fast)
    k1["auto_picks"] = auto_picks
    for i, k in enumerate(kernels):
        k["launches"] = sum(c[i] for c in by_path.values())
        k["launches_by_path"] = {path: c[i] for path, c in by_path.items() if c[i]}
        check(k["launches"] > 0, f"{k['name']} was launched no time on the main paths")
    # The LSTM scan on each main path: a forward, a backward and a reduction
    # a training step and a forward an evaluation window on every WD-GCN
    # path (chess_wdgcn_cls's exact counts: phase_wdgcn_chess), none elsewhere.
    scan_by_path = {path: getattr(c, "scan", (0, 0, 0)) for path, c in by_path.items()}
    for path, (fwd, bwd, red) in scan_by_path.items():
        if "wdgcn" in path:
            check(bwd == red > 0 and fwd >= bwd,
                  f"{path}: LSTM scan launches (forward, backward, reduction) {(fwd, bwd, red)}, "
                  "expected one backward and one reduction a step and a forward each")
        else:
            check((fwd, bwd, red) == (0, 0, 0), f"{path} launched the LSTM scan: {(fwd, bwd, red)}")
    scan["launches"] = sum(map(sum, scan_by_path.values()))
    scan["launches_by_path"] = {path: n for path, n in scan_by_path.items() if any(n)}
    kernels += (scan,)
    print(f"restricted operator times (chess_tmgcn2_cls train window): "
          f"{json.dumps(restricted['operators'])}")
    print("device ms per captured plain epoch (traced): " + json.dumps(
        {path: p["trace"]["device_ms_per_profiled_epoch"] for path, p in profiles.items()}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("shape", "launches_by_path", "train_window", "lp_readout_backward", "restricted_forward",
             "restricted_backward", "kwgcn2_forward", "kwgcn2_backward", "seir_wdgcn_reg",
             "cached_propagation", "restricted_scale_forward", "streamed_group_scale_forward",
             "k1_at_scale_packing_ms", "uci_layer2_forward", "uci_layer2_backward",
             "readout_backward_ops_ms", "spmm_bench_r1", "spmm_bench_chess2", "auto_picks",
             "forward_ms")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {**{k: kern[k] for k in keys}, **{k: kern[k] for k in extra if k in kern}}
        for kern in kernels
    ]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
