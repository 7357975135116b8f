#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. Environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, whether nvcc and triton exist, the TF32 flags (matmul TF32
   must be off: the engine's top-k tie window is sized for f32 noise).
2. Build: compile ``kernels/csrc/fused_query.cu`` and
   ``kernels/csrc/level_ops.cu`` for sm_90a, one nvcc each, in parallel;
   print each kernel's registers, stack frame and spills, and the top-k
   instantiations' range of registers and total spill bytes.  Every fused
   instantiation, the streaming ones included, must have a 0-byte stack
   frame and no spills, the top-k ones at most 128 registers.  The ring
   stages the launcher chooses at each path tile (``stages_of_kernel``),
   the streaming forms' too.
3. Serving index: ``SearchService.from_series`` over
   ``make_wafer_like(1_048_576, 128, seed=0)`` with the default
   ``ServeConfig`` (levels (8, 16), alphabet 10, max_batch 32), then
   ``warmup``.
4. Kernels against their plain PyTorch versions on the card, on inputs
   made the way the serving path makes them (z-normalised queries, half
   k-NN rows at their seed radius, half range rows at ε = 2): at the
   serving shape Q = 32, B = 2^20, at Q = 32, B = 65,536 and at a ragged
   Q = 27, B = 50,001.  d² must agree within 1e-3 + 1e-5·d² (f32
   summation order of the matmul form), no answer may differ outside
   that band around ε², and the merged top-k must agree up to swaps of
   near-equal d².  The selection exactly: ``fused_topk``'s partials
   equal ``ref.block_topk`` of ``fused_range``'s d² bit for bit at the
   open radius ε = 1e28 (every valid row a candidate and an answer) for
   k_sel 9 and the path's k_sel, and in each block's first min(k_sel,
   answers) slots at the path's ε.  Kernel, plain-version and yardstick
   times, and the least time the card could take (bytes over 3.35 TB/s
   or FLOPs over 67 TFLOP/s f32, whichever is larger, for the data this
   run needs).
5. The full-precision slice: with the launch counts set to 0, 64 requests
   from 16 closed-loop clients (k-NN fraction 0.5, k = 5, ε = 2); both
   kernels and the compaction's two (``compact_count`` once a pass,
   ``compact_write``) must have launched.  Every request is replayed
   alone (``check_exactness``: 0 mismatches), and 16 of them are checked
   against an f64 brute force on the card.
6. Where the time of one served micro-batch goes: the fused pass's
   steps, its compaction, the copy of the compact answers and the host's
   replies.  Then the compaction at the benchmark cells' pass shapes
   (``[compact]`` lines): a real fused pass over 2^22 random walks of
   length 256 made on the card (Q = 32, k = 5, range at ε 1 and 2) and
   over the 2^22 windows of 16 random walks (Q = 4, 1-NN, range at ε 3);
   ``compact_count`` and ``compact_write`` on its answers equal their
   plain versions and ``engine.compact_dense`` bit for bit; each
   kernel's device time, its plain version's, a library call's
   (``Tensor.sum``, ``torch.nonzero``) and its least bytes over
   3.35 TB/s (``cost_model.compact_step_bytes``).  The torch engine's
   dense fallback at the synth shape, compacted as served beside the
   dense copy, in turns (``[compact-dense-fallback]``: host ms, peak
   memory, bytes; every compacted row equal to its dense row).
7. The quantized resident tier: ``SearchService.from_series`` with
   ``quantization="int8"`` over the same series, and a bf16 tier of the
   same host index.  The quantized kernels (``fused_quant_range``,
   ``fused_quant_topk``) against their plain versions in both modes at
   the three shapes of phase 4: keep masks equal except on rows within
   the band of the screen's thresh², d̂² within the band;
   ``fused_quant_topk``'s partials equal ``ref.block_topk`` of
   ``fused_quant_range``'s d̂² bit for bit at the path's ε and at the open
   radius (the kept rows are the candidates at any ε).
8. The quantized slice: with the counts set to 0, the same 64 requests
   through the int8 tier; ``fused_quant_range`` must have launched.  The
   replay shows 0 mismatches, the answers equal phase 5's for the same
   requests (rows within the f32 band of the boundary are counted, none
   may be wrong), 16 agree with the f64 brute force; then where one
   quantized micro-batch's time goes.
9. Subsequence search at subseq-1M: 16 wafer-like streams of 262,144
   samples, windows of 128 at stride 4 (W = 1,048,080), levels (8, 16),
   32 queries.  The streaming kernels (``fused_subseq_range``,
   ``fused_subseq_topk``, ``fused_quant_subseq_range`` in int8 and bf16)
   against their plain versions there and at a ragged Q = 27 over 3
   streams of 5,000 at stride 3, on inputs made as the path makes them
   (half the rows at the k-NN fetch's seed radius, half at ε = 2), with
   the band rule of phase 4; kernel 3 bit-identical to ``fused_range``
   over the materialised windows, kernel 4's partials equal to
   ``fused_topk``'s, kernel 7 set-identical to kernel 3; kernel 4's
   partials equal ``ref.block_topk`` of kernel 3's d² bit for bit at the
   open radius (the path's k_sel and k_sel 128) and at the path's ε (the
   first min(k_sel, answers) slots of each block).  Times, plain times,
   the ``torch.matmul`` yardstick and the bounds, which count the stream
   samples, not the window matrix; the selection's own cost (kernel 4 −
   kernel 3) beside ``torch.topk`` over kernel 3's d² in kernel 4's
   blocks and ``fused_topk`` over the materialised windows, which is
   also timed with one ring stage (the launcher's choice at k_sel 67)
   and with two (one block per SM), its partials equal both ways.
   Kernels 3, 4 and 7 (int8 and bf16) at one and at two ring stages of
   the streaming loader: outputs bit-identical both ways, at subseq-1M
   and at the ragged shape, and at subseq-1M both times.
10. The subsequence slice: with the counts set to 0, ``subseq_range_query``
   at ε = 2, ``subseq_knn_query`` at k = 3, excl = 64 (backend auto) and
   ``subseq_range_query_quantized`` in int8; each streaming kernel must
   have launched and kernels 1-2 not.  The answers against the torch
   backend and against an f64 brute force with the exclusion-zone greedy
   on 16 queries (band rule), every k-NN certificate True; where one
   k-NN call's time goes.
11. The subsequence service (``SubseqSearchService.from_streams`` over the
   same streams), 64 requests from 16 clients (k-NN fraction 0.5, k = 3,
   ε = 2): 0 replay mismatches and phase 10's answers.  As in the
   reference, it serves windows as rows through kernels 1-2.
12. The per-level kernels (``kernels/level_ops.py``): with the counts set
   to 0, ``linfit_residual_sq`` and ``paa`` (kernels 8-9) over phase 3's
   z-normalised series at both levels, bit-identical to their plain
   versions and to the engine's device build (``sqrt`` of one equals the
   index's residuals, ``discretize`` of the other its words, on every
   row); ``mindist_sq``, ``sqdist`` and ``prune_level`` (10-12) bit-
   identical to their plain versions at B = 2^20 and all five at the edge
   shapes (B = 1, ragged B at n = 96, L = 1, N = 1, L = 128, bf16 rows,
   the extreme symbols, a PAD_RESIDUAL row).  Times of each kernel alone
   and of its wrapper's whole call, plain times, the one-call yardsticks
   (``torch.matmul`` by the averaging matrix for ``paa``, ``torch.cdist``
   for ``sqdist``) and the bounds (``prune_level``'s counts the words of
   the rows C9 keeps, the only ones it reads; the full-read bound is
   logged beside it).  The build's linfit, word and sqdist register
   instantiations must have no stack frame and no spill.
13. The paper's online phase, one query and one level at a time: the
   port's host ``FastSAXIndex`` of phase 7, its columns uploaded once; 16
   queries at ε ∈ {1, 2}; with the counts set to 0, FAST_SAX on the card
   (``prune_level`` per level, then ``sqdist`` on the survivors) and SAX
   (``mindist_sq`` at the finest level, then ``sqdist``), each against
   the port's op-counted ``search.fastsax_range_query`` /
   ``sax_range_query`` (answers and candidates equal except rows within
   the f32 band of a threshold, which are counted) and FAST_SAX against
   kernel 1 (``range_query_fused``) over phase 3's index; kernels 10-12
   must have launched.  Each engine's op-counted latency, candidates,
   exclusions and time per query; ``sqdist`` timed at the phase's mean
   survivor count, the shape it runs at, back to back (its rows stay in
   L2) and L2-cold (128 MB overwritten before each launch), beside phase
   12's 2^20 rows (the kernels line carries the survivor-count figures,
   back to back); then, outside
   the counted run, where a query's card time goes: the wrapper calls'
   host work, the wait for their kernels, ``nonzero``, the verify, the
   copies, and the kernels alone.
14. The index lifecycle, its stores in a fresh directory on the roomiest
   of the temporary directory and the checkout's ``build/`` (at least 6 GB
   free, else it fails), removed at the end.  (1) ``save_index`` of phase
   7's host index, ``verify_store``, ``SearchService.from_store`` on the
   default ``ServeConfig``: the index on the card equal to
   ``device_index_from_host`` tensor for tensor; with the counts at 0,
   phase 5's 64 requests (kernels 1-2 must launch), 0 replay mismatches,
   every request's direct answer bit-identical to a service over
   ``device_index_from_host``, phase 5's answers by the band rule.  (2) A
   store with an int8 tier, served as stored (no requantization; the
   columns on the card equal ``load_quantized``'s): kernel 5 launches, 0
   replay mismatches, phase 8's answers.  (3) ``MutableIndex.create``
   over the same rows, warm-started with live ingest: 4,096 rows
   inserted and 1,024 ids deleted (base and delta), ``refresh()``; 64
   requests, 0 replay mismatches, 16 against an f64 brute force over the
   live rows, no deleted id answered, 8 inserted rows their own nearest
   neighbours; ``compact()`` and ``refresh()`` leave every answer as it
   was; 512 rows inserted with requests in flight swap in the
   background, and every request submitted after the install replays
   exactly.  (4) ``save_subseq_index`` of phase 9's index, loaded and
   uploaded: phase 10's three engine calls (kernels 3, 4, 7 must launch)
   answer bit for bit as in phase 10; ``SubseqSearchService.from_store``
   serves 16 requests with 0 replay mismatches.  (5) ``run_saturated``
   and ``run_sequential`` over (1)'s service, the same answers request by
   request, and ``benchmark_database`` without ``REPRO_UCR_PATH``.  Every
   time beside the card's name and power limit; the figures under the
   report's ``lifecycle`` key.  The kernels line adds phase 14's
   launches to each kernel's.
15. Traced serving (``ServeConfig(trace=True)``), report key ``obs``,
   ``[obs-*]`` lines.  (1) Phase 5's index and 64 requests through a
   traced service: kernels 1-2 launch, 0 replay mismatches, the answers
   equal phase 5's bit for bit, and ``stats.cascade`` equals the sum of
   the batches' traces (bucket padding dropped); the calibration log
   (the dispatch's wall time against ``fused_pass_estimate``).  (2)
   ``range_query_traced`` (ε = 2) and ``knn_query_traced`` (k = 5) on 32
   queries at 2^20 rows: per level and per query the counters equal the
   plain versions' survivor counts exactly; on 4 queries over phase 13's
   columns they equal ``search.fastsax_range_query``'s op counts, every
   row that differs within the f32 band of a bound.  (3) The closed loop
   untraced, traced, traced, untraced: the ratio of the medians of qps
   (reported, not checked), a Q = 32 batch's ``mixed_query_fused`` and
   counting pass (``mixed_trace``) in CUDA-event ms.  (4) A traced
   service with ``profile_dir``: one ``torch.profiler`` Chrome trace per
   batch (at least 4), each parsed for the card's busy time (the union of
   kernel and copy intervals), the idle share of the capture window and
   the top device operations; the trace must name both fused kernels, or
   the phase says that CUPTI gave no device events and the idle share is
   not measured.  (5) ``start_metrics_server`` over (1)'s
   ``metrics_text``, scraped once: every required family, the cascade
   counters above 0.  (6) 16 of the requests through the traced int8
   tier: 0 replay mismatches, kernel 5 launched in the dispatch and for
   the trace's screen count (at least twice a batch); the tier's range
   and k-NN counters equal the plain widened cascade, its screen count
   kernel 5's keep (the plain keep with band rows counted).  (7)
   ``subseq_range_query_traced`` and ``subseq_knn_query_traced`` at
   subseq-1M: kernels 3 and 4 launch, the answers are phase 10's bit for
   bit, the counters the plain per-level counts over the windows-as-rows
   columns.  The kernels line adds these runs' launches.
16. Extended representation stacks at repr-1M, report key ``repr``,
   ``[repr-*]`` lines: ``make_trending(2^20, 128)`` (its defaults), levels
   (8, 16), α 10, the stack ``("linfit_residual", "sax_word",
   "trend_slope")``, ε = 1.  (1) The bytes reckoned before the run.  (2)
   ``SearchService.from_series`` on the stack builds on the card: words
   and trend words equal the f64 host build's (``device_index_from_host``
   of ``build_index``) except within 1e-4 of a breakpoint (counted).  (3)
   The closed loop (64 requests, 16 clients, k-NN fraction 0.5, k = 5)
   through the extended service and the paper-stack service in turns,
   kernels 1-2 launching in both (the kernels answer with the paper
   pair's cascade and an exact verify, whatever the stack): qps,
   p50 / p99, 0 replay mismatches, 16 requests against the f64 brute
   force, the answers set-identical to the paper stack's by the band
   rule; ``max_memory_allocated``.  (4) ``range_query_traced`` /
   ``knn_query_traced`` on 32 queries (kernels 1-2 answer): the counters
   equal the plain per-level counts (C9, C10, then the trend bound), the
   extended survivors ≤ the paper stack's at every level and fewer
   verified, ``trend_slope``'s own kills per level; the torch engine's
   cascade with the trend test on the card (range and k-NN) against
   kernels 1-2 by the band rule; 4 queries against
   ``search.fastsax_range_query``'s op counts over the same stack (band
   rows counted); traced services show the extra kills in
   ``stats.cascade`` and the metrics text.  (5) The int8 tier with the
   trend column (kernel 5, then the trend test on its kept rows) against
   full precision and against the paper tier's kernel 5.  (6) Phase 13's
   loop with the trend
   bound: ``prune_level``, then ``mindist_sq`` at n = N on the survivors'
   trend words, then ``sqdist``, against the host engine; ``mindist_sq``
   at n = N bit-identical to its plain version and to the bound.  (7)
   subseq-1M's streams with the stack: the window hook's trend words
   against the materialised windows', the answers through kernels 3-4
   against the paper stack's and the torch engine's range answers with
   the trend test.
   (8) ``NearDuplicateFilter`` on the card over 65,536 trending rows with
   an eighth planted near-duplicates, in batches of 1,024: the keep masks
   equal a brute-force dedup on the card (f64), admits per second.  The
   kernels line adds the phase's path launches (not its comparisons).
17. Sharded search at shard-1M, report key ``shard``, ``[shard-*]``
   lines: serve-1M's database and 64 requests and subseq-1M's streams
   over a mesh of P = 4 shards (``dist_search.make_data_mesh(4)``: all
   four on the one card here, shard i on card i mod the card count).
   (a) ``distributed_build``, then the range, k-NN and mixed engines and
   their ``_auto`` forms on 32 queries at ε = 2, k = 5, each counted
   (kernels 1-2 on every shard): range sets, range d², k-NN ids and k-NN
   d² bit-identical to phase 3's index through ``range_query_fused`` /
   ``knn_query_fused``, and held to the f64 brute force by the band rule;
   kernel 1's wrapper timed on one shard and on the whole index.  (b)
   ``SearchService.from_series(mesh=…)``: the closed loop, 0 replay
   mismatches, every answer bit-identical to phase 5's; qps beside phase
   5's.  (c) ``store_sharded`` into phase 14's roomy temp directory, then
   ``SearchService.from_store``: the 64 requests replayed bit-identical,
   save and warm-start seconds.  (d) phase 7's int8 tier resharded
   (``distributed_tiered_index``): kernel 5 on every shard, 0 replay
   mismatches, phase 8's answers bit for bit.  (e) subseq-1M's 16 streams
   over the shards (``distributed_subseq_index``): the range and k-NN
   entry points launch kernels 3-4 (not 1-2) and answer as phase 10.
   (f) ``ServeConfig(failover_shards=4)`` under ``FaultPlan`` s: a
   transient fault on shard 1 healed by a retry; shard 2 killed, marked
   down, every answer certified-partial (``exact`` False, ``rows_ok`` the
   other shards' rows, ``/healthz`` saying so) and equal to the f64 brute
   force over the other shards' rows; revived by a probe, exact again; a
   slowed shard hedged.  The kernels line adds the phase's counted
   launches.
18. The LM serving path, report key ``lm``, ``[lm]`` lines (no kernel of
   the port lies on it: every kernel's launch count is the same before
   and after the phase).  (a) granite-3-2b at its full published config
   (40 layers, d 2048, 32 heads, GQA kv 8, d_ff 8192, vocab 49155;
   2,634,201,088 parameters, the reference's count) through the
   launcher's LM mode, ``--no-smoke --batch 4 --prompt-len 32 --gen 16``,
   in bf16: one ``forward_hidden`` over the prompt and the generated
   tokens holds the prefill's and every decode step's logits to max |Δ|
   / max |logit| <= ``LM_BF16_TOL`` (0.05 for granite, stated per
   architecture from a measured run), the greedy tokens equal its argmax
   wherever its top-2 gap exceeds that tolerance, and every logit is
   finite; the warm prefill and decode times, aggregate tok/s, peak
   memory and a decode step's bound (the bytes it must read over the HBM
   rate) with the share reached.  (b) The same in f32, held to the
   reference's 2e-3 rtol/atol.  (c) mamba2-2.7b, zamba2-1.2b,
   whisper-medium (1500 stub frames) and llama-3.2-vision-11b (1601 stub
   patches) at their full published configs, and mixtral-8x22b and
   qwen3-moe-235b-a22b at their published widths with 4 layers each
   (281 GB and 470 GB of bf16 at full depth fit no one card), in bf16,
   one at a time, memory freed between: batch 2, prompt 32, prefill and
   4 decode steps, the same check; the MoE configs also in f32, held to
   2e-3 (in bf16 a router near a tie may pick another expert).  (d) All
   ten smoke configs in f32 and in bf16 on the CPU and on the card, with
   the same weights and tokens: the largest |Δ| of the logits, within
   2e-3 rtol/atol in f32 and, in bf16, within twice the CPU's own gap
   between its steps and its full forward.
19. LM training and checkpoints, report key ``train``, ``[train]`` lines
   (no kernel of the port lies on it: every launch count is the same
   before and after).  (a) granite-3-2b at its full published config in
   bf16, random weights (seed 0), through the train launcher with the
   reference launcher's defaults (``--global-batch 8 --seq-len 128``), 6
   steps on the port's token pipeline, first with f32 moments, then with
   ``--int8-opt``, the card's memory freed between: every loss and grad
   norm finite; step 0's loss within ``TRAIN_LOSS0_RTOL`` of a no_grad
   ``train_loss`` on the same weights and batch (the int8 run's step 0
   equal to it); one more step's update of the embedding table, layer
   0's ``wq`` and ``final_norm``'s scale held to ``apply_updates`` on
   the CPU on copies of that leaf's parameter, gradient and moments (one
   bf16 ulp, 1e-6 relative on f32 moments and scales, |Δcode| ≤ 1); the
   step ms (median of steps 1-5), tokens/s, peak memory and the model
   FLOPs share (6 · N · tokens a step over the 989 TFLOP/s dense bf16
   peak, N = 2,533,531,648: the parameters less the 49155 × 2048
   embedding table, a gather with no products; ``lm_head`` counts, and
   attention's S² products are left out); with f32 moments one step split on CUDA events into
   forward, backward and optimizer, and one under ``torch.profiler``
   (device operations, busy ms, idle share).  (b) One train step of each
   of the ten smoke configs in f32 on the CPU and on the card from the
   same weights and tokens, then a second step's update on the card
   against ``apply_updates`` on the CPU on the card's own gradients and
   moments, every element (``TRAIN_F32``); ``grad_accum`` 4 against 1 on
   the card.  (c) Kill and resume at smoke size through the
   launcher in a subprocess with deterministic algorithms on: 6 steps
   against 3 + resume 3, the losses bit for bit (an op with no
   deterministic form is named and the losses held to
   ``RESUME_NONDET_RTOL``), the card's checkpoints restored on the CPU
   with sha256 verified.
20. The training mesh on the one card, report key ``mesh``, ``[mesh]``
   lines (no kernel launched).  (a) granite-3-2b at its full published
   config through the train launcher with ``--mesh-devices 2,2`` (the
   four shards on the one card; the launcher's defaults, 3 steps) with
   f32 and with int8 moments: step 0's loss and grad norm against phase
   19's one-device step on the same weights and batch
   (``MESH_LOSS0_RTOL``, ``MESH_GNORM0_RTOL``); one more step's update
   of phase 19's three leaves, block by block on the card, against
   ``apply_updates`` on the CPU on gathered copies (as phase 19 holds
   them); step ms, tokens/s, peak memory, the bytes gathered a step; the
   mesh step at smoke size card against CPU (``MESH_F32``).  (b) The MoE
   configs at their published widths with 4 layers in f32 over a (2, 2)
   mesh (qwen3-moe ``ep``, mixtral ``tp``, model = 2): hidden states
   within ``MOE_MESH_TOL``·(1 + |h|) of the local path, aux equal to the
   per-shard estimator.  (c) ``make_compressed_dp_grad_fn`` over 4 data
   shards on the card, within the reference test's limits.  (d) A
   checkpoint written from the (2, 2) mesh restored onto (4, 1) and onto
   the one device, every leaf equal.  (e) In a subprocess beside (a)-(d):
   the dry run's granite-3-2b train_4k cell on ``meta`` and the roofline
   bound of phase 19's step shape, printed as a share of phase 19's step.

The line before the last is one JSON object with every kernel's figures;
the last line is ``{"ok": true, "device": {...}}``.  Longer results go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
N_SERVE = 1_048_576
# The engine's no-information radius: ε² is +inf in f32, so C10 is open
# and C9 kills only the 1e30 sentinel; every valid row is a candidate.
OPEN_EPS = 1e28
SOURCE = "src/repro_torch/kernels/csrc/fused_query.cu"
REPLACES = {"fused_range": "src/repro/kernels/fused_query.py:245",
            "fused_topk": "src/repro/kernels/fused_query.py:291",
            "fused_quant_range": "src/repro/kernels/fused_query.py:871",
            "fused_quant_topk": "src/repro/kernels/fused_query.py:928",
            "fused_subseq_range": "src/repro/kernels/fused_query.py:509",
            "fused_subseq_topk": "src/repro/kernels/fused_query.py:563",
            "fused_quant_subseq_range":
                "src/repro/kernels/fused_query.py:1035"}
LEVEL_SOURCE = "src/repro_torch/kernels/csrc/level_ops.cu"
LEVEL_REPLACES = {"linfit_residual_sq": "src/repro/kernels/linfit.py:50",
                  "paa": "src/repro/kernels/paa.py:40",
                  "mindist_sq": "src/repro/kernels/mindist.py:38",
                  "sqdist": "src/repro/kernels/sqdist.py:26",
                  "prune_level": "src/repro/kernels/fused_prune.py:53"}
# The paper's online phase, one query and one level at a time (phase 13).
LEVEL_EPS = (1.0, 2.0)
LEVEL_QUERIES = 16
# subseq-1M: the launcher's subsequence defaults (window 128, stride 4,
# excl 64, k 3) over as many windows as serve-1M has rows.
SUBSEQ = dict(streams=16, stream_len=262_144, window=128, stride=4, excl=64,
              k=3, eps=2.0, queries=32)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def band(d2):
    return 1e-3 + 1e-5 * np.abs(d2)


def log(*args) -> None:
    print(*args, flush=True)


def plain_of(fq, args) -> dict:
    """A wrapper's keyword arguments as its plain version takes them: the
    query words' MINDIST panels in place of the words (the kernels read
    the table through the words), no alphabet."""
    out = {k: v for k, v in args.items() if k not in ("alphabet", "q_words")}
    out["q_panels"] = fq._panels(args["q_words"], args["alphabet"])
    return out


def quant_plain(fq, args) -> tuple:
    """The quantized wrappers' positional arguments as the plain versions
    take them."""
    qdev, q, q_words, q_res, eps = args
    return qdev, q, fq._panels(q_words, qdev.alphabet), q_res, eps


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# A spin of ~10 ms at the H100's clocks: longer than the host takes to
# queue 20 wrapper launches.
SPIN_CYCLES = 20_000_000


def device_ms(torch, fn, reps: int) -> float:
    """Device time per call of ``fn``, its launches queued behind a spin
    kernel so that the card runs them back to back: a kernel shorter than
    its launch's host work (the level kernels 10 and 12) would otherwise
    be timed at the host's pace.  Fails if the host took longer to queue
    them than the spin lasted."""
    fn()
    torch.cuda.synchronize()
    spin = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    check(queued_ms < spin[0].elapsed_time(start),
          f"queuing {reps} launches took {queued_ms:.2f} ms, longer than "
          f"the spin")
    return start.elapsed_time(end) / reps


def environment(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    env = {
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvcc": shutil.which("nvcc") or (
            "/usr/local/cuda/bin/nvcc"
            if pathlib.Path("/usr/local/cuda/bin/nvcc").exists() else None),
        "triton": importlib.util.find_spec("triton") is not None,
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "tf32_cudnn": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }
    log(smi)
    log(f"[env] torch {env['torch']} cuda {env['cuda']} python "
        f"{env['python']}; nvcc {env['nvcc']}; triton "
        f"{'present' if env['triton'] else 'absent'}; TF32 matmul "
        f"{env['tf32_matmul']} cudnn {env['tf32_cudnn']}")
    check(not env["tf32_matmul"], "TF32 matmul must stay off")
    return env


def path_inputs(torch, engine, index, queries: np.ndarray, k: int = 8):
    """The fused kernels' inputs as the serving path makes them for one
    micro-batch: z-normalised queries, alternate k-NN rows at their
    slacked seed radius and range rows at ε = 2."""
    dev = index.device
    Q = queries.shape[0]
    qr = engine.represent_queries(
        torch.as_tensor(queries, dtype=torch.float32, device=dev),
        index.levels, index.alphabet)
    knn = (torch.arange(Q, device=dev) % 2 == 0).reshape(Q, 1)
    seed = engine._seed_eps(index, qr, k, None)
    eps = torch.where(knn, engine._slacked(seed),
                      torch.full_like(seed, 2.0))
    args = engine._fused_inputs(index, qr, index.residuals, eps)
    k_sel = k + engine._TOPK_GUARD
    tq, tb = engine._fused_blocks(index, Q, k_sel)
    rq, rb = engine._fused_blocks(index, Q, 0)
    return qr, args, dict(block_q=rq, block_b=rb), \
        dict(block_q=tq, block_b=tb, k=min(k_sel, tb))


def alive_by_level(torch, ref, args) -> list:
    """Surviving (query, row) pairs before each level and after the last
    (the work the cascade and the verify need on these inputs); ``args``
    as the plain versions take them (:func:`plain_of`)."""
    eps = args["eps"].reshape(-1, 1)
    alive = torch.ones((args["q"].shape[0], args["series"].shape[0]),
                       dtype=torch.bool, device=eps.device)
    counts = [int(alive.sum())]
    for li, N in enumerate(args["levels"]):
        one = {k: (v[li:li + 1] if k in ("words", "residuals", "q_panels",
                                          "q_residuals") else v)
               for k, v in args.items()}
        alive &= ref.cascade_alive_ref(one["words"], one["residuals"],
                                       one["q_panels"], one["q_residuals"],
                                       args["eps"], (N,), args["n"])
        counts.append(int(alive.sum()))
    return counts


def quant_alive_by_level(torch, ref, cols, levels, n, panels, q_res,
                         eps) -> list:
    """:func:`alive_by_level` for the widened cascade over quantized
    columns ``cols`` = (words, residuals, scale, zero, err)."""
    alive = torch.ones((eps.shape[0], cols[0][0].shape[0]),
                       dtype=torch.bool, device=eps.device)
    counts = [int(alive.sum())]
    for li, N in enumerate(levels):
        one = [c[li:li + 1] for c in cols]
        alive &= ref.quant_meta_alive_ref(*one, panels[li:li + 1],
                                          q_res[li:li + 1], eps, (N,), n)
        counts.append(int(alive.sum()))
    return counts


def bound_ms(tensors, levels, counts, n: int, topk: bool,
             extra_ops: float = 0.0) -> tuple:
    """Least time for the work: every input and output tensor moved once
    over the memory rate, or the operations these inputs need (``counts``
    from :func:`alive_by_level`, plus ``extra_ops``) over the f32 rate,
    whichever is larger."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    ops = float(extra_ops)
    for li, N in enumerate(levels):
        ops += counts[li] * (3 + 2 * N + 2)         # C9, C10 gather-FMA
    ops += counts[-1] * (2 * n + 4)                 # verify on survivors
    if topk:
        ops += counts[-1]                           # selection compares
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, ops


def range_agreement(got, want, lim2) -> dict:
    """A range pass (answers, d²) against another on the same inputs:
    answers that differ outside the band around the limit ``lim2`` on d²
    ((Q, 1) or (Q, B), e.g. ε²), d² outside the band."""
    ga, gd, wa, wd = (t.cpu().numpy() for t in (*got, *want))
    d_ref = np.where(np.isfinite(wd), wd, gd)
    in_band = np.abs(d_ref - lim2) <= band(lim2)
    differ = ga != wa
    both = ga & wa
    err = float(np.abs(gd[both] - wd[both]).max()) if both.any() else 0.0
    return {"answers": int(wa.sum()), "kernel_answers": int(ga.sum()),
            "max_abs_err": err,
            "mismatch_outside_band": int((differ & ~in_band).sum()),
            "mismatch_in_band": int((differ & in_band).sum()),
            "d2_outside_band": int((np.abs(gd[both] - wd[both])
                                    > band(wd[both])).sum()),
            "inf_off_answers": bool(np.all(np.isinf(gd[~ga])))}


def merged_agreement(fq, got, want, k: int) -> dict:
    """Merged top-k of two partial sets: equal up to near-tie swaps."""
    mgi, mgd = (t.cpu().numpy() for t in fq.merge_topk_partials(*got, k))
    mwi, mwd = (t.cpu().numpy() for t in fq.merge_topk_partials(*want, k))
    swaps = mgi != mwi
    with np.errstate(invalid="ignore"):          # inf − inf on empty slots
        near = np.abs(mgd - mwd) <= band(mwd)
    fin = np.isfinite(mwd)
    gi, gd, wi, wd = (t.cpu().numpy() for t in (*got, *want))
    same = (gi == wi) & np.isfinite(wd)
    return {"partial_slots_equal": float((gi == wi).mean()),
            "merged_equal": bool(np.array_equal(mgi, mwi)),
            "merged_swaps_near_tie": int((swaps & near).sum()),
            "merged_mismatch": int((swaps & ~near).sum()),
            "merged_d2_within_band": bool(
                np.array_equal(np.isfinite(mgd), fin)
                and np.all(np.abs(mgd[fin] - mwd[fin]) <= band(mwd[fin]))),
            "max_abs_err": float(np.abs(gd[same] - wd[same]).max())
            if same.any() else 0.0}


def selection_exact(torch, ref, got, range_d2, k: int, block_b: int,
                    what: str, prefix: bool = False) -> dict:
    """A top-k form's partials ``got`` against ``ref.block_topk`` of its
    range form's d² on the same inputs, idx and d² bit for bit.  At the
    open radius ``OPEN_EPS`` every slot is compared (every valid row is a
    candidate and an answer); with ``prefix``, at a path's ε, each block's
    first min(k, answers in the block) slots (the candidates are all
    survivors, the answers those with d² ≤ ε²)."""
    wi, wd = ref.block_topk(range_d2, k, block_b)
    gi, gd = got
    Q, B = range_d2.shape
    nb = wi.shape[1] // k
    keep = torch.ones((Q, nb, k), dtype=torch.bool, device=wi.device)
    if prefix:
        fin = torch.zeros((Q, nb * block_b), dtype=torch.bool,
                          device=wi.device)
        fin[:, :B] = torch.isfinite(range_d2)
        n_ans = fin.view(Q, nb, block_b).sum(-1).clamp(max=k)
        keep = torch.arange(k, device=wi.device)[None, None, :] \
            < n_ans[..., None]
    gi, gd, wi, wd = (t.reshape(Q, nb, k) for t in (gi, gd, wi, wd))
    out = {"k_sel": k, "block_b": block_b, "slots": int(keep.sum()),
           "idx_equal": bool(torch.equal(gi[keep], wi[keep])),
           "d2_bits_equal": bool(torch.equal(gd[keep].view(torch.int32),
                                             wd[keep].view(torch.int32)))}
    check(out["slots"] > 0 and out["idx_equal"] and out["d2_bits_equal"],
          f"{what}: the top-k selection differs from ref.block_topk of the "
          f"range form's d²: {out}")
    return out


def compare_kernels(torch, engine, fq, ref, index, queries, label,
                    timing: bool) -> dict:
    qr, args, rtile, ttile = path_inputs(torch, engine, index, queries)
    ref_args = plain_of(fq, args)
    Q, B = args["q"].shape[0], args["series"].shape[0]
    eps2 = (args["eps"] * args["eps"]).cpu().numpy()[:, None]
    out = {"Q": Q, "B": B, "range_tile": rtile, "topk_tile": ttile}

    out["range"] = range_agreement(fq.fused_range(**args, **rtile),
                                   ref.fused_range_ref(**ref_args), eps2)
    r = out["range"]
    check(r["mismatch_outside_band"] == 0 and r["d2_outside_band"] == 0
          and r["inf_off_answers"],
          f"fused_range disagrees with its plain version at {label}: {r}")

    k = ttile["k"]
    out["topk"] = dict(merged_agreement(
        fq, fq.fused_topk(**args, **ttile),
        ref.fused_topk_ref(**ref_args, k=k, block_b=ttile["block_b"]), 8),
        k_sel=k)
    t = out["topk"]
    check(t["merged_mismatch"] == 0 and t["merged_d2_within_band"],
          f"fused_topk disagrees with its plain version at {label}: {t}")
    # The selection, exactly: at the open radius for k_sel 9 and the
    # path's k_sel, at the path's ε for its k_sel.
    tile = {key: ttile[key] for key in ("block_q", "block_b")}
    bb = ttile["block_b"]
    open_args = dict(args, eps=torch.full_like(args["eps"], OPEN_EPS))
    rd = fq.fused_range(**open_args, **tile)[1]
    sel = {f"open_k{ks}": selection_exact(
        torch, ref, fq.fused_topk(**open_args, k=ks, **tile), rd, ks, bb,
        f"fused_topk at {label}, open radius")
        for ks in sorted({min(9, bb), k})}
    rd = fq.fused_range(**args, **tile)[1]
    sel[f"path_k{k}"] = selection_exact(
        torch, ref, fq.fused_topk(**args, **ttile), rd, k, bb,
        f"fused_topk at {label}, path ε", prefix=True)
    del rd
    out["selection"] = sel
    log(f"[kernels] {label}: fused_topk's partials equal ref.block_topk of "
        f"fused_range's d² bit for bit: "
        + ", ".join(f"{key} ({v['slots']} slots)" for key, v in sel.items()))
    log(f"[kernels] {label}: Q={Q} B={B} range answers={r['answers']} "
        f"max|Δd²|={r['max_abs_err']:.3g} outside-band="
        f"{r['mismatch_outside_band']} in-band={r['mismatch_in_band']}; "
        f"top-k merged equal={t['merged_equal']} near-tie swaps="
        f"{t['merged_swaps_near_tie']} max|Δd²|={t['max_abs_err']:.3g}")

    if timing:
        lib_ms = cuda_ms(torch, lambda: torch.matmul(args["q"],
                                                     args["series"].T), 20)
        for name, fn, plain, outputs, topk in (
                ("fused_range", lambda: fq.fused_range(**args, **rtile),
                 lambda: ref.fused_range_ref(**ref_args),
                 fq.fused_range(**args, **rtile), False),
                ("fused_topk", lambda: fq.fused_topk(**args, **ttile),
                 lambda: ref.fused_topk_ref(**ref_args, k=k,
                                            block_b=ttile["block_b"]),
                 fq.fused_topk(**args, **ttile), True)):
            tensors = [args["series"], args["norms_sq"], args["q"],
                       args["eps"], *args["words"], *args["residuals"],
                       *args["q_words"],
                       fq._table(args["alphabet"], index.device),
                       *args["q_residuals"], *outputs]
            counts = alive_by_level(torch, ref, ref_args)
            b_ms, b_by, nbytes, ops = bound_ms(tensors, args["levels"],
                                               counts, args["n"], topk)
            out[name] = {"ms": cuda_ms(torch, fn, 20),
                         "plain_ms": cuda_ms(torch, plain, 3),
                         "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "bytes": nbytes, "ops": ops,
                         "alive_by_level": counts}
            log(f"[kernels] {name} at {label}: {out[name]['ms']:.4f} ms "
                f"(plain {out[name]['plain_ms']:.3f} ms, torch.matmul "
                f"of the verify {lib_ms:.4f} ms, bound {b_ms:.4f} ms by "
                f"{b_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
    return out


def ring_stages_at_path_tiles(fq, ops, ss) -> dict:
    """The kernels' own choice of ring stages (``stages_of_kernel``) at
    the tiles the paths choose: serve-1M (Q = 32, B = 2^20, n = 128,
    levels (8, 16), α 10; top-k at the served k bucket 8 + guard 4) in
    f32, int8 and bf16, subseq-1M's streaming forms (stride 4: range in
    f32, int8 and bf16, top-k at k_sel 67) and fused_topk over its
    materialised windows at k_sel 67."""
    lv, Q, out = (8, 16), 32, {}
    for quant in (None, "int8", "bf16"):
        for k_sel in (0, 12):
            bq, _ = ops.choose_fused_blocks(Q, N_SERVE, 128, lv, 10,
                                            k_sel=k_sel, quant=quant)
            out[f"serve-1M {quant or 'f32'} "
                f"{'top-k' if k_sel else 'range'}"] = fq.stages_of_kernel(
                bool(k_sel), 128, lv, 10, bq, Q, k_sel, quant=quant)
    W = SUBSEQ["streams"] * ((SUBSEQ["stream_len"] - SUBSEQ["window"])
                             // SUBSEQ["stride"] + 1)
    for k_sel, quant in ((0, None), (67, None), (0, "int8"), (0, "bf16")):
        bq, _ = ops.choose_subseq_blocks(Q, W, SUBSEQ["window"],
                                         SUBSEQ["stride"], lv, 10, k=k_sel,
                                         quant=quant)
        out[f"subseq-1M {quant or 'f32'} "
            f"{'top-k' if k_sel else 'range'}"] = fq.stages_of_kernel(
            bool(k_sel), SUBSEQ["window"], lv, 10, bq, Q, k_sel,
            quant=quant, stride=SUBSEQ["stride"])
        if k_sel:
            out["subseq-1M top-k over the materialised windows"] = \
                fq.stages_of_kernel(True, SUBSEQ["window"], lv, 10, bq, Q,
                                    k_sel)
    return out


def ptxas_summary(log_text: str) -> list:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` output:
    its template arguments (queries per thread, top-k form, row loader),
    registers and spills."""
    modes = {"0": "f32", "1": "int8", "2": "bf16"}
    out, name, spill = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"fused_(range|topk)_kernelILi(\d+)ELi(\d)ELb(\d)E",
                      line)
        if m and "Compiling entry function" in line:
            name = (f"QPT={m.group(2)} "
                    f"{'top-k' if m.group(1) == 'topk' else 'range'}"
                    f" {modes[m.group(3)]}"
                    f"{' streaming' if m.group(4) == '1' else ''}")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers; "
                       f"{spill}")
            name = None
    return out


def quant_resident_bytes(qdev) -> int:
    """Device bytes of a quantized tier's columns."""
    cols = [qdev.series, qdev.series_scale, qdev.series_zero,
            qdev.series_err, qdev.norms_sq, *qdev.words, *qdev.residuals,
            *qdev.resid_scale, *qdev.resid_zero, *qdev.resid_err]
    return int(sum(t.numel() * t.element_size() for t in cols
                   if t is not None))


def exactness_details(service, workload, result, limit: int = 8) -> list:
    """For a failed replay check: how the first mismatching requests
    differ between their batch and their replay."""
    out = []
    for (kind, q, eps, k), req in zip(workload, result.requests):
        ids, dist = service.direct_query(kind, q, epsilon=eps, k=k)
        if np.array_equal(ids, req.ids) and np.allclose(
                dist, req.distances, rtol=1e-6, atol=1e-9):
            continue
        same = ids.size == req.ids.size and np.array_equal(ids, req.ids)
        out.append({"kind": kind, "ids_equal": bool(same),
                    "n_batch": int(req.ids.size), "n_replay": int(ids.size),
                    "sym_diff": int(np.setxor1d(ids, req.ids).size),
                    "max_rel_dist": float(np.max(np.abs(dist - req.distances)
                                                 / np.maximum(dist, 1e-30)))
                    if same else None})
        if len(out) >= limit:
            break
    return out


def rows_f64(torch, series, dev):
    """A (B, n) host array as an f64 tensor on ``dev``, uploaded in row
    chunks (a read-only store mmap is copied chunk by chunk)."""
    step = 1 << 18
    return torch.cat([torch.as_tensor(np.array(series[s:s + step],
                                               np.float64), device=dev)
                      for s in range(0, series.shape[0], step)])


def brute_force_check(series, workload, result, n_check: int,
                      ids=None, device="cuda") -> dict:
    """f64 brute force on the card over the (B, n) ``series`` the service
    serves, for ``n_check`` served requests (half of each kind).  Range id
    sets and k-NN ids (a stable sort: ties to the lower row) must be
    equal; a row whose f64 d² lies within the f32 band of ε² (range) or of
    the k-th distance (k-NN) may differ and is counted instead.  ``ids``
    (ascending) are the rows' external ids when the service answers in
    them; an answer id that names no row of ``series`` is wrong."""
    import torch
    from repro_torch.core.paa import znormalize_np
    dev = torch.device(device)
    s64 = rows_f64(torch, series, dev)
    picked = {"range": [], "knn": []}
    for i, (kind, *_rest) in enumerate(workload):
        if len(picked[kind]) < n_check // 2 and \
                result.requests[i].status == "ok":
            picked[kind].append(i)
    stats = {"checked": 0, "exact_equal": 0, "boundary": 0, "wrong": 0,
             "boundary_rows": []}
    for i in picked["range"] + picked["knn"]:
        kind, q, eps, k = workload[i]
        req = result.requests[i]
        if ids is not None:
            pos = np.searchsorted(ids, req.ids)
            if not np.array_equal(ids[np.minimum(pos, ids.size - 1)],
                                  req.ids):
                stats["checked"] += 1
                stats["wrong"] += 1
                continue
            req = type(req)(kind=req.kind, query=req.query, ids=pos)
        qz = torch.as_tensor(znormalize_np(
            np.asarray(q, np.float32).astype(np.float64)), device=dev)
        d2t = torch.cat([((s64[s:s + (1 << 18)] - qz) ** 2).sum(-1)
                         for s in range(0, s64.shape[0], 1 << 18)])
        d2 = d2t.cpu().numpy()
        if kind == "range":
            sym = np.setxor1d(np.flatnonzero(d2 <= eps * eps), req.ids)
            gap = np.abs(d2[sym] - eps * eps)
            ok = np.all(gap <= band(eps * eps))
        else:
            want = torch.sort(d2t, stable=True).indices[:k].cpu().numpy()
            sym = np.flatnonzero(want != req.ids)
            gap = np.abs(d2[want[sym]] - d2[req.ids[sym]])
            ok = req.ids.size == k and np.all(gap <= band(d2[want[sym]]))
        if sym.size:
            stats["boundary_rows"].append(
                {"kind": kind, "rows": int(sym.size),
                 "max_d2_gap": float(gap.max())})
        stats["checked"] += 1
        if sym.size == 0:
            stats["exact_equal"] += 1
        elif ok:
            stats["boundary"] += 1
        else:
            stats["wrong"] += 1
    return stats


def breakdown(torch, engine, fq, service, queries,
              label: str = "breakdown") -> dict:
    """Where one served micro-batch (Q = 32, k bucket 8, half k-NN) spends
    its time: the steps of ``engine.mixed_query_fused`` and the
    compaction of its answers (``engine.compact_dense``, the counts' read
    included) timed with CUDA events, then the device-to-host copy of the
    compact answers and the host ``_finish`` over their rows."""
    from repro_torch.serve.batcher import KIND_KNN, KIND_RANGE, Request
    index, cfg = service.backend.index, service.cfg
    dev = index.device
    Q, k = 32, 8
    qs = queries[:Q].astype(np.float32)
    is_knn = np.arange(Q) % 2 == 0
    eps_np = np.where(is_knn, 0.0, 2.0).astype(np.float32)

    def run(ev):
        ev[0].record()
        qr = engine.represent_queries(
            torch.as_tensor(qs, device=dev), index.levels, index.alphabet,
            normalize=cfg.normalize_queries)
        knn_col = torch.as_tensor(is_knn, device=dev).reshape(Q, 1)
        eps_req = torch.as_tensor(eps_np, device=dev).reshape(Q, 1)
        eps = torch.where(knn_col, engine._seed_eps(index, qr, k, None),
                          eps_req)
        tq, tb = engine._fused_blocks(index, Q, k + engine._TOPK_GUARD)
        ev[1].record()
        idxp, _ = fq.fused_topk(
            **engine._fused_inputs(index, qr, index.residuals,
                                   engine._cascade_eps(eps, knn_col)),
            k=min(k + engine._TOPK_GUARD, tb), block_q=tq, block_b=tb)
        ev[2].record()
        d2v = engine._reverify_rows(index, qr, idxp)
        tight = torch.minimum(eps, torch.sqrt(engine._kth_smallest(d2v, k)))
        eps = torch.where(knn_col, tight, eps)
        ev[3].record()
        rq, rb = engine._fused_blocks(index, Q, 0)
        ans, d2 = fq.fused_range(
            **engine._fused_inputs(index, qr, index.residuals,
                                   engine._cascade_eps(eps, knn_col)),
            block_q=rq, block_b=rb)
        overflow = torch.zeros((Q,), dtype=torch.bool, device=dev)
        ev[4].record()
        count, idx, d2c = engine.compact_dense(ans, d2)
        ev[5].record()
        return count, idx, d2c, overflow, idxp

    evs = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    run(evs)
    torch.cuda.synchronize()
    reps, acc = 5, np.zeros(5)
    for _ in range(reps):
        count, idx, d2c, overflow, idxp = run(evs)
        torch.cuda.synchronize()
        acc += [evs[j].elapsed_time(evs[j + 1]) for j in range(5)]
    acc /= reps
    t0 = time.perf_counter()
    host = [t.cpu().numpy() for t in (idx, d2c, overflow)]
    t_copy = (time.perf_counter() - t0) * 1e3
    slots = np.arange(host[0].shape[1])
    reqs = [Request(kind=KIND_KNN if is_knn[i] else KIND_RANGE, query=qs[i],
                    epsilon=float(eps_np[i]), k=5) for i in range(Q)]
    t0 = time.perf_counter()
    for i, req in enumerate(reqs):
        service._finish(req, host[0][i], slots < count[i], host[1][i],
                        service._ids)
    t_finish = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    service.backend.dispatch(qs, eps_np, is_knn, k)
    t_dispatch = (time.perf_counter() - t0) * 1e3
    n = index.n
    out = {
        "queries_and_seed_ms": acc[0], "fused_topk_ms": acc[1],
        "reverify_gather_ms": acc[2], "fused_range_ms": acc[3],
        "compact_ms": acc[4], "compact_C": int(host[0].shape[1]),
        "d2h_copy_ms": t_copy, "host_finish_ms": t_finish,
        "dispatch_total_ms": t_dispatch,
        "d2h_bytes": int(sum(a.nbytes for a in host) + count.nbytes),
        "reverify_gather_bytes": int(idxp.numel() * n * 4),
        "topk_partials_per_query": int(idxp.shape[1]),
    }
    log(f"[{label}] " + json.dumps(out, sort_keys=True))
    return out


# The benchmark cells' pass shapes (portbench/configs): synth-rw256-4M's
# saturated batches (Q = 32 over 2^22 random walks of length 256, k = 5,
# range at ε 1 and 2) and rw-subseq-4M's light ones (Q = 4 over the
# W = 2^22 windows of 16 random walks, 1-NN, range at ε 3), half k-NN.
COMPACT_CELLS = {
    "synth": dict(rows=1 << 22, length=256, Q=32, k=5, eps=(1.0, 2.0)),
    "subseq": dict(streams=16, stream_len=262_271, window=128, Q=4, k=1,
                   eps=(3.0,)),
}


def compact_cell_index(torch, engine, ss, name: str, seed: int):
    """A cell's index on the card, its rows made from ``seed`` as the
    benchmark makes them (cumulative sums of N(0, 1) steps): ``(index,
    queries (Q, n) on the card)``, the queries rows or windows plus noise
    of 0.05."""
    from repro_torch.core.fastsax import FastSAXConfig
    c = COMPACT_CELLS[name]
    g = torch.Generator(device="cuda").manual_seed(seed)
    if name == "synth":
        x = torch.cumsum(torch.randn((c["rows"], c["length"]), generator=g,
                                     device="cuda"), dim=1)
        index = engine.build_device_index(x, (8, 16), 10)
        del x
    else:
        rng = np.random.default_rng(seed)
        streams = np.cumsum(rng.standard_normal(
            (c["streams"], c["stream_len"]), dtype=np.float32), axis=1)
        hidx = ss.build_subseq_index(streams,
                                     FastSAXConfig(n_segments=(8, 16)),
                                     c["window"], 1)
        index = ss.subseq_device_index(hidx).index
    rows = torch.randint(index.size, (c["Q"],), generator=g, device="cuda")
    q = index.series[rows] + 0.05 * torch.randn(
        (c["Q"], index.n), generator=g, device="cuda")
    return index, q


def compact_figures(torch, engine, fq, ref, answer, d2, label: str) -> dict:
    """The compaction kernels on one pass's (Q, B) answers: bit for bit
    against their plain versions (and ``engine.compact_dense``), then the
    kernels' device time back to back (C known, so no read between
    them), the step as the engine runs it (the counts read to size C),
    the plain versions', ``torch.nonzero``'s (one library call that
    finds the same slots, without their d² or a row layout) and the
    least bytes the step moves over 3.35 TB/s."""
    from repro_torch.core.cost_model import compact_step_bytes
    Q, B = answer.shape
    tiles, count = fq.compact_count(answer)
    C = int(count.max())
    idx, out = fq.compact_write(answer, d2, tiles, count, C)
    want_tiles, want_count = ref.compact_count_ref(answer, fq.COMPACT_TILE)
    check(torch.equal(tiles, want_tiles) and torch.equal(count, want_count),
          f"{label}: compact_count differs from its plain version")
    want_idx, want_out = ref.compact_write_ref(answer, d2, C)
    check(torch.equal(idx, want_idx)
          and torch.equal(out.view(torch.int32), want_out.view(torch.int32)),
          f"{label}: compact_write differs from its plain version")
    check(int(count.sum()) == int(answer.sum()),
          f"{label}: the counts miss answers")
    e_count, e_idx, e_out = engine.compact_dense(answer, d2)
    check(np.array_equal(e_count, count.cpu().numpy())
          and torch.equal(e_idx, idx)
          and torch.equal(e_out.view(torch.int32), out.view(torch.int32)),
          f"{label}: engine.compact_dense differs from the kernels")
    del want_tiles, want_count, want_idx, want_out, e_idx, e_out

    def kernels():
        t, c = fq.compact_count(answer)
        fq.compact_write(answer, d2, t, c, C)

    # The step's least bytes, split: the count reads the mask and writes
    # the tiles' counts; the row counts' read to the host is neither
    # kernel's; the write moves the rest.
    nbytes = compact_step_bytes(tiles.cpu().numpy(), B, fq.COMPACT_TILE, C)
    count_bytes = Q * B + tiles.numel() * 4
    write_bytes = nbytes - count_bytes - Q * 4
    ms = device_ms(torch, kernels, 20)
    count_ms = device_ms(torch, lambda: fq.compact_count(answer), 20)
    out = {"Q": Q, "B": B, "C": C, "answers": int(count.sum()),
           "answer_tiles": int((tiles != 0).sum()),
           "tiles": int(tiles.numel()), "ms": ms,
           "step_ms": cuda_ms(torch, lambda: engine.compact_dense(answer, d2),
                              20),
           "plain_ms": cuda_ms(torch, lambda: (
               ref.compact_count_ref(answer, fq.COMPACT_TILE),
               ref.compact_write_ref(answer, d2, C)), 3),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "kernels": {
               "compact_count": {
                   "ms": count_ms,
                   "plain_ms": cuda_ms(torch, lambda: ref.compact_count_ref(
                       answer, fq.COMPACT_TILE), 3),
                   "library_ms": cuda_ms(
                       torch, lambda: answer.sum(dim=1, dtype=torch.int32),
                       10),
                   "bytes": count_bytes},
               "compact_write": {
                   "ms": device_ms(torch, lambda: fq.compact_write(
                       answer, d2, tiles, count, C), 20),
                   "plain_ms": cuda_ms(torch, lambda: ref.compact_write_ref(
                       answer, d2, C), 3),
                   "library_ms": cuda_ms(torch, lambda: torch.nonzero(answer),
                                         10),
                   "bytes": write_bytes}}}
    out["share"] = out["bound_ms"] / ms
    for f in out["kernels"].values():
        f.update(bound_ms=f["bytes"] / HBM_BYTES_PER_S * 1e3,
                 bound_by="bytes", max_abs_err=0.0)
        f["share"] = f["bound_ms"] / f["ms"]
    torch.cuda.empty_cache()
    log(f"[compact] {label}: " + json.dumps(out, sort_keys=True))
    return out


def dense_fallback(torch, engine, index, q, eps, is_knn, k: int) -> dict:
    """The torch engine's dense fallback (``mixed_query_dense``) through
    ``_SingleBackend`` as the service runs it (compacted, then copied),
    beside the same pass with its dense (Q, B) triple copied as it is,
    in turns: host ms a pass, the card's peak memory above what was held
    before, the bytes copied; each compacted row equals its dense row."""
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.service import _DENSE, _SingleBackend
    backend = _SingleBackend(index, ServeConfig(backend="torch"))
    backend._cap = _DENSE
    q_np = q.cpu().numpy()

    def compacted():
        return backend.dispatch(q_np, eps, is_knn, k)

    def dense():
        qr = engine.represent_queries(torch.as_tensor(q_np, device="cuda"),
                                      index.levels, index.alphabet)
        return tuple(t.cpu().numpy() for t in engine.mixed_query_dense(
            index, qr, torch.as_tensor(eps, device="cuda"),
            torch.as_tensor(is_knn, device="cuda"), k))

    runs = {"compacted": [], "dense": []}
    peak, outs = {}, {}
    for name in ("dense", "compacted", "compacted", "dense", "dense",
                 "compacted"):
        torch.cuda.synchronize()
        outs.pop(name, None)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs[name] = compacted() if name == "compacted" else dense()
        runs[name].append((time.perf_counter() - t0) * 1e3)
        peak[name] = max(peak.get(name, 0),
                         torch.cuda.max_memory_allocated() - base)
    c_idx, c_ans, c_d2 = outs["compacted"]
    d_ans, d_d2 = outs["dense"][1:3]
    equal = 0
    for i in range(len(q_np)):
        s = np.flatnonzero(d_ans[i])
        n = int(c_ans[i].sum())
        equal += int(n == s.size and np.array_equal(c_idx[i][:n], s)
                     and np.array_equal(c_d2[i][:n].view(np.int32),
                                        d_d2[i][s].view(np.int32)))
    check(equal == len(q_np), f"dense fallback: {equal} of {len(q_np)} "
          f"compacted rows equal their dense rows")
    out = {"Q": len(q_np), "B": index.size, "C": int(c_idx.shape[1]),
           "compacted_ms": runs["compacted"], "dense_copy_ms": runs["dense"],
           "compacted_peak_bytes": peak["compacted"],
           "dense_copy_peak_bytes": peak["dense"],
           "compacted_d2h_bytes": backend.last_d2h_bytes,
           "dense_d2h_bytes": int(sum(a.nbytes for a in outs["dense"])),
           "compacted_stages_device_ms": {
               n: dev * 1e3 for n, _, _, dev in backend.last_stages},
           "rows_equal": equal}
    del outs, c_idx, c_ans, c_d2, d_ans, d_d2, backend
    torch.cuda.empty_cache()
    log("[compact-dense-fallback] " + json.dumps(out, sort_keys=True))
    return out


def compact_phase(torch, engine, fq, ref, report) -> dict:
    """Phase 6's second part: the compaction at the benchmark cells' pass
    shapes, on the answers of a real fused pass over an index made as
    each cell makes it, and the torch engine's dense fallback at the
    synth cell's shape; everything freed at the end."""
    from repro_torch.core import subseq as ss
    t0 = time.perf_counter()
    figures = {}
    for name, seed in (("synth", 35_001), ("subseq", 35_002)):
        c = COMPACT_CELLS[name]
        index, q = compact_cell_index(torch, engine, ss, name, seed)
        qr = engine.represent_queries(q, index.levels, index.alphabet)
        is_knn = np.arange(c["Q"]) % 2 == 0
        eps = np.array([0.0 if is_knn[i] else
                        c["eps"][(i // 2) % len(c["eps"])]
                        for i in range(c["Q"])], np.float32)
        _, answer, d2, _ = engine.mixed_query_fused(
            index, qr, torch.as_tensor(eps, device="cuda"),
            torch.as_tensor(is_knn, device="cuda"), c["k"])
        label = f"{name} Q={c['Q']} B={index.size}"
        figures[name] = compact_figures(torch, engine, fq, ref, answer, d2,
                                        label)
        del answer, d2, qr
        if name == "synth":
            figures["dense_fallback"] = dense_fallback(
                torch, engine, index, q, eps, is_knn, c["k"])
        del index, q
        torch.cuda.empty_cache()
    figures["seconds"] = time.perf_counter() - t0
    report["compact"] = figures
    log(f"[compact] phase in {figures['seconds']:.1f}s")
    return figures


# ---------------------------------------------------------------------------
# The quantized resident tier (phases 7-8).
# ---------------------------------------------------------------------------


def quant_path_inputs(torch, engine, tindex, queries: np.ndarray,
                      k: int = 8):
    """The quantized kernels' inputs as ``quantized_mixed_query`` makes
    them for one micro-batch: z-normalised queries, alternate k-NN rows at
    their slacked raw-tier seed radius and range rows at ε = 2."""
    qdev = tindex.dev
    dev = qdev.device
    Q = queries.shape[0]
    qr = engine.represent_queries(
        torch.as_tensor(queries, dtype=torch.float32, device=dev),
        qdev.levels, qdev.alphabet)
    knn = (torch.arange(Q, device=dev) % 2 == 0).reshape(Q, 1)
    seed = engine._slacked(engine._tiered_seed_eps(tindex, qr, k))
    eps = torch.where(knn, seed, torch.full_like(seed, 2.0)).reshape(-1)
    args = (qdev, qr.q, qr.words, qr.residuals, eps.contiguous())
    rq, rb = engine._fused_blocks(qdev, Q, quant=True)
    tq, tb = engine._fused_blocks(qdev, Q, k, quant=True)
    return args, dict(block_q=rq, block_b=rb), \
        dict(block_q=tq, block_b=tb, k=k)


def quant_tensors(fq, qdev, args, outputs) -> list:
    """Every tensor a quantized pass reads or writes."""
    _, q, q_words, q_res, eps = args
    return [qdev.series, qdev.series_scale, qdev.series_zero,
            qdev.series_err, qdev.norms_sq, *qdev.words, *qdev.residuals,
            *qdev.resid_scale, *qdev.resid_zero, *qdev.resid_err, q, eps,
            *q_words, fq._table(qdev.alphabet, qdev.device), *q_res,
            *outputs]


def compare_quant_kernels(torch, engine, fq, ref, tindex, queries, label,
                          timing: bool) -> dict:
    """Both quantized kernels against their plain versions on the same
    tensors; with ``timing``, their times, bounds and the yardstick."""
    args, rtile, ttile = quant_path_inputs(torch, engine, tindex, queries)
    qdev, eps = args[0], args[4]
    qplain = quant_plain(fq, args)
    Q, B = args[1].shape[0], qdev.size
    lim2 = ref.screen_limit_sq(eps, qdev.series_err).cpu().numpy()
    out = {"Q": Q, "B": B, "mode": qdev.mode, "range_tile": rtile,
           "topk_tile": ttile}

    out["range"] = range_agreement(fq.fused_quant_range(*args, **rtile),
                                   ref.fused_quant_range_ref(*qplain), lim2)
    r = out["range"]
    check(r["mismatch_outside_band"] == 0 and r["d2_outside_band"] == 0
          and r["inf_off_answers"] and r["answers"] > 0,
          f"fused_quant_range disagrees with its plain version at {label}: "
          f"{r}")

    k = ttile["k"]
    out["topk"] = dict(merged_agreement(
        fq, fq.fused_quant_topk(*args, **ttile),
        ref.fused_quant_topk_ref(*qplain, k=k, block_b=ttile["block_b"]), k),
        k_sel=k)
    t = out["topk"]
    check(t["merged_mismatch"] == 0 and t["merged_d2_within_band"],
          f"fused_quant_topk disagrees with its plain version at {label}: "
          f"{t}")
    # The selection, exactly: the tier's candidates are the kept rows at
    # any ε, so every slot equals ref.block_topk of the range form's d̂²
    # at the path's ε and at the open radius.
    tile = {key: ttile[key] for key in ("block_q", "block_b")}
    sel = {}
    for name, e in (("path", eps), ("open", torch.full_like(eps,
                                                            OPEN_EPS))):
        a = args[:4] + (e,)
        sel[f"{name}_k{k}"] = selection_exact(
            torch, ref, fq.fused_quant_topk(*a, k=k, **tile),
            fq.fused_quant_range(*a, **tile)[1], k, ttile["block_b"],
            f"fused_quant_topk ({qdev.mode}) at {label}, {name}")
    out["selection"] = sel
    log(f"[quant-kernels] {label} {qdev.mode}: fused_quant_topk's partials "
        f"equal ref.block_topk of fused_quant_range's d̂² bit for bit: "
        + ", ".join(f"{key} ({v['slots']} slots)" for key, v in sel.items()))
    log(f"[quant-kernels] {label} {qdev.mode}: Q={Q} B={B} kept="
        f"{r['answers']} (kernel {r['kernel_answers']}) max|Δd̂²|="
        f"{r['max_abs_err']:.3g} outside-band={r['mismatch_outside_band']} "
        f"in-band={r['mismatch_in_band']}; top-k merged equal="
        f"{t['merged_equal']} near-tie swaps={t['merged_swaps_near_tie']} "
        f"max|Δd̂²|={t['max_abs_err']:.3g}")

    if timing:
        u = ref.dequant_series(qdev.series, qdev.series_scale,
                               qdev.series_zero)
        q = args[1]
        lib_ms = cuda_ms(torch, lambda: torch.matmul(q, u.T), 20)
        del u
        counts = quant_alive_by_level(
            torch, ref, (qdev.words, qdev.residuals, qdev.resid_scale,
                         qdev.resid_zero, qdev.resid_err), qdev.levels,
            qdev.n, qplain[2], args[3], eps)
        # Dequantizing the tile: a multiply and an add per int8 code.
        deq_ops = 2.0 * B * qdev.n if qdev.mode == "int8" else 0.0
        for name, fn, plain, topk in (
                ("fused_quant_range",
                 lambda: fq.fused_quant_range(*args, **rtile),
                 lambda: ref.fused_quant_range_ref(*qplain), False),
                ("fused_quant_topk",
                 lambda: fq.fused_quant_topk(*args, **ttile),
                 lambda: ref.fused_quant_topk_ref(
                     *qplain, k=k, block_b=ttile["block_b"]), True)):
            outputs = fn()
            b_ms, b_by, nbytes, ops = bound_ms(
                quant_tensors(fq, qdev, args, outputs), qdev.levels, counts,
                qdev.n, topk, extra_ops=deq_ops + 4.0 * counts[-1])
            del outputs
            out[name] = {"ms": cuda_ms(torch, fn, 20),
                         "plain_ms": cuda_ms(torch, plain, 3),
                         "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "bytes": nbytes, "ops": ops,
                         "alive_by_level": counts}
            log(f"[quant-kernels] {name} at {label} {qdev.mode}: "
                f"{out[name]['ms']:.4f} ms (plain "
                f"{out[name]['plain_ms']:.3f} ms, torch.matmul of the "
                f"verify on û {lib_ms:.4f} ms, bound {b_ms:.4f} ms by "
                f"{b_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
    return out


def serve_phase(torch, fq, service, workload, label: str,
                front=None) -> tuple:
    """The slice's main path: counts at 0, the closed loop (through
    ``front``, the service's load-generator adapter, when given), the
    counts."""
    from repro_torch.serve import run_closed_loop
    fq.reset_launch_counts()
    t0 = time.perf_counter()
    with service:
        result = run_closed_loop(front or service, workload, clients=16)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in fq.KERNELS}
    log(f"[{label}] closed loop in {time.perf_counter() - t0:.1f}s; "
        f"launches {launches}")
    return result, launches


def replay_check(service, workload, result, label: str) -> tuple:
    """Every served request replayed alone: 0 mismatches or fail."""
    from repro_torch.serve import check_exactness
    t0 = time.perf_counter()
    mismatches = check_exactness(service, workload, result)
    t_replay = time.perf_counter() - t0
    if mismatches:
        log(f"[{label}] exactness mismatches: " + json.dumps(
            exactness_details(service, workload, result)))
    check(mismatches == 0, f"{label}: {mismatches} exactness mismatches")
    return mismatches, t_replay


def cross_check(series, workload, got, want) -> dict:
    """The tier's answers against the full-precision phase's for the same
    requests.  Range id sets and k-NN ids must be equal; a differing row
    whose f64 d² lies within the f32 band of ε² (range) or of the other's
    k-th distance (k-NN) is counted as a boundary row, any other as
    wrong."""
    from repro_torch.core.paa import znormalize_np
    stats = {"requests": 0, "equal": 0, "boundary_rows": 0, "wrong": 0}
    for (kind, q, eps, k), g, w in zip(workload, got.requests,
                                       want.requests):
        stats["requests"] += 1
        qz = znormalize_np(np.asarray(q, np.float32).astype(np.float64))
        d2 = lambda ids: ((np.asarray(series[ids], np.float64) - qz) ** 2
                          ).sum(-1)
        if kind == "range":
            sym = np.setxor1d(g.ids, w.ids)
            gap = np.abs(d2(sym) - eps * eps) if sym.size else np.zeros(0)
            bad = int((gap > band(eps * eps)).sum())
        elif g.ids.size != w.ids.size:
            sym = np.arange(max(g.ids.size, w.ids.size))
            bad = int(sym.size)
        else:
            sym = np.flatnonzero(g.ids != w.ids)
            dg, dw = d2(g.ids[sym]), d2(w.ids[sym])
            bad = int((np.abs(dg - dw) > band(dw)).sum())
        if sym.size == 0:
            stats["equal"] += 1
        stats["boundary_rows"] += int(sym.size) - bad
        stats["wrong"] += bad
    return stats


def quant_breakdown(torch, engine, service, queries,
                    label: str = "quant-breakdown") -> dict:
    """Where one quantized micro-batch (Q = 32, k bucket 8, half k-NN)
    spends its time: the steps of ``engine.quantized_mixed_query`` on the
    host clock around synchronised device work, then the device-to-host
    copy and the host ``_finish``."""
    from repro_torch.core.options import SearchOptions
    from repro_torch.index import store
    from repro_torch.serve.batcher import KIND_KNN, KIND_RANGE, Request
    tindex, cfg = service.backend.tindex, service.cfg
    qdev = tindex.dev
    dev = qdev.device
    Q, k = 32, 8
    qs = queries[:Q].astype(np.float32)
    is_knn = np.arange(Q) % 2 == 0
    eps_np = np.where(is_knn, 0.0, 2.0).astype(np.float32)
    opts = SearchOptions()
    sync = torch.cuda.synchronize

    def step(acc, key, fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        acc[key] = acc.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return r

    def run(acc):
        def represent():
            qr = engine.represent_queries(
                torch.as_tensor(qs, device=dev), qdev.levels, qdev.alphabet,
                normalize=cfg.normalize_queries)
            knn_col = torch.as_tensor(is_knn, device=dev).reshape(Q, 1)
            eps_req = torch.as_tensor(eps_np, device=dev).reshape(Q, 1)
            eps = torch.where(knn_col, engine._slacked(
                engine._tiered_seed_eps(tindex, qr, k)), eps_req)
            return qr, knn_col, eps_req, eps
        qr, knn_col, eps_req, eps = step(acc, "query_repr_and_seed_ms",
                                         represent)
        keep, _ = step(acc, "screen_kernel_ms",
                       lambda: engine._quantized_screen_backend(
                           tindex, qr, eps, opts.backend))
        idx, valid, overflow = step(
            acc, "compaction_ms", lambda: engine._compact_escalated(
                keep, max(4 * k, 64), opts.max_doublings))

        def slots():
            qi, si = torch.nonzero(valid, as_tuple=True)
            return qi, si, idx[qi, si]
        qi, si, ids = step(acc, "valid_slots_ms", slots)
        rows = step(acc, "host_gather_ms",
                    lambda: store.gather_rows(tindex.raw, ids.cpu().numpy()))

        def verify():
            d2v = engine._verify_gathered(torch.as_tensor(rows, device=dev),
                                          qr.q[qi])
            d2 = torch.full(valid.shape, float("inf"), device=dev)
            d2[qi, si] = d2v
            ans = torch.where(knn_col, valid,
                              valid & (d2 <= eps_req * eps_req))
            return ans, torch.where(ans, d2, float("inf"))
        ans, d2 = step(acc, "upload_and_verify_ms", verify)
        return (idx, ans, d2, overflow, rows.nbytes, int(ids.numel()),
                valid, qr.q)

    acc = {}
    run(acc)
    acc = {}
    reps = 3
    for _ in range(reps):
        idx, ans, d2, overflow, gbytes, n_rows, valid, q_rows = run(acc)
    out = {key: v / reps for key, v in acc.items()}
    t0 = time.perf_counter()
    host = [t.cpu().numpy() for t in (idx, ans, d2, overflow)]
    out["d2h_copy_ms"] = (time.perf_counter() - t0) * 1e3
    reqs = [Request(kind=KIND_KNN if is_knn[i] else KIND_RANGE, query=qs[i],
                    epsilon=float(eps_np[i]), k=5) for i in range(Q)]
    t0 = time.perf_counter()
    for i, req in enumerate(reqs):
        service._finish(req, host[0][i], host[1][i], host[2][i],
                        service._ids)
    out["host_finish_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    service.backend.dispatch(qs, eps_np, is_knn, k)
    out["dispatch_total_ms"] = (time.perf_counter() - t0) * 1e3
    # The raw-tier verify, synchronous and double-buffered (pinned
    # staging, non_blocking upload), on this batch's slots: the same d²,
    # bit for bit, and each one's time.
    d2s = {}
    for pre in (False, True, False, True):
        d2s[pre] = step(out, f"verify_tier_prefetch_{pre}_ms".lower(),
                        lambda: engine._verify_tier(
                            tindex.raw, idx, q_rows, valid,
                            SearchOptions(verify_prefetch=pre)))
    for pre in (False, True):
        out[f"verify_tier_prefetch_{pre}_ms".lower()] /= 2
    check(torch.equal(d2s[False], d2s[True]),
          "verify_prefetch changed a distance")
    out.update({"d2h_bytes": int(sum(a.nbytes for a in host)),
                "capacity": int(idx.shape[1]), "gathered_rows": n_rows,
                "host_gather_bytes": int(gbytes)})
    log(f"[{label}] " + json.dumps(out, sort_keys=True))
    return out


# ---------------------------------------------------------------------------
# Subsequence search (phases 9-11).
# ---------------------------------------------------------------------------


def subseq_inputs(torch, engine, sidx, qr, kf: int) -> dict:
    """The streaming kernels' inputs as the slice makes them: alternate
    rows at the k-NN fetch's slacked seed radius and at ε = 2."""
    Q = qr.q.shape[0]
    knn = (torch.arange(Q, device=sidx.device) % 2 == 0).reshape(Q, 1)
    seed = engine._slacked(engine._seed_eps(sidx.index, qr, kf, None))
    eps = torch.where(knn, seed, torch.full_like(seed, SUBSEQ["eps"]))
    return dict(streams=sidx.streams, mu=sidx.mu, sd=sidx.sd,
                norms_sq=sidx.index.norms_sq, words=sidx.index.words,
                residuals=sidx.index.residuals, q=qr.q,
                q_words=qr.words, q_residuals=qr.residuals,
                eps=eps.reshape(-1).contiguous(),
                levels=sidx.levels, alphabet=sidx.alphabet,
                window=sidx.window, stride=sidx.stride)


def rows_of(sidx, args) -> dict:
    """The whole-series kernels' inputs over the materialised windows."""
    return dict(series=sidx.index.series, norms_sq=args["norms_sq"],
                words=args["words"], residuals=args["residuals"],
                q=args["q"], q_words=args["q_words"],
                q_residuals=args["q_residuals"], eps=args["eps"],
                levels=args["levels"], alphabet=args["alphabet"],
                n=args["window"])


def compare_subseq_kernels(torch, engine, fq, ref, ss, sidx, qmetas, qr,
                           kf: int, label: str, timing: bool) -> dict:
    """Kernels 3, 4 and 7 against their plain versions and against the
    whole-series kernels over the materialised windows; with ``timing``,
    their times, bounds and the ``torch.matmul`` yardstick."""
    args = subseq_inputs(torch, engine, sidx, qr, kf)
    plain = plain_of(fq, args)
    Q, W = qr.q.shape[0], sidx.n_windows
    k_sel = kf + engine._TOPK_GUARD
    rq, rb = ss._subseq_blocks(sidx, Q, 0)
    tq, tb = ss._subseq_blocks(sidx, Q, k_sel)
    qq, qb = ss._subseq_blocks(sidx, Q, 0, quant="int8")
    rtile, ttile = dict(block_q=rq, block_b=rb), dict(block_q=tq, block_b=tb)
    qtile = dict(block_q=qq, block_b=qb)
    out = {"Q": Q, "W": W, "range_tile": rtile, "topk_tile": ttile,
           "quant_tile": qtile, "k_sel": k_sel}
    eps = args["eps"]
    eps2 = (eps * eps).cpu().numpy()[:, None]

    got = fq.fused_subseq_range(**args, **rtile)
    torch.cuda.synchronize()
    rows = fq.fused_range(**rows_of(sidx, args), **rtile)
    bit = bool(torch.equal(got[0], rows[0]) and torch.equal(got[1], rows[1]))
    del rows
    out["range"] = dict(range_agreement(got,
                                        ref.fused_subseq_range_ref(**plain),
                                        eps2), bit_identical_to_rows=bit)
    r = out["range"]
    check(bit and r["mismatch_outside_band"] == 0
          and r["d2_outside_band"] == 0 and r["inf_off_answers"],
          f"fused_subseq_range disagrees at {label}: {r}")

    gi = fq.fused_subseq_topk(**args, k=k_sel, **ttile)
    torch.cuda.synchronize()
    ri = fq.fused_topk(**rows_of(sidx, args), k=k_sel, **ttile)
    wi = ref.fused_subseq_topk_ref(**plain, k=k_sel, block_b=tb)
    out["topk"] = dict(
        merged_agreement(fq, gi, wi, kf),
        partials_equal_to_rows=bool(torch.equal(gi[0], ri[0])
                                    and torch.equal(gi[1], ri[1])),
        vs_rows=merged_agreement(fq, gi, ri, kf))
    t = out["topk"]
    check(t["merged_mismatch"] == 0 and t["merged_d2_within_band"]
          and t["vs_rows"]["merged_equal"] and t["partials_equal_to_rows"],
          f"fused_subseq_topk disagrees at {label}: {t}")
    del gi, ri, wi
    # The selection, exactly: at the open radius for the path's k_sel and
    # for k_sel 128 (its own tile), at the path's ε for the path's k_sel.
    open_args = dict(args, eps=torch.full_like(eps, OPEN_EPS))
    sel = {}
    for ks in sorted({k_sel, 128}):
        sq, sb = ss._subseq_blocks(sidx, Q, ks)
        tile = dict(block_q=sq, block_b=sb)
        sel[f"open_k{ks}"] = selection_exact(
            torch, ref, fq.fused_subseq_topk(**open_args, k=ks, **tile),
            fq.fused_subseq_range(**open_args, **tile)[1], ks, sb,
            f"fused_subseq_topk at {label}, open radius")
    sel[f"path_k{k_sel}"] = selection_exact(
        torch, ref, fq.fused_subseq_topk(**args, k=k_sel, **ttile),
        fq.fused_subseq_range(**args, **ttile)[1], k_sel, tb,
        f"fused_subseq_topk at {label}, path ε", prefix=True)
    out["selection"] = sel
    log(f"[subseq-kernels] {label}: fused_subseq_topk's partials equal "
        f"ref.block_topk of fused_subseq_range's d² bit for bit: "
        + ", ".join(f"{key} (block_b {v['block_b']}, {v['slots']} slots)"
                    for key, v in sel.items()))

    for mode, qmeta in qmetas.items():
        qargs = {k: v for k, v in args.items()
                 if k not in ("words", "residuals")}
        qa = fq.fused_quant_subseq_range(**qargs, qmeta=qmeta, **qtile)
        torch.cuda.synchronize()
        full = fq.fused_subseq_range(**args, **qtile)
        qplain = ref.fused_quant_subseq_range_ref(**plain_of(fq, qargs),
                                                  qmeta=qmeta)
        out[f"quant_{mode}"] = dict(
            range_agreement(qa, qplain, eps2),
            set_identical_to_full=bool(torch.equal(qa[0], full[0])),
            d2_identical_to_full=bool(torch.equal(qa[1], full[1])))
        m = out[f"quant_{mode}"]
        check(m["set_identical_to_full"] and m["mismatch_outside_band"] == 0
              and m["d2_outside_band"] == 0,
              f"fused_quant_subseq_range ({mode}) disagrees at {label}: {m}")
        del qa, full, qplain
    log(f"[subseq-kernels] {label}: Q={Q} W={W} range answers="
        f"{r['answers']} max|Δd²|={r['max_abs_err']:.3g} outside-band="
        f"{r['mismatch_outside_band']} in-band={r['mismatch_in_band']}, "
        f"bit-identical to fused_range {bit}; top-k (k_sel {k_sel}) merged "
        f"equal={t['merged_equal']} near-tie swaps="
        f"{t['merged_swaps_near_tie']}, partials equal to fused_topk "
        f"{t['partials_equal_to_rows']}; quantized set-identical "
        + str({m: out[f'quant_{m}']['set_identical_to_full']
               for m in qmetas}))

    # Kernels 3, 4 and 7 at one ring stage and at two: the same bits; with
    # ``timing`` both times, beside the whole-series kernels' below.
    qargs = {k: v for k, v in args.items() if k not in ("words", "residuals")}
    forms = {
        "fused_subseq_range": (
            lambda s: fq.fused_subseq_range(**args, **rtile, stages=s),
            (False, rq, 0, None)),
        "fused_subseq_topk": (
            lambda s: fq.fused_subseq_topk(**args, k=k_sel, **ttile,
                                           stages=s),
            (True, tq, k_sel, None)),
        **{f"fused_quant_subseq_range{'' if m == 'int8' else '_' + m}": (
            lambda s, m=m: fq.fused_quant_subseq_range(
                **qargs, qmeta=qmetas[m], **qtile, stages=s),
            (False, qq, 0, m)) for m in qmetas}}
    by_stages = {}
    for name, (fn, (topk, bq, ks, quant)) in forms.items():
        one, two = fn(1), fn(2)
        same = all(torch.equal(a.view(torch.int32) if a.is_floating_point()
                               else a, b.view(torch.int32)
                               if b.is_floating_point() else b)
                   for a, b in zip(one, two))
        del one, two
        check(same, f"{name}'s outputs depend on the ring stages at {label}")
        row = {"bit_identical": same, "chosen_stages": fq.stages_of_kernel(
            topk, sidx.window, sidx.levels, sidx.alphabet, bq, Q, ks,
            quant=quant, stride=sidx.stride)}
        if timing:
            row.update({f"stages_{s}_ms": cuda_ms(
                torch, lambda s=s: fn(s), 20) for s in (1, 2)})
        by_stages[name] = row
    out["by_stages"] = by_stages
    log(f"[subseq-kernels] {label}: kernels 3, 4 and 7 bit-identical at one "
        f"and two ring stages: " + json.dumps(by_stages, sort_keys=True))

    if timing:
        z = sidx.index.series
        lib_ms = cuda_ms(torch, lambda: torch.matmul(args["q"], z.T), 20)
        counts = alive_by_level(torch, ref, plain_of(fq, rows_of(sidx, args)))
        # Building the z tile: a subtract and a divide per window sample.
        z_ops = 2.0 * W * sidx.window
        common = [args["streams"], args["mu"], args["sd"], args["norms_sq"],
                  args["q"], eps, *args["q_words"],
                  fq._table(args["alphabet"], eps.device),
                  *args["q_residuals"]]
        qplain = plain_of(fq, qargs)

        def quant_case(mode):
            """Kernel 7 in ``mode``: its launcher, plain version, columns
            and cascade counts (the int8 one is the path's)."""
            qm = qmetas[mode]
            cols = (qm.words, qm.residuals, qm.scale, qm.zero, qm.err)
            cnt = quant_alive_by_level(torch, ref, cols, sidx.levels,
                                       sidx.window, plain["q_panels"],
                                       args["q_residuals"], eps)
            return (lambda: fq.fused_quant_subseq_range(**qargs, qmeta=qm,
                                                        **qtile),
                    lambda: ref.fused_quant_subseq_range_ref(**qplain,
                                                             qmeta=qm),
                    [c for col in cols for c in col], cnt, False)

        for name, fn, plain_fn, cols, cnt, topk in (
                ("fused_subseq_range",
                 lambda: fq.fused_subseq_range(**args, **rtile),
                 lambda: ref.fused_subseq_range_ref(**plain),
                 [*args["words"], *args["residuals"]], counts, False),
                ("fused_subseq_topk",
                 lambda: fq.fused_subseq_topk(**args, k=k_sel, **ttile),
                 lambda: ref.fused_subseq_topk_ref(**plain, k=k_sel,
                                                   block_b=tb),
                 [*args["words"], *args["residuals"]], counts, True),
                ("fused_quant_subseq_range", *quant_case("int8")),
                ("fused_quant_subseq_range_bf16", *quant_case("bf16"))):
            outputs = fn()
            b_ms, b_by, nbytes, ops = bound_ms(
                common + cols + list(outputs), sidx.levels, cnt,
                sidx.window, topk, extra_ops=z_ops)
            del outputs
            out[name] = {"ms": cuda_ms(torch, fn, 20),
                         "plain_ms": cuda_ms(torch, plain_fn, 3),
                         "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "bytes": nbytes, "ops": ops,
                         "alive_by_level": cnt}
            log(f"[subseq-kernels] {name} at {label}: "
                f"{out[name]['ms']:.4f} ms (plain "
                f"{out[name]['plain_ms']:.3f} ms, torch.matmul q·zᵀ "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}: "
                f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
        out["fused_range_over_rows_ms"] = cuda_ms(
            torch, lambda: fq.fused_range(**rows_of(sidx, args), **rtile), 20)
        out["fused_topk_over_rows_ms"] = cuda_ms(
            torch, lambda: fq.fused_topk(**rows_of(sidx, args), k=k_sel,
                                         **ttile), 20)
        log(f"[subseq-kernels] the whole-series kernels over the "
            f"materialised windows at {label}: fused_range "
            f"{out['fused_range_over_rows_ms']:.4f} ms, fused_topk "
            f"{out['fused_topk_over_rows_ms']:.4f} ms; the streaming ones "
            f"at one and two ring stages: " + ", ".join(
                f"{name} {row['stages_1_ms']:.4f} and "
                f"{row['stages_2_ms']:.4f} ms"
                for name, row in by_stages.items()))
        # fused_topk over the windows at this k_sel both ways: the stages
        # the launcher chooses (one: the lists leave no room for a second
        # at two blocks per SM) and two stages at one block per SM.
        rows = rows_of(sidx, args)
        chosen = fq.stages_of_kernel(True, sidx.window, sidx.levels,
                                     sidx.alphabet, tq, Q, k_sel)
        by_stages = {s: fq.fused_topk(**rows, k=k_sel, **ttile, stages=s)
                     for s in (1, 2)}
        same = all(torch.equal(by_stages[1][i].view(torch.int32),
                               by_stages[2][i].view(torch.int32))
                   for i in (0, 1))
        check(same, f"fused_topk's partials depend on the ring stages at "
              f"{label}, k_sel {k_sel}")
        del by_stages
        out["topk_over_rows_by_stages"] = {
            "k_sel": k_sel, "chosen_stages": chosen,
            "partials_bit_identical": same,
            **{f"stages_{s}_ms": cuda_ms(
                torch, lambda s=s: fq.fused_topk(**rows, k=k_sel, **ttile,
                                                 stages=s), 20)
               for s in (1, 2)},
            **{f"stages_{s}_smem_bytes": fq.smem_bytes_of_kernel(
                True, sidx.window, sidx.levels, sidx.alphabet, tq, Q, k_sel,
                stages=s) for s in (1, 2)}}
        del rows
        log(f"[subseq-kernels] fused_topk over the materialised windows at "
            f"k_sel {k_sel} by ring stages (chosen: {chosen}): "
            + json.dumps(out["topk_over_rows_by_stages"], sort_keys=True))
        # The selection's own cost: kernel 4 less kernel 3 (same loader,
        # cascade and verify; kernel 3 also writes the (Q, W) mask and
        # d²), and torch.topk over kernel 3's d² in kernel 4's blocks, a
        # yardstick for the selection alone that the port never calls.
        nbk = -(-W // tb)
        blocks = torch.full((Q, nbk * tb), float("inf"), device=eps.device)
        blocks[:, :W] = fq.fused_subseq_range(**args, **ttile)[1]
        blocks = blocks.view(Q, nbk, tb)
        out["selection_ms"] = (out["fused_subseq_topk"]["ms"]
                               - out["fused_subseq_range"]["ms"])
        out["torch_topk_ms"] = cuda_ms(
            torch, lambda: torch.topk(blocks, k_sel, dim=-1, largest=False),
            20)
        del blocks
        log(f"[subseq-kernels] the selection at {label} (k_sel {k_sel}, "
            f"block_w {tb}): kernel 4 − kernel 3 = "
            f"{out['selection_ms']:.4f} ms; torch.topk over kernel 3's d² "
            f"in ({Q}, {nbk}, {tb}) blocks {out['torch_topk_ms']:.4f} ms; "
            f"fused_topk over the materialised windows "
            f"{out['fused_topk_over_rows_ms']:.4f} ms")
    return out


def brute_force_windows(torch, sidx, queries, pick) -> list:
    """f64 squared distances of the ``pick`` queries to every window, each
    window z-normalised on its own (mean, population std floored at
    1e-8), on the card: a list of (W,) host arrays."""
    streams = sidx.streams.double()
    S, n = streams.shape
    W_s, w = sidx.windows_per_stream, sidx.window
    wid = torch.arange(sidx.n_windows, device=streams.device)
    start = (wid // W_s) * n + (wid % W_s) * sidx.stride
    win = streams.reshape(-1)[start[:, None]
                              + torch.arange(w, device=streams.device)]
    mu = win.mean(-1, keepdim=True)
    sd = torch.clamp(win.std(-1, correction=0, keepdim=True), min=1e-8)
    z = (win - mu) / sd
    del win
    out = []
    for i in pick:
        q = torch.as_tensor(np.asarray(queries[i], np.float64),
                            device=streams.device)
        q = (q - q.mean()) / torch.clamp(q.std(correction=0), min=1e-8)
        out.append(((z - q) ** 2).sum(-1).cpu().numpy())
    return out


def subseq_vs_brute_force(ss, sidx, bf, pick, ranges, knn, k: int,
                          excl: int) -> dict:
    """The engine's range (ε = 2) and k-NN answers against the f64 brute
    force and its exclusion-zone greedy: a row that differs counts as a
    boundary row when its f64 d² lies within the band of ε² (range) or
    of the other's distance (k-NN), else as wrong."""
    eps2 = SUBSEQ["eps"] ** 2
    stream_of, start_of = sidx.window_meta(np.arange(sidx.n_windows))
    stats = {"checked": 0, "equal": 0, "boundary_rows": 0, "wrong": 0}
    for j, i in enumerate(pick):
        d2 = bf[j]
        sym = np.setxor1d(np.flatnonzero(d2 <= eps2), ranges[i])
        bad = int((np.abs(d2[sym] - eps2) > band(eps2)).sum())
        order = np.argsort(d2, kind="stable")[:4096]
        want, _ = ss.suppress_trivial_matches(
            order[None, :], d2[order][None, :], stream_of, start_of, k, excl)
        got = knn[i]
        off = np.flatnonzero(want[0] != got)
        bad += int((np.abs(d2[want[0][off]] - d2[got[off]])
                    > band(d2[want[0][off]])).sum()) if off.size else 0
        stats["checked"] += 1
        stats["equal"] += int(sym.size == 0 and off.size == 0)
        stats["boundary_rows"] += int(sym.size + off.size) - bad
        stats["wrong"] += bad
    return stats


def subseq_knn_breakdown(torch, engine, fq, ss, sidx, qr, k: int,
                         excl: int) -> dict:
    """Where one engine-level k-NN call (``subseq_knn_query``, Q = 32)
    spends its time: the steps of ``_subseq_knn_fused`` with CUDA
    events, then the device-to-host copy and the host greedy."""
    index = sidx.index
    Q = qr.q.shape[0]
    kf = ss.knn_fetch_count(k, excl, sidx.stride, sidx.n_windows)
    k_sel = kf + engine._TOPK_GUARD
    bq, bw = ss._subseq_blocks(sidx, Q, k_sel)
    names = ["seed_ms", "topk_pass_1_ms", "reverify_1_ms", "topk_pass_2_ms",
             "reverify_2_ms", "merge_and_certificate_ms"]

    def run(ev):
        def topk(eps):
            return fq.fused_subseq_topk(
                **ss._stream_inputs(sidx), words=index.words,
                residuals=index.residuals, q=qr.q, q_words=qr.words,
                q_residuals=qr.residuals,
                eps=engine._cascade_eps(eps).reshape(-1).contiguous(),
                k=k_sel, block_q=bq, block_b=bw)[0]
        ev[0].record()
        eps = engine._seed_eps(index, qr, kf, None)
        ev[1].record()
        idxp = topk(eps)
        ev[2].record()
        d2v = engine._reverify_rows(index, qr, idxp)
        eps = torch.minimum(eps, torch.sqrt(engine._kth_smallest(d2v, kf)))
        ev[3].record()
        idxp = topk(eps)
        ev[4].record()
        d2v = engine._reverify_rows(index, qr, idxp)
        ev[5].record()
        nn = fq.merge_topk_partials(idxp, d2v, kf)
        exact = engine._topk_exact_certificate(d2v, nn[1], kf, k_sel, bw)
        ev[6].record()
        return nn, exact, idxp

    evs = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    run(evs)
    torch.cuda.synchronize()
    reps, acc = 5, np.zeros(6)
    for _ in range(reps):
        nn, exact, idxp = run(evs)
        torch.cuda.synchronize()
        acc += [evs[j].elapsed_time(evs[j + 1]) for j in range(6)]
    out = dict(zip(names, (acc / reps).tolist()))
    t0 = time.perf_counter()
    idx, d2, ex = (t.cpu().numpy() for t in (*nn, exact))
    out["d2h_copy_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ss._suppress_candidates(sidx, idx, d2, k, excl)
    out["host_greedy_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ss.subseq_knn_query(sidx, qr, k, excl=excl)
    torch.cuda.synchronize()
    out["call_total_ms"] = (time.perf_counter() - t0) * 1e3
    out.update({"fetch_count": kf, "k_sel": k_sel, "block_w": bw,
                "reverify_gather_bytes": int(idxp.numel() * sidx.window * 4),
                "partials_per_query": int(idxp.shape[1]),
                "exact": bool(ex.all())})
    log("[subseq-breakdown] " + json.dumps(out, sort_keys=True))
    return out


def subseq_phases(torch, engine, fq, ref, report) -> tuple:
    """Phases 9-11; returns the launch counts of phase 10's engine calls,
    phase 9's kernel figures, and phase 9's host index, queries and phase
    10's answers for phase 14."""
    from repro_torch.core import subseq as ss
    from repro_torch.core.fastsax import FastSAXConfig
    from repro_torch.core.options import SearchOptions
    from repro_torch.data.timeseries import (make_subseq_queries,
                                             make_wafer_like)
    from repro_torch.launch.serve import _SubseqLoadShim
    from repro_torch.serve import (ServeConfig, SubseqSearchService,
                                   WorkloadSpec, make_workload)

    cfg = SUBSEQ
    t0 = time.perf_counter()
    streams = make_wafer_like(cfg["streams"], cfg["stream_len"], seed=0,
                              normalize=False)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    hidx = ss.build_subseq_index(streams, FastSAXConfig(n_segments=(8, 16)),
                                 cfg["window"], cfg["stride"])
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    sidx = ss.subseq_device_index(hidx)
    qmetas = {m: ss.quantize_subseq_meta(hidx, m) for m in ("int8", "bf16")}
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    W = sidx.n_windows
    kf = ss.knn_fetch_count(cfg["k"], cfg["excl"], cfg["stride"], W)
    nbytes = lambda ts: int(sum(t.numel() * t.element_size() for t in ts
                                if t is not None))
    resident = {
        "streams": nbytes([sidx.streams]),
        "mu_sd": nbytes([sidx.mu, sidx.sd]),
        "norms": nbytes([sidx.index.norms_sq]),
        "words_and_residuals": nbytes([*sidx.index.words,
                                       *sidx.index.residuals]),
        "materialised_windows": nbytes([sidx.index.series]),
        **{f"quantized_meta_{m}": nbytes([*q.words, *q.residuals, *q.scale,
                                          *q.zero, *q.err])
           for m, q in qmetas.items()}}
    report["subseq_index"] = {"windows": W, "data_s": t_data,
                              "host_build_s": t_host,
                              "upload_and_quantize_s": t_dev,
                              "fetch_count": kf, "bytes": resident}
    log(f"[subseq-index] {W} windows of {cfg['streams']} streams x "
        f"{cfg['stream_len']}: data {t_data:.1f}s, host build "
        f"{t_host:.2f}s, upload + materialise + quantize {t_dev:.2f}s; "
        f"fetch count {kf} (k_sel {kf + engine._TOPK_GUARD}); bytes on the "
        f"card {resident}")

    # ---- 9. the streaming kernels against their plain versions
    queries = make_subseq_queries(streams, cfg["queries"], cfg["window"],
                                  seed=1)
    qr = ss.represent_subseq_queries(sidx, queries)
    r_streams = make_wafer_like(3, 5000, seed=2, normalize=False)
    r_hidx = ss.build_subseq_index(r_streams,
                                   FastSAXConfig(n_segments=(8, 16)), 128, 3)
    r_sidx = ss.subseq_device_index(r_hidx)
    r_qr = ss.represent_subseq_queries(
        r_sidx, make_subseq_queries(r_streams, 27, 128, seed=4))
    r_kf = ss.knn_fetch_count(cfg["k"], cfg["excl"], 3, r_sidx.n_windows)
    kernels = {
        "subseq_1m": compare_subseq_kernels(
            torch, engine, fq, ref, ss, sidx, qmetas, qr, kf,
            f"Q=32 W={W}", timing=True),
        "ragged": compare_subseq_kernels(
            torch, engine, fq, ref, ss, r_sidx,
            {m: ss.quantize_subseq_meta(r_hidx, m) for m in qmetas}, r_qr,
            r_kf, f"Q=27 W={r_sidx.n_windows} stride 3", timing=False)}
    report["subseq_kernels"] = kernels
    del r_sidx, r_qr

    # ---- 10. the slice's engine entry points, counts from 0
    auto = SearchOptions(backend="auto")
    fq.reset_launch_counts()
    t0 = time.perf_counter()
    ans, d2 = ss.subseq_range_query(sidx, qr, cfg["eps"], auto)
    torch.cuda.synchronize()
    t_range = time.perf_counter() - t0
    t0 = time.perf_counter()
    sel, sel_d2, exact = ss.subseq_knn_query(sidx, qr, cfg["k"],
                                             excl=cfg["excl"], options=auto)
    t_knn = time.perf_counter() - t0
    t0 = time.perf_counter()
    qans, qd2 = ss.subseq_range_query_quantized(sidx, qmetas["int8"], qr,
                                                cfg["eps"])
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in fq.KERNELS}
    check(launches["fused_subseq_range"] > 0
          and launches["fused_subseq_topk"] > 0
          and launches["fused_quant_subseq_range"] > 0,
          f"a streaming kernel of the path did not launch: {launches}")
    check(launches["fused_range"] == 0 and launches["fused_topk"] == 0,
          f"the engine entry points went through kernels 1-2: {launches}")
    check(bool(exact.all()), f"k-NN certificates: {exact.tolist()}")
    check(torch.equal(qans, ans) and torch.equal(qd2, d2),
          "the int8 path's answers differ from full precision")
    torch_opts = SearchOptions(backend="torch")
    vs_torch = range_agreement(
        (ans, d2), ss.subseq_range_query(sidx, qr, cfg["eps"], torch_opts),
        np.float32(cfg["eps"]) ** 2)
    t_sel, t_d2, t_exact = ss.subseq_knn_query(
        sidx, qr, cfg["k"], excl=cfg["excl"], options=torch_opts)
    knn_off = sel != t_sel
    knn_vs_torch = {"equal": int((~knn_off).all(axis=1).sum()),
                    "differ_in_band": int((knn_off & (np.abs(
                        sel_d2 - t_d2) <= band(t_d2))).sum()),
                    "wrong": int((knn_off & (np.abs(sel_d2 - t_d2)
                                             > band(t_d2))).sum()),
                    "torch_exact": bool(t_exact.all())}
    check(vs_torch["mismatch_outside_band"] == 0 and knn_vs_torch["wrong"]
          == 0, f"auto and torch backends disagree: {vs_torch}, "
          f"{knn_vs_torch}")
    steady = {}
    for name, fn in (
            ("range_ms", lambda: ss.subseq_range_query(sidx, qr, cfg["eps"],
                                                       auto)),
            ("knn_ms", lambda: ss.subseq_knn_query(
                sidx, qr, cfg["k"], excl=cfg["excl"], options=auto)),
            ("quantized_range_ms", lambda: ss.subseq_range_query_quantized(
                sidx, qmetas["int8"], qr, cfg["eps"]))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        steady[name] = (time.perf_counter() - t0) / 3 * 1e3
    pick = list(range(16))
    ranges = [np.flatnonzero(a) for a in ans.cpu().numpy()]
    bf = brute_force_windows(torch, sidx, queries, pick)
    vs_bf = subseq_vs_brute_force(ss, sidx, bf, pick, ranges, sel,
                                  cfg["k"], cfg["excl"])
    # At ε = 2 a query has few answers; hold the range path also at each
    # query's 256th smallest f64 distance.
    eps256 = np.sqrt([np.partition(d, 255)[255] for d in bf])
    a256 = ss.subseq_range_query(
        sidx, ss.represent_subseq_queries(sidx, queries[:16]),
        torch.as_tensor(eps256, dtype=torch.float32, device=sidx.device),
        auto)[0].cpu().numpy()
    e2 = eps256.astype(np.float32).astype(np.float64) ** 2
    vs_bf256 = {"answers": int(a256.sum()), "boundary_rows": 0, "wrong": 0}
    for j in range(16):
        sym = np.setxor1d(np.flatnonzero(bf[j] <= e2[j]),
                          np.flatnonzero(a256[j]))
        bad = int((np.abs(bf[j][sym] - e2[j]) > band(e2[j])).sum())
        vs_bf256["boundary_rows"] += int(sym.size) - bad
        vs_bf256["wrong"] += bad
    del bf, a256
    check(vs_bf["wrong"] == 0 and vs_bf["checked"] == 16
          and vs_bf256["wrong"] == 0,
          f"subsequence answers against the f64 brute force: {vs_bf}, at "
          f"the 256th distance {vs_bf256}")
    report["subseq_engine"] = {
        "launches": launches, "first_call_ms": {
            "range": t_range * 1e3, "knn": t_knn * 1e3,
            "quantized_range": t_quant * 1e3},
        "call_ms": steady,
        "range_answers": int(ans.sum()), "knn_exact": bool(exact.all()),
        "vs_torch_range": vs_torch, "vs_torch_knn": knn_vs_torch,
        "brute_force": vs_bf, "brute_force_at_256th": vs_bf256}
    log(f"[subseq-engine] a call (mean of 3, host clock): range "
        f"{steady['range_ms']:.2f} ms, k-NN (k={cfg['k']}, excl="
        f"{cfg['excl']}) {steady['knn_ms']:.2f} ms, int8 range "
        f"{steady['quantized_range_ms']:.2f} ms; launches of the first "
        f"calls {launches}; all k-NN exact; range vs torch {vs_torch}; "
        f"k-NN vs torch {knn_vs_torch}; f64 brute force on 16 queries "
        f"{vs_bf}, at each one's 256th distance {vs_bf256}")
    report["subseq_breakdown"] = subseq_knn_breakdown(
        torch, engine, fq, ss, sidx, qr, cfg["k"], cfg["excl"])

    # ---- 11. the subsequence service over the same streams
    t0 = time.perf_counter()
    svc = SubseqSearchService.from_streams(streams, cfg["window"],
                                           cfg["stride"], ServeConfig(),
                                           excl=cfg["excl"])
    svc.warmup(ks=(svc._fetch_k(cfg["k"], svc.excl),))
    torch.cuda.synchronize()
    t_svc = time.perf_counter() - t0
    workload = make_workload(queries, WorkloadSpec(
        n_requests=64, knn_frac=0.5, k=cfg["k"], epsilon=cfg["eps"]))
    shim = _SubseqLoadShim(svc)
    result, svc_launches = serve_phase(torch, fq, svc, workload,
                                       "subseq-serve", front=shim)
    check(result.served == len(workload),
          f"subseq service: served {result.served} of {len(workload)}")
    mismatches, t_replay = replay_check(shim, workload, result,
                                        "subseq-serve")
    vs_engine = {"requests": 0, "equal": 0, "boundary_rows": 0, "wrong": 0}
    for j, ((kind, q, eps, k), req) in enumerate(zip(workload,
                                                     result.requests)):
        i = j % len(queries)          # make_workload's round robin
        want = ranges[i] if kind == "range" else sel[i][sel[i] >= 0]
        vs_engine["requests"] += 1
        if np.array_equal(np.sort(req.ids) if kind == "range" else req.ids,
                          want):
            vs_engine["equal"] += 1
            continue
        if kind == "range":
            off = np.setxor1d(req.ids, want)
            dd = svc.sidx.index.series[torch.as_tensor(off)].double()
            qz = engine.represent_queries(
                torch.as_tensor(q[None], dtype=torch.float32,
                                device=sidx.device), (8, 16), 10).q.double()
            gap = ((dd - qz) ** 2).sum(-1).cpu().numpy() - eps * eps
            bad = int((np.abs(gap) > band(eps * eps)).sum())
        else:
            n = min(req.ids.size, want.size)
            off = np.flatnonzero(req.ids[:n] != want[:n])
            got_d = req.distances[off] ** 2
            want_d = sel_d2[i][off]
            bad = int((np.abs(got_d - want_d) > band(want_d)).sum()) + \
                abs(req.ids.size - want.size)
        vs_engine["boundary_rows"] += int(off.size) - bad
        vs_engine["wrong"] += bad
    check(vs_engine["wrong"] == 0,
          f"the service's answers differ from phase 10's: {vs_engine}")
    snap = svc.stats.snapshot()
    lat = snap["latency_ms"]
    report["subseq_serve"] = {
        "summary": result.summary(snap), "launches": svc_launches,
        "build_and_warmup_s": t_svc, "exact_mismatches": mismatches,
        "replay_s": t_replay, "vs_engine": vs_engine}
    log(f"[subseq-serve] {result.served}/{len(workload)} served at "
        f"{result.qps:.2f} qps; p50 {lat['p50']} ms p99 {lat['p99']} ms; "
        f"mean batch {snap['mean_batch_size']} over {snap['batches']} "
        f"batches; exactness mismatches {mismatches} ({t_replay:.1f}s); "
        f"against phase 10 {vs_engine}; launches {svc_launches}: the "
        f"service serves windows as rows through kernels 1-2, the "
        f"reference's design (src/repro/serve/service.py:1148)")
    del svc, sidx, qmetas
    keep = {"hidx": hidx, "queries": queries, "ans": ans, "d2": d2,
            "sel": sel, "sel_d2": sel_d2, "exact": exact, "qans": qans,
            "qd2": qd2}
    return launches, kernels, keep


# ---------------------------------------------------------------------------
# The per-level kernels and the level-at-a-time search (phases 12-13).
# ---------------------------------------------------------------------------

def level_ptxas_summary(log_text: str) -> list:
    """:func:`ptxas_summary` for ``level_ops.cu``: the segment body (paa,
    and sqdist's other widths: "sqdist segment"; f32 or bf16 rows),
    sqdist's register body (per row width n), the linfit bodies (per
    segment length L, and the generic one) and the word bodies (mindist,
    prune; per width N, and the generic ones by the size of their
    query-word parameter)."""
    dtype = {"f": "f32", "13__nv_bfloat16": "bf16"}
    names = (
        (r"segment_kernelILi(\d)E(f|13__nv_bfloat16)E",
         lambda m: f"{('paa', 'linfit', 'sqdist segment')[int(m[1])]} "
                   f"{dtype[m[2]]}"),
        (r"sqdist_kernelILi(\d+)E(f|13__nv_bfloat16)E",
         lambda m: f"sqdist n={m[1]} {dtype[m[2]]}"),
        (r"linfit_kernelILi(\d+)E(f|13__nv_bfloat16)E",
         lambda m: f"linfit L={m[1]} {dtype[m[2]]}"),
        (r"linfit_generic_kernelI(f|13__nv_bfloat16)E",
         lambda m: f"linfit generic {dtype[m[1]]}"),
        (r"word_kernelILi(\d+)ELb(\d)E",
         lambda m: f"{('mindist', 'prune')[int(m[2])]} N={m[1]}"),
        (r"word_generic_kernelILi(\d+)ELb(\d)E",
         lambda m: f"{('mindist', 'prune')[int(m[2])]} generic "
                   f"(query word up to {m[1]})"))
    out, name, spill = [], None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = next((label(m) for pat, label in names
                         if (m := re.search(pat, line))), None)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers; "
                       f"{spill}")
            name = None
    return out


def frame_and_spills(line: str) -> tuple:
    """(stack frame bytes, spill store + load bytes) of a ptxas summary
    line."""
    return (int(re.search(r"(\d+) bytes stack frame", line).group(1)),
            sum(int(m) for m in re.findall(r"(\d+) bytes spill", line)))


def max_abs_diff(torch, got, want) -> float:
    """Largest |got − want| (differing entries, for masks)."""
    if got.dtype == torch.bool:
        return float((got != want).sum())
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def level_edge_cases(torch, lo, ref, make_wafer_like, errs, dev) -> dict:
    """Kernels 8-12 against their plain versions, bit for bit, at the
    edge shapes: B = 1, ragged B at n = 96 (L = 12 and 3), L = 1, N = 1,
    a segment longer than a warp (n = 1024, L = 128), bf16 rows, the
    extreme symbols 0 and α − 1, a PAD_RESIDUAL row."""
    cases = 0
    for B, n, N in ((1, 128, 8), (50_001, 96, 8), (50_001, 96, 32),
                    (513, 128, 128), (300, 128, 1), (257, 1024, 8)):
        x32 = torch.as_tensor(make_wafer_like(B, n, seed=6),
                              dtype=torch.float32, device=dev)
        for x in (x32, x32.to(torch.bfloat16)):
            for name, fn, plain in (
                    ("linfit_residual_sq", lo.linfit_residual_sq,
                     ref.linfit_residual_sq_ref),
                    ("paa", lo.paa, ref.paa_ref)):
                got, want = fn(x, N), plain(x, N)
                errs[name] = max(errs[name], max_abs_diff(torch, got, want))
                check(torch.equal(got, want),
                      f"{name} differs from its plain version at B={B} "
                      f"n={n} N={N} {x.dtype}")
            q = x[B // 2].clone()
            got, want = lo.sqdist(x, q), ref.sqdist_ref(x, q)
            errs["sqdist"] = max(errs["sqdist"],
                                 max_abs_diff(torch, got, want))
            check(torch.equal(got, want),
                  f"sqdist differs from its plain version at B={B} n={n} "
                  f"{x.dtype}")
            cases += 1
    for B, N, alphabet in ((1, 8, 10), (50_001, 16, 10), (513, 128, 3),
                           (300, 1, 20)):
        n = 8 * N
        rng = np.random.default_rng(B + N)
        words = rng.integers(0, alphabet, (B, N)).astype(np.int32)
        words[0], words[-1] = 0, alphabet - 1
        qword = rng.integers(0, alphabet, N)
        w = torch.as_tensor(words, device=dev)
        tq = lo.query_table(qword, alphabet, dev)
        got = lo.mindist_sq(w, qword, n, alphabet)
        want = ref.mindist_sq_level_ref(w, tq, n)
        errs["mindist_sq"] = max(errs["mindist_sq"],
                                 max_abs_diff(torch, got, want))
        check(torch.equal(got, want),
              f"mindist_sq differs from its plain version at B={B} N={N}")
        alive = torch.as_tensor(rng.random(B) < 0.7, device=dev)
        res = torch.as_tensor(rng.random(B).astype(np.float32) * 4,
                              device=dev)
        res[B // 2] = 1e30
        for eps in (0.5, 2.0, 1e20):
            got = lo.prune_level(alive, res, w, qword, 1.3, eps, n, alphabet)
            want = ref.prune_level_ref(alive, res, w, tq,
                                       float(np.float32(1.3)),
                                       float(np.float32(eps)), n)
            errs["prune_level"] = max(errs["prune_level"],
                                      max_abs_diff(torch, got, want))
            check(torch.equal(got, want) and not bool(got[B // 2]),
                  f"prune_level differs from its plain version at B={B} "
                  f"N={N} eps={eps}")
        cases += 1
    return {"cases": cases}


def level_bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def level_phase12(torch, engine, lo, ref, index, queries, report) -> tuple:
    """Phase 12: kernels 8-12 against their plain versions on the card,
    8-9 also against the engine's device build of phase 3; their times.
    Returns (the build comparison's launch counts, per-kernel figures)."""
    from repro_torch.core import cost_model
    from repro_torch.kernels import ops
    from repro_torch.core.sax import discretize
    from repro_torch.data.timeseries import make_wafer_like

    x, B, n, A = index.series, index.size, index.n, index.alphabet
    errs = dict.fromkeys(LEVEL_REPLACES, 0.0)
    # Kernels 8-9 over phase 3's index: the engine's own columns.
    lo.reset_launch_counts()
    build = {}
    for li, N in enumerate(index.levels):
        k8, k9 = lo.linfit_residual_sq(x, N), lo.paa(x, N)
        for name, got, want in (
                ("linfit_residual_sq", k8, ref.linfit_residual_sq_ref(x, N)),
                ("paa", k9, ref.paa_ref(x, N))):
            errs[name] = max(errs[name], max_abs_diff(torch, got, want))
            check(torch.equal(got, want), f"{name} differs from its plain "
                  f"version at B={B} N={N}")
        res = torch.sqrt(k8)
        words = discretize(k9, A)
        build[N] = {
            "residual_rows_differ": int((res != index.residuals[li]).sum()),
            "word_rows_differ": int((words != index.words[li])
                                    .any(dim=1).sum())}
        check(build[N]["residual_rows_differ"] == 0
              and build[N]["word_rows_differ"] == 0,
              f"kernels 8-9 do not reproduce the device index at N={N}: "
              f"{build[N]}")
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in lo.KERNELS}
    check(launches["linfit_residual_sq"] > 0 and launches["paa"] > 0,
          f"kernels 8-9 did not launch: {launches}")
    log(f"[level-build] kernels 8-9 over phase 3's index (B={B}, n={n}): "
        f"sqrt(linfit) == residuals and discretize(paa) == words on every "
        f"row of both levels {build}; launches {launches}")

    # Kernels 10-12 at the path's shape: the finest level, one query.
    N = index.levels[-1]
    qr = engine.represent_queries(
        torch.as_tensor(queries[:1], dtype=torch.float32, device=x.device),
        index.levels, A)
    qword = qr.words[-1][0].cpu().numpy()
    qres = float(qr.residuals[-1][0])
    q = qr.q[0].contiguous()
    w, r = index.words[-1], index.residuals[-1]
    tq = lo.query_table(qword, A, x.device)
    ones = torch.ones(B, dtype=torch.bool, device=x.device)
    half = torch.arange(B, device=x.device) % 2 == 0
    checks = [("mindist_sq", lambda: lo.mindist_sq(w, qword, n, A),
               lambda: ref.mindist_sq_level_ref(w, tq, n)),
              ("sqdist", lambda: lo.sqdist(x, q),
               lambda: ref.sqdist_ref(x, q))]
    for eps in (1.0, 2.0, 4.0):
        for alive in (ones, half):
            checks.append(("prune_level",
                           lambda a=alive, e=eps: lo.prune_level(
                               a, r, w, qword, qres, e, n, A),
                           lambda a=alive, e=eps: ref.prune_level_ref(
                               a, r, w, tq, float(np.float32(qres)),
                               float(np.float32(e)), n)))
    for name, fn, plain in checks:
        got, want = fn(), plain()
        errs[name] = max(errs[name], max_abs_diff(torch, got, want))
        check(torch.equal(got, want),
              f"{name} differs from its plain version at B={B}")
    edges = level_edge_cases(torch, lo, ref, make_wafer_like, errs,
                             x.device)
    log(f"[level-kernels] kernels 8-12 bit-identical to their plain "
        f"versions at B={B} n={n} and at {edges['cases']} edge shapes; "
        f"max |kernel − plain| {errs}")

    # Times at B = 2^20, n = 128, the finest level N = 16: "ms" launches
    # the kernel alone (the table and the query word's offsets looked up
    # once; a launch outside the wrapper is not counted) and times the
    # card's work (device_ms), "call_ms" is the wrapper's whole call in a
    # loop, whose host work (checks, the offsets from the word) can exceed
    # a short kernel's time.
    M = torch.zeros((n, N), dtype=torch.float32, device=x.device)
    for s_ in range(N):
        M[s_ * (n // N):(s_ + 1) * (n // N), s_] = 1.0 / (n // N)
    f4 = 4.0
    tab = ops.mindist_table_cached(A, str(x.device))
    qoff = lo.query_offsets(qword, A)
    # Kernel 12 reads the words of the rows C9 keeps (alive ∧ |res − qres|
    # ≤ ε) only: its bound counts those of this run's inputs, beside the
    # bound of reading every row's words.
    q32 = float(np.float32(qres))
    c10_rows = int((torch.abs(r - q32) <= 2.0).sum())
    prune_full = B * (1 + 4 + N * 4 + 1) + A * A * f4
    o_res = torch.empty(B, dtype=torch.float32, device=x.device)
    o_paa = torch.empty((B, N), dtype=torch.float32, device=x.device)
    o_alive = torch.empty(B, dtype=torch.bool, device=x.device)
    timed = {
        "linfit_residual_sq": (
            lambda: lo._segment(1, x, N, None, o_res, "linfit"),
            lambda: lo.linfit_residual_sq(x, N),
            lambda: ref.linfit_residual_sq_ref(x, N), None,
            B * n * f4 + B * f4, B * n * 5.0 + B * N * 8.0),
        "paa": (lambda: lo._segment(0, x, N, None, o_paa, "paa"),
                lambda: lo.paa(x, N), lambda: ref.paa_ref(x, N),
                lambda: torch.matmul(x, M), B * n * f4 + B * N * f4,
                B * n * 1.0 + B * N),
        "mindist_sq": (
            lambda: lo._word(0, w, tab, qoff, n, A, None, None, 0.0, 0.0,
                             o_res, "mindist_sq"),
            lambda: lo.mindist_sq(w, qword, n, A),
            lambda: ref.mindist_sq_level_ref(w, tq, n), None,
            B * N * f4 + A * A * f4 + B * f4, B * N * 2.0 + B),
        "sqdist": (lambda: lo._segment(2, x, 1, q, o_res, "sqdist"),
                   lambda: lo.sqdist(x, q), lambda: ref.sqdist_ref(x, q),
                   lambda: torch.cdist(x, q[None]),
                   B * n * f4 + n * f4 + B * f4, B * n * 3.0),
        "prune_level": (
            lambda: lo._word(1, w, tab, qoff, n, A, ones, r, q32, 2.0,
                             o_alive, "prune_level"),
            lambda: lo.prune_level(ones, r, w, qword, qres, 2.0, n, A),
            lambda: ref.prune_level_ref(ones, r, w, tq, q32, 2.0, n), None,
            prune_full - (B - c10_rows) * N * f4,
            c10_rows * N * 2.0 + B * 6.0)}
    figures = {}
    for name, (kern, call, plain, lib, nbytes, ops) in timed.items():
        b_ms, b_by = level_bound(nbytes, ops)
        figures[name] = {
            "ms": device_ms(torch, kern, 20),
            "call_ms": cuda_ms(torch, call, 20),
            "plain_ms": cuda_ms(torch, plain, 3),
            "library_ms": cuda_ms(torch, lib, 20) if lib else None,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops,
            "max_abs_err": errs[name]}
        f = figures[name]
        log(f"[level-kernels] {name} at B={B} n={n} N={N}: {f['ms']:.4f} ms "
            f"(the wrapper's call {f['call_ms']:.4f} ms, plain "
            f"{f['plain_ms']:.3f} ms, library "
            f"{'—' if lib is None else format(f['library_ms'], '.4f')} ms, "
            f"bound {b_ms:.4f} ms by {b_by}: {nbytes / 1e6:.1f} MB; "
            f"{100 * b_ms / f['ms']:.1f} % of it)")
    full_ms = level_bound(prune_full, B * N * 2.0 + B * 6.0)[0]
    figures["prune_level"].update(c10_rows=c10_rows, full_read_bound_ms=full_ms)
    log(f"[level-kernels] prune_level read the words of the {c10_rows} "
        f"rows C9 keeps at eps=2.0; reading every row's words "
        f"({prune_full / 1e6:.1f} MB) would bound it at {full_ms:.4f} ms, "
        f"{100 * full_ms / figures['prune_level']['ms']:.1f} % of its time")
    # The direct launches computed what the wrappers compute.
    check(torch.equal(o_alive, ref.prune_level_ref(ones, r, w, tq, q32, 2.0,
                                                   n))
          and torch.equal(o_paa, ref.paa_ref(x, N)),
          "a direct launch differs from its wrapper's result")
    tiles = {}
    for kind, Nk in (("linfit", N), ("paa", N), ("sqdist", 1),
                     ("words", N)):
        rows, smem = lo.tile_of(kind, n, Nk)
        tiles[kind] = {"rows": rows, "smem": smem,
                       "blocks_per_sm": cost_model.blocks_per_sm(smem)}
    log(f"[level-kernels] tiles at n={n}: {tiles}")
    report["level_kernels"] = {"build": build, "edges": edges,
                               "figures": figures, "tiles": tiles,
                               "build_launches": launches}
    return launches, figures


def f64_columns(torch, host, dev, extra: str | None = None) -> dict:
    """A host index's cascade columns on the card for its f64 bounds: per
    level the f64 residuals and the symbols (``extra``: that column
    too), and the f64 MINDIST table."""
    from repro_torch.core.sax import mindist_table
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    return {"n": host.n,
            "tab": t(mindist_table(host.config.alphabet), torch.float64),
            "res": [t(lv.residuals, torch.float64) for lv in host.levels],
            "words": [t(lv.words, torch.int64) for lv in host.levels],
            "extra": [t(lv.extra[extra], torch.int64) if extra else None
                      for lv in host.levels]}


def host_bounds(torch, cols, r, li: int, extra: str | None = None):
    """Level ``li``'s f64 bounds of every row for the host-represented
    query ``r`` on the card, the expressions of the registry's host forms
    (``host_gap``, ``host_bound_sq``): ``(gap, sax², extra² or None)``."""
    tab, words = cols["tab"], cols["words"][li]
    Nseg = words.shape[1]
    dev = words.device
    gap = (cols["res"][li] - float(r.residuals[li])).abs()
    cell = tab[words, torch.as_tensor(r.words[li], device=dev).long()[None]]
    b2 = (cols["n"] / Nseg) * (cell * cell).sum(-1)
    if extra is None:
        return gap, b2, None
    cell = tab[cols["extra"][li],
               torch.as_tensor(r.extra[li][extra], device=dev).long()[None]]
    return gap, b2, (cell * cell).sum(-1)


def level_phase13(torch, engine, lo, ref, host, index, queries,
                  report) -> tuple:
    """Phase 13: the paper's online phase, one query and one level at a
    time on the card (kernels 10-12), against the port's op-counted host
    engines and against kernel 1.  Returns the phase's launch counts and
    ``sqdist``'s figures at its mean survivor count."""
    from repro_torch.core import search
    from repro_torch.core.fastsax import represent_query

    cfg, B, n = host.config, host.size, host.n
    A, dev = cfg.alphabet, index.device
    t0 = time.perf_counter()
    series = torch.as_tensor(host.series, dtype=torch.float32, device=dev)
    words = [torch.as_tensor(lv.words, dtype=torch.int32, device=dev)
             for lv in host.levels]
    resid = [torch.as_tensor(lv.residuals, dtype=torch.float32, device=dev)
             for lv in host.levels]
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    fine = list(cfg.levels).index(max(cfg.n_segments))
    cols = f64_columns(torch, host, dev)
    qs = queries[:LEVEL_QUERIES]
    dqr = engine.represent_queries(
        torch.as_tensor(qs, dtype=torch.float32, device=dev), index.levels,
        index.alphabet)
    keys = ("latency", "candidates", "excluded_c9", "excluded_c10")
    stats = {e: {eng: dict.fromkeys(keys + ("card_ms", "host_ms"), 0.0)
                 for eng in ("fastsax", "sax")} for e in LEVEL_EPS}
    tally = dict.fromkeys(("answers", "answer_band", "answer_wrong",
                           "cand_band", "cand_wrong", "k1_band",
                           "k1_wrong"), 0)
    lo.reset_launch_counts()
    for eps in LEVEL_EPS:
        eps2 = ref.eps_sq_f32(eps)
        k1_ans, _ = engine.range_query_fused(index, dqr, eps)
        k1_ans = k1_ans.cpu().numpy()
        for qi in range(len(qs)):
            qr = represent_query(qs[qi], cfg)
            q = torch.as_tensor(qr.q, dtype=torch.float32, device=dev)
            # FAST_SAX on the card: C9 + C10 per level, then the verify.
            torch.cuda.synchronize()
            t = time.perf_counter()
            alive = torch.ones(B, dtype=torch.bool, device=dev)
            for li in range(len(host.levels)):
                alive = lo.prune_level(alive, resid[li], words[li],
                                       qr.words[li], qr.residuals[li], eps,
                                       n, A)
            f_cand = torch.nonzero(alive).flatten()
            f_ans = f_cand[lo.sqdist(series[f_cand], q) <= eps2]
            f_cand, f_ans = f_cand.cpu().numpy(), f_ans.cpu().numpy()
            f_ms = (time.perf_counter() - t) * 1e3
            # SAX on the card: MINDIST at the finest level, the verify.
            t = time.perf_counter()
            md2 = lo.mindist_sq(words[fine], qr.words[fine], n, A)
            s_cand = torch.nonzero(md2 <= eps2).flatten()
            s_ans = s_cand[lo.sqdist(series[s_cand], q) <= eps2]
            s_cand, s_ans = s_cand.cpu().numpy(), s_ans.cpu().numpy()
            s_ms = (time.perf_counter() - t) * 1e3
            # The port's op-counted host engines (f64).
            t = time.perf_counter()
            rf = search.fastsax_range_query(host, qr, eps)
            hf_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            rs = search.sax_range_query(host, qr, eps)
            hs_ms = (time.perf_counter() - t) * 1e3
            # The host cascade's candidate sets and the f64 gap and bound
            # of every row (on the card), for the band rule.
            near = torch.zeros(B, dtype=torch.bool, device=dev)
            h_alive = torch.ones(B, dtype=torch.bool, device=dev)
            for li in range(len(host.levels)):
                gap, b2, _ = host_bounds(torch, cols, qr, li)
                near_b2 = (b2 - eps * eps).abs() <= band(eps * eps)
                near |= ((gap - eps).abs() <= band(eps)) | near_b2
                h_alive &= (gap <= eps) & (b2 <= eps * eps)
                if li == fine:
                    h_sax = (b2 <= eps * eps).cpu().numpy()
                    near_sax = near_b2.cpu().numpy()
            near, h_alive = near.cpu().numpy(), h_alive.cpu().numpy()
            check(int(h_alive.sum()) == rf.candidates
                  and int(h_sax.sum()) == rs.candidates,
                  "the host cascade's candidate sets do not match "
                  "search.py's counts")
            for got, want, near_of in (
                    (f_cand, np.nonzero(h_alive)[0], near),
                    (s_cand, np.nonzero(h_sax)[0], near_sax)):
                diff = np.setxor1d(got, want)
                tally["cand_band"] += int(near_of[diff].sum())
                tally["cand_wrong"] += int((~near_of[diff]).sum())
            for got, want, key in ((f_ans, rf.answers, "answer"),
                                   (s_ans, rs.answers, "answer"),
                                   (np.nonzero(k1_ans[qi])[0], f_ans, "k1")):
                diff = np.setxor1d(got, want)
                d2 = np.sum((host.series[diff] - qr.q) ** 2, axis=-1)
                near_d2 = np.abs(d2 - eps * eps) <= band(eps * eps)
                tally[f"{key}_band"] += int(near_d2.sum())
                tally[f"{key}_wrong"] += int((~near_d2).sum())
            tally["answers"] += len(rf.answers)
            for eng, r, card, hms in (("fastsax", rf, f_ms, hf_ms),
                                      ("sax", rs, s_ms, hs_ms)):
                st = stats[eps][eng]
                for key in keys:
                    st[key] += float(getattr(r, key)) / len(qs)
                st["card_ms"] += card / len(qs)
                st["host_ms"] += hms / len(qs)
        for eng in ("fastsax", "sax"):
            st = stats[eps][eng]
            log(f"[level-search] eps={eps} {eng}: op-counted latency "
                f"{st['latency']:.0f}, candidates {st['candidates']:.1f}, "
                f"excluded C9 {st['excluded_c9']:.1f} C10 "
                f"{st['excluded_c10']:.1f} (means over {len(qs)} queries); "
                f"card {st['card_ms']:.2f} ms in this checked run (FAST_SAX "
                f"first after the host engines; [level-breakdown] times "
                f"them back to back), host f64 {st['host_ms']:.1f} ms per "
                f"query")
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in lo.KERNELS}
    check(tally["answer_wrong"] == 0 and tally["cand_wrong"] == 0
          and tally["k1_wrong"] == 0,
          f"the level-at-a-time search disagrees outside the f32 band: "
          f"{tally}")
    check(all(launches[k] > 0 for k in ("mindist_sq", "sqdist",
                                         "prune_level")),
          f"a level kernel of the path did not launch: {launches}")
    log(f"[level-search] B={B}, {len(qs)} queries at eps {LEVEL_EPS}: "
        f"card against the host engines and kernel 1 {tally}; columns "
        f"uploaded in {upload_s:.2f}s; launches {launches}")
    sq = sqdist_at_survivors(torch, lo, ref, series, dqr.q[0].contiguous(),
                             stats)
    split = level_query_breakdown(torch, lo, host, series, words, resid, qs,
                                  fine)
    report["level_search"] = {"stats": {str(e): v for e, v in stats.items()},
                              "agreement": tally, "launches": launches,
                              "upload_s": upload_s,
                              "sqdist_at_survivors": sq,
                              "breakdown": split}
    return launches, sq


def level_query_breakdown(torch, lo, host, series, words, resid, qs,
                          fine) -> dict:
    """Where a level-at-a-time query's card time goes, after phase 13's
    counted run; means over its queries per ε and engine.  "card" is the
    whole query as phase 13 runs it, the engines back to back with no
    host-engine work between queries and in alternating order (FAST_SAX
    first on even queries, SAX first on odd): in the counted run the
    engine that comes first after the host engines' 70-400 ms finds the
    card idle.  Then the same steps, each on the host clock and ended by
    a synchronize: "host" the wrapper calls' return (checks, offsets, the
    launches: host work), "wait" the rest of their kernels, "nonzero" the
    candidates' indices (a device-to-host sync of its own), "verify" the
    gather, ``sqdist`` and the ε² cut, "copy" the ids to the host; and
    "kernels", the prune or MINDIST kernels alone on the card (CUDA
    events over 20 back-to-back launches)."""
    from repro_torch.core.fastsax import represent_query
    from repro_torch.kernels import ops, ref

    cfg, B, n = host.config, host.size, host.n
    A, dev = cfg.alphabet, series.device
    tab = ops.mindist_table_cached(A, str(dev))
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    steps = ("host", "wait", "nonzero", "verify", "copy")

    def query(eng, qr, q, eps, eps2, clock=None):
        """One query on the card; with ``clock``, a synchronize and a
        time stamp after each step."""
        def mark():
            if clock is not None:
                torch.cuda.synchronize()
                clock.append(time.perf_counter())
        if clock is not None:
            clock.append(time.perf_counter())
        if eng == "fastsax":
            alive = ones
            for li in range(len(words)):
                alive = lo.prune_level(alive, resid[li], words[li],
                                       qr.words[li], qr.residuals[li], eps,
                                       n, A)
        else:
            md2 = lo.mindist_sq(words[fine], qr.words[fine], n, A)
        if clock is not None:
            clock.append(time.perf_counter())
        mark()
        cand = torch.nonzero(alive if eng == "fastsax"
                             else md2 <= eps2).flatten()
        mark()
        ans = cand[lo.sqdist(series[cand], q) <= eps2]
        mark()
        cand.cpu().numpy(), ans.cpu().numpy()
        if clock is not None:
            clock.append(time.perf_counter())

    def kernels(eng, offs, q32, eps):
        if eng == "fastsax":
            o = [torch.empty(B, dtype=torch.bool, device=dev) for _ in words]
            ins = [ones] + o[:-1]
            return lambda: [lo._word(1, words[li], tab, offs[li], n, A,
                                     ins[li], resid[li], q32[li], eps, o[li],
                                     "prune") for li in range(len(words))]
        o = torch.empty(B, dtype=torch.float32, device=dev)
        return lambda: lo._word(0, words[fine], tab, offs[fine], n, A, None,
                                None, 0.0, 0.0, o, "mindist")

    out = {}
    for eps in LEVEL_EPS:
        eps2 = ref.eps_sq_f32(eps)
        acc = {eng: dict.fromkeys(("card",) + steps + ("kernels",), 0.0)
               for eng in ("fastsax", "sax")}
        for qi, qv in enumerate(qs):
            qr = represent_query(qv, cfg)
            q = torch.as_tensor(qr.q, dtype=torch.float32, device=dev)
            q32 = [float(np.float32(r)) for r in qr.residuals]
            offs = [lo.query_offsets(w, A) for w in qr.words]
            order = ("fastsax", "sax") if qi % 2 == 0 else ("sax", "fastsax")
            for eng in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                query(eng, qr, q, eps, eps2)
                acc[eng]["card"] += (time.perf_counter() - t0) * 1e3 / len(qs)
            for eng in order:
                torch.cuda.synchronize()
                clock = []
                query(eng, qr, q, eps, eps2, clock)
                for key, a, b in zip(steps, clock, clock[1:]):
                    acc[eng][key] += (b - a) * 1e3 / len(qs)
                acc[eng]["kernels"] += device_ms(
                    torch, kernels(eng, offs, q32, float(np.float32(eps))),
                    20) / len(qs)
        out[str(eps)] = acc
        for eng, a in acc.items():
            log(f"[level-breakdown] eps={eps} {eng}, ms per query: "
                + ", ".join(f"{k} {v:.4f}" for k, v in a.items())
                + f" (steps sum {sum(a[k] for k in steps):.4f})")
    return out


def sqdist_at_survivors(torch, lo, ref, series, q, stats) -> dict:
    """``sqdist`` at the shape phase 13 gives it: the mean number of
    survivors its launches saw (both engines, both radii), as rows of the
    series.  The kernel launched alone (not counted) back to back, where
    its rows (26 MB at 50,914) stay in the 50 MB L2, and L2-cold, 128 MB
    overwritten before each launch (that write's own time taken off); the
    wrapper's call, the plain version, ``torch.cdist`` and the bound, as
    phase 12 times it at 2^20 rows; the bound's share of each time."""
    m = int(round(np.mean([stats[e][eng]["candidates"] for e in LEVEL_EPS
                           for eng in ("fastsax", "sax")])))
    x = series[:m].contiguous()
    n = x.shape[1]
    out = torch.empty(m, dtype=torch.float32, device=x.device)
    lo._segment(2, x, 1, q, out, "sqdist")
    check(torch.equal(out, ref.sqdist_ref(x, q)),
          f"sqdist differs from its plain version at {m} rows")
    nbytes, ops = m * n * 4.0 + n * 4.0 + m * 4.0, m * n * 3.0
    b_ms, b_by = level_bound(nbytes, ops)
    def kern():
        lo._segment(2, x, 1, q, out, "sqdist")
    flush = torch.empty(32 << 20, dtype=torch.float32, device=x.device)
    flush_ms = device_ms(torch, flush.zero_, 20)
    f = {"rows": m, "ms": device_ms(torch, kern, 20),
         "cold_ms": device_ms(torch, lambda: (flush.zero_(), kern()), 20)
         - flush_ms,
         "flush_ms": flush_ms,
         "call_ms": cuda_ms(torch, lambda: lo.sqdist(x, q), 20),
         "plain_ms": cuda_ms(torch, lambda: ref.sqdist_ref(x, q), 3),
         "library_ms": cuda_ms(torch, lambda: torch.cdist(x, q[None]), 20),
         "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops}
    f["share"], f["cold_share"] = b_ms / f["ms"], b_ms / f["cold_ms"]
    del flush
    log(f"[level-kernels] sqdist at phase 13's mean survivor count ({m} "
        f"rows, n={n}): {f['ms']:.4f} ms back to back, {f['cold_ms']:.4f} "
        f"ms L2-cold (the wrapper's call {f['call_ms']:.4f} ms, plain "
        f"{f['plain_ms']:.3f} ms, torch.cdist {f['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms by {b_by}: {nbytes / 1e6:.2f} MB; "
        f"{100 * f['share']:.1f} % of it warm, {100 * f['cold_share']:.1f} "
        f"% cold)")
    return f


# ---------------------------------------------------------------------------
# Phase 14: the index lifecycle — committed stores, warm starts, live
# ingest, the subsequence store and the load generators.
# ---------------------------------------------------------------------------

LIFECYCLE_MIN_FREE = 6 << 30       # bytes the phase's stores may take
INGEST_ROWS, INGEST_DELETES, SWAP_ROWS = 4096, 1024, 512


def store_dir() -> pathlib.Path:
    """A fresh directory for phase 14's stores on the filesystem with the
    most free space of the temporary directory and the checkout's
    git-ignored ``build/``; fails when fewer than 6 GB are free."""
    import tempfile
    candidates = [pathlib.Path(tempfile.gettempdir()), ROOT / "build"]
    for c in candidates:
        c.mkdir(parents=True, exist_ok=True)
    best = max(candidates, key=lambda c: shutil.disk_usage(c).free)
    free = shutil.disk_usage(best).free
    check(free >= LIFECYCLE_MIN_FREE,
          f"phase 14 needs {LIFECYCLE_MIN_FREE >> 30} GB for its stores; "
          f"the roomiest filesystem ({best}) has {free / 2**30:.1f} GB free")
    return pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_stores_",
                                         dir=best))


def counted(torch, fq, fn):
    """``fn()`` with every launch count at 0 first; returns its result and
    the counts after it."""
    fq.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in fq.KERNELS}


def add_launches(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def same_answers(a, b, exact: bool) -> bool:
    """Two lists of (ids, distances): ids equal, distances bit for bit
    (``exact``) or to the replay's 1e-6."""
    for (ia, da), (ib, db) in zip(a, b):
        if not np.array_equal(ia, ib):
            return False
        if not (np.array_equal(da, db) if exact else
                np.allclose(da, db, rtol=1e-6, atol=1e-9)):
            return False
    return len(a) == len(b)


def direct_answers(service, workload) -> list:
    return [service.direct_query(kind, q, epsilon=eps, k=k)
            for kind, q, eps, k in workload]


def lifecycle_store(torch, engine, fq, host, queries, workload, result,
                    root, smi, launches) -> tuple:
    """Step 1: a plain store of phase 7's host index, verified and
    warm-started on the default ServeConfig; phase 5's 64 requests."""
    from repro_torch.index.store import save_index, verify_store
    from repro_torch.serve import SearchService, ServeConfig
    from repro_torch.serve.service import _SingleBackend

    path = root / "plain"
    t0 = time.perf_counter()
    save_index(host, path)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    verify_store(path)
    t_verify = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc = SearchService.from_store(path)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    kind, q, eps, k = workload[0]
    svc.direct_query(kind, q, epsilon=eps, k=k)
    t_first = time.perf_counter() - t0
    check(svc.backend.backend == "cuda" and svc.mutable is None,
          "the warm start must serve through the kernels")
    t0 = time.perf_counter()
    svc.warmup()
    t_warmup = time.perf_counter() - t0
    direct = engine.device_index_from_host(host)
    check(all(torch.equal(a, b) for a, b in zip(
        (svc.backend.index.series, svc.backend.index.norms_sq,
         *svc.backend.index.words, *svc.backend.index.residuals),
        (direct.series, direct.norms_sq, *direct.words, *direct.residuals))),
        "the index served from the store is not the direct upload")
    res, launched = serve_phase(torch, fq, svc, workload, "lifecycle-store")
    add_launches(launches, launched)
    check(res.served == len(workload), f"served {res.served}")
    check(launched["fused_range"] > 0 and launched["fused_topk"] > 0,
          f"kernels 1-2 did not launch from the warm start: {launched}")
    mismatches, _ = replay_check(svc, workload, res, "lifecycle-store")
    ref_svc = SearchService(_SingleBackend(direct, ServeConfig()))
    bit_equal = same_answers(direct_answers(svc, workload),
                             direct_answers(ref_svc, workload), exact=True)
    check(bit_equal, "store-served answers differ from the direct upload's")
    del ref_svc, direct
    vs_cold = cross_check(host.series, workload, res, result)
    check(vs_cold["wrong"] == 0,
          f"warm answers against phase 5's cold build: {vs_cold}")
    split = breakdown(torch, engine, fq, svc, queries,
                      label="lifecycle-store-breakdown")
    out = {"breakdown": split, "save_s": t_save, "verify_store_s": t_verify,
           "from_store_s": t_load, "warm_start_to_first_answer_s": t_first,
           "warmup_s": t_warmup, "store_bytes": sum(
               f.stat().st_size for f in path.iterdir()),
           "launches": launched, "exact_mismatches": mismatches,
           "bit_identical_to_direct_upload": bit_equal,
           "vs_phase5": vs_cold, "qps": res.qps}
    log(f"[lifecycle-store] {smi}: save {t_save:.2f}s "
        f"({out['store_bytes']} bytes), verify_store {t_verify:.2f}s, "
        f"warm start {t_load:.2f}s to the index, {t_first:.2f}s to the "
        f"first answer; 64 requests at {res.qps:.2f} qps, launches "
        f"{launched}, replay mismatches {mismatches}; answers bit-identical "
        f"to device_index_from_host: {bit_equal}; against phase 5 {vs_cold}")
    return svc, out


def lifecycle_loadgen(svc, workload, smi) -> dict:
    """Step 5: the saturated and the sequential load generators over the
    warm-started service; the benchmark database without a UCR file."""
    import os

    from repro_torch.data.timeseries import (benchmark_database,
                                             make_wafer_like)
    from repro_torch.serve import run_saturated, run_sequential

    check(svc.cfg.max_queue >= len(workload), "max_queue below the workload")
    with svc:
        sat = run_saturated(svc, workload)
    check(sat.served == len(workload), f"saturated: served {sat.served}")
    seq_s, seq = run_sequential(svc, workload)
    equal = same_answers(seq, [(r.ids, r.distances) for r in sat.requests],
                         exact=False)
    check(equal, "run_sequential's answers differ from the saturated run's")
    saved = os.environ.pop("REPRO_UCR_PATH", None)
    try:
        bench_ok = np.array_equal(benchmark_database(128, seed=0),
                                  make_wafer_like(length=128, seed=0))
    finally:
        if saved is not None:
            os.environ["REPRO_UCR_PATH"] = saved
    check(bench_ok, "benchmark_database is not make_wafer_like's rows")
    out = {"saturated_qps": sat.qps, "saturated_wall_s": sat.wall_s,
           "sequential_qps": len(workload) / seq_s, "sequential_wall_s": seq_s,
           "answers_equal": equal, "benchmark_database_is_wafer_like": True}
    log(f"[lifecycle-loadgen] {smi}: run_saturated {sat.qps:.2f} qps "
        f"({sat.wall_s:.2f}s), run_sequential "
        f"{out['sequential_qps']:.2f} qps ({seq_s:.2f}s) over the warm "
        f"start; answers equal request by request: {equal}")
    return out


def lifecycle_quantized(torch, engine, fq, host, queries, workload,
                        qresult, root, smi, launches) -> dict:
    """Step 2: an int8 store served from its stored tier, zero-copy."""
    from repro_torch.index import quantized as tq
    from repro_torch.index import store
    from repro_torch.serve import SearchService, ServeConfig

    path = root / "int8"
    t0 = time.perf_counter()
    store.save_index(host, path, quantization="int8")
    t_save = time.perf_counter() - t0
    calls = []
    real = tq.quantize_host_index
    tq.quantize_host_index = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        t0 = time.perf_counter()
        svc = SearchService.from_store(path, ServeConfig(quantization="int8"))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    finally:
        tq.quantize_host_index = real
    stored = store.load_quantized(path, mode="int8")
    qdev = svc.backend.tindex.dev
    zero_copy = not calls and np.array_equal(
        qdev.series.cpu().numpy(), np.asarray(stored.series)) and all(
        np.array_equal(t.cpu().numpy(), np.asarray(lv.residuals))
        for t, lv in zip(qdev.residuals, stored.levels))
    check(zero_copy, f"the stored int8 tier was not served as stored "
          f"({len(calls)} requantizations)")
    t0 = time.perf_counter()
    svc.warmup()
    log(f"[lifecycle-int8] warmup {time.perf_counter() - t0:.1f}s")
    res, launched = serve_phase(torch, fq, svc, workload, "lifecycle-int8")
    add_launches(launches, launched)
    check(res.served == len(workload), f"int8 store: served {res.served}")
    check(launched["fused_quant_range"] > 0,
          f"kernel 5 did not launch from the stored tier: {launched}")
    mismatches, _ = replay_check(svc, workload, res, "lifecycle-int8")
    equal = same_answers([(r.ids, r.distances) for r in res.requests],
                         [(r.ids, r.distances) for r in qresult.requests],
                         exact=False)
    check(equal, "the int8 store's answers differ from phase 8's")
    split = quant_breakdown(torch, engine, svc, queries,
                            label="lifecycle-int8-breakdown")
    out = {"breakdown": split, "save_s": t_save, "from_store_s": t_load,
           "requantizations": len(calls), "launches": launched,
           "exact_mismatches": mismatches, "equal_to_phase8": equal,
           "qps": res.qps}
    log(f"[lifecycle-int8] {smi}: save with the int8 tier {t_save:.2f}s, "
        f"warm start {t_load:.2f}s (stored tier served as stored, 0 "
        f"requantizations); 64 requests at {res.qps:.2f} qps, launches "
        f"{launched}, replay mismatches {mismatches}, answers equal to "
        f"phase 8's: {equal}")
    del svc
    shutil.rmtree(path)
    return out


def lifecycle_ingest(torch, fq, host, workload, root, smi,
                     launches) -> dict:
    """Step 3: a MutableIndex root warm-started with live ingest: inserts
    and deletes, a refresh, compaction, and a background swap with
    requests in flight."""
    import threading

    from repro_torch.core.fastsax import FastSAXConfig
    from repro_torch.data.timeseries import make_wafer_like
    from repro_torch.index.mutable import MutableIndex
    from repro_torch.serve import SearchService, run_closed_loop

    path = root / "mutable"
    t0 = time.perf_counter()
    mi = MutableIndex.create(path, host.series,
                             FastSAXConfig(n_segments=(8, 16), alphabet=10),
                             normalize=False)
    t_create = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc = SearchService.from_store(path)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(svc.mutable is not None, "a root must warm-start with live ingest")
    svc.warmup()
    out = {"create_s": t_create, "from_store_s": t_load}
    rng = np.random.default_rng(1)
    new_rows = make_wafer_like(INGEST_ROWS, 128, seed=1)
    with svc:
        t0 = time.perf_counter()
        new_ids = svc.insert(new_rows)
        t_insert = time.perf_counter() - t0
        base = np.sort(rng.choice(N_SERVE, INGEST_DELETES - 64,
                                  replace=False))
        dead = np.concatenate([base, new_ids[8::64][:64]])
        t0 = time.perf_counter()
        svc.delete(dead)
        t_delete = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc.refresh()
        t_refresh = time.perf_counter() - t0
        out["insert"] = {"rows": INGEST_ROWS, "insert_s": t_insert,
                         "delete_s": t_delete, "deleted": int(dead.size),
                         "refresh_s": t_refresh,
                         "refresh_steps_s": dict(svc.last_refresh_times)}
        live, live_ids = svc.mutable.live_index()
        check(svc.backend.size == N_SERVE + INGEST_ROWS - dead.size,
              f"{svc.backend.size} rows served after the refresh")
        res, launched = counted(torch, fq, lambda: run_closed_loop(
            svc, workload, clients=16))
        add_launches(launches, launched)
        check(res.served == len(workload), f"ingest: served {res.served}")
        check(launched["fused_range"] > 0 and launched["fused_topk"] > 0,
              f"kernels 1-2 did not launch after the ingest: {launched}")
        mismatches, _ = replay_check(svc, workload, res, "lifecycle-ingest")
        bf = brute_force_check(live.series, workload, res, 16,
                               ids=np.asarray(live_ids))
        check(bf["wrong"] == 0 and bf["checked"] == 16,
              f"ingest answers against the f64 brute force: {bf}")
        answered = np.concatenate([r.ids for r in res.requests])
        own = [int(svc.knn(new_rows[j], 1)[0][0]) for j in range(8)]
        check(own == [int(i) for i in new_ids[:8]],
              f"inserted rows are not their own nearest neighbours: {own}")
        check(not np.isin(np.concatenate([answered, own]), dead).any(),
              "a deleted id was answered")
        before = direct_answers(svc, workload)
        del live, live_ids
        t0 = time.perf_counter()
        svc.mutable.compact()
        t_compact = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc.refresh()
        t_refresh2 = time.perf_counter() - t0
        after = direct_answers(svc, workload)
        unchanged = same_answers(before, after, exact=True)
        check(unchanged, "compaction changed the answers")
        out["serve"] = {"launches": launched, "exact_mismatches": mismatches,
                        "brute_force": bf, "own_nearest": True,
                        "deleted_ids_answered": 0, "qps": res.qps}
        out["compact"] = {"compact_s": t_compact, "refresh_s": t_refresh2,
                          "refresh_steps_s": dict(svc.last_refresh_times),
                          "answers_unchanged": unchanged}
        log(f"[lifecycle-ingest] {smi}: MutableIndex.create over "
            f"{N_SERVE} rows {t_create:.2f}s, warm start {t_load:.2f}s; "
            f"insert {INGEST_ROWS} rows {t_insert:.3f}s, delete "
            f"{dead.size} ids {t_delete:.3f}s, refresh {t_refresh:.2f}s "
            f"(steps {svc_steps(out['insert'])}); 64 requests at "
            f"{res.qps:.2f} qps, launches {launched}, replay mismatches "
            f"{mismatches}; f64 brute force over the live rows {bf}; 8 "
            f"inserted rows their own nearest neighbours, no deleted id "
            f"answered; compact {t_compact:.2f}s, refresh {t_refresh2:.2f}s "
            f"(steps {svc_steps(out['compact'])}), answers unchanged")
        # The background swap, with requests in flight.
        swaps0 = svc.stats.snapshot()["events"]["refresh_swaps"]
        gen0 = svc.generation
        swap_rows = make_wafer_like(SWAP_ROWS, 128, seed=2)
        inserter = threading.Thread(target=svc.insert, args=(swap_rows,))
        rounds = []
        deadline = time.perf_counter() + 300.0
        fq.reset_launch_counts()
        inserter.start()
        while (svc.generation == gen0 or not rounds
               or rounds[-1][0] <= svc._last_refresh):
            check(time.perf_counter() < deadline,
                  "the background swap did not land in 300 s")
            rounds.append((time.perf_counter(),
                           run_closed_loop(svc, workload, clients=16)))
        inserter.join()
        torch.cuda.synchronize()
        add_launches(launches, {k.__name__: k.launches for k in fq.KERNELS})
        swapped_at = svc._last_refresh
        after_swap = [(w, r) for _, rr in rounds
                      for w, r in zip(workload, rr.requests)
                      if r.t_submit > swapped_at]
        bad = 0
        for (kind, q, eps, k), req in after_swap:
            ids, dist = svc.direct_query(kind, q, epsilon=eps, k=k)
            bad += not (req.status == "ok" and np.array_equal(ids, req.ids)
                        and np.allclose(dist, req.distances, rtol=1e-6,
                                        atol=1e-9))
        events = svc.stats.snapshot()["events"]
        check(events["refresh_swaps"] > swaps0
              and events["refresh_failures"] == 0,
              f"background swap: {events}")
        check(after_swap and bad == 0,
              f"{bad} of {len(after_swap)} requests served after the swap "
              f"do not replay")
        out["background_swap"] = {
            "rows": SWAP_ROWS, "rounds": len(rounds),
            "requests_after_swap": len(after_swap), "mismatches": bad,
            "refresh_swaps": events["refresh_swaps"],
            "refresh_failures": events["refresh_failures"],
            "refresh_steps_s": dict(svc.last_refresh_times)}
        log(f"[lifecycle-swap] {smi}: {SWAP_ROWS} rows inserted with "
            f"{len(rounds)} rounds of 64 requests in flight; background "
            f"swap steps {svc_steps(out['background_swap'])}; "
            f"{len(after_swap)} requests served after it, replay "
            f"mismatches {bad}; refresh swaps {events['refresh_swaps']}, "
            f"failures {events['refresh_failures']}")
    del svc, mi
    shutil.rmtree(path)
    return out


def svc_steps(d: dict) -> str:
    return ", ".join(f"{k[:-2]} {v:.3f}s"
                     for k, v in d["refresh_steps_s"].items())


def lifecycle_subseq(torch, fq, sub, root, smi, launches) -> dict:
    """Step 4: phase 9's subsequence index through a store; phase 10's
    engine calls on the loaded index, and the service's warm start."""
    from repro_torch.core import subseq as ss
    from repro_torch.core.options import SearchOptions
    from repro_torch.launch.serve import _SubseqLoadShim
    from repro_torch.serve import (ServeConfig, SubseqSearchService,
                                   WorkloadSpec, make_workload)

    cfg = SUBSEQ
    path = root / "subseq"
    t0 = time.perf_counter()
    ss.save_subseq_index(sub["hidx"], path)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    hidx = ss.load_subseq_index(path)
    sidx = ss.subseq_device_index(hidx)
    qmeta = ss.quantize_subseq_meta(hidx, "int8")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    qr = ss.represent_subseq_queries(sidx, sub["queries"])
    auto = SearchOptions(backend="auto")
    (got, launched) = counted(torch, fq, lambda: (
        ss.subseq_range_query(sidx, qr, cfg["eps"], auto),
        ss.subseq_knn_query(sidx, qr, cfg["k"], excl=cfg["excl"],
                            options=auto),
        ss.subseq_range_query_quantized(sidx, qmeta, qr, cfg["eps"])))
    add_launches(launches, launched)
    check(launched["fused_subseq_range"] > 0
          and launched["fused_subseq_topk"] > 0
          and launched["fused_quant_subseq_range"] > 0,
          f"kernels 3, 4, 7 did not launch from the loaded store: {launched}")
    (ans, d2), (sel, sel_d2, exact), (qans, qd2) = got
    bit = (torch.equal(ans, sub["ans"])
           and torch.equal(d2.view(torch.int32), sub["d2"].view(torch.int32))
           and np.array_equal(sel, sub["sel"])
           and np.array_equal(sel_d2, sub["sel_d2"])
           and np.array_equal(exact, sub["exact"])
           and torch.equal(qans, sub["qans"])
           and torch.equal(qd2.view(torch.int32),
                           sub["qd2"].view(torch.int32)))
    check(bit, "the loaded subsequence index answers differ from phase 10's")
    t0 = time.perf_counter()
    svc = SubseqSearchService.from_store(path, ServeConfig(),
                                         excl=cfg["excl"])
    torch.cuda.synchronize()
    t_svc = time.perf_counter() - t0
    svc.warmup(ks=(svc._fetch_k(cfg["k"], svc.excl),))
    workload = make_workload(sub["queries"], WorkloadSpec(
        n_requests=16, knn_frac=0.5, k=cfg["k"], epsilon=cfg["eps"]))
    shim = _SubseqLoadShim(svc)
    res, svc_launched = serve_phase(torch, fq, svc, workload,
                                    "lifecycle-subseq", front=shim)
    add_launches(launches, svc_launched)
    check(res.served == len(workload), f"subseq store: served {res.served}")
    mismatches, _ = replay_check(shim, workload, res, "lifecycle-subseq")
    out = {"save_s": t_save, "load_and_upload_s": t_load,
           "service_from_store_s": t_svc, "engine_launches": launched,
           "bit_identical_to_phase10": bit, "service_launches": svc_launched,
           "exact_mismatches": mismatches, "store_bytes": sum(
               f.stat().st_size for f in path.iterdir())}
    log(f"[lifecycle-subseq] {smi}: save_subseq_index {t_save:.2f}s "
        f"({out['store_bytes']} bytes), load + upload {t_load:.2f}s; "
        f"engine calls launched {launched}, answers bit-identical to phase "
        f"10's: {bit}; SubseqSearchService.from_store {t_svc:.2f}s, 16 "
        f"requests, replay mismatches {mismatches}")
    del svc, sidx
    shutil.rmtree(path)
    return out


def lifecycle_phase(torch, engine, fq, host, queries, workload, result,
                    qresult, sub, report) -> dict:
    """Phase 14; returns the launch counts of its counted runs, summed."""
    smi = report["env"]["nvidia_smi"]
    root = store_dir()
    launches: dict = {}
    try:
        svc, step1 = lifecycle_store(torch, engine, fq, host, queries,
                                     workload, result, root, smi, launches)
        step5 = lifecycle_loadgen(svc, workload, smi)
        del svc
        shutil.rmtree(root / "plain")
        step2 = lifecycle_quantized(torch, engine, fq, host, queries,
                                    workload, qresult, root, smi, launches)
        step3 = lifecycle_ingest(torch, fq, host, workload, root, smi,
                                 launches)
        step4 = lifecycle_subseq(torch, fq, sub, root, smi, launches)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["lifecycle"] = {"card": smi, "store_dir": str(root.parent),
                           "store": step1, "quantized_store": step2,
                           "live_ingest": step3, "subseq_store": step4,
                           "load_generators": step5, "launches": launches}
    log(f"[lifecycle] launches of phase 14's counted runs: {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: traced serving — the cascade counters, the span ring, the
# calibration log, the metrics text and a torch.profiler trace of the card.
# ---------------------------------------------------------------------------

OBS_EPS = 2.0                  # the range radius of the counter checks
OBS_K = 5                      # the k-NN k of the counter checks
OBS_HOST_QUERIES = 4           # held against the op-counted host engine
OBS_TIER_REQUESTS = 16         # of phase 5's requests, through the tier
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trend_bound_plain(torch, ops, twords, q_twords, alphabet: int):
    """(Q, B) trend_slope bound Σᵢ tab[uᵢ, qᵢ]² by its plain expression:
    a gather from the query panels (``ops.query_panels``), summed in
    ``paa.row_sum``'s order."""
    from repro_torch.core.paa import row_sum
    panels = ops.query_panels(q_twords, alphabet)          # (Q, α, N)
    Q, A, Nseg = panels.shape
    flat = twords.long() * Nseg + torch.arange(Nseg,
                                               device=twords.device)[None]
    cell = torch.gather(panels.reshape(Q, A * Nseg), 1,
                        flat.reshape(1, -1).expand(Q, -1))
    cell = cell.reshape(Q, twords.shape[0], Nseg)
    return row_sum(cell * cell)


def trend_columns(index, qr) -> tuple:
    """The trend_slope columns of an index and its queries, per level, or
    ``(None, None)`` for the paper stack."""
    if not index.extra:
        return None, None
    return ([lv["trend_slope"] for lv in index.extra],
            [lv["trend_slope"] for lv in qr.extra])


def plain_level_counts(torch, ref, ops, words, residuals, q_words, q_res,
                       eps, levels, n: int, alphabet: int, widen=None,
                       twords=None, q_twords=None) -> tuple:
    """Per query, the survivors after each level's C9 and after its C10
    (and, with ``twords``, its trend_slope test) by the plain versions'
    expressions (``ref.cascade_alive_ref``, one test at a time; with
    ``widen``, ``ref.quant_meta_alive_ref``'s widened C9):
    ``(after_c9, after_c10)``, (Q, L) numpy."""
    eps_c = eps.reshape(-1, 1)
    eps2 = eps_c * eps_c
    alive, a9, a10 = None, [], []
    for li, N in enumerate(levels):
        lim = eps_c if widen is None else eps_c + widen[li][None, :]
        ok = torch.abs(residuals[li][None, :] - q_res[li][:, None]) <= lim
        alive = ok if alive is None else alive & ok
        a9.append(alive.sum(dim=-1))
        alive &= ref.mindist_sq_ref(
            words[li], ops.query_panels(q_words[li], alphabet), N, n) <= eps2
        if twords is not None:
            alive &= trend_bound_plain(torch, ops, twords[li], q_twords[li],
                                       alphabet) <= eps2
        a10.append(alive.sum(dim=-1))
    return (torch.stack(a9, -1).cpu().numpy(),
            torch.stack(a10, -1).cpu().numpy())


def counters_equal(trace, counts) -> bool:
    from repro_torch.obs.trace import to_host
    t = to_host(trace)
    return bool(np.array_equal(t.after_c9, counts[0])
                and np.array_equal(t.after_c10, counts[1]))


def index_counts(torch, ref, ops, index, qr, eps) -> tuple:
    """:func:`plain_level_counts` over a ``DeviceIndex``'s columns."""
    tw, qtw = trend_columns(index, qr)
    return plain_level_counts(torch, ref, ops, index.words, index.residuals,
                              qr.words, qr.residuals, eps, index.levels,
                              index.n, index.alphabet, twords=tw,
                              q_twords=qtw)


def quant_counts(torch, ref, ops, qdev, qr, eps) -> tuple:
    """:func:`plain_level_counts` over the tier's quantized columns (the
    widened cascade of ``quant_alive_by_level``)."""
    B = qdev.size
    res = [ref.dequant_residuals(qdev.residuals[li], qdev.resid_scale[li],
                                 qdev.resid_zero[li])
           for li in range(len(qdev.levels))]
    err = [ref.expand_block_col(qdev.resid_err[li], B)
           for li in range(len(qdev.levels))]
    tw, qtw = trend_columns(qdev, qr)
    return plain_level_counts(torch, ref, ops, qdev.words, res, qr.words,
                              qr.residuals, eps, qdev.levels, qdev.n,
                              qdev.alphabet, widen=err, twords=tw,
                              q_twords=qtw)


def host_op_counts(torch, engine, ref, ops, host, queries, eps,
                   device) -> dict:
    """The traced counters of a host index uploaded (the queries
    represented on the host) against the op-counted host engine
    ``search.fastsax_range_query`` over its stack: per row, the level and
    test that kills it (C9, C10, and trend_slope when the stack has it)
    or none, on the card and on the host (f64 bounds, computed on the
    card); rows killed elsewhere on the card must lie in the f32 band of
    a bound (``|gap − ε|`` or ``|bound² − ε²|`` within 1e-3 + 1e-5·x),
    none outside it."""
    from repro_torch.core import search
    from repro_torch.core.fastsax import represent_query
    from repro_torch.obs.trace import excluded_c9, excluded_c10, to_host

    cfg, B, n, A = host.config, host.size, host.n, host.config.alphabet
    L = len(host.levels)
    trend = "trend_slope" if "trend_slope" in cfg.stack else None
    T = 3 if trend else 2                       # tests per level
    dindex = engine.device_index_from_host(host, device)
    reps = [represent_query(q, cfg) for q in queries]
    dev = dindex.device
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    qr = engine.QueryReprDev(
        q=t(np.stack([r.q for r in reps]), torch.float32),
        words=tuple(t(np.stack([r.words[li] for r in reps]), torch.int32)
                    for li in range(L)),
        residuals=tuple(t([r.residuals[li] for r in reps], torch.float32)
                        for li in range(L)),
        extra=tuple({trend: t(np.stack([r.extra[li][trend] for r in reps]),
                              torch.int32)} for li in range(L))
        if trend else ())
    _, _, tr = engine.range_query_traced(dindex, qr, eps)
    tr = to_host(tr)
    eps_t = torch.full((len(reps),), eps, dtype=torch.float32, device=dev)
    check(counters_equal(tr, index_counts(torch, ref, ops, dindex, qr,
                                          eps_t)),
          "the host index's counters differ from the plain versions")
    cols = f64_columns(torch, host, dev, trend)
    out = {"queries": len(reps), "band_rows": 0, "wrong_rows": 0,
           "card": [], "host": []}
    for qi, r in enumerate(reps):
        rf = search.fastsax_range_query(host, r, eps)
        near = torch.zeros(B, dtype=torch.bool, device=dev)
        h_alive = torch.ones(B, dtype=torch.bool, device=dev)
        d_alive = torch.ones(B, dtype=torch.bool, device=dev)
        h_stage = torch.full((B,), T * L, device=dev)
        d_stage = torch.full((B,), T * L, device=dev)
        e32 = eps_t[qi]
        one = slice(qi, qi + 1)
        for li, lv in enumerate(host.levels):
            Nseg = lv.n_segments
            gap, b2, t2 = host_bounds(torch, cols, r, li, trend)
            h_ok = [gap <= eps, b2 <= eps * eps]
            near |= ((gap - eps).abs() <= band(eps)) | \
                ((b2 - eps * eps).abs() <= band(eps * eps))
            d_ok = [(dindex.residuals[li] - qr.residuals[li][qi]).abs()
                    <= e32,
                    ref.mindist_sq_ref(dindex.words[li], ops.query_panels(
                        qr.words[li][one], A), Nseg, n)[0] <= e32 * e32]
            if trend:
                h_ok.append(t2 <= eps * eps)
                near |= (t2 - eps * eps).abs() <= band(eps * eps)
                d_ok.append(trend_bound_plain(
                    torch, ops, dindex.extra[li][trend],
                    qr.extra[li][trend][one], A)[0] <= e32 * e32)
            for j, (hk, dk) in enumerate(zip(h_ok, d_ok)):
                h_stage[h_alive & ~hk] = T * li + j
                h_alive &= hk
                d_stage[d_alive & ~dk] = T * li + j
                d_alive &= dk
        check(int(h_alive.sum()) == rf.candidates,
              "the host cascade's survivors differ from search.py's count")
        diff = (d_stage != h_stage).cpu().numpy()
        near = near.cpu().numpy()
        out["band_rows"] += int((diff & near).sum())
        out["wrong_rows"] += int((diff & ~near).sum())
        out["card"].append([int(excluded_c9(tr, B).sum(-1)[qi]),
                            int(excluded_c10(tr).sum(-1)[qi]),
                            int(tr.candidates[qi])])
        out["host"].append([rf.excluded_c9, rf.excluded_c10, rf.candidates])
    check(out["wrong_rows"] == 0,
          f"the traced counters disagree with the host op counts outside "
          f"the f32 band: {out}")
    off = sum(abs(a - b) for c, h in zip(out["card"], out["host"])
              for a, b in zip(c, h))
    check(off <= 2 * out["band_rows"],
          f"counter differences not explained by band rows: {out}")
    del dindex
    return out


def union_ms(intervals) -> float:
    """Length of the union of (start, end) µs intervals, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def profile_dispatches(paths) -> list:
    """One entry per Chrome trace of ``profiler_capture``: the capture
    window (first event to last end), the card's busy time (the union of
    kernel and copy intervals), the idle share of the window and the top
    device operations by time."""
    out = []
    for path in paths:
        events = [e for e in json.loads(pathlib.Path(path).read_text())
                  .get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e and "ts" in e]
        devs = [e for e in events if e.get("cat") in DEVICE_CATS]
        t0 = min(e["ts"] for e in events)
        t1 = max(e["ts"] + e["dur"] for e in events)
        by_name: dict = {}
        for e in devs:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
        busy = union_ms([(e["ts"], e["ts"] + e["dur"]) for e in devs])
        window = (t1 - t0) / 1e3
        out.append({
            "file": pathlib.Path(path).name, "window_ms": window,
            "device_events": len(devs), "busy_ms": busy,
            "kernels": sorted({short_name(e["name"]) for e in devs}),
            "idle_share": (1.0 - busy / window) if devs else None,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:6]})
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0][:60] or name[:60]


def obs_phase(torch, engine, fq, ref, ops, index, host, queries, workload,
              result, tier8, sub, report) -> dict:
    """Phase 15; returns the launch counts of its main-path runs."""
    import tempfile
    import urllib.request

    from repro_torch.core import subseq as ss
    from repro_torch.core.options import SearchOptions
    from repro_torch.obs.metrics import (REQUIRED_FAMILIES,
                                         start_metrics_server)
    from repro_torch.obs.trace import select_queries, to_host, trace_totals
    from repro_torch.serve import SearchService, ServeConfig
    from repro_torch.serve.service import _QuantizedBackend, _SingleBackend

    t_phase = time.perf_counter()
    obs = {}
    launches: dict = {}
    B = index.size

    def service(cfg, tiered=False):
        backend = (_QuantizedBackend(tier8, cfg) if tiered
                   else _SingleBackend(index, cfg))
        return SearchService(backend, cfg)

    # ---- 1. serve-1M, traced: phase 5's index and requests
    svc = service(ServeConfig(trace=True))
    traces = []
    dispatch = svc.backend.dispatch

    def recording(*args, **kw):
        out = dispatch(*args, **kw)
        if kw.get("want_trace"):
            traces.append(svc.backend.last_trace)
        return out

    svc.backend.dispatch = recording
    res, ln = serve_phase(torch, fq, svc, workload, "obs-serve")
    add_launches(launches, ln)
    check(res.served == len(workload) and ln["fused_range"] > 0
          and ln["fused_topk"] > 0,
          f"traced serving: served {res.served}, launches {ln}")
    mismatches, _ = replay_check(svc, workload, res, "obs-serve")
    same = same_answers([(r.ids, r.distances) for r in res.requests],
                        [(r.ids, r.distances) for r in result.requests],
                        exact=True)
    check(same, "traced answers differ from phase 5's")
    snap = svc.stats.snapshot()
    lives = [s.attrs["batch"] for s in svc.tracer.snapshot()
             if s.name == "dispatch"]
    check(len(lives) == len(traces) == snap["batches"],
          f"{len(traces)} traces, {len(lives)} dispatch spans, "
          f"{snap['batches']} batches")
    want: dict = {}
    for tr, live in zip(traces, lives):
        t = select_queries(tr, np.arange(live))
        add_launches(want, trace_totals(t, B))
        add_launches(want, svc.backend.trace_bytes(t))
    check(want == snap["cascade"],
          f"stats.cascade {snap['cascade']} is not the sum of the batches' "
          f"traces {want}")
    check(want["queries"] == len(workload)
          and want["rows_screened"] == len(workload) * B,
          f"cascade totals: {want}")
    cal = svc.calibration.snapshot()
    obs["serve"] = {"qps": res.qps, "launches": ln,
                    "exact_mismatches": mismatches,
                    "answers_equal_phase5": same, "cascade": want,
                    "spans": svc.tracer.counts(),
                    "calibration": [c.as_dict() for c in cal],
                    "calibration_summary": svc.calibration.summary()}
    log(f"[obs-serve] {res.served}/{len(workload)} served traced at "
        f"{res.qps:.2f} qps; launches {ln}; replay mismatches {mismatches}; "
        f"answers equal phase 5's bit for bit: {same}; stats.cascade equals "
        f"the sum of {len(traces)} batch traces: {want}")
    cs = obs["serve"]["calibration_summary"]
    log(f"[obs-calibration] {cs['n']} dispatches: measured "
        f"{cs['mean_measured_s'] * 1e3:.2f} ms mean against the cost "
        f"model's {cs['mean_predicted_s'] * 1e3:.4f} ms: rel_err "
        f"{cs['mean_rel_err']:.4f}, roofline share "
        f"{cs['mean_roofline_frac']:.5f} (H100 peaks; the measured time is "
        f"the dispatch's engine stage on the card's clock, CUDA events: the "
        f"engine's kernels, torch ops and the gaps between their launches, "
        f"without the representation, the counting pass, the dense (Q, B) "
        f"copy to the host or the sync)")

    # ---- 5. the metrics text of that service, scraped once
    server = start_metrics_server(svc.metrics_text, 0)
    try:
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{server.server_address[1]}/metrics",
            timeout=30).read().decode()
    finally:
        server.shutdown()
        server.server_close()
    missing = [f for f in REQUIRED_FAMILIES if f"# TYPE {f}" not in text]
    stages = dict(re.findall(r'repro_cascade_rows_total\{stage="(\w+)"\} '
                             r'(\S+)', text))
    check(not missing and all(float(v) > 0 for v in stages.values())
          and len(stages) == 8,
          f"metrics scrape: missing {missing}, cascade {stages}")
    obs["metrics"] = {"families": len(REQUIRED_FAMILIES), "cascade": stages,
                      "bytes": len(text)}
    log(f"[obs-metrics] scraped {len(text)} bytes: all "
        f"{len(REQUIRED_FAMILIES)} required families, cascade counters "
        f"{stages}")
    del svc, traces

    # ---- 2. the counters at 2^20 rows against the plain versions
    qs = queries[:32]
    dev = index.device
    qr = engine.represent_queries(
        torch.as_tensor(qs, dtype=torch.float32, device=dev), index.levels,
        index.alphabet)
    (ans, d2, rtr), ln = counted(torch, fq, lambda: engine.range_query_traced(
        index, qr, OBS_EPS))
    add_launches(launches, ln)
    (nn_idx, nn_d2, exact, ktr), ln = counted(
        torch, fq, lambda: engine.knn_query_traced(index, qr, OBS_K))
    add_launches(launches, ln)
    eps_r = torch.full((len(qs),), OBS_EPS, dtype=torch.float32, device=dev)
    eps_k = engine._final_radius(nn_d2, OBS_K).reshape(-1)
    check(counters_equal(rtr, index_counts(torch, ref, ops, index, qr,
                                           eps_r))
          and counters_equal(ktr, index_counts(torch, ref, ops, index, qr,
                                               eps_k)),
          "the traced counters differ from the plain per-level counts")
    check(torch.equal(rtr.answers, ans.sum(-1).to(torch.int32))
          and bool(exact.all()), "range answers / k-NN certificates")
    rh, kh = to_host(rtr), to_host(ktr)
    host_check = host_op_counts(torch, engine, ref, ops, host,
                                qs[:OBS_HOST_QUERIES], OBS_EPS, dev)
    obs["counters"] = {
        "range": {"after_c9_mean": rh.after_c9.mean(0).tolist(),
                  "after_c10_mean": rh.after_c10.mean(0).tolist(),
                  "answers_mean": float(rh.answers.mean())},
        "knn": {"after_c9_mean": kh.after_c9.mean(0).tolist(),
                "after_c10_mean": kh.after_c10.mean(0).tolist(),
                "radius_mean": float(eps_k.mean())},
        "host": host_check}
    log(f"[obs-counters] B={B}, {len(qs)} queries: range at ε={OBS_EPS} and "
        f"k-NN (k={OBS_K}) at the final radius (mean "
        f"{float(eps_k.mean()):.3f}) equal the plain per-level counts "
        f"exactly; mean survivors per level after C9 / C10: range "
        f"{obs['counters']['range']['after_c9_mean']} / "
        f"{obs['counters']['range']['after_c10_mean']}, k-NN "
        f"{obs['counters']['knn']['after_c9_mean']} / "
        f"{obs['counters']['knn']['after_c10_mean']}; against the host op "
        f"counts on {OBS_HOST_QUERIES} queries (excluded C9, C10, "
        f"candidates) card {host_check['card']} host {host_check['host']}, "
        f"band rows {host_check['band_rows']}, wrong "
        f"{host_check['wrong_rows']}")

    # ---- 3. the overhead: untraced, traced, traced, untraced
    qps = {"untraced": [], "traced": []}
    for mode in ("untraced", "traced", "traced", "untraced"):
        s = service(ServeConfig(trace=mode == "traced"))
        r, ln = serve_phase(torch, fq, s, workload, f"obs-{mode}")
        add_launches(launches, ln)
        check(r.served == len(workload), f"{mode}: served {r.served}")
        qps[mode].append(r.qps)
    knn = torch.arange(len(qs), device=dev) % 2 == 0
    eps_m = torch.full((len(qs),), OBS_EPS, dtype=torch.float32, device=dev)
    fused = lambda: engine.mixed_query_fused(index, qr, eps_m, knn, 8)
    out = fused()
    fused_ms = cuda_ms(torch, fused, 5)
    count_ms = cuda_ms(torch, lambda: engine.mixed_trace(
        index, qr, eps_m, knn, 8, out[1], out[2]), 5)
    # Its two parts: the chunked cascade count, the k-th smallest.
    d2a = torch.where(out[1], out[2], float("inf"))
    split = {"cascade_counting_ms": cuda_ms(
                 torch, lambda: engine._cascade_counting(index, qr, eps_m,
                                                         None), 5),
             "kth_smallest_ms": cuda_ms(
                 torch, lambda: engine._kth_smallest(d2a, 8), 5)}
    del d2a
    ratio = float(np.median(qps["traced"]) / np.median(qps["untraced"]))
    obs["overhead"] = {"qps": qps, "ratio_of_medians": ratio,
                       "mixed_query_fused_ms": fused_ms,
                       "mixed_trace_ms": count_ms, **split}
    log(f"[obs-overhead] closed loop, 64 requests, in turns: untraced "
        f"{qps['untraced'][0]:.2f} / {qps['untraced'][1]:.2f} qps, traced "
        f"{qps['traced'][0]:.2f} / {qps['traced'][1]:.2f}: traced / "
        f"untraced median {ratio:.3f} (reported, not checked); a Q=32 "
        f"batch's mixed_query_fused {fused_ms:.3f} ms and its counting pass "
        f"(mixed_trace) {count_ms:.3f} ms: the chunked cascade count "
        f"{split['cascade_counting_ms']:.3f} ms, the k-th smallest over "
        f"(32, B) {split['kth_smallest_ms']:.3f} ms (CUDA events)")

    # ---- 4. a torch.profiler trace of every dispatch
    prof_dir = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_profile_"))
    try:
        s = service(ServeConfig(trace=True, profile_dir=str(prof_dir)))
        r, ln = serve_phase(torch, fq, s, workload, "obs-profile")
        add_launches(launches, ln)
        paths = sorted(prof_dir.glob("dispatch_*.json"))
        batches = s.stats.snapshot()["batches"]
        check(len(paths) == batches >= 4,
              f"{len(paths)} profiler traces for {batches} batches")
        spans = [sp.duration_ms for sp in s.tracer.snapshot()
                 if sp.name == "dispatch"]
        prof = profile_dispatches(paths)
        trace_mb = sum(p.stat().st_size for p in paths) / 1e6
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
    names = {n for p in prof for n in p["kernels"]}
    device_seen = all(p["device_events"] > 0 for p in prof)
    obs["profile"] = {"dispatches": prof, "dispatch_span_ms": spans,
                      "trace_mb": trace_mb, "device_events": device_seen}
    if device_seen:
        check(any("fused_range_kernel" in n for n in names)
              and any("fused_topk_kernel" in n for n in names),
              f"the profile does not name the fused kernels: {names}")
        for p, span in zip(prof, spans):
            log(f"[obs-profile] dispatch {span:.1f} ms (host span): capture "
                f"window {p['window_ms']:.1f} ms, card busy "
                f"{p['busy_ms']:.2f} ms, idle share {p['idle_share']:.4f}; "
                f"top: " + ", ".join(f"{short_name(n)} {ms:.2f} ms"
                                     for n, ms in p["top"][:4]))
    else:
        log("[obs-profile] CUPTI gave no device events in the torch.profiler "
            "traces: the idle share is not measured")
    log(f"[obs-profile] {len(paths)} batches profiled at {r.qps:.2f} qps "
        f"({trace_mb:.1f} MB of Chrome traces, removed)")

    # ---- 6. the int8 tier, traced
    tw = workload[:OBS_TIER_REQUESTS]
    s = service(ServeConfig(quantization="int8", trace=True), tiered=True)
    r, tier_ln = serve_phase(torch, fq, s, tw, "obs-quant-serve")
    add_launches(launches, tier_ln)
    batches = s.stats.snapshot()["batches"]
    check(r.served == len(tw)
          and tier_ln["fused_quant_range"] >= 2 * batches,
          f"the traced tier: served {r.served}, {batches} batches, "
          f"launches {tier_ln} (kernel 5 in the dispatch and in the trace)")
    q_mism, _ = replay_check(s, tw, r, "obs-quant-serve")
    qdev = tier8.dev
    qq = qs[:OBS_TIER_REQUESTS]
    tqr = engine.represent_queries(
        torch.as_tensor(qq, dtype=torch.float32, device=dev), qdev.levels,
        qdev.alphabet)
    (*_, qtr), ln = counted(torch, fq, lambda: engine
                            .quantized_range_query_traced(tier8, tqr,
                                                          OBS_EPS))
    add_launches(launches, ln)
    (_, qnn_d2, _, qktr), ln = counted(
        torch, fq, lambda: engine.quantized_knn_query_traced(tier8, tqr,
                                                             OBS_K))
    add_launches(launches, ln)
    tier_out = {}
    for name, tr, eps in (
            ("range", qtr, torch.full((len(qq),), OBS_EPS,
                                      dtype=torch.float32, device=dev)),
            ("knn", qktr, engine._final_radius(qnn_d2, OBS_K).reshape(-1))):
        check(counters_equal(tr, quant_counts(torch, ref, ops, qdev, tqr,
                                              eps)),
              f"the tier's {name} counters differ from the plain ones")
        panels = tuple(ops.query_panels(w, qdev.alphabet) for w in tqr.words)
        plain = ref.fused_quant_range_ref(qdev, tqr.q, panels, tqr.residuals,
                                          eps)
        blocks = engine._fused_blocks(qdev, len(qq), quant=True)
        got = fq.fused_quant_range(qdev, tqr.q, tqr.words, tqr.residuals,
                                   eps, block_q=blocks[0], block_b=blocks[1])
        agree = range_agreement(got, plain, ref.screen_limit_sq(
            eps, qdev.series_err).cpu().numpy())
        kept = to_host(tr).screen_survivors
        plain_kept = plain[0].sum(-1).cpu().numpy()
        check(np.array_equal(kept, got[0].sum(-1).cpu().numpy())
              and agree["mismatch_outside_band"] == 0
              and int(np.abs(kept - plain_kept).sum())
              <= agree["mismatch_in_band"],
              f"the tier's {name} screen count: {agree}")
        tier_out[name] = {"screen_survivors": int(kept.sum()),
                          "plain_kept": int(plain_kept.sum()),
                          "band_rows": agree["mismatch_in_band"],
                          "after_c10": int(to_host(tr).after_c10[:, -1]
                                           .sum())}
    obs["tier"] = {"launches": tier_ln, "exact_mismatches": q_mism,
                   "qps": r.qps, "batches": batches, **tier_out}
    log(f"[obs-tier] int8 tier traced: {r.served}/{len(tw)} served at "
        f"{r.qps:.2f} qps over {batches} batches, replay mismatches "
        f"{q_mism}; kernel 5 in the dispatch and the trace; range and k-NN "
        f"counters equal the plain widened cascade, screen counts equal "
        f"kernel 5's keep (plain keep with band rows counted): {tier_out}")
    del s

    # ---- 7. subseq-1M, traced: kernels 3 and 4
    cfg = SUBSEQ
    sidx = ss.subseq_device_index(sub["hidx"], dev)
    sqr = ss.represent_subseq_queries(sidx, sub["queries"])
    auto = SearchOptions(backend="auto")
    (sans, sd2, str_), ln3 = counted(torch, fq, lambda: ss
                                     .subseq_range_query_traced(
                                         sidx, sqr, cfg["eps"], auto))
    (sel, sel_d2, sexact, sktr), ln4 = counted(
        torch, fq, lambda: ss.subseq_knn_query_traced(
            sidx, sqr, cfg["k"], excl=cfg["excl"], options=auto))
    add_launches(launches, ln3)
    add_launches(launches, ln4)
    check(ln3["fused_subseq_range"] > 0 and ln4["fused_subseq_topk"] > 0,
          f"the traced subsequence calls: launches {ln3}, {ln4}")
    check(torch.equal(sans, sub["ans"]) and torch.equal(sd2, sub["d2"])
          and np.array_equal(sel, sub["sel"])
          and np.array_equal(sel_d2, sub["sel_d2"]),
          "the traced subsequence answers differ from phase 10's")
    kf = ss.knn_fetch_count(cfg["k"], cfg["excl"], cfg["stride"],
                            sidx.n_windows)
    _, fetch_d2, _ = ss._subseq_knn_fetch(sidx, sqr, kf, auto)
    seps = torch.full((sqr.q.shape[0],), cfg["eps"], dtype=torch.float32,
                      device=dev)
    check(counters_equal(str_, index_counts(torch, ref, ops, sidx.index, sqr,
                                            seps))
          and counters_equal(sktr, index_counts(
              torch, ref, ops, sidx.index, sqr,
              engine._final_radius(fetch_d2, kf).reshape(-1))),
          "the subsequence counters differ from the plain per-level counts")
    sh, skh = to_host(str_), to_host(sktr)
    obs["subseq"] = {"launches": {**ln3, **{k: v for k, v in ln4.items()
                                            if v}},
                     "range_after_c10": int(sh.after_c10[:, -1].sum()),
                     "range_answers": int(sh.answers.sum()),
                     "knn_after_c10": int(skh.after_c10[:, -1].sum()),
                     "knn_answers": int(skh.answers.sum())}
    log(f"[obs-subseq] W={sidx.n_windows}: traced range (launches "
        f"fused_subseq_range {ln3['fused_subseq_range']}) and k-NN "
        f"(fused_subseq_topk {ln4['fused_subseq_topk']}) answer as phase 10 "
        f"bit for bit; counters equal the plain per-level counts over the "
        f"windows-as-rows columns: {obs['subseq']}")
    del sidx
    obs["seconds"] = time.perf_counter() - t_phase
    obs["launches"] = launches
    report["obs"] = obs
    log(f"[obs] phase 15 in {obs['seconds']:.1f}s; launches of its "
        f"main-path runs {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 16: extended representation stacks (repr-1M) — the trend_slope
# column beside the paper pair, on trending data, and the near-duplicate
# curation filter.
# ---------------------------------------------------------------------------

EXT_STACK = ("linfit_residual", "sax_word", "trend_slope")
# repr-1M: make_trending's defaults (16 prototypes, 8 pieces, slope scale
# 2.5, noise 0.08, seed 7) at 2^20 rows of 128, serve-1M's closed loop.
# ε = 1: the median query has answers (a query is a row plus noise) and
# trend_slope kills at both levels; the phase checks both.
REPR = dict(rows=1 << 20, length=128, levels=(8, 16), alphabet=10,
            eps=1.0, requests=64, clients=16, knn_frac=0.5, k=5,
            queries=32, host_queries=4, traced_requests=16,
            level_queries=16, level_eps=(1.0, 2.0),
            curate_rows=65_536, curate_batch=1_024, curate_share=0.125,
            curate_noise=0.02, curate_eps=0.5)
# A device symbol may differ from the f64 host build's only where the f64
# value lies this close to a breakpoint: a hundred times the f32 rounding
# of a z-normalised segment sum.
SYMBOL_BAND = 1e-4


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def counts_now(fq, lo) -> dict:
    return {k.__name__: k.launches for k in fq.KERNELS + lo.KERNELS}


def reset_counts(fq, lo) -> None:
    fq.reset_launch_counts()
    lo.reset_launch_counts()


def symbol_band(got, want: np.ndarray, f64_values: np.ndarray) -> dict:
    """Device symbols ``got`` against the f64 build's ``want``: the count
    that differ, and how many of those lie outside SYMBOL_BAND of a
    breakpoint (must be 0)."""
    from repro_torch.core.sax import breakpoints
    got = got.cpu().numpy()
    rows, cols = np.nonzero(got != np.asarray(want))
    vals = np.asarray(f64_values)[rows, cols]
    bp = breakpoints(REPR["alphabet"])
    near = np.min(np.abs(vals[:, None] - bp[None, :]), axis=-1) \
        <= SYMBOL_BAND if vals.size else np.zeros(0, bool)
    return {"symbols": int(got.size), "differ": int(rows.size),
            "outside_band": int((~near).sum())}


def repr_turns(torch, fq, lo, services, workload, tmp) -> list:
    """The closed loop through each service in turns (paper, extended,
    extended, paper): qps, p50 / p99 latency and the kernels launched in
    each run."""
    from repro_torch.serve import run_closed_loop
    out = []
    for i, (label, svc) in enumerate(services):
        path = pathlib.Path(tmp) / f"turn{i}.jsonl"
        reset_counts(fq, lo)
        with svc:
            result = run_closed_loop(svc, workload,
                                     clients=REPR["clients"],
                                     jsonl_path=path)
            torch.cuda.synchronize()
        launched = {k: v for k, v in counts_now(fq, lo).items() if v}
        lat = [json.loads(line)["latency_ms"]
               for line in path.read_text().splitlines()]
        check(result.served == len(workload),
              f"repr {label}: served {result.served} of {len(workload)}")
        out.append({"stack": label, "qps": result.qps,
                    "p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99)),
                    "launches": launched, "result": result})
        log(f"[repr-serve] {label} stack: {result.qps:.2f} qps, p50 "
            f"{out[-1]['p50_ms']:.1f} ms p99 {out[-1]['p99_ms']:.1f} ms; "
            f"launches {launched}")
    return out


def repr_tier(torch, engine, fq, lo, ref, ops, host, qs) -> tuple:
    """The int8 tier with the trend_slope column (kernel 5, then the
    trend test on its kept rows) against full precision and against the
    paper-stack tier's kernel 5 (the same quantized columns without the
    trend column): answers, cascade and screen counts, launches."""
    from repro_torch.core.options import SearchOptions
    eps, k = REPR["eps"], REPR["k"]
    t0 = time.perf_counter()
    tier_e = engine.TieredIndex.from_host(host, "int8")
    tier_p = engine.TieredIndex(
        dev=dataclasses.replace(tier_e.dev, extra=(),
                                stack=EXT_STACK[:2]), raw=tier_e.raw)
    full = engine.device_index_from_host(host)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    dev = full.device
    for li, lv in enumerate(host.levels):
        col = tier_e.dev.extra[li]["trend_slope"]
        check(col.dtype == torch.int8 and np.array_equal(
            col.cpu().numpy(), lv.extra["trend_slope"].astype(np.int8)),
            "repr: the tier's trend_slope column is not the host's int8")
    q = torch.as_tensor(qs, dtype=torch.float32, device=dev)
    qr_e = engine.represent_queries(q, REPR["levels"], REPR["alphabet"],
                                    stack=EXT_STACK)
    qr_p = engine.represent_queries(q, REPR["levels"], REPR["alphabet"])
    opts = SearchOptions(backend="auto")
    # The same three calls on each tier, each call timed: a range, a
    # k-NN and the trace.
    runs, ms, launched = {}, {}, {}
    for label, tier, qr in (("extended", tier_e, qr_e),
                            ("paper", tier_p, qr_p)):
        reset_counts(fq, lo)
        calls = (("range", lambda: engine.quantized_range_query(
                      tier, qr, eps, options=opts)),
                 ("knn", lambda: engine.quantized_knn_query(
                      tier, qr, k, options=opts)),
                 ("trace", lambda: engine.quantized_cascade_trace(
                      tier.dev, qr, eps)))
        runs[label], ms[label] = {}, {}
        for name, call in calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[label][name] = call()
            torch.cuda.synchronize()
            ms[label][name] = (time.perf_counter() - t0) * 1e3
        launched[label] = {k_: v for k_, v in counts_now(fq, lo).items()
                           if v}
        check(launched[label].get("fused_quant_range", 0) >= 3,
              f"repr: the {label} tier did not launch kernel 5: "
              f"{launched[label]}")
    idx, ans, _, exact = runs["extended"]["range"]
    k_idx, _, k_exact = runs["extended"]["knn"]
    tr_e = runs["extended"]["trace"]
    p_idx, p_ans, _, _ = runs["paper"]["range"]
    tr_p = runs["paper"]["trace"]
    launched_e, launched_p = launched["extended"], launched["paper"]
    # The screen alone at the range radius: kernel 5, and on the extended
    # tier the trend test on its kept rows (comparisons, not path runs).
    for label, tier, qr in (("extended", tier_e, qr_e),
                            ("paper", tier_p, qr_p)):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine._kernel5_screen(tier.dev, qr, eps)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[label]["screen_median"] = sorted(times)[2]
    # Answers: the tier against full precision over the same rows.
    f_ans, _ = engine.range_query(full, qr_e, eps)
    f_idx, f_kd2, _ = engine.knn_query_auto(full, qr_e, k)
    got = [sorted(idx[i][ans[i]].tolist()) for i in range(len(qs))]
    paper = [sorted(p_idx[i][p_ans[i]].tolist()) for i in range(len(qs))]
    want = [torch.nonzero(f_ans[i]).flatten().tolist()
            for i in range(len(qs))]
    stats = {"range_equal": 0, "band_rows": 0, "wrong": 0}
    series = full.series
    for i in range(len(qs)):
        for other in (want[i], paper[i]):
            sym = np.setxor1d(got[i], other)
            if sym.size:
                d2 = ((series[sym] - qr_e.q[i]) ** 2).sum(-1).cpu().numpy()
                near = np.abs(d2 - eps * eps) <= band(eps * eps)
                stats["band_rows"] += int(near.sum())
                stats["wrong"] += int((~near).sum())
        stats["range_equal"] += int(got[i] == want[i])
    kn = (k_idx.cpu().numpy() != f_idx.cpu().numpy())
    if kn.any():
        dk = f_kd2.cpu().numpy()
        d_got = ((series[k_idx.long()] - qr_e.q[:, None]) ** 2).sum(-1)
        gap = np.abs(d_got.cpu().numpy() - dk)
        stats["wrong"] += int((kn & (gap > band(dk))).sum())
        stats["band_rows"] += int((kn & (gap <= band(dk))).sum())
    check(stats["wrong"] == 0 and bool(exact.all()) and bool(k_exact.all()),
          f"repr: the extended tier's answers differ from full precision "
          f"or the paper tier: {stats}")
    # Screen counts: kernel 5 with the trend test on its kept rows against
    # kernel 5 on the paper tier (row for row no more), and each against
    # its plain version (band-counted).
    p_keep, _ = engine.quantized_screen(tier_p.dev, qr_p, eps)
    e_keep, _ = engine.quantized_screen(tier_e.dev, qr_e, eps)
    check(not bool((e_keep & ~p_keep).any()),
          "repr: the extended screen kept a row the paper screen did not")
    k5 = tr_p.screen_survivors.cpu().numpy().astype(np.int64)
    plain_p = p_keep.sum(-1).cpu().numpy()
    scr_e = tr_e.screen_survivors.cpu().numpy().astype(np.int64)
    plain_e = e_keep.sum(-1).cpu().numpy()
    check(np.all(scr_e <= k5),
          f"repr: the extended tier screens more than kernel 5: "
          f"{scr_e.tolist()} vs {k5.tolist()}")
    eps_t = torch.full((len(qs),), eps, dtype=torch.float32, device=dev)
    check(counters_equal(tr_e, quant_counts(torch, ref, ops, tier_e.dev,
                                            qr_e, eps_t))
          and counters_equal(tr_p, quant_counts(torch, ref, ops, tier_p.dev,
                                                qr_p, eps_t)),
          "repr: the tiers' counters differ from the plain widened cascade")
    a10_e = tr_e.after_c10.cpu().numpy()
    a10_p = tr_p.after_c10.cpu().numpy()
    check(np.all(a10_e <= a10_p),
          "repr: the extended tier's cascade kept more rows than the "
          "paper tier's")
    out = {"build_s": t_build, "answers": stats,
           "after_c10_mean": {"extended": a10_e.mean(0).tolist(),
                              "paper": a10_p.mean(0).tolist()},
           "screen_mean": {"extended_kernel5": float(scr_e.mean()),
                           "extended_plain": float(plain_e.mean()),
                           "paper_kernel5": float(k5.mean()),
                           "paper_plain": float(plain_p.mean())},
           "kernel5_vs_plain_rows": {
               "paper": int(np.abs(k5 - plain_p).sum()),
               "extended": int(np.abs(scr_e - plain_e).sum())},
           "ms": ms,
           "launches": {"extended": launched_e, "paper": launched_p}}
    del tier_e, tier_p, full
    return out, {k_: launched_e.get(k_, 0) + launched_p.get(k_, 0)
                 for k_ in set(launched_e) | set(launched_p)}


def repr_level_search(torch, lo, ref, ops, host, queries, dev) -> tuple:
    """Phase 13's level-at-a-time loop with the extended stack: per level
    ``prune_level`` (kernel 12), then ``mindist_sq`` (kernel 10) at n = N
    on the trend words of C9 ∧ C10's survivors, then ``sqdist`` (kernel
    11) on the last survivors; against the op-counted host engine over
    the same stack, and the paper pair's loop timed beside it."""
    from repro_torch.core import search
    from repro_torch.core.fastsax import represent_query
    from repro_torch.core.representation import get

    cfg, B, n = host.config, host.size, host.n
    A, levels = cfg.alphabet, tuple(cfg.levels)
    series = torch.as_tensor(host.series, dtype=torch.float32, device=dev)
    words = [torch.as_tensor(lv.words, dtype=torch.int32, device=dev)
             for lv in host.levels]
    resid = [torch.as_tensor(lv.residuals, dtype=torch.float32, device=dev)
             for lv in host.levels]
    twords = [torch.as_tensor(lv.extra["trend_slope"], dtype=torch.int32,
                              device=dev) for lv in host.levels]
    cols = f64_columns(torch, host, dev, "trend_slope")
    trend = get("trend_slope")
    qs = queries[:REPR["level_queries"]]
    tally = dict.fromkeys(("answers", "cand_band", "cand_wrong",
                           "answer_band", "answer_wrong", "paper_band",
                           "paper_wrong"), 0)
    stats = {e: {"extended": dict.fromkeys(
        ("card_ms", "candidates", "latency", "excluded_c9", "excluded_c10",
         "trend_kills"), 0.0),
        "paper": {"card_ms": 0.0, "candidates": 0.0}}
        for e in REPR["level_eps"]}
    lo.reset_launch_counts()
    for eps in REPR["level_eps"]:
        eps2 = ref.eps_sq_f32(eps)
        for qi in range(len(qs)):
            qr = represent_query(qs[qi], cfg)
            q = torch.as_tensor(qr.q, dtype=torch.float32, device=dev)
            # The paper pair on the card (phase 13's FAST_SAX).
            torch.cuda.synchronize()
            t = time.perf_counter()
            alive = torch.ones(B, dtype=torch.bool, device=dev)
            for li in range(len(levels)):
                alive = lo.prune_level(alive, resid[li], words[li],
                                       qr.words[li], qr.residuals[li], eps,
                                       n, A)
            p_cand = torch.nonzero(alive).flatten()
            p_ans = p_cand[lo.sqdist(series[p_cand], q) <= eps2]
            p_cand, p_ans = p_cand.cpu().numpy(), p_ans.cpu().numpy()
            p_ms = (time.perf_counter() - t) * 1e3
            # The extended stack: trend_slope after each level's C10.
            t = time.perf_counter()
            alive = torch.ones(B, dtype=torch.bool, device=dev)
            kills = 0
            for li, N in enumerate(levels):
                alive = lo.prune_level(alive, resid[li], words[li],
                                       qr.words[li], qr.residuals[li], eps,
                                       n, A)
                cand = torch.nonzero(alive).flatten()
                tb = lo.mindist_sq(twords[li][cand],
                                   qr.extra[li]["trend_slope"], N, A)
                dead = cand[tb > eps2]
                alive[dead] = False
                kills += int(dead.numel())
            e_cand = torch.nonzero(alive).flatten()
            e_ans = e_cand[lo.sqdist(series[e_cand], q) <= eps2]
            e_cand, e_ans = e_cand.cpu().numpy(), e_ans.cpu().numpy()
            e_ms = (time.perf_counter() - t) * 1e3
            # The op-counted host engine (f64) over the same stack.
            rf = search.fastsax_range_query(host, qr, eps)
            near = torch.zeros(B, dtype=torch.bool, device=dev)
            h_alive = torch.ones(B, dtype=torch.bool, device=dev)
            for li in range(len(levels)):
                gap, b2, t2 = host_bounds(torch, cols, qr, li, "trend_slope")
                near |= ((gap - eps).abs() <= band(eps)) | \
                    ((b2 - eps * eps).abs() <= band(eps * eps)) | \
                    ((t2 - eps * eps).abs() <= band(eps * eps))
                h_alive &= (gap <= eps) & (b2 <= eps * eps) & \
                    (t2 <= eps * eps)
            near, h_alive = near.cpu().numpy(), h_alive.cpu().numpy()
            check(int(h_alive.sum()) == rf.candidates,
                  "repr: the host cascade's candidates differ from "
                  "search.py's count")
            diff = np.setxor1d(e_cand, np.nonzero(h_alive)[0])
            tally["cand_band"] += int(near[diff].sum())
            tally["cand_wrong"] += int((~near[diff]).sum())
            for got, want, key in ((e_ans, rf.answers, "answer"),
                                   (e_ans, p_ans, "paper")):
                diff = np.setxor1d(got, want)
                d2 = np.sum((host.series[diff] - qr.q) ** 2, axis=-1)
                near_d2 = np.abs(d2 - eps * eps) <= band(eps * eps)
                tally[f"{key}_band"] += int(near_d2.sum())
                tally[f"{key}_wrong"] += int((~near_d2).sum())
            tally["answers"] += len(rf.answers)
            ext, pap = stats[eps]["extended"], stats[eps]["paper"]
            ext["card_ms"] += e_ms / len(qs)
            pap["card_ms"] += p_ms / len(qs)
            ext["candidates"] += rf.candidates / len(qs)
            pap["candidates"] += p_cand.size / len(qs)
            ext["latency"] += rf.latency / len(qs)
            ext["excluded_c9"] += rf.excluded_c9 / len(qs)
            ext["excluded_c10"] += rf.excluded_c10 / len(qs)
            ext["trend_kills"] += kills / len(qs)
        ext, pap = stats[eps]["extended"], stats[eps]["paper"]
        log(f"[repr-level] eps={eps}: card ms per query extended "
            f"{ext['card_ms']:.3f} (the paper pair's loop, run first, "
            f"{pap['card_ms']:.3f}); candidates {ext['candidates']:.1f} "
            f"against the paper pair's {pap['candidates']:.1f}, "
            f"trend_slope's kills on the card {ext['trend_kills']:.1f}; the "
            f"host engine over the stack: op-counted latency "
            f"{ext['latency']:.0f}, excluded C9 {ext['excluded_c9']:.1f} "
            f"C10 {ext['excluded_c10']:.1f} (means over {len(qs)} "
            f"queries)")
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in lo.KERNELS}
    check(tally["cand_wrong"] == 0 and tally["answer_wrong"] == 0
          and tally["paper_wrong"] == 0,
          f"repr: the extended level-at-a-time search disagrees outside "
          f"the f32 band: {tally}")
    check(all(launches[k] > 0 for k in ("mindist_sq", "sqdist",
                                         "prune_level")),
          f"repr: a level kernel did not launch: {launches}")
    # Kernel 10 at n = N is the trend_slope bound: bit for bit its plain
    # version, and the engine's dev_bound_sq (the scale is exactly 1.0f).
    qr = represent_query(qs[0], cfg)
    tab = ops.mindist_table_cached(A, str(dev))
    bit = True
    for li, N in enumerate(levels):
        qt = qr.extra[li]["trend_slope"]
        got = lo.mindist_sq(twords[li], qt, N, A)
        want = ref.mindist_sq_level_ref(twords[li],
                                        lo.query_table(qt, A, dev), N)
        bound = trend.dev_bound_sq(
            twords[li], torch.as_tensor(qt[None], device=dev), n=n, N=N,
            tab=tab)[0]
        bit &= bool(torch.equal(got, want)) and bool(torch.equal(got, bound))
    check(bit and float(np.float32(levels[0]) / np.float32(levels[0]))
          == 1.0, "repr: mindist_sq at n = N is not the trend_slope bound")
    log(f"[repr-level] B={B}, {len(qs)} queries at eps {REPR['level_eps']}: "
        f"card against the host engine {tally}; launches {launches}; "
        f"mindist_sq at n = N bit-identical to ref.mindist_sq_level_ref "
        f"and trend_slope's dev_bound_sq")
    return {"stats": {str(e): v for e, v in stats.items()},
            "agreement": tally, "launches": launches}, launches


def repr_subseq(torch, engine, fq, lo, ss) -> tuple:
    """subseq-1M's streams and shapes with the extended stack: the window
    hook's trend words against the materialised windows', the range and
    k-NN answers through kernels 3-4 against the paper stack's, and the
    torch engine's range answers with the trend test against them."""
    from repro_torch.core.fastsax import FastSAXConfig, LevelData
    from repro_torch.core.options import SearchOptions
    from repro_torch.core.representation import _trend_scaled_slope_np, get
    from repro_torch.data.timeseries import (make_subseq_queries,
                                             make_wafer_like)

    cfg = SUBSEQ
    streams = make_wafer_like(cfg["streams"], cfg["stream_len"], seed=0,
                              normalize=False)
    t0 = time.perf_counter()
    hidx = ss.build_subseq_index(streams, FastSAXConfig(
        n_segments=REPR["levels"], stack=EXT_STACK), cfg["window"],
        cfg["stride"])
    t_host = time.perf_counter() - t0
    W, W_s, w = hidx.n_windows, hidx.windows_per_stream, hidx.window
    rep = get("trend_slope")
    want = {lv.n_segments: [] for lv in hidx.levels}
    vals = {lv.n_segments: [] for lv in hidx.levels}
    for lo_ in range(0, W, 1 << 17):
        wid = np.arange(lo_, min(W, lo_ + (1 << 17)))
        win = hidx.streams[(wid // W_s)[:, None],
                           ((wid % W_s) * hidx.stride)[:, None]
                           + np.arange(w)[None, :]]
        z = (win - hidx.mu[wid, None]) / hidx.sd[wid, None]
        for Nseg in want:
            slope = _trend_scaled_slope_np(z, Nseg)
            want[Nseg].append(rep.symbolize_np(z, Nseg, REPR["alphabet"]))
            vals[Nseg].append(slope)
    hook = {f"N{lv.n_segments}": symbol_band(
        torch.as_tensor(lv.extra["trend_slope"]),
        np.concatenate(want[lv.n_segments]),
        np.concatenate(vals[lv.n_segments])) for lv in hidx.levels}
    check(all(v["outside_band"] == 0 for v in hook.values()),
          f"repr: the window hook's trend words differ from the "
          f"materialised windows' outside the band: {hook}")
    paper = dataclasses.replace(
        hidx, config=FastSAXConfig(n_segments=REPR["levels"]),
        levels=[LevelData(n_segments=lv.n_segments, words=lv.words,
                          residuals=lv.residuals) for lv in hidx.levels])
    t0 = time.perf_counter()
    sidx_e = ss.subseq_device_index(hidx)
    sidx_p = ss.subseq_device_index(paper)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    queries = make_subseq_queries(streams, cfg["queries"], w, seed=1)
    qr_e = ss.represent_subseq_queries(sidx_e, queries)
    qr_p = ss.represent_subseq_queries(sidx_p, queries)
    eps, k, excl = cfg["eps"], cfg["k"], cfg["excl"]
    runs, launched = {}, {}
    for label, sidx, qr in (("paper", sidx_p, qr_p),
                            ("extended", sidx_e, qr_e)):
        reset_counts(fq, lo)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ans, d2 = ss.subseq_range_query(sidx, qr, eps)
        torch.cuda.synchronize()
        t_range = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        sel, sel_d2, exact = ss.subseq_knn_query(sidx, qr, k, excl=excl)
        torch.cuda.synchronize()
        t_knn = (time.perf_counter() - t0) * 1e3
        launched[label] = {k_: v for k_, v in counts_now(fq, lo).items()
                           if v}
        check(bool(np.all(exact)), f"repr: subseq {label} k-NN not exact")
        runs[label] = (ans, d2, sel, sel_d2, t_range, t_knn)
    check(all(launched[lab].get("fused_subseq_range", 0) > 0
              and launched[lab].get("fused_subseq_topk", 0) > 0
              for lab in launched),
          f"repr: kernels 3-4 did not launch: {launched}")
    a_p, d_p, s_p, sd_p = runs["paper"][:4]
    a_e, d_e, s_e, sd_e = runs["extended"][:4]
    # The torch engine over the windows-as-rows index, the trend test in
    # its cascade (a comparison, not a path run).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a_t, d_t = ss.subseq_range_query(sidx_e, qr_e, eps,
                                     options=SearchOptions(backend="torch"))
    torch.cuda.synchronize()
    t_torch = (time.perf_counter() - t0) * 1e3
    agree = {"answers": int(a_p.sum())}
    for key, (a, d) in (("extended", (a_e, d_e)), ("torch", (a_t, d_t))):
        differ = (a_p != a).cpu().numpy()
        d2 = torch.where(a_p, d_p, d).cpu().numpy()
        near = np.abs(d2 - eps * eps) <= band(eps * eps)
        agree[f"{key}_range_band"] = int((differ & near).sum())
        agree[f"{key}_range_wrong"] = int((differ & ~near).sum())
    off = s_p != s_e
    kgap = np.abs(sd_p - sd_e)
    agree["knn_band"] = int((off & (kgap <= band(sd_p))).sum())
    agree["knn_wrong"] = int((off & ~(kgap <= band(sd_p))).sum())
    check(agree["extended_range_wrong"] == 0 and agree["knn_wrong"] == 0
          and agree["torch_range_wrong"] == 0,
          f"repr: subseq answers differ from the paper stack's: {agree}")
    # trend_slope's kills over the windows, at the range radius.
    tr_e = engine.cascade_trace(sidx_e.index, qr_e, eps)
    tr_p = engine.cascade_trace(sidx_p.index, qr_p, eps)
    out = {"windows": W, "host_build_s": t_host, "upload_s": t_dev,
           "hook_vs_windows": hook, "agreement": agree,
           "ms": {**{lab: {"range": runs[lab][4], "knn": runs[lab][5]}
                     for lab in runs}, "torch_range_extended": t_torch},
           "after_c10_mean": {
               "extended": tr_e.after_c10.float().mean(0).tolist(),
               "paper": tr_p.after_c10.float().mean(0).tolist()},
           "launches": launched}
    log(f"[repr-subseq] {W} windows: host build with the window hook "
        f"{t_host:.2f}s, upload {t_dev:.2f}s; hook against the materialised "
        f"windows {hook}; answers against kernels 3-4 {agree}; ms per call "
        f"{out['ms']}; after C10 per level (means) {out['after_c10_mean']}; "
        f"launches {launched}")
    del sidx_e, sidx_p
    return out, {k_: launched["paper"].get(k_, 0)
                 + launched["extended"].get(k_, 0)
                 for k_ in set(launched["paper"]) | set(launched["extended"])}


def plant_duplicates(rows: int, length: int, share: float, noise: float,
                     seed: int = 3):
    """Trending rows in admit order with a known share of planted near
    duplicates: a planted row is an earlier row of the stream (of an
    earlier batch or of its own) plus ``noise`` per sample.  Returns the
    rows and the planted mask."""
    from repro_torch.data.timeseries import make_trending
    rng = np.random.default_rng(seed)
    x = make_trending(rows, length, seed=seed + 8)
    planted = rng.random(rows) < share
    planted[0] = False
    for i in np.nonzero(planted)[0]:
        x[i] = x[rng.integers(i)] + noise * rng.standard_normal(length)
    return x, planted


def repr_curation(torch) -> dict:
    """``NearDuplicateFilter`` on the card over trending rows with planted
    near-duplicates, batch by batch against a brute-force dedup on the
    card (f64, the same z-normalised f32 rows); admits per second."""
    from repro_torch.core.paa import znormalize_np
    from repro_torch.data.curation import NearDuplicateFilter

    cfg = REPR
    rows, bs, eps = cfg["curate_rows"], cfg["curate_batch"], \
        cfg["curate_eps"]
    x, planted = plant_duplicates(rows, cfg["length"], cfg["curate_share"],
                                  cfg["curate_noise"])
    filt = NearDuplicateFilter(cfg["length"], epsilon=eps)
    check(filt.device.type == "cuda", "repr: the filter is not on the card")
    dev = filt.device
    pool = torch.zeros((0, cfg["length"]), dtype=torch.float64, device=dev)
    margin, keeps, t_admit = np.inf, [], 0.0
    for lo_ in range(0, rows, bs):
        batch = x[lo_:lo_ + bs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep = filt.admit(batch)
        torch.cuda.synchronize()
        t_admit += time.perf_counter() - t0
        z = torch.as_tensor(znormalize_np(batch).astype(np.float32),
                            device=dev).double()
        zn = (z * z).sum(-1)
        bf = torch.ones(z.shape[0], dtype=torch.bool, device=dev)
        if pool.shape[0]:
            d2 = zn[:, None] - 2.0 * z @ pool.T + (pool * pool).sum(-1)[None]
            bf &= ~(d2 <= eps * eps).any(-1)
            margin = min(margin, float((d2 - eps * eps).abs().min()))
        d2b = zn[:, None] - 2.0 * z @ z.T + zn[None]
        off = ~torch.eye(z.shape[0], dtype=torch.bool, device=dev)
        margin = min(margin, float((d2b - eps * eps).abs()[off].min()))
        near = (d2b <= eps * eps).cpu().numpy()
        bf = bf.cpu().numpy()
        kept = []
        for i in np.nonzero(bf)[0]:
            if near[i, kept].any():
                bf[i] = False
            else:
                kept.append(i)
        check(np.array_equal(keep, bf),
              f"repr: the filter's keep mask differs from the brute force "
              f"in the batch at row {lo_}")
        pool = torch.cat([pool, z[torch.as_tensor(bf, device=dev)]])
        keeps.append(keep)
    keep = np.concatenate(keeps)
    out = {"rows": rows, "batch": bs, "eps": eps,
           "planted": int(planted.sum()),
           "rejected": int((~keep).sum()),
           "planted_rejected": int((planted & ~keep).sum()),
           "accepted": filt.stats.accepted, "pool": filt.pool_size,
           "indexed_rows": filt._indexed_rows,
           "min_margin_d2": margin, "admit_s": t_admit,
           "rows_per_s": rows / t_admit,
           "admits_per_s": (rows // bs) / t_admit}
    check(out["accepted"] == out["pool"] == int(keep.sum())
          and out["rejected"] > 0 and margin > band(eps * eps),
          f"repr: curation figures do not add up: {out}")
    log(f"[repr-curate] {rows} trending rows in batches of {bs} at eps "
        f"{eps}: {out['planted']} planted, {out['rejected']} rejected "
        f"({out['planted_rejected']} of them planted); keep masks equal to "
        f"the brute force on the card (smallest |d² − ε²| {margin:.4f}); "
        f"{out['admits_per_s']:.2f} admits/s, {out['rows_per_s']:.0f} "
        f"rows/s")
    return out


def repr_phase(torch, engine, fq, lo, ref, ops, ss, report) -> dict:
    """Phase 16 (repr-1M).  Returns the launches of the phase's path runs
    per kernel (the turns, the traced twins, the tier, the level-at-a-time
    loop and the subsequence calls; not the comparisons)."""
    import tempfile

    from repro_torch.core.fastsax import FastSAXConfig, build_index
    from repro_torch.core.paa import paa_np
    from repro_torch.core.representation import _trend_scaled_slope_np
    from repro_torch.data.timeseries import make_queries, make_trending
    from repro_torch.obs.trace import to_host
    from repro_torch.serve import (SearchService, ServeConfig, WorkloadSpec,
                                   make_workload, run_closed_loop)

    cfg = REPR
    levels, A, eps = cfg["levels"], cfg["alphabet"], cfg["eps"]
    B, n = cfg["rows"], cfg["length"]
    total = {}
    out = {}
    t_phase = time.perf_counter()

    steps, t_step = {}, [time.perf_counter()]

    def add(launched):
        for name, count in launched.items():
            total[name] = total.get(name, 0) + count

    def step(name):
        now = time.perf_counter()
        steps[name] = now - t_step[0]
        t_step[0] = now

    # ---- 1. data and the bytes reckoned before the run
    t0 = time.perf_counter()
    db = make_trending(B, n)
    queries = make_queries(db, cfg["requests"], seed=1)
    t_data = time.perf_counter() - t0
    reckoned = {"series": B * n * 4, "paper_words": B * sum(levels) * 4,
                "trend_words": B * sum(levels) * 4,
                "residuals": B * len(levels) * 4, "norms": B * 4,
                "gather_per_level_and_extra_q32": 32 * B * max(levels) * 4}
    log(f"[repr-data] make_trending({B}, {n}) and {cfg['requests']} "
        f"queries in {t_data:.1f}s; bytes reckoned before the run: "
        f"{reckoned}")

    step("data")
    # ---- 2. the device build against the host build uploaded
    t0 = time.perf_counter()
    host = build_index(db, FastSAXConfig(n_segments=levels, alphabet=A,
                                         stack=EXT_STACK))
    t_host = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    svc_e = SearchService.from_series(db, ServeConfig(stack=EXT_STACK))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    svc_p = SearchService.from_series(db, ServeConfig())
    built = svc_e.backend.index
    check(svc_e.backend.backend == "cuda"
          and built.device.type == "cuda" and built.stack == EXT_STACK,
          "repr: the extended service must run the kernels on the card")
    check(svc_p.backend.backend == "cuda",
          "repr: the paper-stack service must run the kernels")
    up = engine.device_index_from_host(host)
    bands = {}
    for li, N in enumerate(levels):
        lv = host.levels[li]
        check(np.array_equal(up.extra[li]["trend_slope"].cpu().numpy(),
                             lv.extra["trend_slope"]),
              "repr: device_index_from_host changed the trend words")
        bands[f"words_N{N}"] = symbol_band(built.words[li], lv.words,
                                           paa_np(host.series, N))
        bands[f"trend_N{N}"] = symbol_band(
            built.extra[li]["trend_slope"], lv.extra["trend_slope"],
            _trend_scaled_slope_np(host.series, N))
        bands[f"resid_N{N}_max_abs"] = float(
            (built.residuals[li] - up.residuals[li]).abs().max())
    check(all(v["outside_band"] == 0 for v in bands.values()
              if isinstance(v, dict)),
          f"repr: device symbols differ from the host build outside the "
          f"f32 band of a breakpoint: {bands}")
    nbytes = lambda ts: int(sum(t.numel() * t.element_size() for t in ts))
    resident = {"series": nbytes([built.series]),
                "paper_words": nbytes(built.words),
                "trend_words": nbytes([lv["trend_slope"]
                                       for lv in built.extra]),
                "residuals": nbytes(built.residuals),
                "norms": nbytes([built.norms_sq])}
    del up
    log(f"[repr-build] host build {t_host:.1f}s, device build + service "
        f"{t_build:.2f}s; device symbols against the f64 host build "
        f"{bands}; resident bytes {resident}")

    step("build")
    # ---- 3. serving, in turns with the paper stack
    svc_e.warmup()
    svc_p.warmup()
    spec = WorkloadSpec(n_requests=cfg["requests"],
                        knn_frac=cfg["knn_frac"], k=cfg["k"], epsilon=eps)
    workload = make_workload(queries, spec)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        turns = repr_turns(torch, fq, lo, [("paper", svc_p),
                                           ("extended", svc_e),
                                           ("extended", svc_e),
                                           ("paper", svc_p)], workload, tmp)
    peak = torch.cuda.max_memory_allocated() - mem0
    for t in turns:
        check(t["launches"].get("fused_range", 0) > 0
              and t["launches"].get("fused_topk", 0) > 0,
              f"repr: kernels 1-2 did not launch in the {t['stack']} "
              f"service: {t['launches']}")
        add(t["launches"])
    res_e, res_p = turns[1]["result"], turns[0]["result"]
    # One request of each kind alone through each service.
    direct = {}
    for label, svc in (("paper", svc_p), ("extended", svc_e)):
        for kind, kw in (("range", {"epsilon": eps}), ("knn",
                                                       {"k": cfg["k"]})):
            t0 = time.perf_counter()
            for q in queries[:4]:
                svc.direct_query(kind, q, **kw)
            direct[f"{label}_{kind}_ms"] = \
                (time.perf_counter() - t0) * 1e3 / 4
    mismatches, t_replay = replay_check(svc_e, workload, res_e, "repr-serve")
    bf = brute_force_check(built.series.cpu().numpy(), workload, res_e, 16)
    check(bf["wrong"] == 0 and bf["checked"] >= 8,
          f"repr: brute-force disagreement: {bf}")
    vs_paper = cross_check(built.series.cpu().numpy(), workload, res_e,
                           res_p)
    check(vs_paper["wrong"] == 0,
          f"repr: extended answers differ from the paper stack's: "
          f"{vs_paper}")
    out["serve"] = {"turns": [{k: v for k, v in t.items() if k != "result"}
                              for t in turns],
                    "exact_mismatches": mismatches, "replay_s": t_replay,
                    "direct_ms": direct, "brute_force": bf,
                    "vs_paper": vs_paper,
                    "peak_bytes_above_start": peak}
    log(f"[repr-serve] exactness mismatches {mismatches} ({t_replay:.1f}s); "
        f"brute force {bf}; against the paper stack {vs_paper}; one "
        f"request alone (ms) {direct}; max_memory_allocated during the "
        f"turns {peak} bytes above the "
        f"phase's start (two services resident)")

    step("serve")
    # ---- 4. traced: counters per level, extended against paper
    dev = built.device
    q32 = torch.as_tensor(queries[:cfg["queries"]], dtype=torch.float32,
                          device=dev)
    qr_e = engine.represent_queries(q32, levels, A, stack=EXT_STACK)
    qr_p = engine.represent_queries(q32, levels, A)
    eps_t = torch.full((q32.shape[0],), eps, dtype=torch.float32,
                       device=dev)
    reset_counts(fq, lo)
    _, _, tr_e = engine.range_query_traced(built, qr_e, eps)
    nn_e = engine.knn_query_traced(built, qr_e, cfg["k"])
    torch.cuda.synchronize()
    launched_e = {k_: v for k_, v in counts_now(fq, lo).items() if v}
    reset_counts(fq, lo)
    _, _, tr_p = engine.range_query_traced(svc_p.backend.index, qr_p, eps)
    engine.knn_query_traced(svc_p.backend.index, qr_p, cfg["k"])
    torch.cuda.synchronize()
    launched_p = {k_: v for k_, v in counts_now(fq, lo).items() if v}
    check(all(ln.get("fused_range", 0) > 0 and ln.get("fused_topk", 0) > 0
              for ln in (launched_e, launched_p)),
          f"repr: traced launches {launched_e} / {launched_p}")
    add(launched_e)
    add(launched_p)
    check(counters_equal(tr_p, index_counts(torch, ref, ops,
                                            svc_p.backend.index, qr_p,
                                            eps_t)),
          "repr: the paper stack's counters differ from the plain counts")
    check(counters_equal(tr_e, index_counts(torch, ref, ops, built, qr_e,
                                            eps_t)),
          "repr: the traced counters differ from the plain per-level counts")
    # The torch engine's cascade with the trend test on the card against
    # kernels 1-2 on the paper stack (a comparison, not a path run).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_ans, t_d2 = engine.range_query(built, qr_e, eps)
    t_idx, t_kd2, t_exact = engine.knn_query_auto(built, qr_e, cfg["k"])
    torch.cuda.synchronize()
    ms_torch = (time.perf_counter() - t0) * 1e3
    p_ans, p_d2 = engine.range_query_fused(svc_p.backend.index, qr_p, eps)
    p_idx, p_kd2, _ = engine.knn_query_fused(svc_p.backend.index, qr_p,
                                             cfg["k"])
    differ = (t_ans != p_ans).cpu().numpy()
    d2 = torch.where(p_ans, p_d2, t_d2).cpu().numpy()
    near = np.abs(d2 - eps * eps) <= band(eps * eps)
    koff = (t_idx != p_idx).cpu().numpy()
    kd2 = p_kd2.cpu().numpy()
    kgap = np.abs(t_kd2.cpu().numpy() - kd2)
    vs_torch = {"range_band": int((differ & near).sum()),
                "range_wrong": int((differ & ~near).sum()),
                "knn_band": int((koff & (kgap <= band(kd2))).sum()),
                "knn_wrong": int((koff & ~(kgap <= band(kd2))).sum()),
                "torch_range_knn_ms": ms_torch}
    check(vs_torch["range_wrong"] == 0 and vs_torch["knn_wrong"] == 0
          and bool(t_exact.all()),
          f"repr: the torch engine with the trend test differs from "
          f"kernels 1-2: {vs_torch}")
    del t_ans, t_d2, p_ans, p_d2, d2
    tr_e, tr_p = to_host(tr_e), to_host(tr_p)
    d_k = engine._final_radius(nn_e[1], cfg["k"]).reshape(-1)
    check(counters_equal(nn_e[3], index_counts(torch, ref, ops, built, qr_e,
                                               d_k)),
          "repr: the k-NN trace differs from the plain counts at d_k")
    med = float(np.median(tr_e.answers))
    check(med >= 1, f"repr: the median query has no answer at eps {eps}")
    check(np.all(tr_e.after_c9 <= tr_p.after_c9)
          and np.all(tr_e.after_c10 <= tr_p.after_c10)
          and tr_e.verified.sum() < tr_p.verified.sum(),
          "repr: the extended stack kept more rows than the paper stack")
    # trend_slope's own kills per level: the rows that survive C9 and C10
    # of a level on the extended cascade but not its trend test.
    kills = {}
    alive = None
    for li, N in enumerate(levels):
        ok9 = (built.residuals[li][None] - qr_e.residuals[li][:, None]
               ).abs() <= eps
        alive = ok9 if alive is None else alive & ok9
        alive &= ref.mindist_sq_ref(built.words[li], ops.query_panels(
            qr_e.words[li], A), N, n) <= eps * eps
        before = alive.sum(-1)
        alive &= trend_bound_plain(torch, ops, built.extra[li]["trend_slope"],
                                   qr_e.extra[li]["trend_slope"], A) \
            <= eps * eps
        kills[f"N{N}"] = float((before - alive.sum(-1)).float().mean())
    del alive
    check(all(v > 0 for v in kills.values()),
          f"repr: trend_slope killed no row at some level: {kills}")
    host_counts = host_op_counts(torch, engine, ref, ops, host,
                                 queries[:cfg["host_queries"]], eps, dev)
    # Traced services: the extras' kills reach stats and /metrics.  Range
    # requests at one ε, so the two stacks' counters compare row for row.
    served = {}
    wl16 = make_workload(queries[:cfg["traced_requests"]], WorkloadSpec(
        n_requests=cfg["traced_requests"], knn_frac=0.0, epsilon=eps))
    for label, svc, stack in (("extended", svc_e, EXT_STACK),
                              ("paper", svc_p, EXT_STACK[:2])):
        tsvc = SearchService(svc.backend, ServeConfig(stack=stack,
                                                      trace=True))
        reset_counts(fq, lo)
        with tsvc:
            r = run_closed_loop(tsvc, wl16, clients=cfg["clients"])
            torch.cuda.synchronize()
        check(r.served == len(wl16), f"repr: traced {label} served "
                                     f"{r.served} of {len(wl16)}")
        add({k_: v for k_, v in counts_now(fq, lo).items() if v})
        served[label] = tsvc.stats.snapshot()["cascade"]
        check("repro_cascade_rows_total" in tsvc.metrics_text(),
              "repr: no cascade family in the metrics text")
    check(served["extended"]["after_c10"] < served["paper"]["after_c10"],
          f"repr: the traced service shows no extra kills: {served}")
    out["traced"] = {
        "after_c9_mean": {"extended": tr_e.after_c9.mean(0).tolist(),
                          "paper": tr_p.after_c9.mean(0).tolist()},
        "after_c10_mean": {"extended": tr_e.after_c10.mean(0).tolist(),
                           "paper": tr_p.after_c10.mean(0).tolist()},
        "verified_mean": {"extended": float(tr_e.verified.mean()),
                          "paper": float(tr_p.verified.mean())},
        "median_answers": med,
        "trend_kills_mean": kills, "host_op_counts": host_counts,
        "service_cascade": served, "torch_engine_vs_kernels": vs_torch,
        "launches": {"extended": launched_e, "paper": launched_p}}
    log(f"[repr-trace] eps={eps}, {q32.shape[0]} queries: after C9 per "
        f"level {out['traced']['after_c9_mean']}, after C10 "
        f"{out['traced']['after_c10_mean']}, verified "
        f"{out['traced']['verified_mean']} (means; counters equal the "
        f"plain per-level counts), median answers {med}; trend_slope "
        f"kills per level {kills}; the torch engine's cascade with the "
        f"trend test against kernels 1-2 {vs_torch}; "
        f"host op counts on {host_counts['queries']} queries: "
        f"{host_counts['band_rows']} band rows, 0 wrong; traced services' "
        f"after_c10 {served['extended']['after_c10']} against "
        f"{served['paper']['after_c10']}")
    del svc_e, svc_p, built, qr_e, qr_p

    step("traced")
    # ---- 5. the int8 tier
    out["tier"], launched = repr_tier(torch, engine, fq, lo, ref, ops, host,
                                      queries[:cfg["queries"]])
    add(launched)
    log(f"[repr-tier] int8: answers {out['tier']['answers']}; widened "
        f"cascade after C10 per level (means) "
        f"{out['tier']['after_c10_mean']}; series-screen survivors (means) "
        f"{out['tier']['screen_mean']}; kernel 5 against "
        f"its plain keep (rows) {out['tier']['kernel5_vs_plain_rows']}; ms "
        f"{out['tier']['ms']}; launches {out['tier']['launches']}")

    step("tier")
    # ---- 6. level at a time
    out["level"], launched = repr_level_search(torch, lo, ref, ops, host,
                                               queries, dev)
    add(launched)
    del host, db

    step("level")
    # ---- 7. subsequence
    out["subseq"], launched = repr_subseq(torch, engine, fq, lo, ss)
    add(launched)

    step("subseq")
    # ---- 8. curation
    out["curation"] = repr_curation(torch)
    step("curation")

    out.update({"data_s": t_data, "host_build_s": t_host,
                "device_build_s": t_build, "bands": bands,
                "reckoned_bytes": reckoned, "resident_bytes": resident,
                "seconds": time.perf_counter() - t_phase,
                "steps_s": steps, "launches": total})
    report["repr"] = out
    log(f"[repr] phase 16 in {out['seconds']:.1f}s (steps "
        f"{ {k: round(v, 1) for k, v in steps.items()} }); path launches "
        f"{total}")
    return total


# ---------------------------------------------------------------------------
# Phase 17: sharded search (shard-1M) — the database sharded over a mesh of
# P = 4 shards on the card, sharded stores, the sharded int8 tier, the
# stream-sharded subsequence search and failover shards under a FaultPlan.
# ---------------------------------------------------------------------------

# shard-1M: serve-1M's index and requests and subseq-1M's streams over 4
# shards (all on one card here: make_data_mesh places shard i on card
# i mod the card count).
SHARD = dict(shards=4, queries=32, eps=2.0, k=5, rows=N_SERVE)


def resident_bytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors
                   if t is not None))


def index_bytes(idx) -> int:
    return resident_bytes([idx.series, idx.norms_sq, *idx.words,
                           *idx.residuals])


def shard_engines(torch, engine, fq, ds, db, index, queries, smi) -> tuple:
    """Step (a): the sharded engines on 32 queries, each counted, against
    the single index's fused path (bit for bit) and the f64 brute force."""
    from repro_torch.core.paa import znormalize_np

    cfg = SHARD
    mesh = ds.make_data_mesh(cfg["shards"])
    check(mesh.size == cfg["shards"], f"mesh of {mesh.size} shards")
    padded, nv = ds.pad_database(db, mesh.size)
    t0 = time.perf_counter()
    sidx = ds.distributed_build(padded, (8, 16), 10, mesh, n_valid=nv)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    qs = queries[:cfg["queries"]]
    Q = qs.shape[0]
    is_knn = np.arange(Q) % 2 == 0
    eps_vec = np.full(Q, cfg["eps"], np.float32)
    launches: dict = {}
    out = {}
    for name, fn in (
            ("range", lambda: ds.distributed_range_query(
                sidx, qs, cfg["eps"], mesh)),
            ("range_auto", lambda: ds.distributed_range_query_auto(
                sidx, qs, cfg["eps"], mesh)),
            ("knn", lambda: ds.distributed_knn_query(sidx, qs, cfg["k"],
                                                     mesh)),
            ("mixed", lambda: ds.distributed_mixed_query(
                sidx, qs, eps_vec, is_knn, cfg["k"], mesh)),
            ("mixed_auto", lambda: ds.distributed_mixed_query_auto(
                sidx, qs, eps_vec, is_knn, cfg["k"], mesh))):
        out[name], ln = counted(torch, fq, fn)
        check(ln["fused_range"] + ln["fused_topk"] > 0,
              f"{name}: kernels 1-2 did not launch: {ln}")
        add_launches(launches, ln)
    check(launches["fused_range"] > 0 and launches["fused_topk"] > 0,
          f"the sharded engines did not launch kernels 1-2: {launches}")
    # The single index of phase 3 through the fused path, uncounted.
    qr = engine.represent_queries(
        torch.as_tensor(qs, dtype=torch.float32, device="cuda"), (8, 16), 10)
    w_ans, w_d2 = engine.range_query_fused(index, qr, cfg["eps"])
    w_idx, w_kd2, _ = engine.knn_query_fused(index, qr, cfg["k"])
    gidx, ans, d2, ovf = out["range_auto"]
    check(not bool(ovf.any()), "range_auto still overflowed")
    bit = {"range_sets": 0, "range_d2": 0, "knn_ids": 0, "knn_d2": 0}
    for i in range(Q):
        g = gidx[i][ans[i]].long()
        want = torch.nonzero(w_ans[i]).flatten()
        bit["range_sets"] += int(torch.equal(torch.sort(g).values, want))
        bit["range_d2"] += int(torch.equal(
            d2[i][ans[i]], w_d2[i][g]))
    nn_idx, nn_d2, exact = out["knn"]
    check(bool(exact.all()), "sharded k-NN certificates")
    bit["knn_ids"] = int((nn_idx[:, :cfg["k"]] == w_idx.long()).all(
        dim=-1).sum())
    bit["knn_d2"] = int((nn_d2[:, :cfg["k"]] == w_kd2).all(dim=-1).sum())
    check(all(v == Q for v in bit.values()),
          f"sharded answers differ from the single index's: {bit} of {Q}")
    # The mixed batch: range rows the same sets, k-NN rows the same ids.
    mg, ma, md, movf = out["mixed_auto"]
    check(not bool(movf.any()), "mixed_auto still overflowed")
    mixed_ok = 0
    for i in range(Q):
        if is_knn[i]:
            top, _ = engine.mixed_topk(mg[i:i + 1], md[i:i + 1], cfg["k"])
            mixed_ok += int(torch.equal(top[0].long(), w_idx[i].long()))
        else:
            mixed_ok += int(torch.equal(
                torch.sort(mg[i][ma[i]].long()).values,
                torch.nonzero(w_ans[i]).flatten()))
    check(mixed_ok == Q, f"mixed: {mixed_ok} of {Q} equal")
    # The f64 brute force under the band rule.
    s64 = index.series.double()
    bf = {"checked": 0, "boundary_rows": 0, "wrong": 0}
    for i in range(Q):
        qz = torch.as_tensor(znormalize_np(qs[i].astype(np.float64)),
                             device="cuda")
        dd = torch.cat([((s64[s:s + (1 << 18)] - qz) ** 2).sum(-1)
                        for s in range(0, s64.shape[0], 1 << 18)])
        e2 = cfg["eps"] ** 2
        got = gidx[i][ans[i]].long().cpu().numpy()
        d_np = dd.cpu().numpy()
        sym = np.setxor1d(np.flatnonzero(d_np <= e2), got)
        bad = int((np.abs(d_np[sym] - e2) > band(e2)).sum())
        want = torch.sort(dd, stable=True).indices[:cfg["k"]].cpu().numpy()
        kid = nn_idx[i, :cfg["k"]].cpu().numpy()
        off = np.flatnonzero(kid != want)
        bad += int((np.abs(d_np[kid[off]] - d_np[want[off]])
                    > band(d_np[want[off]])).sum())
        bf["checked"] += 1
        bf["boundary_rows"] += int(sym.size + off.size)
        bf["wrong"] += bad
    del s64
    check(bf["wrong"] == 0, f"sharded answers vs the f64 brute force: {bf}")
    # Per-shard kernel 1 at the path's shape against the whole index's.
    shard0 = sidx.shards[0]
    eps_col = engine._eps_qcol(cfg["eps"], Q, "cuda")
    shard_ms = cuda_ms(torch, lambda: engine.range_query_fused(
        shard0, qr, eps_col), 5)
    whole_ms = cuda_ms(torch, lambda: engine.range_query_fused(
        index, qr, eps_col), 5)
    res = {"build_s": t_build, "launches": launches, "bit_identical": bit,
           "mixed_equal": mixed_ok, "brute_force": bf,
           "resident_bytes": sum(index_bytes(s) for s in sidx.shards),
           "single_index_bytes": index_bytes(index),
           "kernel1_ms_one_shard": shard_ms,
           "kernel1_ms_whole_index": whole_ms}
    log(f"[shard-engines] {smi}: {mesh.size} shards of {sidx.b_loc} rows on "
        f"{sorted({str(d) for d in mesh.devices})}, built in {t_build:.2f}s, "
        f"{res['resident_bytes']} bytes resident (one index "
        f"{res['single_index_bytes']}); range/range_auto/knn/mixed/"
        f"mixed_auto launches {launches}; bit-identical to phase 5's fused "
        f"path {bit} of {Q}; mixed {mixed_ok}/{Q}; f64 brute force {bf}; "
        f"range_query_fused (kernel 1 wrapper) at Q={Q}: one shard "
        f"{shard_ms:.3f} ms, the whole index {whole_ms:.3f} ms")
    return mesh, sidx, res


def dispatch_ms(torch, backend, queries, reps: int = 5) -> float:
    """Host ms of one Q = 32 mixed dispatch (half k-NN at k = 8, half
    range at ε = 2), answers on the host, mean of ``reps`` after one."""
    q = np.asarray(queries[:32], np.float32)
    eps = np.full(32, SHARD["eps"], np.float32)
    is_knn = np.arange(32) % 2 == 0
    backend.dispatch(q, eps, is_knn, 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        backend.dispatch(q, eps, is_knn, 8)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def shard_service(torch, fq, ds, db, index, mesh, queries, workload, result,
                  root, smi) -> tuple:
    """Steps (b) and (c): serve-1M's closed loop through
    ``from_series(mesh=…)``, a Q = 32 dispatch against one index's; the
    sharded store and a warm start."""
    from repro_torch.serve import SearchService, ServeConfig
    from repro_torch.serve.service import _ShardedBackend, _SingleBackend

    t0 = time.perf_counter()
    svc = SearchService.from_series(db, ServeConfig(), mesh=mesh)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    check(isinstance(svc.backend, _ShardedBackend)
          and svc.backend.backend == "cuda",
          "the sharded service must serve through the kernels")
    t0 = time.perf_counter()
    svc.warmup()
    t_warm = time.perf_counter() - t0
    res, launched = serve_phase(torch, fq, svc, workload, "shard-serve")
    check(res.served == len(workload), f"served {res.served}")
    check(launched["fused_range"] > 0 and launched["fused_topk"] > 0,
          f"kernels 1-2 did not launch from the sharded service: {launched}")
    mismatches, t_replay = replay_check(svc, workload, res, "shard-serve")
    vs5 = {"requests": len(workload), "equal": sum(
        int(np.array_equal(g.ids, w.ids)
            and np.array_equal(g.distances, w.distances))
        for g, w in zip(res.requests, result.requests))}
    check(vs5["equal"] == len(workload),
          f"sharded service answers differ from phase 5's: {vs5}")
    snap = svc.stats.snapshot()
    served = direct_answers(svc, workload)
    # Where a batch's time goes: the sharded dispatch (four compact
    # buffers copied) against one index's (the dense (Q, B) layout).
    split = {"sharded_ms": dispatch_ms(torch, svc.backend, queries),
             "one_index_ms": dispatch_ms(
                 torch, _SingleBackend(index, ServeConfig()), queries),
             "sharded_d2h_bytes": svc.backend.last_d2h_bytes}
    path = root / "sharded"
    t0 = time.perf_counter()
    ds.store_sharded(svc.backend.index, path)
    t_save = time.perf_counter() - t0
    del svc
    t0 = time.perf_counter()
    warm = SearchService.from_store(path)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(isinstance(warm.backend, _ShardedBackend)
          and len(warm.backend.index.shards) == mesh.size,
          "the sharded store must warm-start the sharded backend")
    (warm_answers, wl) = counted(torch, fq,
                                 lambda: direct_answers(warm, workload))
    check(wl["fused_range"] > 0 and wl["fused_topk"] > 0,
          f"the warm start did not launch kernels 1-2: {wl}")
    check(same_answers(warm_answers, served, exact=True),
          "the warm-started sharded service answers differently")
    store_bytes = sum(f.stat().st_size for f in path.rglob("*")
                      if f.is_file())
    shutil.rmtree(path)
    out = {"build_s": t_build, "warmup_s": t_warm, "qps": res.qps,
           "phase5_qps": result.qps, "latency_ms": snap["latency_ms"],
           "mean_batch": snap["mean_batch_size"], "launches": launched,
           "exact_mismatches": mismatches, "replay_s": t_replay,
           "vs_phase5": vs5, "store_save_s": t_save,
           "warm_start_s": t_load, "store_bytes": store_bytes,
           "warm_launches": wl, "dispatch_q32": split}
    lat = snap["latency_ms"]
    log(f"[shard-serve] {smi}: 64 requests at {res.qps:.2f} qps over "
        f"{mesh.size} shards (phase 5, one index: {result.qps:.2f} qps); "
        f"p50 {lat['p50']} ms p99 {lat['p99']} ms; launches {launched}; "
        f"replay mismatches {mismatches}; answers bit-identical to phase "
        f"5's {vs5['equal']}/{vs5['requests']}; a Q=32 mixed dispatch "
        f"(k=8) {split['sharded_ms']:.1f} ms sharded "
        f"({split['sharded_d2h_bytes']} bytes to the host) against "
        f"{split['one_index_ms']:.1f} ms on one index")
    log(f"[shard-store] {smi}: store_sharded {t_save:.2f}s "
        f"({store_bytes} bytes), warm start {t_load:.2f}s, the 64 requests "
        f"replayed bit-identical, launches {wl}")
    return out, launched, wl


def shard_tier(torch, fq, ds, tier8, mesh, workload, qresult, smi) -> tuple:
    """Step (d): the sharded int8 tier, kernel 5 on every shard."""
    from repro_torch.serve import SearchService, ServeConfig
    from repro_torch.serve.service import _DistQuantizedBackend

    cfg = ServeConfig(quantization="int8")
    t0 = time.perf_counter()
    dti = ds.distributed_tiered_index(tier8, mesh)
    torch.cuda.synchronize()
    t_shard = time.perf_counter() - t0
    svc = SearchService(_DistQuantizedBackend(dti, mesh, cfg), cfg)
    check(svc.backend.backend == "cuda", "the sharded tier must use kernel 5")
    svc.warmup()
    res, launched = serve_phase(torch, fq, svc, workload, "shard-tier")
    check(res.served == len(workload), f"served {res.served}")
    check(launched["fused_quant_range"] >= mesh.size,
          f"kernel 5 did not launch on every shard: {launched}")
    mismatches, _ = replay_check(svc, workload, res, "shard-tier")
    vs8 = {"requests": len(workload), "equal": sum(
        int(np.array_equal(g.ids, w.ids)
            and np.array_equal(g.distances, w.distances))
        for g, w in zip(res.requests, qresult.requests))}
    check(vs8["equal"] == len(workload),
          f"sharded tier answers differ from phase 8's: {vs8}")
    out = {"reshard_s": t_shard, "qps": res.qps,
           "phase8_qps": qresult.qps, "launches": launched,
           "exact_mismatches": mismatches, "vs_phase8": vs8,
           "resident_bytes": sum(quant_resident_bytes(s)
                                 for s in dti.shards)}
    log(f"[shard-tier] {smi}: int8 tier resharded onto {mesh.size} shards "
        f"in {t_shard:.2f}s ({out['resident_bytes']} bytes resident); 64 "
        f"requests at {res.qps:.2f} qps (phase 8, one tier: "
        f"{qresult.qps:.2f}), launches {launched}, replay "
        f"mismatches {mismatches}, phase 8's answers {vs8['equal']}/"
        f"{vs8['requests']}")
    return out, launched


def shard_subseq(torch, fq, ds, sub, mesh, smi) -> tuple:
    """Step (e): subseq-1M's 16 streams over the shards, kernels 3-4."""
    cfg = SUBSEQ
    t0 = time.perf_counter()
    dsx = ds.distributed_subseq_index(sub["hidx"], mesh)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    launches: dict = {}
    (gidx, ans, d2, ovf), ln = counted(torch, fq, lambda: (
        ds.distributed_subseq_range_query(dsx, sub["queries"], cfg["eps"],
                                          mesh)))
    add_launches(launches, ln)
    (sel, sel_d2, exact), ln = counted(torch, fq, lambda: (
        ds.distributed_subseq_knn_query(dsx, sub["queries"], cfg["k"], mesh,
                                        excl=cfg["excl"])))
    add_launches(launches, ln)
    check(launches["fused_subseq_range"] >= mesh.size
          and launches["fused_subseq_topk"] >= mesh.size,
          f"kernels 3-4 did not launch on every shard: {launches}")
    check(launches["fused_range"] == 0 and launches["fused_topk"] == 0,
          f"the stream shards went through kernels 1-2: {launches}")
    check(bool(exact.all()) and not bool(ovf.any()),
          "stream-sharded certificates")
    want = sub["ans"]
    equal = sum(int(torch.equal(torch.sort(gidx[i][ans[i]].long()).values,
                                torch.nonzero(want[i]).flatten()))
                for i in range(want.shape[0]))
    knn_equal = int((sel == sub["sel"]).all(axis=1).sum())
    check(equal == want.shape[0] and knn_equal == want.shape[0],
          f"stream-sharded answers differ from phase 10's: range {equal}, "
          f"k-NN {knn_equal} of {want.shape[0]}")
    out = {"build_s": t_build, "launches": launches, "range_equal": equal,
           "knn_equal": knn_equal, "shard_windows": dsx.w_loc,
           "resident_bytes": sum(
               resident_bytes([s.streams, s.mu, s.sd]) + index_bytes(s.index)
               for s in dsx.shards)}
    log(f"[shard-subseq] {smi}: {cfg['streams']} streams over {mesh.size} "
        f"shards ({dsx.w_loc} windows each) in {t_build:.2f}s, "
        f"{out['resident_bytes']} bytes resident; launches {launches}; "
        f"range {equal} and k-NN {knn_equal} of {want.shape[0]} equal to "
        f"phase 10's")
    return out, launches


def failover_request(svc, kind, q, eps, k):
    req = (svc.submit_knn(q, k) if kind == "knn"
           else svc.submit_range(q, eps))
    req.wait(120)
    return req


def shard_failover(torch, fq, db, series, workload, smi) -> tuple:
    """Step (f): failover shards under a FaultPlan — a transient fault
    healed by a retry, a killed shard marked down (certified-partial
    answers equal to the brute force over the other shards' rows, the
    coverage in /healthz), revived by a probe, and a slowed shard
    hedged."""
    import urllib.request

    from repro_torch.obs.metrics import start_metrics_server
    from repro_torch.runtime import chaos
    from repro_torch.serve import SearchService, ServeConfig

    cfg = ServeConfig(max_batch=8, failover_shards=SHARD["shards"])
    t0 = time.perf_counter()
    svc = SearchService.from_series(db, cfg)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    eng = svc.backend.engine
    check(svc.backend.backend == "cuda" and eng.n_shards == SHARD["shards"]
          and all(d.type == "cuda" for d in eng.devices),
          "failover shards must sit on the card")
    t0 = time.perf_counter()
    svc.warmup(qs=(1, 8))
    t_warm = time.perf_counter() - t0
    check(eng.shard_states() == ["up"] * eng.n_shards,
          f"a shard went down in the warmup: {eng.shard_states()}")
    per = [int(s.size) for s in eng.shards]
    off = eng.offsets
    picks = [i for i, w in enumerate(workload) if w[0] == "knn"][:4] + \
        [i for i, w in enumerate(workload) if w[0] == "range"][:4]
    server = start_metrics_server(svc.metrics_text, 0, health_fn=svc.health)
    url = f"http://127.0.0.1:{server.server_address[1]}/healthz"
    steps = {}
    launches: dict = {}
    try:
        with svc:
            fq.reset_launch_counts()
            healthy = [failover_request(svc, *workload[i]) for i in picks]
            check(all(r.exact for r in healthy), "healthy: not exact")
            # A transient fault on shard 1: one attempt, healed by a retry.
            plan = chaos.FaultPlan(seed=0, specs=[chaos.FaultSpec(
                site="shard_query", key="1", start=0, stop=1)])
            with chaos.injected(plan):
                r = failover_request(svc, *workload[picks[0]])
            check(r.exact and eng.events["retries"] >= 1,
                  f"transient fault not healed: {r.coverage}, "
                  f"{dict(eng.events)}")
            steps["transient"] = {"coverage": r.coverage,
                                  "retries": eng.events["retries"]}
            # Shard 2 killed: down after 3 dispatches, partial answers.
            plan = chaos.FaultPlan(seed=0, specs=[chaos.FaultSpec(
                site="shard_query", key="2")])
            with chaos.injected(plan):
                partial = [failover_request(svc, *workload[i])
                           for i in picks]
                health = json.loads(urllib.request.urlopen(url).read())
            states = eng.shard_states()
            check(states[2] == "down" and eng.events["shard_down"] >= 1,
                  f"shard 2 not marked down: {states}")
            rows_other = sum(per) - per[2]
            check(all((not p.exact) and p.coverage["shards_ok"] == 3
                      and p.coverage["rows_ok"] == rows_other
                      for p in partial),
                  f"partial coverage: {[p.coverage for p in partial]}")
            check(health["coverage"]["rows_ok"] == rows_other
                  and not health["coverage"]["exact"],
                  f"/healthz coverage: {health}")
            # Revived by a probe: exact again within probe_every dispatches.
            revived = []
            for i in picks:
                revived.append(failover_request(svc, *workload[i]))
                if revived[-1].exact:
                    break
            check(revived[-1].exact and eng.shard_states()[2] == "up",
                  f"shard 2 not revived: {eng.shard_states()}")
            again = [failover_request(svc, *workload[i]) for i in picks]
            check(all(a.exact for a in again), "not exact after revival")
            # A slowed shard: its first attempt outlasts the watchdog's
            # timeout and is hedged; the re-dispatch answers in time.
            plan = chaos.FaultPlan(seed=0, specs=[chaos.FaultSpec(
                site="shard_query", key="0", mode="slow", delay_s=2.0,
                start=0, stop=1)])
            hedges0 = eng.events["hedges"]
            t0 = time.perf_counter()
            with chaos.injected(plan):
                slow = failover_request(svc, *workload[picks[0]])
            t_slow = time.perf_counter() - t0
            check(eng.events["hedges"] > hedges0 and t_slow < 2.0,
                  f"the slowed shard was not hedged: {dict(eng.events)}, "
                  f"{t_slow:.2f}s")
            # The hedged-away first attempt sleeps out its delay in the
            # pool, then queries: wait for it, so that its launches count
            # here and none falls into a later phase.
            eng.close(wait=True)
            torch.cuda.synchronize()
            launches = {k.__name__: k.launches for k in fq.KERNELS}
    finally:
        server.shutdown()
        server.server_close()
    check(launches["fused_range"] > 0 and launches["fused_topk"] > 0,
          f"the failover shards did not launch kernels 1-2: {launches}")
    # Answers: healthy and revived ones equal phase 5's by the band rule;
    # the partial ones the f64 brute force over the other shards' rows.
    from repro_torch.core.paa import znormalize_np
    s64 = rows_f64(torch, series, torch.device("cuda"))
    keep = torch.ones(s64.shape[0], dtype=torch.bool, device="cuda")
    keep[off[2]:off[2] + per[2]] = False
    bf = {"checked": 0, "boundary_rows": 0, "wrong": 0}
    for reqs, mask in ((healthy, None), (again, None), (partial, keep)):
        for i, req in zip(picks, reqs):
            kind, q, eps, k = workload[i]
            qz = torch.as_tensor(znormalize_np(
                np.asarray(q, np.float32).astype(np.float64)), device="cuda")
            dd = ((s64 - qz) ** 2).sum(-1)
            if mask is not None:
                dd = torch.where(mask, dd, torch.full_like(dd, np.inf))
            d_np = dd.cpu().numpy()
            if kind == "range":
                sym = np.setxor1d(np.flatnonzero(d_np <= eps * eps), req.ids)
                bad = int((np.abs(d_np[sym] - eps * eps)
                           > band(eps * eps)).sum())
            else:
                want = torch.sort(dd, stable=True).indices[:k].cpu().numpy()
                sym = np.flatnonzero(want != req.ids)
                bad = int((np.abs(d_np[req.ids[sym]] - d_np[want[sym]])
                           > band(d_np[want[sym]])).sum())
            bf["checked"] += 1
            bf["boundary_rows"] += int(sym.size)
            bf["wrong"] += bad
    del s64
    check(bf["wrong"] == 0, f"failover answers vs the f64 brute force: {bf}")
    out = {"build_s": t_build, "warmup_s": t_warm, "steps": steps,
           "partial_coverage": partial[0].coverage,
           "healthz": health, "revived_after": len(revived),
           "slowed_dispatch_s": t_slow, "events": dict(eng.events),
           "brute_force": bf, "launches": launches}
    log(f"[shard-failover] {smi}: {eng.n_shards} failover shards built in "
        f"{t_build:.2f}s, warmup {t_warm:.1f}s; transient fault healed "
        f"({steps['transient']}); shard 2 killed: down, coverage "
        f"{partial[0].coverage}, /healthz {health['coverage']}; revived "
        f"after {len(revived)} dispatch(es); slowed shard hedged in "
        f"{t_slow:.2f}s; events {dict(eng.events)}; f64 brute force {bf}; "
        f"launches {launches}")
    return out, launches


def shard_phase(torch, engine, fq, db, index, tier8, sub, queries,
                workload, result, qresult, report) -> dict:
    """Phase 17; returns the launch counts of its counted runs, summed."""
    from repro_torch.core import dist_search as ds

    smi = report["env"]["nvidia_smi"]
    t_start = time.perf_counter()
    launches: dict = {}
    mesh, sidx, engines = shard_engines(torch, engine, fq, ds, db, index,
                                        queries, smi)
    add_launches(launches, engines["launches"])
    del sidx
    root = store_dir()
    try:
        serve, ln, wl = shard_service(torch, fq, ds, db, index, mesh,
                                      queries, workload, result, root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    add_launches(launches, ln)
    add_launches(launches, wl)
    tier, ln = shard_tier(torch, fq, ds, tier8, mesh, workload, qresult, smi)
    add_launches(launches, ln)
    subseq, ln = shard_subseq(torch, fq, ds, sub, mesh, smi)
    add_launches(launches, ln)
    failover, ln = shard_failover(torch, fq, db, index.series.cpu().numpy(),
                                  workload, smi)
    add_launches(launches, ln)
    report["shard"] = {"card": smi, "shards": SHARD["shards"],
                       "engines": engines, "serve": serve, "tier": tier,
                       "subseq": subseq, "failover": failover,
                       "launches": launches,
                       "seconds": time.perf_counter() - t_start,
                       "max_memory_allocated":
                           torch.cuda.max_memory_allocated()}
    log(f"[shard] phase 17 in {report['shard']['seconds']:.1f}s on {smi}; "
        f"launches of its counted runs {launches}")
    return launches


# ---- Phase 18: the LM serving path.
LM_ARCH = "granite-3-2b"
LM_ARGV = ["--arch", LM_ARCH, "--no-smoke", "--batch", "4",
           "--prompt-len", "32", "--gen", "16"]
LM_PARAMS = 2_634_201_088      # the reference's ModelConfig.param_count()
LM_F32_TOL = 2e-3              # the reference's serving rtol and atol
# bf16: max |Δ| over max |logit| between a step's logits and the full
# forward's, per architecture at the width it runs at here, about twice
# what an H100 80GB HBM3 at 700 W measured (granite 0.0207, mamba2
# 0.0819, zamba2 0.0516, whisper 0.0104, the VLM 0.00291, mixtral 0.198
# and qwen3-moe 0.0548 at 4 layers).  The SSM kinds round their chunked
# prefill at the reference's bf16 points (the decay-weighted B, the chunk
# states) where decode's recurrence keeps f32 state.  In the MoE configs
# a router near a tie picks another expert for a token when its bf16
# input moves by one rounding, and that token's logits move by a tenth
# of their size: the reference does the same (its two XLA compiles of
# qwen3-moe's smoke config differ by 0.2 on the CPU), so their bf16
# ratio admits it and their f32 run is held to the reference's 2e-3.
# Turning ``allow_bf16_reduced_precision_reduction`` off moved granite's
# ratio by nothing (0.02108 both ways, PERF.md), so the port leaves
# PyTorch's default.  Where the port's bf16 stands against the reference
# is ``tests/test_torch_lm.py``'s (the CPU) and step (d)'s (the card).
LM_BF16_TOL = {"granite-3-2b": 0.05, "mamba2-2.7b": 0.15,
               "zamba2-1.2b": 0.1, "whisper-medium": 0.02,
               "llama-3.2-vision-11b": 0.006, "mixtral-8x22b": 0.4,
               "qwen3-moe-235b-a22b": 0.11}
# One of each other kind at its full published config.
LM_FULL = ("mamba2-2.7b", "zamba2-1.2b", "whisper-medium",
           "llama-3.2-vision-11b")
# The MoE configs at their published widths, their depth cut to what one
# card holds (281 GB and 470 GB of bf16 weights at full depth).
LM_MOE_LAYERS = {"mixtral-8x22b": 4, "qwen3-moe-235b-a22b": 4}
LM_BUDGET_S = 90


def open_gates(torch, model) -> None:
    """The VLM's gated cross blocks start closed (tanh 0 = 0); open them
    so that the cross path shows in the check."""
    if model.cfg.kind == "vlm":
        with torch.no_grad():
            for cp in model["cross_layers"]:
                cp.gate_attn.fill_(0.5)
                cp.gate_mlp.fill_(-0.5)


def forced_logits(torch, model, tokens, memory, forced):
    """``prefill`` over the prompt, then a ``decode_step`` on each token of
    ``forced`` (B, n) in turn: the logits (B, n + 1, V) of every step, so
    that two devices are held to one token sequence."""
    from repro_torch.models.transformer import decode_step, prefill

    with torch.inference_mode():
        logits, cache = prefill(model, tokens, memory=memory,
                                max_seq=tokens.shape[1] + forced.shape[1])
        steps = [logits]
        for j in range(forced.shape[1]):
            logits, cache = decode_step(model, cache, forced[:, j:j + 1])
            steps.append(logits)
    return torch.stack(steps, dim=1)


def free_card(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def lm_consistency(torch, model, res, tol: float | None) -> dict:
    """One ``forward_hidden`` over the prompt and the generated tokens
    against the prefill's and every decode step's logits; the greedy
    tokens against its argmax where its top-2 gap exceeds the tolerance.
    ``tol``: the bf16 ratio bound; None holds f32 to the reference's
    rtol / atol."""
    from repro_torch.models.transformer import forward_hidden, logits_of

    P = res["tokens"].shape[1]
    with torch.inference_mode():
        seq = torch.cat([res["tokens"], res["generated"]], dim=1)
        h, _ = forward_hidden(model, seq, res["memory"])
        full = logits_of(model, h[:, P - 1:])          # (B, gen + 1, V)
        steps = res["logits"]
        diff = (steps - full).abs()
        scale = float(full.abs().max())
        rel = float(diff.max()) / scale
        f32 = tol is None
        tol_abs = LM_F32_TOL * (1 + scale) if f32 else tol * scale
        within = bool((diff <= LM_F32_TOL + LM_F32_TOL * full.abs()).all()
                      if f32 else rel <= tol)
        top2 = full[:, :-1].topk(2, dim=-1).values
        decisive = (top2[..., 0] - top2[..., 1]) > tol_abs
        wrong = (full[:, :-1].argmax(-1) != res["generated"]) & decisive
        finite = bool(torch.isfinite(steps).all()
                      and torch.isfinite(full).all())
    return {"max_abs_diff": float(diff.max()), "max_abs_logit": scale,
            "rel": rel, "tol": tol, "within": within, "finite": finite,
            "greedy_checked": int(decisive.sum()),
            "greedy_wrong": int(wrong.sum()), "positions": int(diff.shape[1])}


def lm_check(out: dict, label: str) -> None:
    check(out["finite"], f"{label}: a logit is not finite")
    check(out["within"], f"{label}: the steps' logits differ from the full "
          f"forward's beyond the tolerance: {out}")
    check(out["greedy_wrong"] == 0, f"{label}: greedy tokens differ from the "
          f"full forward's argmax at decisive positions: {out}")


def decode_bound(torch, model, batch: int, max_seq: int) -> dict:
    """The least time a decode step could take on the card: the bytes it
    must move (every weight but the embedding table read once, B table
    rows, the whole cache read once) over the HBM rate; its operations
    (2 per weight and token) over the bf16 tensor-core peak."""
    from repro_torch.models.transformer import init_cache

    cfg = model.cfg
    table = model["embed"]["table"]
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    weights -= table.numel() * table.element_size()
    def nbytes_of(tree) -> int:
        if isinstance(tree, torch.Tensor):
            return tree.numel() * tree.element_size()
        if isinstance(tree, (tuple, list)):
            return sum(nbytes_of(t) for t in tree)
        if isinstance(tree, dict):
            return sum(nbytes_of(t) for t in tree.values())
        return 0                                   # the position, an int

    cache_bytes = nbytes_of(init_cache(cfg, batch, max_seq, "meta"))
    nbytes = weights + batch * cfg.d_model * table.element_size() \
        + cache_bytes
    ops = 2 * (model_numel(model) - table.numel()) * batch
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "weight_bytes": weights,
            "cache_bytes": cache_bytes, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def model_numel(model) -> int:
    return sum(p.numel() for p in model.parameters())


def lm_decode_profile(torch, model, tokens, steps: int = 4) -> dict:
    """Where a decode step's time goes: ``torch.profiler`` around
    ``steps`` warm decode steps (the prefill outside it), parsed as phase
    15 parses its traces — the window, the card's busy time, the idle
    share, device events per step and the top device operations."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import decode_step, prefill

    with torch.inference_mode():
        logits, cache = prefill(model, tokens,
                                max_seq=tokens.shape[1] + steps + 1)
        nxt = logits.argmax(-1)[:, None]
        logits, cache = decode_step(model, cache, nxt)
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    nxt = logits.argmax(-1)[:, None]
                    logits, cache = decode_step(model, cache, nxt)
                torch.cuda.synchronize()
            path = pathlib.Path(d) / "decode.json"
            prof.export_chrome_trace(str(path))
            out = profile_dispatches([path])[0]
    out["steps"] = steps
    out["device_events_per_step"] = out["device_events"] / steps
    return out


def lm_granite(torch, launcher, dev, smi) -> dict:
    """(a) granite-3-2b through the launcher in bf16, then the warm
    readings."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = launcher.main(LM_ARGV)
    t_launch = time.perf_counter() - t0
    model = res["model"]
    n = model_numel(model)
    check(n == LM_PARAMS == res["cfg"].param_count(),
          f"granite-3-2b has {n} parameters, not {LM_PARAMS}")
    check(res["logits"].device.type == "cuda", "the LM did not run on the card")
    tol = LM_BF16_TOL[LM_ARCH]
    cons = lm_consistency(torch, model, res, tol)
    lm_check(cons, "granite-3-2b bf16")
    warm = launcher.generate(model, res["tokens"], None, 16)
    same = bool(torch.equal(warm["generated"], res["generated"]))
    B = res["tokens"].shape[0]
    bound = decode_bound(torch, model, B, 48)
    peak = torch.cuda.max_memory_allocated()
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    prof = lm_decode_profile(torch, model, res["tokens"])
    out = {"launcher_argv": LM_ARGV, "params": n,
           "weight_gb": n * 2 / 1e9, "launcher_s": t_launch,
           "cold_prefill_ms": res["prefill_s"] * 1e3,
           "cold_decode_ms": res["decode_s"] * 1e3,
           "prefill_ms": warm["prefill_s"] * 1e3,
           "decode_ms": warm["decode_s"] * 1e3,
           "tok_s": B / warm["decode_s"], "warm_tokens_equal": same,
           "max_memory_allocated": peak, "bound": bound,
           "bound_share": bound["bound_ms"] / (warm["decode_s"] * 1e3),
           "bf16": cons, "reduced_precision_reduction": flag,
           "decode_profile": prof}
    log(f"[lm] granite-3-2b full width ({n:,} params, "
        f"{out['weight_gb']:.2f} GB bf16) through the launcher "
        f"({' '.join(LM_ARGV)}) in {t_launch:.1f}s on {smi}")
    log(f"[lm] granite-3-2b bf16: prefill {out['prefill_ms']:.2f} ms, "
        f"decode {out['decode_ms']:.3f} ms/token, {out['tok_s']:.1f} tok/s "
        f"aggregate (warm; the launcher's cold run: "
        f"{out['cold_prefill_ms']:.1f} and {out['cold_decode_ms']:.2f} ms); "
        f"max_memory_allocated {peak / 1e9:.2f} GB")
    log(f"[lm] granite-3-2b decode bound {bound['bound_ms']:.3f} ms "
        f"({bound['bound_by']}: {bound['bytes'] / 1e9:.3f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; operations "
        f"{bound['ops_ms']:.4f} ms): {100 * out['bound_share']:.1f}% of it "
        f"reached")
    log(f"[lm] granite-3-2b bf16 vs one full forward over {cons['positions']}"
        f" positions: max |Δ| {cons['max_abs_diff']:.4g}, max |logit| "
        f"{cons['max_abs_logit']:.4g}, ratio {cons['rel']:.4g} (tolerance "
        f"{tol}); greedy tokens equal at {cons['greedy_checked']} "
        f"decisive positions; reduced-precision reductions {flag} "
        f"(PyTorch's default)")
    if prof["device_events"]:
        log(f"[lm] granite-3-2b decode profile ({prof['steps']} warm steps): "
            f"window {prof['window_ms']:.2f} ms, card busy "
            f"{prof['busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f};"
            f" {prof['device_events_per_step']:.0f} device operations a "
            f"step; top: " + ", ".join(f"{short_name(k)} {v:.2f} ms"
                                       for k, v in prof["top"][:4]))
    else:
        log("[lm] granite-3-2b decode profile: CUPTI gave no device events "
            "(idle share not measured)")
    del res, model, warm
    free_card(torch)
    return out


def lm_run(torch, launcher, arch, cfg, dev, batch: int, prompt: int,
           gen: int, seed: int = 0) -> tuple:
    """Init on the card, open the VLM's gates, generate, check."""
    from repro_torch.models.transformer import init_params

    t0 = time.perf_counter()
    model = init_params(cfg, dev, seed=seed)
    open_gates(torch, model)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tokens, memory = launcher.lm_inputs(cfg, batch, prompt, dev, seed)
    res = launcher.generate(model, tokens, memory, gen)
    res.update(tokens=tokens, memory=memory)
    cons = lm_consistency(torch, model, res, None if cfg.dtype == "float32"
                          else LM_BF16_TOL[arch])
    out = {"params": model_numel(model), "init_s": t_init,
           "prefill_ms": res["prefill_s"] * 1e3,
           "decode_ms": res["decode_s"] * 1e3,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "check": cons}
    return model, out


def lm_phase(torch, report) -> None:
    """Phase 18; launches none of the port's kernels."""
    from repro_torch import configs
    from repro_torch.kernels import fused_query as fq
    from repro_torch.kernels import level_ops as lo
    from repro_torch.launch import serve as launcher
    from repro_torch.models.transformer import init_params

    smi = report["env"]["nvidia_smi"]
    t_phase = time.perf_counter()
    before = [k.launches for k in fq.KERNELS + lo.KERNELS]
    dev = torch.device("cuda")
    free_card(torch)
    # The LM's steps are host-bound: threads left by earlier phases share
    # the host with them.
    threads = sorted(t.name for t in threading.enumerate())
    log(f"[lm] {len(threads)} threads alive at the phase's start: "
        f"{threads[:12]}")
    lm = {"card": smi, "threads_at_start": threads,
          "granite": lm_granite(torch, launcher, dev, smi)}

    # (b) granite-3-2b in f32
    torch.cuda.reset_peak_memory_stats()
    cfg32 = dataclasses.replace(configs.get(LM_ARCH), dtype="float32")
    model, out = lm_run(torch, launcher, LM_ARCH, cfg32, dev, 4, 32, 16)
    lm_check(out["check"], "granite-3-2b f32")
    lm["granite_f32"] = out
    c = out["check"]
    log(f"[lm] granite-3-2b f32 ({out['params'] * 4 / 1e9:.2f} GB): prefill "
        f"{out['prefill_ms']:.2f} ms, decode {out['decode_ms']:.3f} ms/token;"
        f" vs the full forward max |Δ| {c['max_abs_diff']:.3g} (max |logit| "
        f"{c['max_abs_logit']:.3g}; within {LM_F32_TOL} rtol/atol); greedy "
        f"equal at {c['greedy_checked']} decisive positions; "
        f"max_memory_allocated {out['max_memory_allocated'] / 1e9:.2f} GB")
    del model
    free_card(torch)

    # (c) the other kinds at full width; the MoE configs at their
    # published widths with their depth cut
    lm["kinds"] = {}
    runs = [(a, configs.get(a)) for a in LM_FULL] + [
        (a, dataclasses.replace(configs.get(a), n_layers=n, dtype=dt))
        for a, n in LM_MOE_LAYERS.items() for dt in ("float32", "bfloat16")]
    for arch, cfg in runs:
        torch.cuda.reset_peak_memory_stats()
        model, out = lm_run(torch, launcher, arch, cfg, dev, 2, 32, 4)
        check(out["params"] == cfg.param_count(),
              f"{arch}: {out['params']} parameters, the config counts "
              f"{cfg.param_count()}")
        depth = configs.get(arch).n_layers
        label = f"{arch} full width" + (
            f", {cfg.n_layers} of {depth} layers" if cfg.n_layers < depth
            else "") + f" {cfg.dtype}"
        lm_check(out["check"], label)
        lm["kinds"][label] = out
        c = out["check"]
        log(f"[lm] {label} ({cfg.kind}, {out['params']:,} params): init "
            f"{out['init_s']:.1f}s, prefill {out['prefill_ms']:.1f} ms, "
            f"decode {out['decode_ms']:.2f} ms/token, max_memory_allocated"
            f" {out['max_memory_allocated'] / 1e9:.2f} GB; vs the full "
            f"forward max |Δ| {c['max_abs_diff']:.3g} ratio {c['rel']:.3g} "
            f"(tolerance {c['tol'] or LM_F32_TOL}); greedy equal at "
            f"{c['greedy_checked']} "
            f"decisive positions")
        del model
        free_card(torch)
    lm["depth_cut"] = {
        a: f"{n} of {configs.get(a).n_layers} layers; at full depth "
           f"{configs.get(a).param_count():,} params, "
           f"{configs.get(a).param_count() * 2 / 1e9:.0f} GB in bf16: no one "
           f"card holds it"
        for a, n in LM_MOE_LAYERS.items()}
    log(f"[lm] cut: {lm['depth_cut']}; their full depth waits for the "
        f"multi-card path")

    # (d) every smoke config in f32 and in bf16, the card against the CPU
    # on the same weights and tokens.  f32: the reference's 2e-3.  bf16:
    # twice the CPU's own gap between its steps and its full forward (the
    # gap tests/test_torch_lm.py holds the port to the reference by): the
    # card and the CPU may each stand that far from the function.
    lm["cpu_vs_card"] = {}
    for arch in configs.list_archs():
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(configs.smoke(arch), dtype=dtype)
            model = init_params(cfg, "cpu", seed=0)
            open_gates(torch, model)
            toks, mem = launcher.lm_inputs(cfg, 2, 16, "cpu", seed=1)
            want = launcher.generate(model, toks, mem, 4)
            model.to(dev)
            g = forced_logits(torch, model, toks.to(dev),
                              None if mem is None else mem.to(dev),
                              want["generated"].to(dev)).cpu()
            w = want["logits"]
            err = float((g - w).abs().max())
            if dtype == "float32":
                tol = LM_F32_TOL
                ok = bool(((g - w).abs() <= tol + tol * w.abs()).all())
            else:
                model.to("cpu")
                tol = 2 * lm_consistency(torch, model, dict(
                    want, tokens=toks, memory=mem), 1.0)["rel"]
                ok = err / float(w.abs().max()) <= tol
            lm["cpu_vs_card"][f"{arch} {dtype}"] = {
                "max_abs_diff": err, "rel": err / float(w.abs().max()),
                "tol": tol}
            check(ok and bool(torch.isfinite(g).all()),
                  f"{arch} smoke {dtype}: the card's logits differ from the "
                  f"CPU's by {err} (tolerance {tol})")
            del model
    for dtype in ("float32", "bfloat16"):
        runs = {k: v for k, v in lm["cpu_vs_card"].items()
                if k.endswith(dtype)}
        worst = max(runs, key=lambda k: runs[k]["rel"])
        log(f"[lm] the ten smoke configs in {dtype}, the card against the "
            f"CPU (prefill + 4 decode steps, the same weights and tokens): "
            f"largest |Δ| {runs[worst]['max_abs_diff']:.3g}, ratio "
            f"{runs[worst]['rel']:.3g} ({worst}, tolerance "
            f"{runs[worst]['tol']:.3g}); " + ", ".join(
                f"{k.split()[0]} {v['rel']:.3g}/{v['tol']:.3g}"
                for k, v in runs.items()))
    after = [k.launches for k in fq.KERNELS + lo.KERNELS]
    check(after == before, f"the LM phase launched a kernel: {before} -> "
          f"{after}")
    lm["seconds"] = time.perf_counter() - t_phase
    report["lm"] = lm
    log(f"[lm] phase 18 in {lm['seconds']:.1f}s; no kernel of the port "
        f"launched")
    check(lm["seconds"] <= LM_BUDGET_S,
          f"phase 18 took {lm['seconds']:.1f}s, over its {LM_BUDGET_S} s")
    free_card(torch)


# ---- Phase 19: LM training and checkpoints.
TRAIN_ARGV = ["--arch", LM_ARCH, "--steps", "6", "--global-batch", "8",
              "--seq-len", "128", "--log-every", "1"]   # no --smoke
# The leaves whose update on the card is held to the optimizer on the
# CPU: the embedding table, a layer's weight and a scale without decay.
TRAIN_LEAVES = ("embed.table", "layers.0.attn.wq", "final_norm.scale")
# Step 0's loss against a no_grad train_loss on the same weights and
# batch: the same bf16 forward either way (the checkpointed blocks
# recompute it only in the backward pass).
TRAIN_LOSS0_RTOL = 1e-3
# (b), the smoke configs in f32, card against CPU: the loss, the grad
# norm, each gradient leaf (max |Δg| / max |g|, the CPU tests' bound
# against JAX), and the card's update against the CPU's on the card's
# own gradients and moments: each updated parameter and moment (max |Δ| /
# max |x| per leaf, see ``train_step_card_vs_cpu``).
TRAIN_F32 = {"loss": 1e-5, "grad_norm": 1e-4, "grads": 1e-4,
             "params": 1e-5, "moments": 1e-5}
TRAIN_BUDGET_S = 90
# The model-FLOPs count's N: granite-3-2b's parameters less its 49155 ×
# 2048 embedding table, which is gathered, not multiplied (``lm_head`` is
# a separate matrix and counts).
TRAIN_MATMUL_PARAMS = LM_PARAMS - 49155 * 2048


def bf16_ulps(torch, a, b) -> float:
    """The largest |Δ| in bf16 units in the last place of the larger
    value."""
    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs()).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return float(((a - b).abs() / ulp).max())


def rel_gap(torch, got, want) -> float:
    scale = float(want.float().abs().max())
    gap = float((got.float() - want.float()).abs().max())
    return gap / scale if scale > 0 else gap


def leaf_update_check(torch, opt, res, leaves) -> dict:
    """One more step on the model and state a launcher run returned: the
    card's update of each of ``leaves`` against ``apply_updates`` on the
    CPU on copies of that leaf's parameter, (clipped) gradient and
    moments."""
    from repro_torch.models.transformer import decayed_names
    from repro_torch.training.step import loss_and_grads, trainable

    model, state, cfg = res["model"], res["opt_state"], res["opt_cfg"]
    params = trainable(model)
    decay = decayed_names(params)
    batch = res["pipeline"].batch_at(len(res["losses"]) + res["start"])
    _, grads = loss_and_grads(model, params, batch)
    grads, _ = opt.clip_by_global_norm(grads, 1.0)
    cpu = {"step": state["step"].cpu(), "moments": {}}
    cpu_p, cpu_g = {}, {}
    for k in leaves:
        cpu_p[k] = params[k].detach().to("cpu", copy=True)
        cpu_g[k] = grads[k].to("cpu", copy=True)
        cpu["moments"][k] = {kk: t.to("cpu", copy=True)
                             for kk, t in state["moments"][k].items()}
    opt.apply_updates(cfg, params, grads, state, decay)
    opt.apply_updates(cfg, cpu_p, cpu_g, cpu, decay)
    out = {}
    for k in leaves:
        card = state["moments"][k]
        rec = {"param_bf16_ulps": bf16_ulps(torch, params[k].detach().cpu(),
                                            cpu_p[k]),
               "decays": k in decay}
        for kk, t in card.items():
            want = cpu["moments"][k][kk]
            if t.dtype == torch.int8:
                d = (t.cpu().int() - want.int()).abs()
                rec[kk] = {"max_code_diff": int(d.max()),
                           "codes_differing": int((d > 0).sum()),
                           "codes": d.numel()}
            else:
                rec[kk] = rel_gap(torch, t.cpu(), want)
        out[k] = rec
        check(rec["param_bf16_ulps"] <= 1,
              f"{k}: the card's update is {rec['param_bf16_ulps']} bf16 "
              f"ulps from the CPU's")
        for kk, v in rec.items():
            if isinstance(v, dict):
                check(v["max_code_diff"] <= 1, f"{k}/{kk}: {v}")
            elif kk not in ("param_bf16_ulps", "decays"):
                check(v <= 1e-6, f"{k}/{kk}: the card's moment is {v} "
                      f"(relative) from the CPU's")
    del grads, params
    return out


def train_step_split(torch, opt, res) -> dict:
    """One more step split into its forward, backward and optimizer on
    CUDA events, and one under ``torch.profiler``: device operations,
    the card's busy ms and idle share."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models.transformer import decayed_names, train_loss
    from repro_torch.training.step import trainable

    model, state, cfg = res["model"], res["opt_state"], res["opt_cfg"]
    params = trainable(model)
    decay = decayed_names(params)
    batch = res["pipeline"].batch_at(0)

    def step(ev=None):
        with record_function("forward"):
            loss = train_loss(model, batch)
        if ev:
            ev[1].record()
        with record_function("backward"):
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()), allow_unused=True,
                materialize_grads=True)))
        if ev:
            ev[2].record()
        with record_function("optimizer"):
            grads, _ = opt.clip_by_global_norm(grads, 1.0)
            opt.apply_updates(cfg, params, grads, state, decay)

    def timed() -> dict:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        step(ev)
        ev[3].record()
        torch.cuda.synchronize()
        return {"forward_ms": ev[0].elapsed_time(ev[1]),
                "backward_ms": ev[1].elapsed_time(ev[2]),
                "optimizer_ms": ev[2].elapsed_time(ev[3])}

    out = timed()
    # The same step with the blocks not checkpointed: what "selective"
    # costs (its recompute, and its policy's call on every operation).
    remat = model.cfg
    model.cfg = dataclasses.replace(remat, remat="none")
    out["remat_none"] = timed()
    model.cfg = remat
    out["remat"] = remat.remat
    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        path = pathlib.Path(d) / "train_step.json"
        prof.export_chrome_trace(str(path))
        out["profile"] = profile_dispatches([path])[0]
    return out


def train_granite(torch, train, opt, int8: bool, smi: str) -> dict:
    """(a) granite-3-2b at full width through the launcher, 6 steps."""
    import statistics

    argv = TRAIN_ARGV + (["--int8-opt"] if int8 else [])
    label = "int8 moments" if int8 else "f32 moments"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.run(train.parse_args(argv))
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = model_numel(res["model"])
    check(n == LM_PARAMS, f"granite-3-2b has {n} parameters")
    check(next(res["model"].parameters()).device.type == "cuda",
          "the training did not run on the card")
    losses, norms = res["losses"], res["grad_norms"]
    check(len(losses) == 6 and all(np.isfinite(losses + norms)),
          f"{label}: a loss or grad norm is not finite: {losses} {norms}")
    step_s = statistics.median(res["step_s"][1:6])
    tokens = 8 * 128
    flops = 6 * TRAIN_MATMUL_PARAMS * tokens
    out = {"argv": argv, "run_s": t_run, "losses": losses,
           "grad_norms": norms, "step_s": res["step_s"],
           "step_ms": step_s * 1e3, "tokens_per_step": tokens,
           "tok_s": tokens / step_s, "model_flops": flops,
           "flops_share": flops / step_s / BF16_FLOPS_PER_S,
           "max_memory_allocated": peak}
    out["leaf_update"] = leaf_update_check(torch, opt, res, TRAIN_LEAVES)
    if not int8:
        out["split"] = train_step_split(torch, opt, res)
    log(f"[train] granite-3-2b full width, {label} ({n:,} params, bf16): "
        f"6 steps through the launcher in {t_run:.1f}s on {smi}; losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.3f}" for x in norms))
    log(f"[train] granite-3-2b {label}: step {out['step_ms']:.1f} ms (median "
        f"of steps 1-5), {out['tok_s']:.0f} tokens/s, model FLOPs "
        f"6·{TRAIN_MATMUL_PARAMS:,}·{tokens} a step (N without the "
        f"embedding table; attention's S² left out) = "
        f"{100 * out['flops_share']:.2f}% of the "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s dense bf16 peak; "
        f"max_memory_allocated {peak / 1e9:.2f} GB")
    log(f"[train] granite-3-2b {label}: a step's update on the card against "
        f"apply_updates on the CPU on copies of "
        + "; ".join(f"{k}: {v}" for k, v in out["leaf_update"].items()))
    if "split" in out:
        s = out["split"]
        p = s["profile"]
        n = s["remat_none"]
        log(f"[train] granite-3-2b {label} step split (CUDA events, remat "
            f"{s['remat']}): forward {s['forward_ms']:.1f} ms, backward "
            f"{s['backward_ms']:.1f} ms, optimizer {s['optimizer_ms']:.1f} "
            f"ms; with remat none {n['forward_ms']:.1f}, "
            f"{n['backward_ms']:.1f} and {n['optimizer_ms']:.1f} ms")
        if p["device_events"]:
            log(f"[train] granite-3-2b step profile: window "
                f"{p['window_ms']:.1f} ms, card busy {p['busy_ms']:.1f} ms, "
                f"idle share {p['idle_share']:.3f}; {p['device_events']} "
                f"device operations; top: " + ", ".join(
                    f"{short_name(k)} {v:.2f} ms" for k, v in p["top"][:4]))
        else:
            log("[train] granite-3-2b step profile: CUPTI gave no device "
                "events (idle share not measured)")
    res.clear()
    free_card(torch)
    return out


def train_step_card_vs_cpu(torch, arch: str, dev) -> dict:
    """(b) One train step of ``arch``'s smoke config in f32 on the CPU and
    on the card, on the same weights and tokens: the loss, the grad norm
    and every gradient leaf (max |Δg| / max |g|), as gaps relative to the
    CPU's.  Then a second step's update on the card against
    ``apply_updates`` on the CPU run on copies of the card's own
    parameters, clipped gradients and (non-zero) moments: every element
    of every updated parameter and moment (max |Δ| / max |x| per leaf).
    The two devices' gradients differ by their summation order, and Adam
    maps a small gradient to about its sign, so the optimizer is held on
    the same gradients."""
    from repro_torch import configs
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch.serve import lm_inputs
    from repro_torch.models.transformer import decayed_names, init_params
    from repro_torch.training import optimizer as opt
    from repro_torch.training.step import (loss_and_grads, make_train_step,
                                           trainable)

    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    pipe = TokenPipeline(TokenPipelineConfig(cfg.vocab_size, 4, 32), "cpu")
    batch = pipe.batch_at(0)
    memory = lm_inputs(cfg, 4, 32, "cpu", seed=1)[1]
    if memory is not None:
        batch["memory"] = memory
    ocfg = opt.AdamWConfig(warmup_steps=1, decay_steps=10)
    step = make_train_step(ocfg)
    out = []
    for where in ("cpu", dev):
        model = init_params(cfg, "cpu", seed=0)
        open_gates(torch, model)
        model.to(where)
        params = trainable(model)
        b = {k: v.to(where) for k, v in batch.items()}
        _, grads = loss_and_grads(model, params, b)
        state = opt.init_state(ocfg, params)
        _, _, m = step(model, state, b)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: g.cpu() for k, g in grads.items()}))
    (l0, n0, g0), (l1, n1, g1) = out
    gaps = {"loss": abs(l1 - l0) / abs(l0),
            "grad_norm": abs(n1 - n0) / abs(n0),
            "grads": max(rel_gap(torch, g1[k], g0[k]) for k in g0)}

    # The card's second step, and the CPU's optimizer on its inputs.
    b = {k: v.to(dev) for k, v in pipe.batch_at(1).items()}
    if memory is not None:
        b["memory"] = memory.to(dev)
    _, grads = loss_and_grads(model, params, b)
    grads, _ = opt.clip_by_global_norm(grads, 1.0)
    decay = decayed_names(params)
    cpu_p = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
    cpu_g = {k: g.to("cpu", copy=True) for k, g in grads.items()}
    cpu_s = {"step": state["step"].cpu(),
             "moments": {k: {kk: t.to("cpu", copy=True) for kk, t in
                             st.items()} for k, st in
                         state["moments"].items()}}
    opt.apply_updates(ocfg, params, grads, state, decay)
    opt.apply_updates(ocfg, cpu_p, cpu_g, cpu_s, decay)
    gaps["params"] = max(rel_gap(torch, params[k].detach().cpu(), cpu_p[k])
                         for k in cpu_p)
    gaps["moments"] = max(rel_gap(torch, t.cpu(), cpu_s["moments"][k][kk])
                          for k, st in state["moments"].items()
                          for kk, t in st.items())
    return gaps


def train_gaps_within(gaps: dict) -> bool:
    """(b)'s tolerances, ``TRAIN_F32``."""
    return all(gaps[k] <= tol for k, tol in TRAIN_F32.items())


def grad_accum_on_card(torch, dev) -> dict:
    """grad_accum 4 against 1 on the card (lr 0), granite's smoke config
    in f32, as ``tests/test_training.py`` holds the reference."""
    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    from repro_torch.training import optimizer as opt
    from repro_torch.training.step import make_train_step, trainable

    cfg = dataclasses.replace(configs.smoke(LM_ARCH), dtype="float32",
                              remat="none")
    ocfg = opt.AdamWConfig(lr=0.0, weight_decay=0.0)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (8, 32), device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))}
    m = {}
    for accum in (1, 4):
        model = init_params(cfg, dev, seed=0)
        state = opt.init_state(ocfg, trainable(model))
        _, _, m[accum] = make_train_step(ocfg, grad_accum=accum)(
            model, state, batch)
    return {"loss": abs(float(m[4]["loss"]) - float(m[1]["loss"]))
            / abs(float(m[1]["loss"])),
            "grad_norm": abs(float(m[4]["grad_norm"])
                             - float(m[1]["grad_norm"]))
            / abs(float(m[1]["grad_norm"]))}


# (c) Kill and resume on the card: three launcher runs in one process
# with deterministic algorithms on (cuBLAS needs its workspace config set
# before it starts); warn_only names an op with no deterministic form.
RESUME_CODE = """
import json, sys, warnings
sys.path.insert(0, "src")
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
from repro_torch.launch.train import main
base = ["--arch", "granite-3-2b", "--smoke", "--global-batch", "4",
        "--seq-len", "32", "--ckpt-every", "3", "--log-every", "100",
        "--warmup-steps", "2", "--decay-steps", "6"]
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    a = main(base + ["--steps", "6", "--ckpt-dir", sys.argv[1] + "/full"])
    main(base + ["--steps", "3", "--ckpt-dir", sys.argv[1] + "/split"])
    b = main(base + ["--steps", "6", "--ckpt-dir", sys.argv[1] + "/split",
                     "--resume"])
nondet = sorted({str(w.message)[:300] for w in caught
                 if "deterministic" in str(w.message)})
print("RESUME", json.dumps({"a": a, "b": b, "nondet": nondet,
                            "device": torch.cuda.get_device_name(0)}))
"""
RESUME_NONDET_RTOL = 1e-5   # only if an op has no deterministic form


def meta_like(torch, directory: pathlib.Path, step: int) -> dict:
    """A tree of ``meta`` tensors shaped as a checkpoint's manifest."""
    man = json.loads((directory / f"step_{step:08d}" / "manifest.json")
                     .read_text())
    tree: dict = {}
    for path, meta in man["leaves"].items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.empty(meta["shape"], device="meta")
    return tree


def train_resume_on_card(torch) -> dict:
    import os
    import tempfile

    from repro_torch.checkpoint import restore_pytree

    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
                   PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", RESUME_CODE, d],
                           capture_output=True, text=True, cwd=ROOT,
                           env=env, timeout=300)
        check(r.returncode == 0, f"the resume runs failed: {r.stderr[-3000:]}")
        got = json.loads(r.stdout.split("RESUME", 1)[1])
        out = {"seconds": time.perf_counter() - t0, **got}
        check("[train] resumed from step 3" in r.stdout,
              "the resumed run did not start from step 3")
        a, b = got["a"], got["b"]
        out["bitwise"] = a[3:] == b
        if got["nondet"]:
            gap = max(abs(x - y) / abs(x) for x, y in zip(a[3:], b))
            out["rel_gap"] = gap
            check(gap <= RESUME_NONDET_RTOL, f"resumed losses {b} against "
                  f"{a[3:]} (ops without a deterministic form: "
                  f"{got['nondet']})")
        else:
            check(out["bitwise"], f"resumed losses {b} differ from the "
                  f"uninterrupted run's {a[3:]}")
        # The card's checkpoints restore on the CPU with sha256 verified.
        like = meta_like(torch, pathlib.Path(d) / "split", 6)
        full = restore_pytree(like, pathlib.Path(d) / "full", 6,
                              device="cpu", verify=True)
        split = restore_pytree(like, pathlib.Path(d) / "split", 6,
                               device="cpu", verify=True)
        flat_f, flat_s = flat_tree(full), flat_tree(split)
        out["leaves"] = len(flat_f)
        out["checkpoints_equal"] = all(torch.equal(flat_f[k], flat_s[k])
                                       for k in flat_f)
        check(out["checkpoints_equal"] or got["nondet"],
              "the resumed run's last checkpoint differs from the "
              "uninterrupted run's")
    return out


def flat_tree(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def train_phase(torch, report) -> None:
    """Phase 19; launches none of the port's kernels."""
    from repro_torch import configs
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import fused_query as fq
    from repro_torch.kernels import level_ops as lo
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_params, train_loss
    from repro_torch.training import optimizer as opt

    smi = report["env"]["nvidia_smi"]
    t_phase = time.perf_counter()
    before = [k.launches for k in fq.KERNELS + lo.KERNELS]
    dev = torch.device("cuda")
    free_card(torch)
    out = {"card": smi, "bf16_peak_flops": BF16_FLOPS_PER_S,
           "granite": {"f32_moments": train_granite(torch, train, opt, False,
                                                    smi),
                       "int8_moments": train_granite(torch, train, opt, True,
                                                     smi)}}
    g32, g8 = out["granite"]["f32_moments"], out["granite"]["int8_moments"]
    # Step 0's loss: the same weights (seed 0) and batch under no_grad.
    cfg = configs.get(LM_ARCH)
    model = init_params(cfg, dev, seed=0)
    batch = TokenPipeline(TokenPipelineConfig(cfg.vocab_size, 8, 128),
                          dev).batch_at(0)
    with torch.no_grad():
        loss0 = float(train_loss(model, batch))
    del model
    free_card(torch)
    gap0 = abs(g32["losses"][0] - loss0) / loss0
    out["loss0"] = {"no_grad": loss0, "f32_run": g32["losses"][0],
                    "int8_run": g8["losses"][0], "rel_gap": gap0}
    check(gap0 <= TRAIN_LOSS0_RTOL, f"step 0's loss {g32['losses'][0]} "
          f"against a no_grad train_loss {loss0}")
    check(g8["losses"][0] == g32["losses"][0],
          "step 0's loss differs between the f32 and int8 runs")
    log(f"[train] granite-3-2b step 0 loss {g32['losses'][0]:.6f} against a "
        f"no_grad train_loss {loss0:.6f} on the same weights and batch: "
        f"{gap0:.3g} relative (tolerance {TRAIN_LOSS0_RTOL}); the int8 run's "
        f"step 0 equal")

    # (b) the ten smoke configs in f32, card against CPU; grad_accum
    out["cpu_vs_card"] = {a: train_step_card_vs_cpu(torch, a, dev)
                          for a in configs.list_archs()}
    cvc = out["cpu_vs_card"]
    for key, tol in TRAIN_F32.items():
        worst = max(cvc, key=lambda a: cvc[a][key])
        log(f"[train] the ten smoke configs in f32, one train step, card "
            f"against CPU: {key} largest gap {cvc[worst][key]:.3g} ({worst};"
            f" tolerance {tol}); " + ", ".join(
                f"{a} {v[key]:.2g}" for a, v in cvc.items()))
    bad = {a: v for a, v in cvc.items() if not train_gaps_within(v)}
    check(not bad, f"the card's train step differs from the CPU's: {bad}")
    acc = grad_accum_on_card(torch, dev)
    out["grad_accum"] = acc
    log(f"[train] grad_accum 4 against 1 on the card (f32, lr 0): loss "
        f"{acc['loss']:.3g}, grad norm {acc['grad_norm']:.3g} relative "
        f"(tolerances 1e-5 and 1e-4)")
    check(acc["loss"] <= 1e-5 and acc["grad_norm"] <= 1e-4,
          f"grad_accum 4 differs from 1 on the card: {acc}")

    # (c) kill and resume through the launcher on the card
    res = train_resume_on_card(torch)
    out["resume"] = res
    log(f"[train] kill and resume on the card ({res['device']}): 6 steps "
        f"against 3 + resume 3 in {res['seconds']:.1f}s; losses "
        f"{'bit for bit equal' if res['bitwise'] else 'not bitwise'} "
        f"({res['b']}); deterministic algorithms on, ops without a "
        f"deterministic form: {res['nondet'] or 'none'}; the card's step-6 "
        f"checkpoints ({res['leaves']} leaves) restore on the CPU with "
        f"sha256 verified, equal: {res['checkpoints_equal']}")

    after = [k.launches for k in fq.KERNELS + lo.KERNELS]
    check(after == before, f"the training phase launched a kernel: "
          f"{before} -> {after}")
    out["seconds"] = time.perf_counter() - t_phase
    report["train"] = out
    log(f"[train] phase 19 in {out['seconds']:.1f}s; no kernel of the port "
        f"launched")
    check(out["seconds"] <= TRAIN_BUDGET_S,
          f"phase 19 took {out['seconds']:.1f}s, over its {TRAIN_BUDGET_S} s")
    free_card(torch)


# ---- Phase 20: the training mesh on the one card, the analysis tools.
MESH_DEVICES = "2,2"
MESH_ARGV = ["--arch", LM_ARCH, "--steps", "3", "--global-batch", "8",
             "--seq-len", "128", "--log-every", "1",
             "--mesh-devices", MESH_DEVICES]      # no --smoke
# Step 0 over the (2, 2) mesh against phase 19's single-device step on
# the same weights (seed 0) and batch.  Both data rows sit on the one
# card and run as one pass: the same bf16 forward and backward; the norm
# sums its squares by blocks (a psum) where one device sums by leaves.
MESH_LOSS0_RTOL = 1e-5
MESH_GNORM0_RTOL = 1e-4
# The mesh step at smoke size in f32, card against CPU (as TRAIN_F32).
MESH_F32 = {"loss": 1e-5, "grad_norm": 1e-4, "params": 1e-5}
MESH_STEP_CASES = (("granite-3-2b", False), ("granite-3-2b", True),
                   ("qwen3-moe-235b-a22b", False))
MOE_MESH_MODES = {"qwen3-moe-235b-a22b": "ep", "mixtral-8x22b": "tp"}
MOE_MESH_TOL = 2e-4            # y against the local path, f32
MOE_AUX_RTOL = 1e-5            # aux against the per-shard estimator
MESH_BUDGET_S = 150
# (e) on the host beside (a)-(d): the dry run's granite-3-2b train_4k cell
# on the single-pod mesh, and the roofline of phase 19's step shape.
DRYRUN_CODE = """
import json, sys
sys.path.insert(0, "src")
import torch
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.models.transformer import Model
from repro_torch.runtime import roofline as rl
from repro_torch.runtime.op_cost import op_cost
from repro_torch.training.optimizer import AdamWConfig, init_state
from repro_torch.training.step import make_train_step, trainable
status = dryrun.run_cell("granite-3-2b", "train_4k", False,
                         __import__("pathlib").Path(sys.argv[1]))
cell = json.loads(open(sys.argv[1] + "/granite-3-2b__train_4k__single.json")
                  .read())
cfg = configs.get("granite-3-2b")            # the launcher's: "selective"
model = Model(cfg, "meta")
ocfg = AdamWConfig()
cost = op_cost(make_train_step(ocfg), model,
               init_state(ocfg, trainable(model)),
               {"tokens": torch.empty(8, 128, dtype=torch.int64)})
t = rl.terms_from_analysis({"flops": cost.flops, "bytes accessed":
                            cost.bytes}, 0.0, 1,
                           rl.model_flops_train(cfg, 8 * 128))
print("DRYRUN", json.dumps({"status": status, "cell": cell,
                            "phase19_shape": {"flops": cost.flops,
                                              "bytes": cost.bytes,
                                              "ops": len(cost.ops),
                                              **t.as_dict(),
                                              "bound_s": t.bound_s}}))
"""


def sharded_numel(sm) -> int:
    return sum(int(np.prod(t.shape)) for t in sm.params.values())


def mesh_leaf_update_check(torch, opt, res, leaves) -> dict:
    """One more step over the mesh on the model and state a launcher run
    returned: each of ``leaves`` updated block by block on the card
    against ``apply_updates`` on the CPU on copies of the gathered
    parameter, (clipped) gradient and moments."""
    from repro_torch.models.transformer import decayed_names
    from repro_torch.training.step import (apply_sharded_updates,
                                           clip_sharded, mesh_loss_and_grads)

    sm, state, cfg = res["model"], res["opt_state"], res["opt_cfg"]
    batch = res["pipeline"].batch_at(len(res["losses"]) + res["start"])
    _, grads = mesh_loss_and_grads(sm, batch)
    grads, _ = clip_sharded(grads, 1.0)
    decay = decayed_names(sm.skeleton())
    cpu = {"step": state["step"].cpu(), "moments": {}}
    cpu_p, cpu_g = {}, {}
    for k in leaves:
        cpu_p[k] = sm.params[k].full("cpu").clone()
        cpu_g[k] = grads[k].full("cpu").clone()
        cpu["moments"][k] = {kk: t.full("cpu").clone()
                             for kk, t in state["moments"][k].items()}
    apply_sharded_updates(cfg, sm, grads, state)
    opt.apply_updates(cfg, cpu_p, cpu_g, cpu, {k for k in leaves
                                               if k in decay})
    out = {}
    for k in leaves:
        rec = {"param_bf16_ulps": bf16_ulps(torch, sm.params[k].full("cpu"),
                                            cpu_p[k]),
               "blocks": len(sm.params[k].shards), "decays": k in decay}
        for kk, t in state["moments"][k].items():
            got, want = t.full("cpu"), cpu["moments"][k][kk]
            if got.dtype == torch.int8:
                d = (got.int() - want.int()).abs()
                rec[kk] = {"max_code_diff": int(d.max()),
                           "codes_differing": int((d > 0).sum()),
                           "codes": d.numel()}
            else:
                rec[kk] = rel_gap(torch, got, want)
        out[k] = rec
        check(rec["param_bf16_ulps"] <= 1,
              f"{k}: the mesh's update is {rec['param_bf16_ulps']} bf16 "
              f"ulps from the CPU's")
        for kk, v in rec.items():
            if isinstance(v, dict):
                check(v["max_code_diff"] <= 1, f"{k}/{kk}: {v}")
            elif kk in state["moments"][k]:
                check(v <= 1e-6, f"{k}/{kk}: the mesh's moment is {v} "
                      f"(relative) from the CPU's")
    del grads
    return out


def mesh_granite(torch, train, opt, int8: bool, single: dict,
                 smi: str) -> dict:
    """(a) granite-3-2b at full width through the launcher over the
    (2, 2) mesh on the one card, 3 steps."""
    import statistics

    from repro_torch.runtime import collectives
    from repro_torch.training.step import ShardedModel

    argv = MESH_ARGV + (["--int8-opt"] if int8 else [])
    label = "int8 moments" if int8 else "f32 moments"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with collectives.recording() as stats:
        res = train.run(train.parse_args(argv))
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    sm = res["model"]
    check(isinstance(sm, ShardedModel), "the launcher did not shard")
    n = sharded_numel(sm)
    check(n == LM_PARAMS, f"granite-3-2b has {n} parameters over the mesh")
    blocks = [b for t in sm.params.values() for b in t.shards]
    check(all(b.device.type == "cuda" for b in blocks),
          "a block of the mesh is not on the card")
    losses, norms = res["losses"], res["grad_norms"]
    check(len(losses) == 3 and all(np.isfinite(losses + norms)),
          f"{label}: a loss or grad norm is not finite: {losses} {norms}")
    steps = len(losses)
    gathered = stats.bytes_by_kind.get("all-gather", 0.0) / (4 * steps)
    step_s = statistics.median(res["step_s"][1:])
    tokens = 8 * 128
    out = {"argv": argv, "run_s": t_run, "losses": losses,
           "grad_norms": norms, "step_s": res["step_s"],
           "step_ms": step_s * 1e3, "tok_s": tokens / step_s,
           "max_memory_allocated": peak, "blocks": len(blocks),
           "gathered_bytes_per_step": gathered,
           "collectives": stats.summary(),
           "loss0_rel_gap": abs(losses[0] - single["losses"][0])
           / single["losses"][0],
           "grad_norm0_rel_gap": abs(norms[0] - single["grad_norms"][0])
           / single["grad_norms"][0]}
    out["leaf_update"] = mesh_leaf_update_check(torch, opt, res,
                                                TRAIN_LEAVES)
    log(f"[mesh] granite-3-2b full width over a ({MESH_DEVICES}) mesh on "
        f"the one card, {label} ({n:,} params in {len(blocks)} blocks, "
        f"bf16): 3 steps through the launcher in {t_run:.1f}s on {smi}; "
        f"losses " + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.3f}" for x in norms))
    log(f"[mesh] granite-3-2b {label}: step 0 against phase 19's one-device "
        f"step on the same weights and batch: loss {losses[0]:.6f} vs "
        f"{single['losses'][0]:.6f} ({out['loss0_rel_gap']:.3g} relative, "
        f"tolerance {MESH_LOSS0_RTOL}), grad norm {norms[0]:.4f} vs "
        f"{single['grad_norms'][0]:.4f} ({out['grad_norm0_rel_gap']:.3g}, "
        f"tolerance {MESH_GNORM0_RTOL})")
    log(f"[mesh] granite-3-2b {label}: step {out['step_ms']:.1f} ms (median "
        f"of steps 1-2; phase 19's one-device step "
        f"{single['step_ms']:.1f} ms), {out['tok_s']:.0f} tokens/s, "
        f"max_memory_allocated {peak / 1e9:.2f} GB (phase 19 "
        f"{single['max_memory_allocated'] / 1e9:.2f} GB); gathered "
        f"{gathered / 1e9:.3f} GB a step (the whole model once: both rows "
        f"share the card, one pass); recorded link traffic "
        f"{stats.total_bytes / steps / 1e9:.2f} GB a step over 4 devices")
    log(f"[mesh] granite-3-2b {label}: a step's update block by block on "
        f"the card against apply_updates on the CPU on gathered copies of "
        + "; ".join(f"{k}: {v}" for k, v in out["leaf_update"].items()))
    check(out["loss0_rel_gap"] <= MESH_LOSS0_RTOL,
          f"{label}: step 0's loss over the mesh {losses[0]} against one "
          f"device's {single['losses'][0]}")
    check(out["grad_norm0_rel_gap"] <= MESH_GNORM0_RTOL,
          f"{label}: step 0's grad norm over the mesh {norms[0]} against "
          f"one device's {single['grad_norms'][0]}")
    res.clear()
    free_card(torch)
    return out


def mesh_step_card_vs_cpu(torch, arch: str, int8: bool, dev) -> dict:
    """One (2, 2) mesh train step of ``arch``'s smoke config in f32 on the
    CPU and on the card from the same weights and tokens: the loss, the
    grad norm and every updated parameter (max |Δ| / max |p| per leaf)."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_test_parallelism
    from repro_torch.models.transformer import init_params
    from repro_torch.training import optimizer as opt
    from repro_torch.training.step import (init_sharded_state,
                                           make_train_step, shard_model)

    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32",
                              remat="none")
    ocfg = opt.AdamWConfig(lr=1e-3, int8_moments=int8)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32),
                                     generator=torch.Generator()
                                     .manual_seed(0))}
    out = []
    for where in ("cpu", dev):
        par = make_test_parallelism(2, 2, device=where)
        sm = shard_model(init_params(cfg, "cpu", seed=0), par)
        state = init_sharded_state(ocfg, sm)
        _, _, m = make_train_step(ocfg, par=par)(
            sm, state, {k: v.to(where) for k, v in batch.items()})
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: t.full("cpu") for k, t in sm.params.items()}))
    (l0, n0, p0), (l1, n1, p1) = out
    return {"loss": abs(l1 - l0) / abs(l0),
            "grad_norm": abs(n1 - n0) / abs(n0),
            "params": max(rel_gap(torch, p1[k], p0[k]) for k in p0)}


def moe_mesh_card_vs_cpu(torch, arch: str, dev) -> dict:
    """The MoE's mesh branch of ``arch``'s smoke config (f32) over a
    (2, 2) mesh on the CPU and on the card: y and aux."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_test_parallelism
    from repro_torch.models import moe

    cfg = configs.smoke(arch).moe
    g = torch.Generator().manual_seed(0)
    d = 64
    p = {"router": torch.randn(d, cfg.n_experts, generator=g) / 8,
         "w_gate": torch.randn(cfg.n_experts, d, cfg.d_ff, generator=g) / 8,
         "w_up": torch.randn(cfg.n_experts, d, cfg.d_ff, generator=g) / 8,
         "w_down": torch.randn(cfg.n_experts, cfg.d_ff, d, generator=g) / 11}
    x = torch.randn(4, 16, d, generator=g)
    y0, a0 = moe.moe_forward(p, x, cfg, make_test_parallelism(
        2, 2, device="cpu"))
    y1, a1 = moe.moe_forward({k: v.to(dev) for k, v in p.items()},
                             x.to(dev), cfg,
                             make_test_parallelism(2, 2, device=dev))
    return {"y": float((y1.cpu() - y0).abs().max()),
            "aux": abs(float(a1) - float(a0)) / abs(float(a0))}


def moe_mesh_full_width(torch, arch: str, dev) -> dict:
    """(b) The MoE config at its published width with
    ``LM_MOE_LAYERS`` layers in f32: the forward over a (2, 2) mesh of the
    one card (``ep`` or ``tp`` over model = 2) against the local path on
    the same weights and tokens, and its aux against the per-shard
    estimator (the mean over the two data rows of each row's aux)."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_test_parallelism
    from repro_torch.launch.serve import lm_inputs
    from repro_torch.models.transformer import forward_hidden, init_params

    cfg = dataclasses.replace(configs.get(arch), dtype="float32",
                              n_layers=LM_MOE_LAYERS[arch])
    check(cfg.moe.mode == MOE_MESH_MODES[arch],
          f"{arch}: mode {cfg.moe.mode}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, dev, seed=0)
    toks, _ = lm_inputs(cfg, 2, 64, dev, seed=1)
    par = make_test_parallelism(2, 2)
    with torch.no_grad():
        h0, aux0 = forward_hidden(model, toks)
        h1, aux1 = forward_hidden(model, toks, par=par)
        est = torch.stack([forward_hidden(model, toks[i:i + 1])[1]
                           for i in range(2)]).mean()
    out = {"layers": cfg.n_layers, "mode": cfg.moe.mode,
           "experts": cfg.moe.n_experts, "d_ff": cfg.moe.d_ff,
           "seconds": time.perf_counter() - t0,
           "max_abs_diff": float((h1 - h0).abs().max()),
           "max_abs_h": float(h0.abs().max()),
           "aux_mesh": float(aux1), "aux_local": float(aux0),
           "aux_estimator": float(est),
           "aux_rel_gap": abs(float(aux1) - float(est)) / abs(float(est)),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    ok = bool(((h1 - h0).abs() <= MOE_MESH_TOL * (1 + h0.abs())).all())
    del model, h0, h1
    free_card(torch)
    check(ok, f"{arch} over the mesh: hidden states {out['max_abs_diff']} "
          f"from the local path's")
    check(out["aux_rel_gap"] <= MOE_AUX_RTOL,
          f"{arch}: the mesh's aux {out['aux_mesh']} against the per-shard "
          f"estimator {out['aux_estimator']}")
    return out


def compressed_dp_on_card(torch, dev) -> dict:
    """(c) ``make_compressed_dp_grad_fn`` over 4 data shards on the card:
    the reference test's problem and limits (one round within 5 %, the
    mean of 16 rounds within 1 % of the exact gradient), and the card
    against the CPU round by round."""
    from repro_torch.runtime.sharding import make_mesh
    from repro_torch.training.compress import (init_error_feedback,
                                               make_compressed_dp_grad_fn)

    g = torch.Generator().manual_seed(0)
    W = torch.randn(32, 8, generator=g)
    xs = torch.randn(16, 32, generator=g)
    ys = xs @ W

    def loss_fn(p, batch):
        x, y = batch
        return torch.mean((x @ p["w"] - y) ** 2)

    runs = {}
    for where in ("cpu", dev):
        params = {"w": torch.zeros(32, 8, device=where)}
        fn = make_compressed_dp_grad_fn(
            loss_fn, make_mesh((4,), ("data",), [where]))
        w0 = torch.zeros(32, 8, device=where, requires_grad=True)
        exact = torch.autograd.grad(loss_fn({"w": w0}, (
            xs.to(where), ys.to(where))), w0)[0].cpu()
        err = [init_error_feedback(params) for _ in range(4)]
        rounds = []
        for _ in range(17):
            _, gr, err = fn(params, (xs.to(where), ys.to(where)), err)
            rounds.append(gr["w"].cpu())
        runs[str(where)] = (exact, rounds)
    exact, rounds = runs[str(dev)]
    scale = float(exact.abs().max())
    out = {"one_round": float((rounds[0] - exact).abs().max()) / scale,
           "sixteen_rounds": float((torch.stack(rounds[1:]).mean(0)
                                    - exact).abs().max()) / scale,
           "card_vs_cpu": max(float((a - b).abs().max()) for a, b in
                              zip(rounds, runs["cpu"][1])) / scale}
    check(out["one_round"] < 0.05 and out["sixteen_rounds"] < 0.01,
          f"compressed DP gradients on the card: {out}")
    check(out["card_vs_cpu"] <= 1e-5, f"compressed DP, card vs CPU: {out}")
    return out


def mesh_checkpoint_reshard(torch) -> dict:
    """(d) A checkpoint written from the (2, 2) mesh on the card (the
    launcher, smoke size, int8 moments) restored onto a (4, 1) mesh and
    onto the one device: every leaf equal."""
    import tempfile

    from repro_torch.checkpoint import (params_to_tree, restore_pytree,
                                        sharded_checkpoint_like)
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_parallelism
    from repro_torch.runtime.sharding import ShardedTensor
    from repro_torch.training.step import init_sharded_state, shard_model

    base = ["--arch", LM_ARCH, "--smoke", "--steps", "2", "--global-batch",
            "4", "--seq-len", "32", "--int8-opt", "--log-every", "100"]
    with tempfile.TemporaryDirectory() as d:
        res = train.run(train.parse_args(base + ["--mesh-devices", "2,2",
                                                 "--ckpt-dir", d]))
        sm = res["model"]
        par41 = make_test_parallelism(4, 1)
        sm41 = shard_model(sm.full("cuda"), par41)
        like, shardings = sharded_checkpoint_like(
            sm41, init_sharded_state(res["opt_cfg"], sm41))
        on41 = restore_pytree(like, d, 2, shardings, device="cuda")
        on1 = restore_pytree(like, d, 2)
        a, b = flat_tree(on41), flat_tree(on1)
        check(a.keys() == b.keys(), "the two restores differ in leaves")
        equal = all(torch.equal(
            a[k].full() if isinstance(a[k], ShardedTensor) else a[k], b[k])
            for k in a)
        blocks = {k: len(v.shards) for k, v in a.items()
                  if isinstance(v, ShardedTensor)}
        devices = {str(x.device) for v in a.values()
                   if isinstance(v, ShardedTensor) for x in v.shards} | {
            str(v.device) for v in b.values()}
        # the restore holds the trained model's values
        trained = flat_tree({"params": params_to_tree(sm)})
        same = all(torch.equal(t.full(), b[k]) for k, t in trained.items())
    out = {"leaves": len(a), "equal": equal,
           "max_blocks": max(blocks.values()), "devices": sorted(devices),
           "equals_the_trained_model": same}
    check(equal and same, f"a (2, 2) checkpoint restores differently: {out}")
    return out


def mesh_phase(torch, report) -> None:
    """Phase 20; launches none of the port's kernels."""
    import tempfile

    from repro_torch import configs
    from repro_torch.kernels import fused_query as fq
    from repro_torch.kernels import level_ops as lo
    from repro_torch.launch import train
    from repro_torch.training import optimizer as opt

    smi = report["env"]["nvidia_smi"]
    t_phase = time.perf_counter()
    before = [k.launches for k in fq.KERNELS + lo.KERNELS]
    dev = torch.device("cuda")
    free_card(torch)
    # (e) starts first, on the host, and is read at the end
    tmp = tempfile.TemporaryDirectory()
    dry = subprocess.Popen([sys.executable, "-c", DRYRUN_CODE, tmp.name],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, cwd=ROOT)
    try:
        single = report["train"]["granite"]
        out = {"card": smi, "granite": {
            "f32_moments": mesh_granite(torch, train, opt, False,
                                        single["f32_moments"], smi),
            "int8_moments": mesh_granite(torch, train, opt, True,
                                         single["int8_moments"], smi)}}

        out["step_card_vs_cpu"] = {
            f"{a} {'int8' if i8 else 'f32'}": mesh_step_card_vs_cpu(
                torch, a, i8, dev) for a, i8 in MESH_STEP_CASES}
        worst = {k: max(v[k] for v in out["step_card_vs_cpu"].values())
                 for k in MESH_F32}
        log(f"[mesh] the (2, 2) mesh step at smoke size in f32, card against "
            f"CPU: largest gaps {worst} (tolerances {MESH_F32}); "
            + "; ".join(f"{k}: loss {v['loss']:.2g} params {v['params']:.2g}"
                        for k, v in out["step_card_vs_cpu"].items()))
        check(all(worst[k] <= tol for k, tol in MESH_F32.items()),
              f"the mesh step differs between card and CPU: "
              f"{out['step_card_vs_cpu']}")

        # (b) the MoE's mesh branch at published width
        out["moe"] = {a: moe_mesh_full_width(torch, a, dev)
                      for a in MOE_MESH_MODES}
        out["moe_smoke_card_vs_cpu"] = {
            a: moe_mesh_card_vs_cpu(torch, a, dev) for a in MOE_MESH_MODES}
        for a, m in out["moe"].items():
            s = out["moe_smoke_card_vs_cpu"][a]
            log(f"[mesh] {a} full width, {m['layers']} layers, f32, "
                f"{m['mode']} over model = 2 ({m['experts']} experts, d_ff "
                f"{m['d_ff']}) on a (2, 2) mesh of the one card: hidden "
                f"states against the local path max |Δ| "
                f"{m['max_abs_diff']:.3g} (max |h| {m['max_abs_h']:.3g}; "
                f"tolerance {MOE_MESH_TOL}·(1 + |h|)); aux {m['aux_mesh']:.6f}"
                f" against the per-shard estimator {m['aux_estimator']:.6f} "
                f"({m['aux_rel_gap']:.3g}, tolerance {MOE_AUX_RTOL}; the "
                f"local path's {m['aux_local']:.6f}); {m['seconds']:.1f}s, "
                f"max_memory_allocated {m['max_memory_allocated'] / 1e9:.2f}"
                f" GB; smoke card vs CPU y {s['y']:.2g}, aux {s['aux']:.2g}")
            check(s["y"] <= 1e-5 and s["aux"] <= 1e-5,
                  f"{a}: the MoE's mesh branch differs on the card: {s}")

        # (c) compressed DP gradients over 4 data shards on the card
        out["compressed_dp"] = compressed_dp_on_card(torch, dev)
        c = out["compressed_dp"]
        log(f"[mesh] compressed DP gradients over 4 data shards on the card:"
            f" one round {c['one_round']:.4f} of max |g| (limit 0.05), the "
            f"mean of 16 rounds {c['sixteen_rounds']:.5f} (limit 0.01); card"
            f" against CPU {c['card_vs_cpu']:.2g}")

        # (d) the elastic reshard
        out["reshard"] = mesh_checkpoint_reshard(torch)
        r = out["reshard"]
        log(f"[mesh] a checkpoint from the (2, 2) mesh on the card (smoke, "
            f"int8 moments, {r['leaves']} leaves, up to {r['max_blocks']} "
            f"blocks a leaf) restored onto (4, 1) and onto one device: "
            f"equal {r['equal']}; on {r['devices']}")
    finally:
        try:
            so, se = dry.communicate(timeout=600)
        finally:
            if dry.poll() is None:
                dry.kill()
            tmp.cleanup()

    # (e) the dry run's cell and phase 19's roofline
    check(dry.returncode == 0 and "DRYRUN" in so,
          f"the dry run failed: {se[-3000:]}")
    got = json.loads(so.split("DRYRUN", 1)[1])
    cell, p19 = got["cell"], got["phase19_shape"]
    check(got["status"] == "ok", f"the dry run's cell: {cell}")
    measured = single["f32_moments"]["step_ms"] / 1e3
    out["dryrun"] = {"cell": cell, "phase19_shape": p19,
                     "phase19_measured_s": measured,
                     "bound_share": p19["bound_s"] / measured}
    log(f"[mesh] dry run, granite-3-2b train_4k on the 16 x 16 mesh (meta): "
        f"arguments {cell['memory']['argument_size_in_bytes'] / 1e9:.3f} GB "
        f"a device of 80, {cell['analysis']['flops_global']:.4g} FLOPs, "
        f"{cell['analysis']['collective_bytes_global']:.4g} collective bytes,"
        f" dominant {cell['roofline']['dominant']}, roofline fraction "
        f"{cell['roofline']['roofline_fraction']:.3f} "
        f"({cell['analysis']['seconds']}s)")
    log(f"[mesh] roofline of phase 19's step (granite-3-2b, 8 x 128, one "
        f"H100): {p19['hlo_flops']:.4g} FLOPs, {p19['hlo_bytes']:.4g} bytes "
        f"({p19['ops']} operations), bound {p19['bound_s'] * 1e3:.2f} ms "
        f"({p19['dominant']}); phase 19 measured {measured * 1e3:.1f} ms: "
        f"{100 * out['dryrun']['bound_share']:.2f} % of it on {smi}")

    after = [k.launches for k in fq.KERNELS + lo.KERNELS]
    check(after == before, f"the mesh phase launched a kernel: "
          f"{before} -> {after}")
    out["seconds"] = time.perf_counter() - t_phase
    report["mesh"] = out
    log(f"[mesh] phase 20 in {out['seconds']:.1f}s; no kernel of the port "
        f"launched")
    check(out["seconds"] <= MESH_BUDGET_S,
          f"phase 20 took {out['seconds']:.1f}s, over its {MESH_BUDGET_S} s")
    free_card(torch)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import engine
    from repro_torch.core import subseq as ss
    from repro_torch.core.fastsax import FastSAXConfig, build_index
    from repro_torch.data.timeseries import make_queries, make_wafer_like
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_query as fq
    from repro_torch.kernels import level_ops as lo
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import (SearchService, ServeConfig, WorkloadSpec,
                                   make_workload)
    from repro_torch.serve.service import _QuantizedBackend

    t_start = time.perf_counter()
    report = {"env": environment(torch)}

    t0 = time.perf_counter()
    build.build(["fused_query", "level_ops"])
    info = build.BUILD_INFO["fused_query"]
    linfo = build.BUILD_INFO["level_ops"]
    report["build"] = {"seconds": time.perf_counter() - t0,
                       "nvcc_seconds": info["seconds"], "log": info["log"],
                       "level_ops_nvcc_seconds": linfo["seconds"],
                       "level_ops_log": linfo["log"]}
    log(f"[build] fused_query.cu and level_ops.cu in "
        f"{report['build']['seconds']:.1f}s (nvcc {info['seconds']:.1f}s "
        f"and {linfo['seconds']:.1f}s, in parallel)")
    report["build"]["kernels"] = ptxas_summary(info["log"])
    report["build"]["level_kernels"] = level_ptxas_summary(linfo["log"])
    for line in report["build"]["kernels"] + report["build"]["level_kernels"]:
        log("[build] " + line)
    topk_build = [line for line in report["build"]["kernels"]
                  if " top-k " in line]
    regs = [int(m) for line in topk_build
            for m in re.findall(r"(\d+) registers", line)]
    spills = sum(int(m) for line in topk_build
                 for m in re.findall(r"(\d+) bytes spill", line))
    report["build"]["topk_registers"] = regs
    report["build"]["topk_spill_bytes"] = spills
    if topk_build:
        log(f"[build] the {len(topk_build)} top-k instantiations: "
            f"{min(regs)}-{max(regs)} registers, {spills} bytes of spill "
            f"stores and loads in all")
    # Every instantiation, the streaming ones included, keeps its
    # per-level state in registers: no stack frame and no spill.
    frames = {line.split(":")[0]: frame_and_spills(line)
              for line in report["build"]["kernels"]}
    report["build"]["stack_and_spill_bytes"] = frames
    check(frames, "no ptxas report of the fused kernels in the build log")
    streaming = [k for k in frames if "streaming" in k]
    check(streaming, "no streaming instantiation in the build log")
    log(f"[build] stack frame and spill bytes of the {len(frames)} fused "
        f"instantiations ({len(streaming)} streaming): max "
        f"{max(v[0] for v in frames.values())} and "
        f"{max(v[1] for v in frames.values())}")
    check(all(v == (0, 0) for v in frames.values()),
          f"a fused instantiation has a stack frame or spills: {frames}")
    check(all(r <= 128 for r in regs), f"top-k registers above 128: {regs}")
    # The linfit, word and sqdist register bodies of level_ops.cu keep
    # their state in registers: no stack frame and no spill in any
    # instantiation.
    level_frames = {line.split(":")[0]: frame_and_spills(line)
                    for line in report["build"]["level_kernels"]
                    if not line.startswith(("paa ", "sqdist segment "))}
    report["build"]["level_stack_and_spill_bytes"] = level_frames
    check(level_frames, "no ptxas report of the level kernels in the log")
    check(any(k.startswith("sqdist n=128 ") for k in level_frames),
          "no ptxas report of sqdist's register body in the log")
    log(f"[build] stack frame and spill bytes of the {len(level_frames)} "
        f"linfit, word and sqdist register instantiations of "
        f"level_ops.cu: max "
        f"{max(v[0] for v in level_frames.values())} and "
        f"{max(v[1] for v in level_frames.values())}")
    check(all(v == (0, 0) for v in level_frames.values()),
          f"a level instantiation has a stack frame or spills: "
          f"{level_frames}")
    report["build"]["ring_stages"] = ring_stages_at_path_tiles(fq, ops, ss)
    log("[build] ring stages the launcher chooses at the path tiles: "
        + json.dumps(report["build"]["ring_stages"], sort_keys=True))

    t0 = time.perf_counter()
    db = make_wafer_like(N_SERVE, 128, seed=0)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    service = SearchService.from_series(db, ServeConfig())
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    check(service.backend.backend == "cuda", "serving must use the kernels")
    t0 = time.perf_counter()
    service.warmup()
    torch.cuda.synchronize()
    report["index"] = {"rows": N_SERVE, "data_s": t_data,
                       "build_s": t_build,
                       "warmup_s": time.perf_counter() - t0,
                       "memory_allocated": torch.cuda.memory_allocated()}
    log(f"[index] {N_SERVE} rows: data {t_data:.1f}s, device build "
        f"{t_build:.2f}s, warmup {report['index']['warmup_s']:.1f}s")

    queries = make_queries(db, 64, seed=1)
    small_db = make_wafer_like(65_536, 128, seed=1)
    small = engine.build_device_index(small_db, (8, 16), 10)
    ragged_db = make_wafer_like(50_001, 128, seed=2)
    ragged = engine.build_device_index(ragged_db, (8, 16), 10)
    report["kernels"] = {
        "serving": compare_kernels(torch, engine, fq, ref,
                                   service.backend.index, queries[:32],
                                   "Q=32 B=1048576", timing=True),
        "b65536": compare_kernels(torch, engine, fq, ref, small,
                                  make_queries(small_db, 32, seed=3),
                                  "Q=32 B=65536", timing=True),
        "ragged": compare_kernels(torch, engine, fq, ref, ragged,
                                  make_queries(ragged_db, 27, seed=4),
                                  "Q=27 B=50001", timing=False),
    }
    del small, ragged

    spec = WorkloadSpec(n_requests=64, knn_frac=0.5, k=5, epsilon=2.0)
    workload = make_workload(queries, spec)
    result, launches = serve_phase(torch, fq, service, workload, "serve")
    d2h_batch = service.backend.last_d2h_bytes     # the last served batch
    snap = service.stats.snapshot()
    check(result.served == len(workload),
          f"served {result.served} of {len(workload)}")
    check(launches["fused_range"] > 0 and launches["fused_topk"] > 0
          and launches["compact_count"] >= snap["batches"] > 0
          and launches["compact_write"] > 0,
          f"a kernel of the path did not launch: {launches}")
    mismatches, t_replay = replay_check(service, workload, result, "serve")
    bf = brute_force_check(service.backend.index.series.cpu().numpy(),
                           workload, result, 16)
    check(bf["wrong"] == 0 and bf["checked"] >= 8,
          f"brute-force disagreement: {bf}")
    lat = snap["latency_ms"]
    report["serve"] = {"summary": result.summary(snap), "launches": launches,
                       "exact_mismatches": mismatches, "replay_s": t_replay,
                       "brute_force": bf,
                       "d2h_bytes_last_batch": d2h_batch}
    log(f"[serve] {result.served}/{len(workload)} served at "
        f"{result.qps:.2f} qps; p50 {lat['p50']} ms p99 {lat['p99']} ms; "
        f"mean batch {snap['mean_batch_size']} over {snap['batches']} "
        f"batches; launches {launches}; exactness mismatches {mismatches} "
        f"({t_replay:.1f}s); brute force {bf}; device-to-host {d2h_batch} "
        f"bytes in the last batch")

    report["breakdown"] = breakdown(torch, engine, fq, service, queries)
    compact = compact_phase(torch, engine, fq, ref, report)
    log(f"[time] phases 1-6 in {time.perf_counter() - t_start:.1f}s")

    # ---- 7. the quantized resident tier: index and kernels
    t0 = time.perf_counter()
    qservice = SearchService.from_series(db, ServeConfig(quantization="int8"))
    torch.cuda.synchronize()
    t_qbuild = time.perf_counter() - t0
    check(isinstance(qservice.backend, _QuantizedBackend)
          and qservice.backend.backend == "cuda",
          "the quantized service must serve through the tier's kernel")
    tier8 = qservice.backend.tindex
    t0 = time.perf_counter()
    host = build_index(db, FastSAXConfig(n_segments=(8, 16), alphabet=10))
    tier16 = engine.TieredIndex.from_host(host, "bf16")
    torch.cuda.synchronize()
    t_bf16 = time.perf_counter() - t0
    qhost_bytes = {m: quant_resident_bytes(t.dev)
                   for m, t in (("int8", tier8), ("bf16", tier16))}
    report["quant_index"] = {"int8_service_build_s": t_qbuild,
                             "bf16_tier_build_s": t_bf16,
                             "resident_bytes": qhost_bytes,
                             "raw_tier_bytes": int(tier8.raw.nbytes)}
    log(f"[quant-index] {N_SERVE} rows: int8 service (host build + "
        f"quantize + upload) {t_qbuild:.1f}s, bf16 tier {t_bf16:.1f}s; "
        f"resident bytes {qhost_bytes}, raw tier {tier8.raw.nbytes} bytes "
        f"on the host")
    small_host = build_index(small_db, FastSAXConfig(n_segments=(8, 16),
                                                     alphabet=10))
    ragged_host = build_index(ragged_db, FastSAXConfig(n_segments=(8, 16),
                                                       alphabet=10))
    qk = {}
    small_q = make_queries(small_db, 32, seed=3)
    ragged_q = make_queries(ragged_db, 27, seed=4)
    for mode, tier in (("int8", tier8), ("bf16", tier16)):
        qk[mode] = {
            "serving": compare_quant_kernels(
                torch, engine, fq, ref, tier, queries[:32],
                "Q=32 B=1048576", timing=True),
            "b65536": compare_quant_kernels(
                torch, engine, fq, ref,
                engine.TieredIndex.from_host(small_host, mode), small_q,
                "Q=32 B=65536", timing=True),
            "ragged": compare_quant_kernels(
                torch, engine, fq, ref,
                engine.TieredIndex.from_host(ragged_host, mode), ragged_q,
                "Q=27 B=50001", timing=False)}
    del tier16, small_host, ragged_host
    report["quant_kernels"] = qk
    kernel_phase_launches = {k.__name__: k.launches for k in fq.KERNELS}
    log(f"[quant-kernels] launches in phases 4 and 7 (comparisons and "
        f"timing, not serving): {kernel_phase_launches}")

    # ---- 8. the quantized slice: the same 64 requests through the tier
    t0 = time.perf_counter()
    qservice.warmup()
    log(f"[quant-serve] warmup {time.perf_counter() - t0:.1f}s")
    qresult, qlaunches = serve_phase(torch, fq, qservice, workload,
                                     "quant-serve")
    qsnap = qservice.stats.snapshot()
    check(qresult.served == len(workload),
          f"quantized: served {qresult.served} of {len(workload)}")
    check(qlaunches["fused_quant_range"] >= qsnap["batches"] > 0,
          f"the quantized screen kernel did not launch once per batch: "
          f"{qlaunches}, {qsnap['batches']} batches")
    q_d2h = qservice.backend.last_d2h_bytes
    q_cap = qservice.backend.last_capacity
    q_mismatches, q_replay = replay_check(qservice, workload, qresult,
                                          "quant-serve")
    vs_full = cross_check(tier8.raw, workload, qresult, result)
    check(vs_full["wrong"] == 0,
          f"quantized answers differ from full precision: {vs_full}")
    q_bf = brute_force_check(tier8.raw, workload, qresult, 16)
    check(q_bf["wrong"] == 0 and q_bf["checked"] >= 8,
          f"quantized brute-force disagreement: {q_bf}")
    qlat = qsnap["latency_ms"]
    report["quant_serve"] = {
        "summary": qresult.summary(qsnap), "launches": qlaunches,
        "exact_mismatches": q_mismatches, "replay_s": q_replay,
        "vs_full_precision": vs_full, "brute_force": q_bf,
        "d2h_bytes_last_batch": q_d2h, "capacity_last_batch": q_cap}
    log(f"[quant-serve] {qresult.served}/{len(workload)} served at "
        f"{qresult.qps:.2f} qps; p50 {qlat['p50']} ms p99 {qlat['p99']} "
        f"ms; mean batch {qsnap['mean_batch_size']} over "
        f"{qsnap['batches']} batches; launches {qlaunches}; exactness "
        f"mismatches {q_mismatches} ({q_replay:.1f}s); against the "
        f"full-precision phase {vs_full}; brute force {q_bf}; "
        f"device-to-host {q_d2h} bytes and capacity {q_cap} in the last "
        f"batch")
    report["quant_breakdown"] = quant_breakdown(torch, engine, qservice,
                                                queries)
    log(f"[time] phases 1-8 in {time.perf_counter() - t_start:.1f}s")
    index = service.backend.index   # phase 3's, for phases 12-13, 15, 17
    del qservice, service

    # ---- 9-11. subsequence search
    slaunches, sk, sub = subseq_phases(torch, engine, fq, ref, report)
    log(f"[time] phases 1-11 in {time.perf_counter() - t_start:.1f}s")

    # ---- 12. kernels 8-12 against their plain versions and the device
    # build of phase 3
    blaunches, lk = level_phase12(torch, engine, lo, ref, index, queries,
                                  report)
    # ---- 13. the paper's online phase, level at a time, on the card
    llaunches, sq = level_phase13(torch, engine, lo, ref, host, index,
                                  queries, report)
    log(f"[time] phases 1-13 in {time.perf_counter() - t_start:.1f}s")

    # ---- 14. the index lifecycle: stores, warm starts, live ingest
    plaunches = lifecycle_phase(torch, engine, fq, host, queries, workload,
                                result, qresult, sub, report)
    log(f"[time] phases 1-14 in {time.perf_counter() - t_start:.1f}s")

    # ---- 15. traced serving: counters, spans, calibration, metrics,
    # the profiler
    olaunches = obs_phase(torch, engine, fq, ref, ops, index, host, queries,
                          workload, result, tier8, sub, report)
    del host
    log(f"[time] phases 1-15 in {time.perf_counter() - t_start:.1f}s")
    for name, count in olaunches.items():
        plaunches[name] = plaunches.get(name, 0) + count

    # ---- 16. extended representation stacks, trending data, curation
    rlaunches = repr_phase(torch, engine, fq, lo, ref, ops, ss, report)
    log(f"[time] phases 1-16 in {time.perf_counter() - t_start:.1f}s")
    for name, count in rlaunches.items():
        if name in LEVEL_REPLACES:
            llaunches[name] = llaunches.get(name, 0) + count
        else:
            plaunches[name] = plaunches.get(name, 0) + count

    # ---- 17. sharded search, sharded stores, failover shards (shard-1M)
    shlaunches = shard_phase(torch, engine, fq, db, index, tier8, sub,
                             queries, workload, result, qresult, report)
    del db, index, tier8, sub
    log(f"[time] phases 1-17 in {time.perf_counter() - t_start:.1f}s")
    add_launches(plaunches, shlaunches)

    # ---- 18. the LM serving path (launches none of the kernels)
    lm_phase(torch, report)
    log(f"[time] phases 1-18 in {time.perf_counter() - t_start:.1f}s")

    # ---- 19. LM training and checkpoints (launches none of the kernels)
    train_phase(torch, report)
    log(f"[time] phases 1-19 in {time.perf_counter() - t_start:.1f}s")

    # ---- 20. the training mesh on the one card, the analysis tools
    # (launches none of the kernels)
    mesh_phase(torch, report)
    log(f"[time] phases 1-20 in {time.perf_counter() - t_start:.1f}s")

    kernels = []
    for name in ("fused_range", "fused_topk"):
        main = report["kernels"]["serving"][name]
        key = "range" if name == "fused_range" else "topk"
        err = max(report["kernels"][s][key]["max_abs_err"]
                  for s in report["kernels"])
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name] + plaunches[name],
                        "max_abs_err": err,
                        "ms": main["ms"], "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"],
                        "bound_by": main["bound_by"],
                        "library_ms": main["library_ms"]})
    # The tier serves in int8 (the mode from_series was given); the
    # launches are those of the quantized serving runs (phases 8 and 14),
    # where the top-k form is on no path (0).
    for name in ("fused_quant_range", "fused_quant_topk"):
        main = qk["int8"]["serving"][name]
        key = "range" if name == "fused_quant_range" else "topk"
        err = max(qk[m][s][key]["max_abs_err"] for m in qk for s in qk[m])
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": qlaunches[name] + plaunches[name],
                        "max_abs_err": err,
                        "ms": main["ms"], "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"],
                        "bound_by": main["bound_by"],
                        "library_ms": main["library_ms"]})
    # Kernels 3, 4 and 7: launches from the engine calls of phases 10 and
    # 14-16.
    for name, key in (("fused_subseq_range", "range"),
                      ("fused_subseq_topk", "topk"),
                      ("fused_quant_subseq_range", "quant")):
        main = sk["subseq_1m"][name]
        errs = [sk[c][k]["max_abs_err"] for c in sk for k in sk[c]
                if k.startswith(key) and isinstance(sk[c][k], dict)
                and "max_abs_err" in sk[c][k]]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": slaunches[name] + plaunches[name],
                        "max_abs_err": max(errs),
                        "ms": main["ms"], "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"],
                        "bound_by": main["bound_by"],
                        "library_ms": main["library_ms"]})
    # The compaction (no TPU kernel: the reference copies the dense
    # layout): launches from phase 5's serving run and phases 14-17's;
    # times at the synth cell's pass shape (phase 6), C the pass's own.
    for name in ("compact_count", "compact_write"):
        main = compact["synth"]["kernels"][name]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": None,
                        "launches": launches[name] + plaunches.get(name, 0),
                        "max_abs_err": main["max_abs_err"],
                        "ms": main["ms"], "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"],
                        "bound_by": main["bound_by"],
                        "library_ms": main["library_ms"]})
    # Kernels 8-9: launches from phase 12's build comparison; 10-12 from
    # phase 13's and phase 16's level-at-a-time searches.  sqdist's figures are at the
    # shape phase 13 gives it (its survivors), phase 12's at 2^20 rows
    # are in the report.
    for name in LEVEL_REPLACES:
        f = dict(lk[name])
        if name == "sqdist":
            f.update({k: sq[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")})
        kernels.append({"name": name, "route": "cuda", "source": LEVEL_SOURCE,
                        "replaces": LEVEL_REPLACES[name],
                        "launches": (blaunches if name in (
                            "linfit_residual_sq", "paa") else
                                     llaunches)[name],
                        "max_abs_err": f["max_abs_err"], "ms": f["ms"],
                        "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
                        "bound_by": f["bound_by"],
                        "library_ms": f["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(report, indent=1, sort_keys=True, default=str))
    print(report["env"]["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
