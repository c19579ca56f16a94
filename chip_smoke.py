#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one GPU

Phases (any failure exits non-zero; nothing falls back to the CPU path or
to a plain version while a GPU is present):

  build    nvcc-builds every kernel of the port from src/repro_torch/csrc,
           one process per source, all at once; prints the build time, the
           compiler's register/spill report per kernel (no sample_clique
           variant may spill) and the card's name and power limit.
  clique   sample_clique kernel vs its plain version on the card: random
           rows at W in {2, 32, 128, 512, 1024, 4096, 8192, 16384}, at
           W = 512 with fills in 1-32 and in 33-64 and with u = 0 and
           weights over 33 decades, and rows gathered from a real engine
           round — all eight outputs bitwise equal.  The fused round
           (sample_clique_round) vs its plain composition (gather,
           sample_clique_plain at width W, commit) on clones of the engine
           state: every state tensor after the round (drop entries aside)
           and the four edge outputs bitwise equal, at rounds of the 64^3
           final attempt (fill_slack 256, W = 512: the first, the first
           with a row of fill > 32, the first with fill > 64, the middle,
           the last) and of a B = 2 batch.
  factor16 the card's factor of grid3d_uniform_16 (nnz-sort, key 0) vs the
           one the port builds on the CPU in this run — col_ptr, rows, vals,
           D, rounds and overflow equal bit for bit.
  main     the main path through the user entry points, launch counts
           reset just before and read just after: Solver().factor of
           grid3d(64,64,64,'uniform',seed=2) (nnz-sort, chunk 256,
           fill_slack 32, strict), then solves of 1 and 8 right-hand sides
           (tol 1e-6, maxiter 500).  Every lane must converge, its true
           residual (float64 edge-list matvec on the host) must agree,
           sample_clique_round (once per engine round, fewer than 5,544)
           and the level sweep ell_sweep_fleet must have launched and the
           standalone sample_clique and the full-row ell_spmv_fleet must
           not.  FactorProbe reads the factor's layer spans: each
           strict attempt (slack, W, rounds run, round of the first
           dropped edge, wall time; a discarded attempt must stop within
           8 rounds of its first overflow) and factor_s split into pools
           and uniforms,
           engine rounds (host ms per round), finalize, schedules and
           admission.  Then one
           1-lane and one 8-lane preconditioner apply of the handle's
           factor against the full-row composition the sweeps replaced
           (ell_spmv_fleet over each row's live slots, the fleet's flen /
           blen, then where(level == lv), each row's level from the
           factor's packed schedules built anew) on the same input:
           bitwise equal, both times printed.  The
           full-row kernel's launches over these two applies are its
           comparison_launches in the kernel table; its launches in that
           row are [main]'s, 0: its own path is [zoo], whose rows carry
           [zoo]'s launches.
  spmv     ell_spmv_fleet kernel vs its plain version at the main path's
           shapes (its forward panels over flen, 1 and 8 lanes, x
           gathered through L1): relative error <= 1e-5, bitwise equal to
           the kernel over all K slots, and a lane alone bitwise equal to
           the same lane inside the 8-lane batch.  ell_sweep_fleet vs its
           plain version at the largest and at an average forward level
           (8 lanes, y interleaved as the apply keeps it): relative error
           <= 1e-5, bitwise equal to the same level on lane-major y, and
           lanes 0 and 5 alone bitwise equal to their lanes of the 8.
  library  the library path through the user entry points, launch counts
           reset just before and read just after: factorize_wavefront of
           the main path's graph with its settings and key (bit-identical to
           the main path's handle factor; its attempts and split printed
           as in main), make_preconditioner (level-sorted
           device schedules), then laplacian_pcg (1 rhs) and
           laplacian_pcg_batched (the same 8 rhs as the main path), tol
           1e-6, maxiter 500.  Every lane must converge with a true residual
           below 1e-4, the level sweeps ell_sweep and ell_sweep_multi must
           have launched once per triangular solve (2 launches an apply,
           1 + iterations applies a solve) and the full-row ell_spmv and
           ell_spmv_multi not at all, and lane 0 of the block, solved alone
           afterwards, must take the same iterates bit for bit.  Then one 1-rhs and one 8-rhs
           apply of the path's preconditioner against the per-level
           full-row composition the sweeps replaced
           (ops.trisolve_panels_full: the slab kernel over each whole
           padded slab, then y[rows] -= Y) on the same input: bitwise
           equal, both times printed.  The full-row kernels' launches over
           these two applies are their comparison_launches in the kernel
           table; their launches there are the library path's, 0.
  slabs    ell_spmv and ell_spmv_multi (8 columns) vs their plain versions
           on level slabs of the library path's schedules (the largest
           forward and backward slabs and a small ragged one): relative
           error <= 1e-5; ell_spmv bitwise equal to ell_spmv_fleet's lane
           on the same slab, and each ell_spmv_multi column bitwise equal to
           ell_spmv of that column.  ell_sweep and ell_sweep_multi (B = 8
           and 11) at the largest, an average and a small ragged forward
           level, one level each (one launch a call): relative error <=
           1e-5 vs their plain versions; ell_sweep bitwise equal to
           ell_sweep_fleet's lane (a
           row-indexed copy of the slab at the panel's full width) and to
           ell_spmv + commit, each ell_sweep_multi column bitwise equal to
           ell_sweep of that column.
  attention the flash_attention path through its entry point, launch
           counts reset just before and read just after, at the attention
           shapes of two configured models in the dtype they serve in —
           qwen3-14b prefill (B=1, 40 q heads over 8 kv heads expanded x5,
           S=4096, d=128, bf16, causal) and a recurrentgemma-2b local layer
           (B=1, 10 heads over 1 kv head expanded, S=2048 = its window,
           d=256, bf16, causal) — and at one float32 non-causal shape (B=1,
           H=40, S=2048, d=128).  Each result must be finite and agree with
           flash_attention_plain on the same inputs: float32 max |diff| <=
           2e-5 max|plain| + 1e-6, bf16 within the bound derived from the
           kernel's rounding of P to bf16 (within_tolerance); the kernel
           must have launched.  scaled_dot_product_attention's distance
           from the plain version is printed beside the kernel's.  A bf16
           result must also agree with the float64 reference of the
           kernel's own numerics (flash_attention_bf16_reference, P
           rounded to bf16) within its output rounding plus the slack of
           its fp32 steps (within_reference), elementwise.
  timing   each kernel, its plain version and (where one exists) one
           PyTorch library call for the same function, timed with CUDA
           events at the main path's shapes (the library path's largest
           forward slab for ell_spmv and ell_spmv_multi, the two bf16
           model shapes for flash_attention, whose library call is
           scaled_dot_product_attention; ell_sweep_fleet at the main
           factor's largest and at an average forward level, 8 lanes on
           interleaved y, with its group width G and the level kernel's
           device time beside the call's (which also holds the solve's
           lane grouping);
           ell_sweep and ell_sweep_multi, 8 columns, at the library
           path's largest and an average forward level, against
           torch.sparse.mm on that level's live slots in CSR, and one
           whole forward triangular solve of each, 1 and 8 columns,
           bitwise equal to the full-row composition and within
           SOLVE_PLAIN_TOL of its plain version, against
           torch.triangular_solve on the factor's lower part in CSR
           (cuSPARSE's triangular solve), beside its bytes bound and the
           design's measured chain time (its levels times one level of
           the walk over a 4,096-level path; not a limit of the card)),
           beside the least time the card
           could take (bytes over 3.35 TB/s, or operations over the peak
           rate, whichever is larger: fp32's 67 TFLOP/s for the solver's
           kernels, the bf16 tensor cores' 989 TFLOP/s for attention, with
           the fp32 figure printed beside it); each kernel's device time
           per launch, from a torch.profiler trace of 20 back-to-back
           launches, beside its CUDA-event mean (which also holds the
           wrapper's host work when that outlasts the kernel); and one
           preconditioner apply of each path on the same factor, with its
           device busy time from a torch.profiler trace of one apply, its
           launches and its sweeps' C calls (2 an apply on either path;
           the library path's 2 launches an apply).
           sample_clique at the rows of the 64^3 final attempt's middle
           round (R = 256, W = 512) and sample_clique_round on the same
           round (the state restored before each call, outside the timed
           span; device time of the kernel alone from a trace), against
           its plain composition, with its bound over the live lanes
           beside the padded-lane bound; and 16 consecutive engine rounds
           from there: wall time, device busy time, idle share.
  serve    the serving stack through its entry points, on the main path's
           Solver (its max_handles raised to 2): a second factor of the
           64^3 graph under key 1 (graph_id g64_k1; sample_clique_round
           once per round), the two handles' bucket keys, the fleet stack's
           bytes per device and the peak device memory; then, launch
           counts reset just before and read just after, a seeded trace of
           12 requests alternating between the two factors (requests 3, 7
           and 11 blocks of 4 right-hand sides, 21 columns; tol 1e-6 and
           1e-4 in alternate pairs, maxiter 500) through a SolveEngine (8
           slots, 8 iterations a tick, with a MetricsRegistry, a Tracer and
           a FlightRecorder) drained by run_until_drained, and the same
           trace as fresh requests through a SolveFrontend over a fresh
           engine on the same cache, awaited on asyncio.  Every request
           must converge and equal a direct handle.solve of its own block
           bit for bit (x, iters, relres), every column's true residual
           must be below 10 tol, each run's EngineStats must count 12
           requests and 21 columns in and out (step_compiles == buckets),
           the rendered repro_engine_completed_total must sum to 24, the
           tracer must hold one trace per request with its stage spans
           summing to its latency, ell_sweep_fleet must have launched and
           no other kernel.  Printed: ticks, tick wall (median, max),
           requests/s and column-iterations/s, latency p50/p99 and queue
           wait p50, and the device busy share of one full tick (8 lanes)
           from a torch.profiler trace.  Last, one apply of 8 lanes of the
           two factors interleaved in fidx ([a, b, a, b, b, a, a, b]): each
           lane bitwise equal to its right-hand side applied alone by its
           handle and to the full-row composition.
  cluster  the solve cluster through its entry points, after the earlier
           phases' device state is released ([main]'s host factor kept):
           SolveCluster with 2 solve replicas and 1 factor-tier replica,
           all on cuda:0, affinity routing, 8 slots, 8 iterations a tick,
           the main path's construction settings (chunk 256, fill_slack
           32, strict) and hot-factor replication above 8 requests/s (1 s
           window, copies live 600 s).  Two 64^3 graphs registered, not
           factored: grid3d(64,64,64,'uniform',seed=2) (nnz-sort) under
           key 0 and the same with seed=3 under key 1.  Launch counts reset
           just before and read just after, a seeded 24-request trace
           (requests 0 and 1 open on the two graphs, the rest 3/4 on the
           first; every fourth a block of 4 right-hand sides, 42 columns;
           tol 1e-6 and 1e-4 alternating, maxiter 500) submitted from a
           pool of 4 threads, the tier worker's first take held until both
           cold placements are queued (so they share one batch, as the
           tests gate it), then the hot copy awaited, then a warm burst of
           8 single right-hand sides on the first graph (tol 1e-6), which
           the two holders split.  Every request must be routed and
           converge, equal a direct handle.solve on the replica that
           served it bit for bit (x, iters), and have true residuals below
           1e-4; each solve replica must serve part of the warm burst; the
           two cold placements must share one tier batch
           (coalesced_factorizations >= 2); the first graph must
           replicate at least once, with adoptions == tier
           factorizations == 2 + replications; every resident factor of
           the first graph (the primary and its copy) must equal [main]'s
           bit for bit (col_ptr, rows, vals, D); step_compiles == buckets
           on each replica; sample_clique_round must launch once per
           engine round of the tier's constructions; ell_sweep_fleet's
           count must equal the launches its callers asked for, tallied
           per thread apart from the counter (one per non-empty level of
           each sweep), and each replica's driver thread must have
           launched it; no other kernel.  Printed: the tier's attempts,
           batches and construction wall, each adoption's wall, requests/s,
           column-iterations/s, latency p50/p99, queue wait p50, the worst
           true residual per tol, the affinity hit rate, per-replica routed
           counts, warm-burst requests and sweep launches, factors and
           fleet bytes, and the peak allocated memory.
  zoo      the preconditioner families through their entry points, after
           [cluster]'s device state is released, on one FactorCache on
           cuda:0; launch counts reset just before and read just after
           items 1-4.  (1) ichol (IC(0)) of [main]'s 64^3 graph with
           [main]'s 1 and 8 right-hand sides and lane 0 of the 8 alone
           (tol 1e-6, maxiter 500): every lane converged with a true
           residual below 1e-4, lane 0 alone bitwise equal to lane 0 of
           the block, only the level sweep ell_sweep_fleet launched; the
           host build time, shift and nnz (read by IcholProbe), levels, panel
           K and solve walls printed.  (2) amg and spai on
           grid3d_uniform_16 and spai on powerlaw_4k (n = 4096, the
           reference's serving scale: both families build a dense n x n
           operator on the host), the same three solves of seeded
           right-hand sides: converged, true residual below 1e-4, lane 0
           alone bitwise equal, and the full-row ell_spmv_fleet's launches
           equal to the applies the solves asked for (1 + the largest
           iteration count of each), no level sweep; build time, K, nnz
           and panel bytes printed.  (3) one SolveEngine (4 slots, 8
           iterations a tick) serving all four families on
           grid3d_uniform_16 at once, one 2-rhs request each: each equal
           to its handle's direct solve bit for bit, buckets == 4 ==
           step_compiles.  (4) --precond auto through
           launch.serve.run_service (suite small, 12 requests, a 12-request
           warm-up after the reference's pass serving every family on every
           graph at every pow2 width): every request converged; the
           selector's picks_by_family and requests/s printed.  The path
           must have launched ell_spmv_fleet, ell_sweep_fleet and
           sample_clique_round (the AC factors) and nothing else.  Then,
           outside the counts, one ichol apply against both solves through
           ell_sweep_fleet_plain (relative error <= 1e-5), and the
           full-row kernel on each spmv panel over its live slots (flen)
           with 8 seeded lanes against ell_spmv_fleet_plain: each side, at
           every (lane, row), within its own summation order's standard
           forward-error bound of the exact float64 row sum
           (spmv.ell_spmv_fleet_error_bounds: the kernel gamma_m sum_k
           |v x| with m = ceil(K/G) + log2 G, G the row's thread group;
           the plain version gamma_K; the worst ratios printed), bitwise
           equal to the kernel over all K slots and to the kernel with x
           gathered through L1 instead of staged in shared memory, each
           lane alone bitwise equal to its lane of the batch; and the amg
           and spai panels of grid3d_uniform_16 stacked under 8
           interleaved lanes (fidx 0, 1, 0, 1, ...): each lane bitwise
           equal to the lane alone and to its lane of its factor's 8-lane
           launch.  [timing] then times the full-row kernel on the amg
           panel of grid3d_uniform_16 and the spai panel of powerlaw_4k
           (8 lanes over flen; 1 lane and the gathers through L1
           printed), beside its plain version, torch.sparse.mm on the
           panel's live slots in CSR (within gamma_K sum_k |v x| of the
           exact row sums, a bound for any order) and the bound of the
           live slots.
  dist     the distributed paths (core.dist on torch.distributed, meshes
           from launch.mesh), after [zoo]'s device state is released.
           (1) NCCL, world size 1, in this process: the 64^3 graph,
           [main]'s factor through make_preconditioner and [main]'s 1-rhs
           b; the communicator set up by one all-reduce first, then,
           launch counts and all-reduces counted from 0 around each,
           sharded_pcg and laplacian_pcg (tol 1e-6, maxiter 500), timed
           in the order A B B A, the first of each checked: x,
           iterations and relres bitwise equal, one all-reduce an
           iteration, the same ell_sweep launches (2 an apply) and no
           other kernel;
           then batched_factorize of keys 0 and 1 (chunk 256, fill_slack
           256: the strict run's final slack, W = 512): key 0's slice,
           compacted by ensemble_factor, equal to [main]'s factor bit for
           bit (col_ptr, rows, vals, D), sample_clique_round launched once
           a round (the keys' longest run, up to the next 8-round check)
           and the standalone sample_clique never.  (2) gloo, world size 4
           on the one card (NCCL refuses two ranks on one card), spawned
           processes over a TCPStore on 127.0.0.1 that must all report
           within 300 s (a rank that fails or exits fails the phase); the
           parent built the kernels in [build] and factors
           grid3d(32,32,32,'uniform',seed=2) (nnz-sort) with [main]'s
           settings and 8 keys non-strict at its final slack.  Each rank:
           the sharded matvec within 2e-4 of the float64 host matvec,
           sharded_pcg (tol 1e-6) converged with x and iterations bitwise
           equal across ranks, batched_factorize of the 8 keys (2 a rank)
           with every rank's state equal and each key's compacted slice
           equal to the parent's single-device factor bit for bit;
           sample_clique_round and ell_sweep (2 launches an apply)
           launched on every rank.  (3)
           examples/torch_quickstart.py, torch_sparsify.py and
           torch_spectral_embedding.py through main() on the card at their
           own sizes: every solve converged, sample_clique_round and the
           sweeps (ell_sweep; ell_sweep_multi for the block solves)
           launched.  Printed: walls, iterations, all-reduce counts and
           sizes, rounds and launches of each part.  The kernel table's
           sample_clique_round and ell_sweep rows carry (1)'s launches as
           dist_launches.

  lm       the LM serving path (repro_torch.models, .configs), after the
           earlier phases' device state is released, TF32 off, with the
           launch counters reset before it and read after it: no kernel of
           the port may launch.  (1) Every smoke config in float32: the same
           CPU-initialized parameters (torch.Generator seed 0) on cuda:0 and
           on the CPU in this run, fwd_train's logits within 1e-3 of the
           largest (1e-2 for recurrentgemma's float32-conditioned RG-LRU)
           and loss_fn within 1e-4 relative; one backward on the card with
           finite gradients that reach the embedding; prefill of 16 tokens
           plus one decode_step against fwd_train at 2e-2 (whisper, whose
           prefill orders cross-attention and MLP unlike its forward in the
           reference too: finite logits).  (2) Every arch at full width in
           bf16, B = 1, depth cut to one period of its pattern (gemma3-27b
           6 layers, recurrentgemma-2b 3, whisper-tiny whole, 4 + 4, the
           rest 2), parameters from init_params on the card (seed 11):
           fwd_train over 4,096 seeded tokens, prefill of the first 3,968,
           then a decode_step at each of the last 128 positions (past
           gemma3's window, around recurrentgemma's rolling buffer); every
           step's logits and prefill's last row within LM_BF16_TOL of
           fwd_train's row (whisper: finite).  (3) qwen3-14b whole (40
           layers, 14.77 B parameters, bf16): prefill of 2 prompts of 2,048
           tokens, 32 greedy decode steps; finite logits, and the first
           step's and prefill's last row within LM_BF16_TOL of fwd_train
           over the 2,049 tokens.  Printed for (2) and (3): prefill ms and
           tokens/s against 2·N·tokens flops at 989 TFLOP/s (N: the
           parameters a token multiplies by), decode ms a step against the
           weight bytes at 3.35 TB/s, peak allocated memory, walls and the
           card.
  train    the LM training path (repro_torch.optim, .checkpoint,
           .distributed.steps, .train, launch/train.py,
           examples/torch_train_lm.py), after [lm]'s device state is
           released, TF32 off, with the launch counters reset before it and
           read after it: no kernel of the port may launch.  (1) The
           reference trainer tests' tiny config (qwen3's smoke family at 2
           layers, d_model 64, vocab 256) in float32, B 4 x S 32, lr 1e-3:
           the same CPU-initialized parameters (Trainer seed 0) and
           adamw_init state on the CPU and on cuda:0 in this run, 5 steps at
           grad_accum 2: each step's loss, ce, aux and gnorm within 1e-5
           relative, the final parameters within 1e-3 of the largest
           |value|; a card Trainer of 30 steps whose CE (every 5 steps)
           decreases; resume on the card: 10 steps against 6 steps, a
           checkpoint, a fresh Trainer restoring it onto the card and 4 more
           steps, with the metrics, parameters and moments bit for bit
           equal; examples/torch_train_lm.py through main() on the card with
           --steps 100 --crash-at 40 (it asserts that CE decreases; it must
           resume at 40); launch/train.py --smoke --steps 4 through main().
           (2) qwen3-14b at full width, depth cut to 2 layers (2.216 B
           parameters, 1.439 B multiplied per token), and (3) mamba2-1.3b
           whole (48 layers, 1.342 B, tied embedding), each as a Trainer
           with bf16 parameters and float32 moments (the reference's train
           layout), grad_accum 2, 3 steps, no checkpoint directory, at B 2 x
           S 4,096 (train_4k's length) and B 2 x S 2,048: finite loss, ce and
           gnorm; every leaf's first moment nonzero; every leaf changed,
           except one whose every |p| is at least 512 * 3 lr (a bf16
           rounding absorbs any AdamW move there: mamba2's D at 1.0); the
           moments float32; step 1's loss within 2e-2 relative of loss_fn of
           the initial parameters on the same batch.  Printed for (2) and
           (3): the step walls (synchronized), the median of steps 2-3,
           tokens/s against 6·N·tokens flops at 989 TFLOP/s (N: the
           parameters a token multiplies by; 71.5 ms and 33.4 ms), peak
           allocated memory, then one more step traced by torch.profiler
           (its wall, the device's busy time and its share of the untraced
           step wall) and the AdamW update alone (synchronized), each
           part's wall and the card.
  mesh     the LM sharding layer (repro_torch.distributed.ctx, the step
           builders and Trainer over DeviceMeshes, launch/dryrun.py), after
           [train]'s device state is released, TF32 off, with the launch
           counters reset before it and read after it: no kernel of the
           port may launch.  (1) NCCL, world 1, a (1, 1) mesh on the card:
           the [train] tiny config's Trainer, 3 steps at grad_accum 2 over
           the mesh, and the qwen3 smoke config's prefill of 16 tokens and
           4 decode steps, each bit for bit equal to mesh=None (metrics,
           parameters, moments, logits).  (2) Gloo, 4 ranks spawned beside
           the one card (their tensors on its host; MESH_RANK_DEVICE gives
           the reason), (2, 2) ("data", "model") and (2, 1, 2) ("pod",
           "data", "model") meshes: qwen3, moonshot, mamba2,
           recurrentgemma, gemma3 and whisper smoke configs in float32, a
           train step at grad_accum 2 and a prefill plus 4 decode steps
           (float32 caches), each against the same run with mesh=None on
           the ranks' device: metrics within 1e-5 relative, parameters
           within 1e-3 of the largest and 2.1 lr each, moments within 1e-3
           (1e-2 recurrentgemma), logits within 1e-4 of the largest; every
           rank's local shards the specs' division.  (3) qwen3-14b at full
           width, 2 of 40 layers, bf16 (init_params on the card, seed 11),
           4 gloo ranks (on the host, as (2)) on a (1, 4) mesh: prefill of
           2 x 512 tokens, then 8 decode steps, logits within LM_BF16_TOL
           of the one-device run on the card; the walls and each rank's
           peak (host resident set) printed: host-bound by gloo, recorded,
           not judged.  (4) Dry runs (started at the
           phase's start, each its own low-priority process, on meta
           tensors over a fake group): qwen3-14b train_4k and decode_32k on
           16x16 and 2x16x16, moonshot train_4k on 16x16; each status ok,
           its per-device peak bytes against the card's memory and its
           compute, memory and collective seconds printed as estimates at
           the H100's datasheet constants.
The build phase also prints the number of HGMMA (wgmma) instructions in
the attention library's SASS, where cuobjdump exists.

The last three lines are the kernel table as JSON (one row per kernel,
two for sample_clique — the standalone rows, then the fused round —,
two for ell_sweep_fleet — the largest forward level, then an average
one —, three for ell_sweep and for ell_sweep_multi — those two levels,
then one whole forward solve —,
two for flash_attention — the qwen3-14b shape, then the
recurrentgemma-2b one — and three for the full-row ell_spmv_fleet: [main]'s
forward panel over flen with [main]'s launches (0) and comparison launches,
then [zoo]'s amg and spai panels, each with [zoo]'s launch count), the card's
name and power limit, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import gc
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_OPS_PER_S = 67e12             # H100 SXM fp32, outside the tensor cores
BF16_TC_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
# the keys of a row of the kernel table
ROW_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
# a row's optional keys: launches made only to compare a kernel with what
# replaced it on the main path, apart from the main path's own count; the
# kernel's launches on [dist]'s world-1 path; and a whole solve's chain
# time (its levels times the walk's measured hand-off)
EXTRA_KEYS = ("comparison_launches", "dist_launches", "chain_ms")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bits(t):
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def bitwise_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and bool(torch.equal(bits(a), bits(b)))


def time_ms(fn, reps: int = 20) -> float:
    """Mean time of ``fn`` in ms by CUDA events after a warm-up call."""
    import torch
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


def permuted(g):
    from repro_torch.core.ordering import ORDERINGS
    perm = ORDERINGS["nnz-sort"](g, seed=0)
    return g.permute(perm).coalesce()


KERNELS = ("sample_clique", "ell_spmv_fleet", "ell_spmv", "ell_spmv_multi",
           "flash_attention")


def phase_build(runtime):
    t0 = time.time()
    reports = runtime.build(KERNELS)
    log(f"[build] {len(KERNELS)} kernels built in {time.time() - t0:.1f}s "
        f"(nvcc, sm_90a, one process each, in parallel)")
    for name, rep in reports.items():
        fn = ""
        for line in rep.splitlines():
            if "Function properties for " in line:
                fn = kernel_name(line.split("Function properties for ")[-1])
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {fn}: {line.strip()}")
            if name == "sample_clique" and "spill stores" in line:
                check(line.strip().split("bytes spill stores")[0]
                      .split(",")[-1].strip() == "0",
                      f"sample_clique {fn} spills: {line.strip()}")
    for name in KERNELS:
        runtime.load(name)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(cuobjdump).exists():
        sass = subprocess.run([cuobjdump, "-sass",
                               str(runtime._lib_path("flash_attention"))],
                              capture_output=True, text=True, timeout=120)
        check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr}")
        hgmma = sum("HGMMA" in line for line in sass.stdout.splitlines())
        log(f"[build] flash_attention SASS: {hgmma} HGMMA instructions")
        check(hgmma > 0, "the attention library has no HGMMA instruction")
    else:
        log("[build] cuobjdump not found: HGMMA count not read")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


def kernel_name(mangled: str) -> str:
    """A kernel's name from ptxas' mangled one: the identifiers it spells
    and its integer template arguments (sample_clique_kernel<16>)."""
    import re
    names, args, i = [], [], 0
    while i < len(mangled):
        m = re.match(r"Li(\d+)E", mangled[i:])           # int template arg
        if m:
            args.append(m.group(1))
            i += len(m.group(0))
            continue
        m = re.match(r"\d+", mangled[i:])                # <length><name>
        if m:
            start = i + len(m.group(0))
            names.append(mangled[start:start + int(m.group(0))])
            i = start + int(m.group(0))
            continue
        i += 1
    name = next((x for x in names if "kernel" in x or "attention" in x),
                names[-1] if names else mangled)
    return name + (f"<{', '.join(args)}>" if args else "")


def clique_rows(ids, ws, fill, u):
    """Kernel vs plain on the same rows; returns the max |diff| of the
    float outputs (0 when bitwise equal) or fails."""
    from repro_torch.kernels import sample_clique as sc
    k = sc.sample_clique(ids, ws, fill, u)
    p = sc.sample_clique_plain(ids, ws, fill, u)
    import torch
    torch.cuda.synchronize()
    for name in k._fields:
        a, b = getattr(k, name), getattr(p, name)
        check(bitwise_equal(a, b.to(a.dtype)),
              f"sample_clique {name} differs from the plain version at "
              f"R={ids.shape[0]} W={ids.shape[1]}")
    return 0.0


def clique_random_rows(dev):
    """Random rows at W = 2 ... 16384 with uniform fills, at W = 512 with
    fills drawn in 1-32 and in 33-64, and at W = 512 with u = 0 and weights
    spread over 33 decades (thresholds equal to S1, sums that round)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    cases = [(W, "uniform fills") for W in (2, 32, 128, 512, 1024, 4096,
                                            8192, 16384)]
    cases += [(512, "fills 1-32"), (512, "fills 33-64"),
              (512, "u = 0, weights 1e-30..1e3")]
    for W, tag in cases:
        R = 256 if W <= 1024 else 16
        lo, hi = {"fills 1-32": (1, 32), "fills 33-64": (33, 64)}.get(
            tag, (0, W))
        fill = rng.integers(lo, hi + 1, R).astype(np.int32)
        ids = rng.integers(0, max(2, W // 2), (R, W)).astype(np.int32)
        ws = rng.uniform(0.1, 3.0, (R, W)).astype(np.float32)
        u = rng.uniform(0.0, 1.0, (R, W)).astype(np.float32)
        if tag.startswith("u = 0"):
            fill = rng.integers(2, 65, R).astype(np.int32)
            ids = rng.integers(0, 256, (R, W)).astype(np.int32)
            ws = (10.0 ** rng.uniform(-30, 3, (R, W))).astype(np.float32)
            u[:] = 0.0
        clique_rows(*(torch.from_numpy(a).to(dev) for a in (ids, ws, fill,
                                                             u)))
        log(f"[clique] random rows R={R} W={W} {tag}: 8/8 outputs bitwise "
            f"equal")


def engine_clone(s):
    return type(s)(*(t.clone() for t in s))


def round_against_plain(s, st, tag: str):
    """The fused round (sample_clique_round) against its plain composition
    (gather, sample_clique_plain at width W, commit) on clones of the
    engine state ``s`` at its next round: every state tensor after the
    round bitwise equal (the drop entries, pool slot P and column n,
    aside: the stages write them and nothing reads them) and the four
    edge outputs bitwise equal.  Returns (live rows, rows with fill > 32,
    rows with fill > 64)."""
    import torch
    from repro_torch.core import parac
    from repro_torch.kernels import sample_clique as sc
    cand, ok = parac._round_ready(s.elim, s.dep, parac._live(s, st),
                                  chunk=st.chunk)
    a, b = engine_clone(s), engine_clone(s)
    got = sc.eliminate_round(a, st, cand, ok)
    want = sc.eliminate_round_plain(b, st, cand, ok)
    torch.cuda.synchronize()
    for name, x, y in zip(a._fields, a, b):
        if x.dim() == 2:
            x, y = x[:, :-1], y[:, :-1]
        check(bitwise_equal(x, y), f"fused round {tag}: state {name} "
                                   f"differs from the plain composition")
    for name, x, y in zip(got._fields, got, want):
        check(bitwise_equal(x, y), f"fused round {tag}: edges {name} "
                                   f"differ from the plain composition")
    fill = torch.where(ok, torch.gather(s.col_fill, 1, cand), 0)
    return (int(ok.sum()), int((fill > 32).sum()), int((fill > 64).sum()))


def fused_rounds_64(dev, g):
    """The fused round against its plain composition at rounds of the 64^3
    final attempt (fill_slack 256, W = 512): the first round, the first
    round with a row of fill > 32, the first with fill > 64, the middle
    one and the last."""
    import numpy as np
    import torch
    from repro_torch.core import parac
    from repro_torch.core.column_math import key_from_seed
    built = parac._build_pool(parac._pool_edges(g, np.float32, dev), 256)
    s, st = parac._init_engine([built], [key_from_seed(0)], n_pad=g.n,
                               P_pad=built.P,
                               W=max(parac._next_pow2(built.dmax), 2),
                               chunk=256)
    want = {"first": False, "fill > 32": False, "fill > 64": False,
            "middle": False, "last": False}
    wide = [0, 0]
    for r in range(g.n + 1):
        cand, ok = parac._round_ready(s.elim, s.dep, parac._live(s, st),
                                      chunk=st.chunk)
        fill = torch.where(ok, torch.gather(s.col_fill, 1, cand), 0)
        live, top, n_elim = torch.stack(
            [ok.sum(), fill.max().long(), s.n_elim[0].long()]).tolist()
        if live == 0:
            break
        tags = [t for t, hit in (("first", r == 0),
                                 ("fill > 32", top > 32),
                                 ("fill > 64", top > 64),
                                 ("middle", r == 749),
                                 ("last", n_elim + live == g.n))
                if hit and not want[t]]
        if tags:
            live, w32, w64 = round_against_plain(s, st, f"64^3 round {r}")
            wide = [wide[0] + w32, wide[1] + w64]
            for t in tags:
                want[t] = True
            log(f"[clique] fused round == plain composition bit for bit: "
                f"64^3 final attempt (W={st.W}) round {r} "
                f"({', '.join(tags)}): {live} live rows, {w32} with fill > "
                f"32, {w64} with fill > 64, max fill {top}")
        parac._engine_round(s, st)
    check(all(want.values()), f"64^3 final attempt: rounds not reached "
                              f"{[t for t, v in want.items() if not v]}")
    check(wide[0] > 0 and wide[1] > 0, "64^3: no checked round held rows "
                                       "of fill > 32 and > 64")


def fused_rounds_batch(dev):
    """The fused round against its plain composition on a B = 2 batch
    (grid3d_uniform_16 and grid2d 64x64, fill_slack 64, padded to a common
    bucket) at rounds over both factors."""
    import numpy as np
    from repro_torch.core import parac
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.data import graphs
    gs = [permuted(graphs.SUITE["grid3d_uniform_16"]()),
          permuted(graphs.grid2d(64, 64, seed=1))]
    built = [parac._build_pool(parac._pool_edges(g, np.float32, dev), 64)
             for g in gs]
    s, st = parac._init_engine(
        built, [key_from_seed(0), key_from_seed(1)],
        n_pad=parac._next_pow2(max(g.n for g in gs)),
        P_pad=parac._next_pow2(max(b.P for b in built)),
        W=max(parac._next_pow2(max(b.dmax for b in built)), 2), chunk=256)
    for r in range(161):
        if r % 40 == 0:
            live, w32, w64 = round_against_plain(s, st, f"B=2 round {r}")
            log(f"[clique] fused round == plain composition bit for bit: "
                f"B=2 (W={st.W}) round {r}: {live} live rows, {w32} with "
                f"fill > 32, {w64} with fill > 64")
        parac._engine_round(s, st)


def phase_clique(dev, g64):
    import numpy as np
    from repro_torch.core import parac
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.data import graphs
    from repro_torch.kernels import sample_clique as sc
    clique_random_rows(dev)
    # rows of a real engine round: grid3d 16^3 after 40 rounds
    g = permuted(graphs.SUITE["grid3d_uniform_16"]())
    built = parac._build_pool(parac._pool_edges(g, np.float32, dev), 32)
    s, st = parac._init_engine([built], [key_from_seed(0)], n_pad=g.n,
                               P_pad=built.P,
                               W=max(parac._next_pow2(built.dmax), 2),
                               chunk=256)
    parac._run_engine_batched(s, st, max_rounds=40)
    cand, ok = parac._round_ready(s.elim, s.dep, parac._live(s, st),
                                  chunk=256)
    ids, ws, fill, u, _, _ = sc.round_gather(s, st, cand, ok)
    clique_rows(ids, ws, fill, u)
    log(f"[clique] engine round 41 of grid3d_uniform_16 (R={ids.shape[0]} "
        f"W={ids.shape[1]}, {int(ok.sum())} live rows): 8/8 outputs "
        f"bitwise equal")
    fused_rounds_64(dev, g64)
    fused_rounds_batch(dev)


def phase_factor16(dev):
    import numpy as np
    from repro_torch.core.parac import factorize_wavefront
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.data import graphs
    g = permuted(graphs.SUITE["grid3d_uniform_16"]())
    kw = dict(chunk=256, fill_slack=32, strict=True)
    t0 = time.time()
    fg = factorize_wavefront(g, key_from_seed(0), device=dev, **kw)
    t1 = time.time()
    fc = factorize_wavefront(g, key_from_seed(0), device="cpu", **kw)
    t2 = time.time()
    for name in ("col_ptr", "rows", "vals", "D"):
        a, b = getattr(fg, name), getattr(fc, name)
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        check(a.shape == b.shape and np.array_equal(a, b),
              f"grid3d_uniform_16 factor: {name} differs card vs CPU")
    for k in ("rounds", "overflow", "fill_slack"):
        check(fg.stats[k] == fc.stats[k],
              f"grid3d_uniform_16 factor: stats[{k}] {fg.stats[k]} (card) "
              f"!= {fc.stats[k]} (CPU)")
    log(f"[factor16] card factor == CPU factor bit for bit: n={g.n} "
        f"nnz={fg.nnz} rounds={fg.stats['rounds']} "
        f"fill_slack={fg.stats['fill_slack']} overflow={fg.stats['overflow']}"
        f" (card {t1 - t0:.2f}s incl. warm-up, CPU {t2 - t1:.2f}s)")


class FactorProbe:
    """Where a factor's time goes, read from the program's own layer
    spans (``repro_torch.obs.tracing``): a tracer is attached to the
    process while the ``with`` block runs, and each strict attempt
    (``parac.attempt``: slack, gather width W, rounds launched, the round
    a frozen graph stopped at, its first dropped edge, wall time) and the
    stages inside it are read back from it.  Stage times are host
    times: nothing synchronizes the card at a stage's ends."""

    def __init__(self):
        self.spans = []

    def __enter__(self):
        from repro_torch.obs import tracing
        self._tracer = tracing.Tracer()
        tracing.attach(self._tracer)
        return self

    def __exit__(self, *exc):
        from repro_torch.obs import tracing
        tracing.detach()
        self.spans = self._tracer.layer_spans()
        return False

    def seconds(self, *names) -> float:
        return sum(s.end - s.start for s in self.spans if s.name in names)

    @property
    def attempts(self) -> list:
        out = []
        for s in sorted((s for s in self.spans if s.name == "parac.attempt"),
                        key=lambda s: s.start):
            a = s.attrs
            out.append(dict(
                fill_slack=a["slack"], W=a["W"], rounds_run=a["launched"],
                first_overflow=a["rounds"] if a["overflow"] else None,
                overflow=a["overflow"], members=a["members"], kept=a["kept"],
                seconds=s.end - s.start))
        return out

    def report(self, tag: str, factor_s: float) -> int:
        """Log the attempts and the split of ``factor_s``; return the
        rounds run."""
        attempts = self.attempts
        rounds = sum(a["rounds_run"] for a in attempts)
        for k, a in enumerate(attempts):
            log(f"[{tag}] attempt {k + 1}: fill_slack={a['fill_slack']} "
                f"W={a['W']} rounds run={a['rounds_run']} first overflow at "
                f"round {a['first_overflow']} (overflow {a['overflow']}) "
                f"wall {a['seconds']:.3f}s")
        by_id = {s.sid: s for s in self.spans}
        sched = self.seconds("trisolve.schedules")
        in_admit = sum(s.end - s.start for s in self.spans
                       if s.name == "trisolve.schedules"
                       and by_id.get(s.parent) is not None
                       and by_id[s.parent].name == "solver.admit")
        pools = self.seconds("parac.pools", "parac.init")
        engine = self.seconds("parac.rounds")
        fin = self.seconds("parac.finalize")
        admission = self.seconds("solver.admit") - in_admit
        other = factor_s - (pools + engine + fin + sched + admission)
        log(f"[{tag}] factor {factor_s:.3f}s = pools and uniforms "
            f"{pools:.3f}s + engine rounds {engine:.3f}s "
            f"({rounds} rounds, host {engine / max(rounds, 1) * 1e3:.3f}"
            f" ms per round) + finalize and compaction {fin:.3f}s + "
            f"schedules {sched:.3f}s + admission {admission:.3f}s + other "
            f"{other:.3f}s (host times of the program's spans)")
        return rounds


def engine_rounds_busy(s, st, k: int = 16):
    """``k`` consecutive engine rounds from the state ``s`` (advanced in
    place): the wall time of an unprofiled run of those rounds from a
    clone of the state, then from one torch.profiler trace of them the
    device busy time and events, the host-issued operations (top-level
    ops on the host) and the three device ops that take the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import parac
    twin = engine_clone(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
        parac._engine_round(twin, st)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    del twin
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(k):
            parac._engine_round(s, st)
        torch.cuda.synchronize()
    events = prof.events()
    busy, n_dev = union_ms([(e.time_range.start, e.time_range.end)
                            for e in events
                            if e.device_type == DeviceType.CUDA])
    host_ops = sum(1 for e in events if e.device_type == DeviceType.CPU
                   and e.cpu_parent is None and e.name.startswith("aten::"))
    by_name = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return dict(wall_ms=wall, busy_ms=busy, device_events=n_dev,
                host_ops=host_ops, top=top)


def log_engine_rounds(tag: str, start: int, r: dict, k: int = 16) -> None:
    idle = ("device time not measured (the trace holds no device event)"
            if r["busy_ms"] is None else
            f"device busy {r['busy_ms']:.3f} ms in {r['device_events']} "
            f"device events, idle share {1 - r['busy_ms'] / r['wall_ms']:.3f}")
    log(f"[{tag}] {k} consecutive engine rounds of the 64^3 final attempt "
        f"from round {start}: wall {r['wall_ms']:.3f} ms "
        f"({r['wall_ms'] / k:.3f} ms per round); {idle}; "
        f"{r['host_ops'] / k:.1f} host-issued ops and "
        f"{r['device_events'] / k:.1f} device events per round")
    log(f"[{tag}] their most expensive device ops: " + "; ".join(
        f"{name[:70]} {ms:.3f} ms" for name, ms in r["top"]))


def true_relres(g, x, b) -> float:
    """||L x - b|| / ||b|| in float64 on the host (edge-list matvec), with
    b projected to mean zero as the solver does."""
    import numpy as np
    from repro_torch.core.laplacian import laplacian_matvec_np
    x = np.asarray(x, np.float64)
    b = np.asarray(b, np.float64)
    b = b - b.mean()
    return float(np.linalg.norm(laplacian_matvec_np(g, x) - b)
                 / np.linalg.norm(b))


def check_early_stop(tag: str, probe: FactorProbe) -> None:
    """Every discarded strict attempt stopped within 8 rounds (one check)
    of its first overflow; the kept one dropped nothing."""
    *discarded, kept = probe.attempts
    for a in discarded:
        first = a["first_overflow"]
        check(first is not None and 0 <= a["rounds_run"] - first < 8,
              f"{tag}: a discarded attempt ran {a['rounds_run']} rounds, "
              f"its first overflow was at round {first}")
    check(kept["overflow"] == 0, f"{tag}: the kept attempt overflowed")


def phase_main(dev, g):
    import numpy as np
    import torch
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.solver import Solver
    from repro_torch.kernels import runtime
    rng = np.random.default_rng(0)
    b1 = rng.normal(size=g.n).astype(np.float32)
    B8 = rng.normal(size=(8, g.n)).astype(np.float32)
    torch.cuda.synchronize()
    runtime.reset_launches()
    t0 = time.time()
    with FactorProbe() as probe:
        solver = Solver(chunk=256, fill_slack=32, strict=True, device=dev)
        h = solver.factor(g, key_from_seed(0))
        torch.cuda.synchronize()
    t_factor = time.time() - t0
    rounds_run = probe.report("main", t_factor)
    check_early_stop("main path", probe)
    f = h.factor
    t0 = time.time()
    r1 = solver.solve(torch.from_numpy(b1).to(dev), tol=1e-6, maxiter=500)
    torch.cuda.synchronize()
    t_solve1 = time.time() - t0
    t0 = time.time()
    r8 = solver.solve(torch.from_numpy(B8).to(dev), tol=1e-6, maxiter=500)
    torch.cuda.synchronize()
    t_solve8 = time.time() - t0
    launches = dict(runtime.LAUNCHES)
    log(f"[main] grid3d 64^3 n={g.n} m={g.m}: factor {t_factor:.2f}s "
        f"rounds={f.stats['rounds']} fill_slack={f.stats['fill_slack']} "
        f"overflow={f.stats['overflow']} nnz={f.nnz} "
        f"levels fwd={h.n_levels_fwd} bwd={h.n_levels_bwd} "
        f"K fwd={h.fleet.Kf} bwd={h.fleet.Kb}")
    it8 = r8.iters.cpu().numpy()
    log(f"[main] solve 1 rhs {t_solve1:.2f}s iters={int(r1.iters)} "
        f"relres={float(r1.relres):.3e}; solve 8 rhs {t_solve8:.2f}s "
        f"iters={it8.min()}..{it8.max()} "
        f"max relres={float(r8.relres.max()):.3e}")
    log(f"[main] launches: {launches}")
    check(bool(r1.converged) and bool(r8.converged.all()),
          "main path: a lane did not converge")
    xs = [r1.x.cpu().numpy()] + list(r8.x.cpu().numpy())
    bs = [b1] + list(B8)
    for x, b in zip(xs, bs):
        check(np.all(np.isfinite(x)) and x.shape == (g.n,),
              "main path: non-finite or misshapen solution")
        rr = true_relres(g, x, b)
        check(rr < 1e-4, f"main path: true residual {rr:.2e} of a "
                         f"converged lane")
    for name in ("sample_clique_round", "ell_sweep_fleet"):
        check(launches.get(name, 0) > 0,
              f"main path never launched the {name} kernel")
    check(launches.get("sample_clique_round", 0) == rounds_run,
          "main path: sample_clique_round did not launch once per round")
    check(launches.get("sample_clique_round", 0) < 5544,
          "main path: the factor launched as many eliminations as before "
          "the early stop (5,544)")
    for name in ("sample_clique", "ell_spmv_fleet"):
        check(launches.get(name, 0) == 0,
              f"main path launched the {name} kernel, which it no longer "
              f"uses")
    full_row = apply_against_full_row(dev, h)
    return dict(solver=solver, handle=h, launches=launches,
                full_row_launches=full_row, t_factor=t_factor,
                t_solve1=t_solve1, t_solve8=t_solve8, graph=g, b1=b1, B8=B8,
                r1=r1, r8=r8)


def full_row_apply(h, levels, fidx, R):
    """One preconditioner apply through the full-row composition that the
    level sweeps replaced: per level ell_spmv_fleet over every row's live
    slots (the fleet's flen / blen), then where(level_of == lv, y - Y, y).
    ``levels`` is the handle's (forward, backward) level per row."""
    from repro_torch.kernels import ops
    fl = h.fleet
    fa = fl.arrays
    f = fidx.long()
    L = R.shape[0]
    Y = ops.trisolve_fleet_masked(fa.fcols, fa.fvals, fidx,
                                  levels[0].expand(L, -1), R,
                                  n_levels=fl.f_levels,
                                  lane_levels=fa.fnlv[f], lens=fa.flen)
    return ops.trisolve_fleet_masked(fa.bcols, fa.bvals, fidx,
                                     levels[1].expand(L, -1),
                                     Y * fa.dinv[f], n_levels=fl.b_levels,
                                     lane_levels=fa.bnlv[f], lens=fa.blen)


def apply_against_full_row(dev, h):
    """A 1-lane and an 8-lane apply of the handle's factor through the
    level sweeps, each bitwise equal to the full-row composition on the
    same input, with each row's level taken from the factor's packed
    schedules built anew (the fleet keeps only the level row lists).
    Returns the launch counts over the two full-row applies (reset just
    before; these are comparison launches, not the main path's)."""
    import torch
    from repro_torch.core.pcg import fleet_precondition
    from repro_torch.core.trisolve import build_schedules_batched
    from repro_torch.kernels import runtime
    fl = h.fleet
    fwd, bwd = build_schedules_batched([h.factor.to_device(dev)])[0]
    levels = (fwd.level_of[None], bwd.level_of[None])
    gen = torch.Generator(device=dev).manual_seed(3)
    runs = []
    for L in (1, 8):
        R = torch.zeros((L, h.n_pad), device=dev)
        R[:, :h.n] = torch.randn((L, h.n), generator=gen, device=dev)
        runs.append((L, R, torch.full((L,), h.fleet_row, dtype=torch.int32,
                                      device=dev)))
    torch.cuda.synchronize()
    runtime.reset_launches()
    for L, R, fidx in runs:
        t0 = time.time()
        f_plan, b_plan = h.plans()
        new = fleet_precondition(fl.arrays, fidx, R, f_plan=f_plan,
                                 b_plan=b_plan)
        torch.cuda.synchronize()
        t_new = time.time() - t0
        t0 = time.time()
        old = full_row_apply(h, levels, fidx, R)
        torch.cuda.synchronize()
        t_old = time.time() - t0
        check(bitwise_equal(new, old),
              f"main path: the {L}-lane apply through the level sweeps "
              f"differs from the full-row composition")
        log(f"[main] {L}-lane apply: level sweeps {t_new * 1e3:.2f} ms == "
            f"full-row composition {t_old * 1e3:.2f} ms, bit for bit")
    launches = dict(runtime.LAUNCHES)
    log(f"[main] launches over the two applies: {launches}")
    return launches


def phase_spmv(dev, h):
    import torch
    from repro_torch.kernels import ops, spmv
    fa = h.fleet.arrays
    n_pad = h.n_pad
    gen = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((8, n_pad), generator=gen, device=dev)
    fidx8 = torch.full((8,), h.fleet_row, dtype=torch.int32, device=dev)
    worst = 0.0
    for L in (1, 8):
        y = spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx8[:L], X[:L],
                                fa.flen)
        p = spmv.ell_spmv_fleet_plain(fa.fcols, fa.fvals, fidx8[:L], X[:L],
                                      fa.flen)
        y_all = spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx8[:L], X[:L])
        torch.cuda.synchronize()
        err = float((y - p).abs().max())
        rel = err / max(float(p.abs().max()), 1e-30)
        check(rel <= 1e-5, f"ell_spmv_fleet L={L}: relative error {rel:.2e}")
        check(bitwise_equal(y, y_all),
              f"ell_spmv_fleet L={L}: the live slots (flen) differ from "
              f"all K slots")
        worst = max(worst, err)
        log(f"[spmv] L={L} R={n_pad} K={fa.fcols.shape[2]}: max abs err "
            f"{err:.3e} (relative {rel:.2e}); over flen == over all K, bit "
            f"for bit")
    y1 = spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx8[:1], X[:1].clone(),
                             fa.flen)
    y8 = spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx8, X, fa.flen)
    for lane in range(8):
        yl = spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx8[:1],
                                 X[lane:lane + 1].contiguous(), fa.flen)
        check(bitwise_equal(yl[0], y8[lane]),
              f"ell_spmv_fleet: lane {lane} alone differs from the same "
              f"lane in the 8-lane batch")
    check(bitwise_equal(y1[0], y8[0]), "ell_spmv_fleet: lane 0 differs")
    log("[spmv] each of 8 lanes alone == the same lane in the 8-lane batch, "
        "bit for bit")
    sweep_worst = 0.0
    for tag, lv in sweep_levels(h).items():
        sw = sweep_call(h, lv, X)
        Yk, Yp = ops.interleaved(X), X.clone()
        sw(spmv.ell_sweep_fleet, Yk)
        sw(spmv.ell_sweep_fleet_plain, Yp)
        Ylm = X.clone()
        sw(spmv.ell_sweep_fleet, Ylm)
        torch.cuda.synchronize()
        err = float((Yk - Yp).abs().max())
        rel = err / max(float(Yp.abs().max()), 1e-30)
        check(rel <= 1e-5, f"ell_sweep_fleet {tag} level {lv}: relative "
                           f"error {rel:.2e}")
        check(bitwise_equal(Yk, Ylm), f"ell_sweep_fleet {tag} level {lv}: "
                                      f"interleaved y differs from "
                                      f"lane-major")
        for lane in (0, 5):
            one = X[lane:lane + 1].clone()
            sweep_call(h, lv, one)(spmv.ell_sweep_fleet, one)
            check(bitwise_equal(one[0], Yk[lane]),
                  f"ell_sweep_fleet {tag} level {lv}: lane {lane} alone "
                  f"differs from the same lane of 8")
        sweep_worst = max(sweep_worst, err)
        k = int(level_entry(h, lv)[0, 2])
        log(f"[spmv] ell_sweep_fleet L=8 {tag} forward level {lv} (level_k "
            f"{k}, G {spmv.group_width(k)}): max abs err {err:.3e} "
            f"(relative {rel:.2e}) vs its plain version; interleaved == "
            f"lane-major and each lane alone == its lane of 8, bit for bit")
    return dict(full_row=worst, sweep=sweep_worst)


def sweep_levels(h):
    """The handle's largest forward level and an average one (the level
    whose row count is nearest the mean over levels 1 ..)."""
    import numpy as np
    start = h.fleet.arrays.fstart[h.fleet_row].cpu().numpy()
    counts = np.diff(start[:h.n_levels_fwd + 1])[1:]
    largest = int(np.argmax(counts)) + 1
    average = int(np.argmin(np.abs(counts - counts.mean()))) + 1
    return {"largest": largest, "average": average}


def level_entry(h, lv: int):
    """The forward plan's entry of level ``lv`` alone (one launch):
    (level, row count bound, longest live row)."""
    plan = h.fleet.f_plan
    only = plan[plan[:, 0] == lv]
    check(only.shape[0] == 1, f"level {lv} is not in the forward plan")
    return only


def sweep_call(h, lv, Y):
    """fn(kernel_or_plain, y): one forward level ``lv`` of the handle's
    factor, in place on ``y`` ``[L, n_pad]`` (every lane the handle's;
    lane-major or interleaved)."""
    import torch
    fa = h.fleet.arrays
    only = level_entry(h, lv)
    fidx = torch.full((Y.shape[0],), h.fleet_row, dtype=torch.int32,
                      device=Y.device)
    return lambda fn, y: fn(fa.fcols, fa.fvals, fa.flen, fa.frows, fa.fstart,
                            fidx, y, only)


def phase_library(dev, main):
    import numpy as np
    import torch
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.parac import factorize_wavefront
    from repro_torch.core.pcg import laplacian_pcg, laplacian_pcg_batched
    from repro_torch.core.trisolve import make_preconditioner
    from repro_torch.kernels import runtime
    g, b1, B8 = main["graph"], main["b1"], main["B8"]
    torch.cuda.synchronize()
    runtime.reset_launches()
    t0 = time.time()
    with FactorProbe() as probe:
        f = factorize_wavefront(g, key_from_seed(0), chunk=256,
                                fill_slack=32, strict=True, device=dev)
        torch.cuda.synchronize()
    t_factor = time.time() - t0
    probe.report("library", t_factor)
    check_early_stop("library path", probe)
    t0 = time.time()
    apply = make_preconditioner(f)
    torch.cuda.synchronize()
    t_prec = time.time() - t0
    t0 = time.time()
    r1 = laplacian_pcg(g, apply, torch.from_numpy(b1).to(dev), tol=1e-6,
                       maxiter=500)
    torch.cuda.synchronize()
    t_solve1 = time.time() - t0
    t0 = time.time()
    r8 = laplacian_pcg_batched(g, lambda R: apply(R.T).T,
                               torch.from_numpy(B8).to(dev), tol=1e-6,
                               maxiter=500)
    torch.cuda.synchronize()
    t_solve8 = time.time() - t0
    launches = dict(runtime.LAUNCHES)
    # lane independence on the card: lane 0 of the block, solved alone
    r0 = laplacian_pcg(g, apply, torch.from_numpy(B8[0]).to(dev), tol=1e-6,
                       maxiter=500)
    check(int(r0.iters) == int(r8.iters[0])
          and bitwise_equal(r0.x, r8.x[0]),
          "library path: lane 0 of the 8-rhs solve differs from the same "
          "rhs solved alone")
    hf = main["handle"].factor
    for name in ("col_ptr", "rows", "vals", "D"):
        a, b = getattr(f, name), getattr(hf, name)
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        check(a.shape == b.shape and np.array_equal(a, b),
              f"library path: factorize_wavefront's {name} differs from the "
              f"main path's handle factor")
    it1, it8 = int(r1.iters), r8.iters.cpu().numpy()
    m1, m8 = int(main["r1"].iters), main["r8"].iters.cpu().numpy()
    log(f"[library] factorize_wavefront {t_factor:.2f}s == main path's "
        f"handle factor bit for bit (nnz={f.nnz}, rounds="
        f"{f.stats['rounds']}, fill_slack={f.stats['fill_slack']}); "
        f"make_preconditioner {t_prec:.2f}s")
    log(f"[library] solve 1 rhs {t_solve1:.2f}s iters={it1} (main path "
        f"{main['t_solve1']:.2f}s, {m1}) relres={float(r1.relres):.3e}; "
        f"solve 8 rhs {t_solve8:.2f}s iters={it8.min()}..{it8.max()} (main "
        f"path {main['t_solve8']:.2f}s, {m8.min()}..{m8.max()}) max relres="
        f"{float(r8.relres.max()):.3e}")
    log(f"[library] launches: {launches}; ell_sweep per 1-rhs apply "
        f"{launches.get('ell_sweep', 0) / (it1 + 1):.1f}, ell_sweep_multi "
        f"per 8-rhs apply "
        f"{launches.get('ell_sweep_multi', 0) / (it8.max() + 1):.1f}")
    log("[library] lane 0 of the 8-rhs solve == the same rhs solved alone, "
        "bit for bit (x and iterations)")
    check(bool(r1.converged) and bool(r8.converged.all()),
          "library path: a lane did not converge")
    xs = [r1.x.cpu().numpy()] + list(r8.x.cpu().numpy())
    for x, b in zip(xs, [b1] + list(B8)):
        check(np.all(np.isfinite(x)) and x.shape == (g.n,),
              "library path: non-finite or misshapen solution")
        rr = true_relres(g, x, b)
        check(rr < 1e-4, f"library path: true residual {rr:.2e} of a "
                         f"converged lane")
    # one launch per triangular solve: two an apply, and a PCG applies
    # its preconditioner once before its first iteration and once in each
    for name, applies in (("ell_sweep", it1 + 1),
                          ("ell_sweep_multi", int(it8.max()) + 1)):
        check(launches.get(name, 0) == 2 * applies,
              f"library path: {launches.get(name, 0)} launches of {name}, "
              f"not 2 for each of its {applies} applies")
    for name in ("ell_spmv", "ell_spmv_multi"):
        check(launches.get(name, 0) == 0,
              f"library path launched the full-row {name} kernel")
    fwd, bwd, full_row = library_against_full_row(dev, f, apply)
    return dict(factor=f, launches=launches, full_row_launches=full_row,
                fwd=fwd, bwd=bwd, t_factor=t_factor, t_prec=t_prec,
                t_solve1=t_solve1, t_solve8=t_solve8)


def library_against_full_row(dev, f, apply):
    """A 1-rhs and an 8-rhs apply of the library path's preconditioner
    (``apply``, the level sweeps), each bitwise equal to the per-level
    full-row composition the sweeps replaced (ops.trisolve_panels_full:
    ell_spmv / ell_spmv_multi over each whole padded slab, then
    y[rows] -= Y) on the factor's schedules built anew, on the same input.
    Returns the schedules and the launch counts over the two full-row
    applies (reset just before; comparison launches, not the path's)."""
    import torch
    from repro_torch.core.trisolve import build_schedules_device
    from repro_torch.kernels import ops, runtime
    fwd, bwd = build_schedules_device(f)
    D = f.to_device().D
    # the D^-1 scale of make_preconditioner_from_schedules
    dinv = torch.where(D > 0, 1.0 / torch.where(D > 0, D, 1.0), 0.0)

    def full_row(r):
        y = ops.trisolve_panels_full(fwd, r)
        return ops.trisolve_panels_full(
            bwd, y * (dinv if y.dim() == 1 else dinv[:, None]), flip=True)

    gen = torch.Generator(device=dev).manual_seed(4)
    runs = [torch.randn(shape, generator=gen, device=dev)
            for shape in ((f.n,), (f.n, 8))]
    torch.cuda.synchronize()
    runtime.reset_launches()
    for r in runs:
        tag = "1-rhs" if r.dim() == 1 else "8-rhs"
        t0 = time.time()
        new = apply(r)
        torch.cuda.synchronize()
        t_new = time.time() - t0
        t0 = time.time()
        old = full_row(r)
        torch.cuda.synchronize()
        t_old = time.time() - t0
        check(bitwise_equal(new, old),
              f"library path: the {tag} apply through the level sweeps "
              f"differs from the full-row composition")
        log(f"[library] {tag} apply: level sweeps {t_new * 1e3:.2f} ms == "
            f"full-row composition {t_old * 1e3:.2f} ms, bit for bit")
    launches = dict(runtime.LAUNCHES)
    log(f"[library] launches over the two applies: {launches}")
    return fwd, bwd, launches


def pick_level(sched, which: str) -> int:
    """A level >= 1 of the schedule: the one with the most rows
    ("largest"), the one whose row count is nearest the mean over levels
    1 .. ("average"), or a small ragged one ("ragged": 2 to 63 rows, not a
    multiple of 8; else the smallest)."""
    import numpy as np
    sizes = np.diff(sched.row_ptr)
    lv = np.arange(sizes.size)
    live = (lv >= 1) & (sizes > 0)
    if which == "largest":
        return int(lv[live][np.argmax(sizes[live])])
    if which == "average":
        pool = lv[live]
        return int(pool[np.argmin(np.abs(sizes[pool] - sizes[pool].mean()))])
    ragged = live & (sizes > 1) & (sizes < 64) & (sizes % 8 != 0)
    pool = lv[ragged] if ragged.any() else lv[live]
    return int(pool[np.argmin(sizes[pool])])


def slab_rows(sched, which: str):
    """(lo, hi) of the slab of pick_level(sched, which)."""
    lv = pick_level(sched, which)
    return int(sched.row_ptr[lv]), int(sched.row_ptr[lv + 1])


def level_plan(sched, lv: int):
    """The sweep plan of level ``lv`` alone (one launch)."""
    plan = sched.plan[sched.plan[:, 0] == sched.row_ptr[lv]]
    check(plan.shape[0] == 1, f"level {lv} is not in the sweep plan")
    return plan


def fleet_lane_of_level(sched, lv, y):
    """Level ``lv`` swept by ell_sweep_fleet, one lane, on a row-indexed
    copy of the level's slab at the panel's full width: returns the swept
    copy of ``y``."""
    import numpy as np
    import torch
    from repro_torch.kernels import spmv
    dev = y.device
    lo, hi = int(sched.row_ptr[lv]), int(sched.row_ptr[lv + 1])
    rows = sched.row_ids[lo:hi].long()
    cols = torch.zeros((1, sched.n, sched.K), dtype=torch.int32, device=dev)
    vals = torch.zeros((1, sched.n, sched.K), device=dev)
    lens = torch.zeros((1, sched.n), dtype=torch.int32, device=dev)
    cols[0, rows], vals[0, rows] = sched.cols[lo:hi], sched.vals[lo:hi]
    lens[0, rows] = sched.row_len[lo:hi]
    starts = torch.as_tensor(sched.row_ptr.astype("int32"), device=dev)[None]
    only = np.array([[lv, hi - lo, sched.level_k[lv]]], np.int32)
    out = y[None].clone()
    spmv.ell_sweep_fleet(cols, vals, lens, sched.row_ids[None].contiguous(),
                         starts, torch.zeros(1, dtype=torch.int32, device=dev),
                         out, only)
    return out[0]


def phase_slabs(dev, lib):
    import torch
    from repro_torch.kernels import spmv
    fwd, bwd = lib["fwd"], lib["bwd"]
    log(f"[slabs] device schedules: fwd levels={fwd.n_levels} K={fwd.K}, "
        f"bwd levels={bwd.n_levels} K={bwd.K}")
    n = fwd.n
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(n, generator=gen, device=dev)
    X = torch.randn((n, 8), generator=gen, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    worst = {"ell_spmv": 0.0, "ell_spmv_multi": 0.0}
    for sched, tag, which in ((fwd, "fwd", "largest"), (bwd, "bwd",
                                                        "largest"),
                              (fwd, "fwd", "ragged")):
        lo, hi = slab_rows(sched, which)
        c, v = sched.cols[lo:hi], sched.vals[lo:hi]
        y = spmv.ell_spmv(c, v, x)
        Y = spmv.ell_spmv_multi(c, v, X)
        for name, k, p in (("ell_spmv", y, spmv.ell_spmv_plain(c, v, x)),
                           ("ell_spmv_multi", Y,
                            spmv.ell_spmv_multi_plain(c, v, X))):
            torch.cuda.synchronize()
            err = float((k - p).abs().max())
            rel = err / max(float(p.abs().max()), 1e-30)
            check(rel <= 1e-5, f"{name} {tag} {which} slab: relative error "
                               f"{rel:.2e}")
            worst[name] = max(worst[name], err)
            log(f"[slabs] {name} {tag} {which} slab R={hi - lo} K={sched.K}: "
                f"max abs err {err:.3e} (relative {rel:.2e})")
        lane = spmv.ell_spmv_fleet(c[None], v[None], zero, x[None])[0]
        check(bitwise_equal(y, lane), f"ell_spmv differs from the fleet "
                                      f"kernel's lane on the {tag} slab")
        for b in range(8):
            check(bitwise_equal(Y[:, b], spmv.ell_spmv(c, v,
                                                       X[:, b].contiguous())),
                  f"ell_spmv_multi column {b} differs from ell_spmv on the "
                  f"{tag} slab")
    log("[slabs] ell_spmv == ell_spmv_fleet's lane and each ell_spmv_multi "
        "column == ell_spmv of that column, bit for bit, on every slab")
    sweep_worst = sweep_slabs(dev, fwd)
    return dict(fwd=fwd, bwd=bwd, worst={**worst, **sweep_worst})


def sweep_slabs(dev, fwd):
    """ell_sweep and ell_sweep_multi at the largest, an average and a small
    ragged forward level, one level alone each (one launch a call, its
    walk tables built for the call): against their plain
    versions (relative error <= 1e-5 over the level's rows), ell_sweep
    bitwise against ell_sweep_fleet's lane and against ell_spmv followed
    by y[rows] -= Y, and each ell_sweep_multi column (B = 8 and B = 11)
    bitwise against ell_sweep of that column.  Returns each kernel's
    largest |error| against its plain version."""
    import torch
    from repro_torch.kernels import runtime, spmv
    gen = torch.Generator(device=dev).manual_seed(2)
    args = (fwd.cols, fwd.vals, fwd.row_len, fwd.row_ids)
    worst = {"ell_sweep": 0.0, "ell_sweep_multi": 0.0}
    for which in ("largest", "average", "ragged"):
        lv = pick_level(fwd, which)
        plan = level_plan(fwd, lv)
        walk = spmv.sweep_walk(plan, dev)
        lo, hi = int(fwd.row_ptr[lv]), int(fwd.row_ptr[lv + 1])
        rows = fwd.row_ids[lo:hi].long()
        other = torch.ones(fwd.n, dtype=torch.bool, device=dev)
        other[rows] = False
        for B in (None, 8, 11):
            name = "ell_sweep" if B is None else "ell_sweep_multi"
            y0 = torch.randn((fwd.n,) if B is None else (fwd.n, B),
                             generator=gen, device=dev)
            got, want = y0.clone(), y0.clone()
            before = runtime.LAUNCHES.get(name, 0)
            getattr(spmv, name)(*args, got, walk)
            check(runtime.LAUNCHES.get(name, 0) == before + 1,
                  f"{name} {which} level {lv}: not one launch")
            spmv.ell_sweep_plain(*args, want, plan)
            torch.cuda.synchronize()
            err = float((got[rows] - want[rows]).abs().max())
            rel = err / max(float(want[rows].abs().max()), 1e-30)
            check(rel <= 1e-5, f"{name} B={B} {which} forward level {lv}: "
                               f"relative error {rel:.2e}")
            check(bitwise_equal(got[other], y0[other]),
                  f"{name} {which} level {lv} changed rows of other levels")
            worst[name] = max(worst[name], err)
            log(f"[slabs] {name} B={B or 1} {which} forward level {lv} "
                f"rows={hi - lo} level_k={int(fwd.level_k[lv])}: max abs "
                f"err {err:.3e} (relative {rel:.2e}) vs its plain version")
            if B is None:
                lane = fleet_lane_of_level(fwd, lv, y0)
                check(bitwise_equal(got, lane),
                      f"ell_sweep differs from ell_sweep_fleet's lane at "
                      f"the {which} forward level {lv}")
                full = y0.clone()
                full[rows] -= spmv.ell_spmv(fwd.cols[lo:hi], fwd.vals[lo:hi],
                                            y0)
                check(bitwise_equal(got, full),
                      f"ell_sweep differs from ell_spmv + commit at the "
                      f"{which} forward level {lv}")
            else:
                for b in range(B):
                    col = y0[:, b].contiguous()
                    spmv.ell_sweep(*args, col, walk)
                    check(bitwise_equal(got[:, b], col),
                          f"ell_sweep_multi B={B} column {b} differs from "
                          f"ell_sweep at the {which} forward level {lv}")
    log("[slabs] ell_sweep == ell_sweep_fleet's lane == ell_spmv + commit, "
        "and each ell_sweep_multi column (B = 8, 11) == ell_sweep of that "
        "column, bit for bit, at every level")
    return worst


# (tag, B, q heads, kv heads, S, d, dtype, causal) of the [attention] phase;
# the first two are the model shapes the timing rows use
ATTENTION_SHAPES = (
    ("qwen3-14b prefill", 1, 40, 8, 4096, 128, "bfloat16", True),
    ("recurrentgemma-2b local", 1, 10, 1, 2048, 256, "bfloat16", True),
    ("float32 non-causal", 1, 40, 40, 2048, 128, "float32", False),
)


def attention_inputs(dev, shape, seed: int):
    """q ``[B, H, S, d]`` and k, v made for ``kv heads`` and expanded to H
    (each kv head serves H / kv consecutive q heads), from ``seed``."""
    import torch
    _, B, H, Hkv, S, d, dtype, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((B, H, S, d), generator=gen, device=dev).to(dt)
    k, v = (torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(dt)
            .repeat_interleave(H // Hkv, dim=1) for _ in range(2))
    return q, k, v


def within_tolerance(got, want, v):
    """(ok, max |diff|) of the kernel's output ``got`` against the plain
    version's ``want`` on the same inputs.

    float32: max |diff| <= 2e-5 max|want| + 1e-6 (the same products and
    sums in another order).

    bfloat16: elementwise
        |got - want| <= u (|got| + |want|) + (u + (S + d) 2**-24) max|v|
    with u = 2**-8, the unit roundoff of bf16, and max|v| over the (batch,
    head).  The kernel rounds P to bf16 before P V and keeps the row sums
    l in fp32: each p_c moves by at most u p_c and the weights p_c / l sum
    to 1, so the output moves by at most u max|v|.  Each side rounds its
    fp32 output to bf16 once, at most u |o| (u (|got| + |want|) bounds
    both, to first order).  The fp32 sums of the d-term scores and of the
    S-term rows, taken in another order on each side, add at most
    (S + d) 2**-24 of max|v|.  Where a row's softmax spreads over
    thousands of keys, |o| is far below max|v| and this bound is loose:
    within_reference holds the kernel to its own numerics as well."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    if got.dtype == torch.float32:
        return err <= 2e-5 * float(w.abs().max()) + 1e-6, err
    u = 2.0 ** -8
    S, d = v.shape[-2:]
    vmax = v.float().abs().amax(dim=(-2, -1), keepdim=True)
    tol = u * (g.abs() + w.abs()) + (u + (S + d) * 2.0 ** -24) * vmax
    return bool((diff <= tol).all()), err


def within_reference(got, q, k, v, causal):
    """(ok, max |diff|, largest |diff| / bound) of the bf16 kernel's output
    against the float64 reference of its own numerics
    (flash_attention_bf16_reference: P rounded to bf16 as the kernel
    rounds it), elementwise |got - o| <= 2**-8 |got| + slack: the output's
    rounding to bf16 plus the slack that the reference derives from the
    kernel's fp32 steps (score sums, ex2.approx, the running maxima, a
    rounding of P that may flip within that error, the fp32 sums of P·V
    and l)."""
    from repro_torch.kernels import flash_attention as fa
    o, slack = fa.flash_attention_bf16_reference(q, k, v, causal=causal)
    g = got.double()
    diff = (g - o).abs()
    tol = 2.0 ** -8 * g.abs() + slack
    return (bool((diff <= tol).all()), float(diff.max()),
            float((diff / tol).max()))


def phase_attention(dev):
    """The flash_attention path: its entry point at the model shapes,
    launch counts reset just before and read just after, each result held
    against the plain version on the same inputs."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import runtime
    inputs = [attention_inputs(dev, shape, seed)
              for seed, shape in enumerate(ATTENTION_SHAPES)]
    torch.cuda.synchronize()
    runtime.reset_launches()
    t0 = time.time()
    outs = [fa.flash_attention(q, k, v, causal=shape[7])
            for shape, (q, k, v) in zip(ATTENTION_SHAPES, inputs)]
    torch.cuda.synchronize()
    t_path = time.time() - t0
    launches = dict(runtime.LAUNCHES)
    errs = []
    for shape, (q, k, v), o in zip(ATTENTION_SHAPES, inputs, outs):
        tag, B, H, Hkv, S, d, dtype, causal = shape
        check(o.shape == q.shape and o.dtype == q.dtype
              and bool(torch.isfinite(o.float()).all()),
              f"flash_attention {tag}: non-finite or misshapen output")
        p = fa.flash_attention_plain(q, k, v, causal=causal)
        lib = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal)
        torch.cuda.synchronize()
        ok, err = within_tolerance(o, p, v)
        lib_ok, lib_err = within_tolerance(lib, p, v)
        rel = err / max(float(p.float().abs().max()), 1e-30)
        log(f"[attention] {tag} B={B} H={H} (kv heads {Hkv}) S={S} d={d} "
            f"{dtype} causal={causal}: max abs err {err:.3e} (relative "
            f"{rel:.2e}) vs flash_attention_plain; "
            f"scaled_dot_product_attention {lib_err:.3e} (within the "
            f"bound: {lib_ok})")
        check(ok, f"flash_attention {tag}: kernel differs from the plain "
                  f"version beyond the tolerance (max abs err {err:.3e})")
        if o.dtype == torch.bfloat16:
            ok, ref_err, ratio = within_reference(o, q, k, v, causal)
            log(f"[attention] {tag}: max abs err {ref_err:.3e} vs the "
                f"float64 reference of the bf16 kernel's numerics, at most "
                f"{ratio:.3f} of its elementwise bound")
            check(ok, f"flash_attention {tag}: kernel differs from the "
                      f"reference of its own numerics beyond the bound "
                      f"(max abs err {ref_err:.3e}, {ratio:.3f} of the "
                      f"bound)")
        errs.append(err)
    log(f"[attention] {len(outs)} calls in {t_path:.2f}s; launches: "
        f"{launches}")
    check(launches.get("flash_attention", 0) == len(outs),
          "the attention path did not launch the flash_attention kernel "
          "once per call")
    return dict(inputs=inputs, errs=errs, launches=launches)


def attention_timing(dev, attn):
    """Timing rows of flash_attention at the two bf16 model shapes, with
    scaled_dot_product_attention on the same tensors as the library call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rows = []
    for shape, (q, k, v), err in zip(ATTENTION_SHAPES[:2], attn["inputs"],
                                     attn["errs"]):
        tag, B, H, Hkv, S, d, dtype, causal = shape
        kern = lambda: fa.flash_attention(q, k, v, causal=causal)  # noqa: E731
        plain = lambda: fa.flash_attention_plain(                  # noqa: E731
            q, k, v, causal=causal)
        lib_call = lambda: F.scaled_dot_product_attention(         # noqa: E731
            q, k, v, is_causal=causal)
        # the yardstick computes the same function: within 2**-5 of the
        # largest output (it rounds its probabilities to bf16)
        o_k, o_l = kern(), lib_call()
        torch.cuda.synchronize()
        lib_err = float((o_k.float() - o_l.float()).abs().max())
        check(lib_err <= 2 ** -5 * float(o_k.float().abs().max()),
              f"scaled_dot_product_attention disagrees with flash_attention "
              f"at {tag} (max abs diff {lib_err:.3e})")
        ms = time_ms(kern)
        device_ms = device_ms_per_launch(kern)
        plain_ms = time_ms(plain, reps=3)
        lib_ms = time_ms(lib_call)
        # q, k, v read once and o written once; 4 d flops per (row, kept
        # column): two products of 2 d flops each
        kept = S * (S + 1) // 2 if causal else S * S
        ops = 4 * B * H * d * kept
        nbytes = 4 * B * H * S * d * q.element_size()
        rows.append(dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:81",
            launches=attn["launches"].get("flash_attention", 0),
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bound(nbytes, ops, BF16_TC_OPS_PER_S), library_ms=lib_ms,
            bound_fp32_ms=bound(nbytes, ops)["bound_ms"], device_ms=device_ms,
            shape=f"{tag} B={B} H={H} S={S} d={d} {dtype} causal={causal} "
                  f"flops={ops:.4e} bytes={nbytes} sdpa_max_abs_diff="
                  f"{lib_err:.3e}"))
    log_rows(rows)
    return rows


def slab_rows_timing(dev, slabs, lib):
    """Timing rows of ell_spmv and ell_spmv_multi (8 columns) at the
    library path's largest forward slab."""
    import torch
    from repro_torch.kernels import spmv
    fwd = slabs["fwd"]
    lo, hi = slab_rows(fwd, "largest")
    c, v = fwd.cols[lo:hi], fwd.vals[lo:hi]
    R, K, n = hi - lo, fwd.K, fwd.n
    nnz = int((v != 0).sum())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        csr = torch.sparse_csr_tensor(
            torch.arange(0, R * K + 1, K, device=dev), c.reshape(-1).long(),
            v.reshape(-1), size=(R, n), check_invariants=False)
    rows = []
    for name, B in (("ell_spmv", 1), ("ell_spmv_multi", 8)):
        x = torch.randn((n, B), device=dev)
        if name == "ell_spmv":
            x = x[:, 0].contiguous()
            kern = lambda: spmv.ell_spmv(c, v, x)               # noqa: E731
            plain = lambda: spmv.ell_spmv_plain(c, v, x)        # noqa: E731
            lib_call = lambda: torch.sparse.mm(csr, x[:, None])  # noqa: E731
        else:
            kern = lambda: spmv.ell_spmv_multi(c, v, x)         # noqa: E731
            plain = lambda: spmv.ell_spmv_multi_plain(c, v, x)  # noqa: E731
            lib_call = lambda: torch.sparse.mm(csr, x)          # noqa: E731
        y_k = kern().reshape(R, B)
        y_l = lib_call().reshape(R, B)
        torch.cuda.synchronize()
        lib_rel = float((y_l - y_k).abs().max()) / max(
            float(y_k.abs().max()), 1e-30)
        check(lib_rel <= 1e-4, f"torch.sparse.mm disagrees with {name} "
                               f"({lib_rel:.2e})")
        ms = time_ms(kern)
        device_ms = device_ms_per_launch(kern)
        plain_ms = time_ms(plain, reps=3)
        lib_ms = time_ms(lib_call)
        # nonzero slots read once for all columns, the x rows they gather
        # read once, y written once
        x_bytes = gathered_bytes(c, v, B)
        nbytes = nnz * 8 + x_bytes + R * B * 4
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces="src/repro/kernels/spmv.py:"
                     + ("65" if name == "ell_spmv" else "139"),
            launches=lib["launches"].get(name, 0),
            comparison_launches=lib["full_row_launches"].get(name, 0),
            max_abs_err=slabs["worst"][name], ms=ms, plain_ms=plain_ms,
            **bound(nbytes, 2 * B * nnz), library_ms=lib_ms,
            shape=f"R={R} K={K} B={B} nnz={nnz} x_bytes={x_bytes} "
                  f"padded_bytes={R * K * 8}", device_ms=device_ms))
    log_rows(rows)
    return rows


def sweep_rows_timing(dev, slabs, lib):
    """Timing rows of ell_sweep and ell_sweep_multi (8 columns) at the
    library path's largest and an average forward level, one level alone
    per launch (its walk tables built beforehand), with torch.sparse.mm on
    the level's live slots in CSR as the library call (the product alone,
    without the commit)."""
    import torch
    from repro_torch.kernels import spmv
    fwd = slabs["fwd"]
    n = fwd.n
    args = (fwd.cols, fwd.vals, fwd.row_len, fwd.row_ids)
    rows_out = []
    for which in ("largest", "average"):
        lv = pick_level(fwd, which)
        plan = level_plan(fwd, lv)
        lo, hi = int(fwd.row_ptr[lv]), int(fwd.row_ptr[lv + 1])
        R, k = hi - lo, int(fwd.level_k[lv])
        rows = fwd.row_ids[lo:hi].long()
        c, v = fwd.cols[lo:hi, :k], fwd.vals[lo:hi, :k]
        lens = fwd.row_len[lo:hi]
        live_mask = torch.arange(k, device=dev)[None, :] < lens[:, None]
        live = int(lens.sum())
        crow = torch.zeros(R + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(lens.long(), 0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            csr = torch.sparse_csr_tensor(crow, c[live_mask].long(),
                                          v[live_mask], size=(R, n),
                                          check_invariants=False)
        walk = spmv.sweep_walk(plan, dev)
        for name, B in (("ell_sweep", 1), ("ell_sweep_multi", 8)):
            kernel = getattr(spmv, name)
            y = torch.randn((n,) if B == 1 else (n, B), device=dev)
            y0 = y.clone()
            yp = y.clone()
            kernel(*args, y, walk)
            y_lib = torch.sparse.mm(csr, y0.reshape(n, B)).reshape(R, B)
            torch.cuda.synchronize()
            s_k = (y0[rows] - y[rows]).reshape(R, B)
            # the sweep returns y - S, rounded once: within a few ulps of
            # max(|y|, |S|) of the product S
            scale = max(float(y0[rows].abs().max()),
                        float(y_lib.abs().max()), 1e-30)
            lib_rel = float((s_k - y_lib).abs().max()) / scale
            check(lib_rel <= 1e-4, f"torch.sparse.mm disagrees with {name} "
                                   f"at the {which} level ({lib_rel:.2e})")
            kern = lambda: kernel(*args, y, walk)                # noqa: E731
            plain = lambda: spmv.ell_sweep_plain(*args, yp, plan)  # noqa: E731
            y_in = y0.reshape(n, B)
            lib_call = lambda: torch.sparse.mm(csr, y_in)        # noqa: E731
            ms = time_ms(kern)
            device_ms = device_ms_per_launch(kern)
            plain_ms = time_ms(plain, reps=3)
            lib_ms = time_ms(lib_call)
            # live slots (index and value) read once for all columns, the
            # rows' row_ids and row_len, the y sectors the slots gather,
            # the level's rows of y read and written
            y_bytes = gathered_bytes(c, v, B)
            nbytes = live * 8 + R * 8 + y_bytes + 2 * R * B * 4
            rows_out.append(dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/"
                       + ("ell_spmv.cu" if B == 1 else "ell_spmv_multi.cu"),
                replaces="src/repro/kernels/spmv.py:"
                         + ("65" if B == 1 else "139"),
                launches=lib["launches"].get(name, 0),
                max_abs_err=slabs["worst"][name], ms=ms, plain_ms=plain_ms,
                **bound(nbytes, 2 * B * live), library_ms=lib_ms,
                shape=f"{which} forward level {lv}: B={B} rows={R} "
                      f"level_k={k} K={fwd.K} live_slots={live} "
                      f"y_bytes={y_bytes}",
                device_ms=device_ms))
    log_rows(rows_out)
    return rows_out


CHAIN_LEVELS = 4096
# a whole forward solve against its plain version on the card, relative to
# its largest value: the two sum each row in another order (the kernel in
# ell_row.cuh's, the plain version left to right), and a level's rounding
# feeds every later level
SOLVE_PLAIN_TOL = 1e-5


def chain_schedule(dev, levels: int = CHAIN_LEVELS, width: int = 1):
    """The forward schedule of a path, row i reading row i - 1: ``levels``
    plan entries of one row each, so a sweep over it is a chain of level
    hand-offs and little else.  ``width`` > 1: each row of the path also
    reads ``width`` - 1 rows of level 0 (seeded), so its rows hold
    ``width`` live slots."""
    import torch
    from repro_torch.core.trisolve import _schedule_from_edges_device
    n0 = width - 1                      # level-0 rows before the path
    i = torch.arange(n0 + 1, n0 + levels + 1, device=dev)
    dst, src = [i], [i - 1]
    if n0:
        gen = torch.Generator(device="cpu").manual_seed(width)
        far = torch.argsort(torch.rand((levels, n0), generator=gen),
                            dim=1).to(dev)
        dst.append(i.repeat_interleave(n0))
        src.append(far.reshape(-1))
    dst, src = torch.cat(dst), torch.cat(src)
    return _schedule_from_edges_device(
        n0 + levels + 1, dst, src,
        torch.full((dst.numel(),), 0.5 / width, device=dev))


def piece_walk(sched):
    """A SweepWalk of ``sched``'s plan in pieces only (each entry's rows in
    pieces of one block, no runs), so every level waits on the done
    counter of the one before."""
    import numpy as np
    import torch
    from repro_torch.kernels import spmv
    _, entries = spmv.walk_items(sched.plan)
    pieces = []
    for e in range(entries.shape[0]):      # one entry alone makes no run
        items, _ = spmv.walk_items(np.ascontiguousarray(entries[e:e + 1, :3]))
        items[:, 2] = e
        pieces.append(items)
    dev = sched.cols.device
    items = np.concatenate(pieces) if pieces else np.zeros((0, 4), np.int32)
    return spmv.SweepWalk(plan=sched.plan,
                          items=torch.from_numpy(items).to(dev),
                          entries=torch.from_numpy(entries).to(dev))


def run_levels(sched) -> int:
    """Levels of ``sched``'s walk that follow another level of their run
    inside one block (each hands off by __syncthreads, not the done
    counter)."""
    items = sched.walk.items.cpu().numpy()
    runs = items[items[:, 3] < 0]
    return int((runs[:, 1] - 1).sum())


def chain_per_level_us(dev, chain, B: int, pieces: bool = False) -> dict:
    """One sweep over ``chain`` at ``B`` columns (1: ell_sweep), per level
    in µs: the walk kernel's device time (``kernel``), the call's device
    busy time (``busy``) and its CUDA-event time (``event``).  ``pieces``:
    with walk tables of pieces only (piece_walk), so each level hands off
    through the done counter, not inside a run."""
    import torch
    from repro_torch.kernels import spmv
    kernel = spmv.ell_sweep if B == 1 else spmv.ell_sweep_multi
    y = torch.ones((chain.n,) if B == 1 else (chain.n, B), device=dev)
    walk = piece_walk(chain) if pieces else chain.walk

    def fn():
        y.fill_(1.0)
        kernel(chain.cols, chain.vals, chain.row_len, chain.row_ids, y, walk)
    levels = chain.plan.shape[0]
    k_ms = kernel_device_ms(fn, lambda: None, "walk_kernel", n=5)
    busy, _ = device_busy_ms(fn)
    return dict(kernel=None if k_ms is None else k_ms * 1e3 / levels,
                busy=None if busy is None else busy * 1e3 / levels,
                event=time_ms(fn, reps=5) * 1e3 / levels)


def solve_bytes(sched, B: int) -> int:
    """Bytes one whole triangular solve over ``sched`` must move: the live
    slots (index and value) and each swept row's id and length read once,
    y read once and the swept rows of y written once."""
    live = int(sched.row_len.sum())
    rows = int(sched.plan[:, 1].sum())
    return live * 8 + rows * 8 + sched.n * B * 4 + rows * B * 4


def lower_csr(sched):
    """The strictly lower part N of a forward schedule's unit-triangular
    matrix I + N (its sweep solves (I + N) y = b) in CSR, in vertex order:
    row ``row_ids[r]`` holds the live (col, val) slots of slab row ``r``.
    Checks that every live column precedes its row, so that
    torch.triangular_solve(upper=False) solves the same system."""
    import torch
    n, K = sched.cols.shape
    live = (torch.arange(K, device=sched.cols.device)[None, :]
            < sched.row_len[:, None])
    rows = sched.row_ids.long()[:, None].expand(-1, K)[live]
    cols = sched.cols[live].long()
    check(bool((cols < rows).all()), "the forward factor is not strictly "
                                     "lower triangular in vertex order")
    return torch.sparse_coo_tensor(torch.stack((rows, cols)),
                                   sched.vals[live], (n, n)
                                   ).coalesce().to_sparse_csr()


def sweep_solve_timing(dev, slabs, lib):
    """Timing rows of one whole forward triangular solve of the library
    path (ops.trisolve_panels: ell_sweep at 1 column, ell_sweep_multi at
    8), each bitwise equal to the full-row composition and within
    SOLVE_PLAIN_TOL of its plain version run on the card.  The library
    call is torch.triangular_solve on the factor's strictly lower part in
    CSR (lower_csr; unitriangular, so cuSPARSE's triangular solve), held
    to SOLVE_PLAIN_TOL of the kernel's result.  Beside the bytes bound,
    the only bound, the design's measured chain time (``chain_ms``, not a
    limit of the card): the plan's levels times this walk's time a level
    over a CHAIN_LEVELS-level path of one-slot rows whose levels hand off
    through the done counter (a hand-off, a gather and a commit), and
    the same with the walk's runs (the levels that follow another of
    their run inside one block at the path's per-level time with
    runs)."""
    import torch
    from repro_torch.kernels import ops, spmv
    fwd = slabs["fwd"]
    n, levels = fwd.n, fwd.plan.shape[0]
    live = int(fwd.row_len.sum())
    chain = chain_schedule(dev)
    csr = lower_csr(fwd)
    rows_out = []
    for name, B in (("ell_sweep", 1), ("ell_sweep_multi", 8)):
        gen = torch.Generator(device=dev).manual_seed(7 + B)
        y0 = torch.randn((n,) if B == 1 else (n, B), generator=gen,
                         device=dev)
        got = ops.trisolve_panels(fwd, y0)
        full = ops.trisolve_panels_full(fwd, y0)
        check(bitwise_equal(got, full), f"{name}: the whole forward solve "
                                        f"differs from the full-row "
                                        f"composition")
        plain = y0.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spmv.ell_sweep_plain(fwd.cols, fwd.vals, fwd.row_len, fwd.row_ids,
                             plain, fwd.plan)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((got - plain).abs().max())
        scale = max(float(plain.abs().max()), 1e-30)
        rel = err / scale
        check(rel <= SOLVE_PLAIN_TOL, f"{name}: the whole forward solve is "
                                      f"{rel:.2e} of its largest value from "
                                      f"its plain version")
        y_in = y0.reshape(n, B)

        def library(y_in=y_in):
            return torch.triangular_solve(y_in, csr, upper=False,
                                          unitriangular=True).solution
        lib_rel = float((library().reshape(got.shape) - got).abs().max()
                        ) / scale
        check(lib_rel <= SOLVE_PLAIN_TOL,
              f"torch.triangular_solve disagrees with {name}'s whole "
              f"forward solve ({lib_rel:.2e} of its largest value)")

        def solve(y0=y0):
            return ops.trisolve_panels(fwd, y0)
        ms = time_ms(solve)
        library_ms = time_ms(library)
        device_ms = kernel_device_ms(solve, lambda: None, "walk_kernel")
        busy, events = device_busy_ms(solve)
        hand = chain_per_level_us(dev, chain, B, pieces=True)
        inside = chain_per_level_us(dev, chain, B)
        # a trace may lose the kernel's record: then the busy time, then
        # the CUDA-event time of the same calls
        per, per_in = (next(t[k] for k in ("kernel", "busy", "event")
                            if t[k] is not None) for t in (hand, inside))
        chain_ms = levels * per / 1e3
        in_runs = run_levels(fwd)
        run_chain_ms = ((levels - in_runs) * per + in_runs * per_in) / 1e3
        nbytes = solve_bytes(fwd, B)
        rows_out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/"
                   + ("ell_spmv.cu" if B == 1 else "ell_spmv_multi.cu"),
            replaces="src/repro/kernels/spmv.py:"
                     + ("65" if B == 1 else "139"),
            launches=lib["launches"].get(name, 0),
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bound(nbytes, 2 * B * live), library_ms=library_ms,
            chain_ms=chain_ms,
            shape=f"whole forward solve: B={B} levels={levels} "
                  f"rows={int(fwd.plan[:, 1].sum())} live_slots={live} "
                  f"bytes={nbytes}; the design's chain time (not a limit "
                  f"of the card) {chain_ms:.4f} ms = {levels} levels x "
                  f"{per:.3f} us, this walk's hand-off (over a "
                  f"{CHAIN_LEVELS}-level path in pieces: kernel "
                  f"{hand['kernel']}, busy {hand['busy']}, event "
                  f"{hand['event']} us a level); with runs "
                  f"{run_chain_ms:.4f} ms ({in_runs} levels inside runs at "
                  f"{per_in:.3f} us); call busy {busy} ms in "
                  f"{events} device events; relative error {rel:.2e} vs "
                  f"plain; library torch.triangular_solve on the CSR lower "
                  f"part, {lib_rel:.2e} from the kernel",
            device_ms=device_ms))
        log(f"[timing] {name} whole forward solve B={B}: "
            f"{ms:.4f} ms against the bytes bound "
            f"{rows_out[-1]['bound_ms']:.4f} ms; the design's chain time "
            f"{chain_ms:.4f} ms; torch.triangular_solve {library_ms:.4f} ms")
    log_rows(rows_out)
    return rows_out


def apply_timing(dev, main, slabs):
    """One preconditioner apply of each path on the same factor, 1 and 8
    right-hand sides: the main path's fleet level sweeps and the library
    path's level-slab sweeps; for each, the C calls of its sweeps (one per
    triangular solve) beside its launches, and the group width the main
    path's sweep takes at the two timed forward levels."""
    import torch
    from repro_torch.core.trisolve import make_preconditioner_from_schedules
    from repro_torch.kernels import runtime, spmv
    h = main["handle"]
    for tag, lv in sweep_levels(h).items():
        k = int(level_entry(h, lv)[0, 2])
        log(f"[timing] ell_sweep_fleet at the {tag} forward level {lv}: "
            f"level_k {k}, G {spmv.group_width(k)} (the panel's K "
            f"{h.fleet.Kf} would give {spmv.group_width(h.fleet.Kf)})")
    apply = make_preconditioner_from_schedules(slabs["fwd"], slabs["bwd"],
                                               h.factor.device.D)
    n = h.n
    r1 = torch.randn(n, device=dev)
    R8 = torch.randn((n, 8), device=dev)
    out = {}
    for tag, fn, reps in (
            ("main 1 rhs", lambda: h.precondition(r1), 3),
            ("library 1 rhs", lambda: apply(r1), 5),
            ("main 8 rhs", lambda: h.precondition(R8), 2),
            ("library 8 rhs", lambda: apply(R8), 5)):
        ms = time_ms(fn, reps=reps)
        runtime.reset_launches()
        with SweepCalls() as calls:
            fn()
        torch.cuda.synchronize()
        launches = dict(runtime.LAUNCHES)
        busy, n_dev = device_busy_ms(fn)
        out[tag] = dict(ms=ms, busy_ms=busy, c_calls=calls.n)
        idle = ("device time not measured (the trace holds no device event)"
                if busy is None else
                f"device busy {busy:.2f} ms in {n_dev} device events, idle "
                f"share {1 - busy / ms:.3f} of the unprofiled mean")
        log(f"[timing] preconditioner apply, {tag}: {ms:.2f} ms, launches "
            f"{launches}, sweep C calls {calls.n}; {idle}")
        if tag.startswith("main"):
            check(calls.n == 2, f"{tag}: the apply made {calls.n} "
                                f"ell_sweep_fleet calls, not 2")
        else:
            name = "ell_sweep" if tag.endswith("1 rhs") else "ell_sweep_multi"
            check(calls.n == 2
                  and {k: v for k, v in launches.items() if v} == {name: 2},
                  f"{tag}: the apply made {calls.n} sweep calls and "
                  f"launched {launches}, not 2 calls and 2 {name}")
    return out


class SweepCalls:
    """While the ``with`` block runs, counts the calls of the level
    sweeps' wrappers (``ell_sweep_fleet``, ``ell_sweep``,
    ``ell_sweep_multi``): each is one C call, one triangular solve."""

    NAMES = ("ell_sweep_fleet", "ell_sweep", "ell_sweep_multi")

    def __init__(self):
        self.n = 0

    def __enter__(self):
        from repro_torch.kernels import spmv
        self._orig = {name: getattr(spmv, name) for name in self.NAMES}

        def counted(orig):
            def call(*args, **kw):
                self.n += 1
                return orig(*args, **kw)
            return call
        for name, orig in self._orig.items():
            setattr(spmv, name, counted(orig))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import spmv
        for name, orig in self._orig.items():
            setattr(spmv, name, orig)


# kernels that must not launch while the [serve] phase serves: only the
# fleet level sweep runs a request's PCG
SERVE_SILENT = ("ell_spmv_fleet", "sample_clique", "sample_clique_round",
                "ell_sweep", "ell_sweep_multi", "ell_spmv", "ell_spmv_multi",
                "flash_attention")


def serve_trace(n: int, gids):
    """The [serve] trace: 12 (graph id, rhs block, tol) alternating
    between the two factors; requests 3, 7 and 11 are blocks of 4
    right-hand sides, the other 9 single (21 columns in all); tol 1e-6
    and 1e-4 in alternate pairs, so each factor sees both."""
    import numpy as np
    rng = np.random.default_rng(1)
    out = []
    for i in range(12):
        nrhs = 4 if i in (3, 7, 11) else 1
        b = rng.normal(size=(nrhs, n) if nrhs > 1 else n).astype(np.float32)
        out.append((gids[i % 2], b, (1e-6, 1e-4)[(i // 2) % 2]))
    return out


def timed_ticks(eng, durations):
    """Record the wall time of every ``eng.tick()`` into ``durations``
    (``run_until_drained`` calls the instance's ``tick``)."""
    tick = eng.tick

    def timed():
        t0 = time.perf_counter()
        out = tick()
        durations.append(time.perf_counter() - t0)
        return out
    eng.tick = timed


def full_tick_busy(dev, solver, gids, n):
    """(unprofiled wall ms, device busy ms, device events) of one engine
    tick with all 8 lanes stepping: 8 single-column requests that cannot
    converge in the ticks measured, admitted by a first tick."""
    import numpy as np
    import torch
    from repro_torch.serve import SolveEngine, SolveRequest
    eng = SolveEngine(solver, slots=8, iters_per_tick=8)
    rng = np.random.default_rng(2)
    for i in range(8):
        eng.submit(SolveRequest(
            rid=i, graph_id=gids[i % 2], tol=1e-30, maxiter=24,
            b=rng.normal(size=n).astype(np.float32)))
    eng.tick()
    check(sum(lane is not None for lane in eng.lanes) == 8,
          "serve: the full tick's 8 lanes were not all admitted")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.tick()
    wall = (time.perf_counter() - t0) * 1e3
    busy, events = device_busy_ms(eng.tick)
    eng.run_until_drained()
    return wall, busy, events


def phase_serve(dev, main, card):
    """The [serve] phase (see the module docstring)."""
    import asyncio
    import numpy as np
    import torch
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.kernels import runtime
    from repro_torch.obs import (FlightRecorder, MetricsRegistry, Tracer,
                                 percentile, render)
    from repro_torch.serve import SolveEngine, SolveFrontend, SolveRequest
    t_phase = time.time()
    solver, g, h0 = main["solver"], main["graph"], main["handle"]
    solver.max_handles = 2          # the Solver's default keeps one factor
    torch.cuda.synchronize()
    runtime.reset_launches()
    t0 = time.time()
    with FactorProbe() as probe:
        h1 = solver.factor(g, key_from_seed(1), graph_id="g64_k1")
        torch.cuda.synchronize()
    t_factor = time.time() - t0
    rounds = probe.report("serve", t_factor)
    check(runtime.LAUNCHES.get("sample_clique_round", 0) == rounds,
          "serve: the second factor did not launch sample_clique_round "
          "once per round")
    check(h0.graph_id in solver and "g64_k1" in solver,
          "serve: the two factors are not both cached")
    keys = [(h.fleet.family, h.fleet.n_pad, h.fleet.k_tier)
            for h in (h0, h1)]
    shared = h0.fleet is h1.fleet
    st = solver.stats()
    log(f"[serve] second factor (key 1) {t_factor:.2f}s, {rounds} rounds; "
        f"bucket keys {keys[0]} and {keys[1]} "
        f"({'one fleet' if shared else 'two fleets'}, rows "
        f"{h0.fleet_row} and {h1.fleet_row}, Kf {h1.fleet.Kf} Kb "
        f"{h1.fleet.Kb}); fleet bytes by device "
        f"{st['fleet_device_bytes_by_device']}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; {card}")
    gids = [h0.graph_id, "g64_k1"]
    trace = serve_trace(g.n, gids)
    cols = sum(np.atleast_2d(b).shape[0] for _, b, _ in trace)
    reg, tracer, flight = MetricsRegistry(), Tracer(), FlightRecorder()
    torch.cuda.synchronize()
    runtime.reset_launches()
    eng = SolveEngine(solver, slots=8, iters_per_tick=8, metrics=reg,
                      tracer=tracer, flight=flight)
    ticks = []
    timed_ticks(eng, ticks)
    reqs = [SolveRequest(rid=i, graph_id=gid, b=b, tol=tol, maxiter=500)
            for i, (gid, b, tol) in enumerate(trace)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    t_engine = time.perf_counter() - t0
    eng2 = SolveEngine(solver, slots=8, iters_per_tick=8, metrics=reg,
                       tracer=tracer, flight=flight)

    async def drive(fe):
        return await asyncio.gather(*[
            fe.solve(gid, b, tol=tol, maxiter=500)
            for gid, b, tol in trace])

    t0 = time.perf_counter()
    with SolveFrontend(eng2, max_queue=64) as fe:
        served = asyncio.run(drive(fe))
        fstats = fe.stats()
    t_front = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    log(f"[serve] launches over both runs: {launches}")
    check(launches.get("ell_sweep_fleet", 0) > 0,
          "serve: ell_sweep_fleet never launched")
    for name in SERVE_SILENT:
        check(launches.get(name, 0) == 0,
              f"serve: the {name} kernel launched while serving")
    check(len(done) == 12 and fstats.completed == 12 and fstats.failed == 0,
          "serve: a request did not complete")
    for tag, e in (("engine", eng), ("frontend", eng2)):
        es = e.stats()
        log(f"[serve] {tag} stats: {es.as_dict()}")
        check(es.completed == 12 and es.cols_in == es.cols_out == cols,
              f"serve: {tag} EngineStats count {es.completed} requests, "
              f"{es.cols_in} columns in, {es.cols_out} out")
        check(es.step_compiles == es.buckets,
              f"serve: {tag} step signatures {es.step_compiles} != buckets "
              f"{es.buckets}")
    handles = {h0.graph_id: h0, "g64_k1": h1}
    for i, (gid, b, tol) in enumerate(trace):
        ref = handles[gid].solve(torch.from_numpy(np.atleast_2d(b)).to(dev),
                                 tol=tol, maxiter=500)
        x_ref = ref.x.cpu().numpy()
        for tag, r in (("engine", reqs[i]), ("frontend", served[i])):
            check(r.status == "converged",
                  f"serve: {tag} request {i} ended {r.status!r}")
            check(np.array_equal(np.atleast_2d(r.x).view(np.uint32),
                                 x_ref.view(np.uint32))
                  and np.array_equal(np.atleast_1d(r.iters),
                                     ref.iters.cpu().numpy())
                  and np.array_equal(np.atleast_1d(r.relres),
                                     ref.relres.cpu().numpy()
                                     .astype(np.float64)),
                  f"serve: {tag} request {i} differs from its direct solve")
        for x, bb in zip(x_ref, np.atleast_2d(b)):
            rr = true_relres(g, x, bb)
            check(rr < 10 * tol, f"serve: request {i} true residual "
                                 f"{rr:.2e} at tol {tol:.0e}")
    samples = [ln for ln in render(reg).splitlines()
               if ln.startswith("repro_engine_completed_total{")]
    total = sum(float(ln.rsplit(" ", 1)[1]) for ln in samples)
    check(total == 24, f"serve: repro_engine_completed_total sums to "
                       f"{total}, not 24")
    traces = {tr.trace_id: tr for tr in tracer.traces()}
    every = reqs + served
    check(len(traces) == 24 and set(traces) == {r.trace_id for r in every},
          f"serve: {len(traces)} traces for 24 requests")
    for r in every:
        tr = traces[r.trace_id]
        check(abs(tr.span_sum_s - r.latency_s) <= 0.05 * r.latency_s,
              f"serve: request {r.rid}'s spans sum to {tr.span_sum_s:.4f}s "
              f"of a {r.latency_s:.4f}s latency")
    col_iters = sum(int(np.sum(r.iters)) for r in reqs)
    lat = [r.latency_s for r in reqs]
    log(f"[serve] engine run: {eng.ticks} ticks in {t_engine:.3f}s, tick "
        f"wall median {percentile(ticks, 50) * 1e3:.2f} ms max "
        f"{max(ticks) * 1e3:.2f} ms; {12 / t_engine:.3f} requests/s, "
        f"{col_iters / t_engine:.1f} column-iterations/s ({col_iters} "
        f"column-iterations); latency p50 {percentile(lat, 50):.3f}s p99 "
        f"{percentile(lat, 99):.3f}s, queue wait p50 "
        f"{percentile([r.queue_wait_s for r in reqs], 50):.3f}s; {card}")
    flat = [r.latency_s for r in served]
    log(f"[serve] frontend run: {eng2.ticks} ticks in {t_front:.3f}s; "
        f"{12 / t_front:.3f} requests/s; latency p50 "
        f"{percentile(flat, 50):.3f}s p99 {percentile(flat, 99):.3f}s, "
        f"queue wait p50 "
        f"{percentile([r.queue_wait_s for r in served], 50):.3f}s; {card}")
    if shared:
        two_factor_apply(dev, h0, h1, card)
    wall, busy, events = full_tick_busy(dev, solver, gids, g.n)
    idle = ("device time not measured (the trace holds no device event)"
            if busy is None else
            f"device busy {busy:.2f} ms in {events} device events, busy "
            f"share {busy / wall:.3f} of the unprofiled tick")
    log(f"[serve] one full tick (8 lanes, 8 iterations): {wall:.2f} ms; "
        f"{idle}; {card}")
    log(f"[serve] phase passed in {time.time() - t_phase:.1f}s; {card}")


def two_factor_apply(dev, h0, h1, card):
    """One apply of 8 lanes of the bucket's two factors interleaved in
    fidx ([a, b, a, b, b, a, a, b], the bucket's whole plans), each lane
    bitwise equal to that right-hand side applied alone by its handle
    (the plans cut to its own levels), and to the full-row composition."""
    import torch
    from repro_torch.core.pcg import fleet_precondition
    from repro_torch.core.trisolve import build_schedules_batched
    fl = h0.fleet
    a, b = h0.fleet_row, h1.fleet_row
    order = [h0, h1, h0, h1, h1, h0, h0, h1]
    fidx = torch.tensor([h.fleet_row for h in order], dtype=torch.int32,
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    R = torch.zeros((8, fl.n_pad), device=dev)
    R[:, :h0.n] = torch.randn((8, h0.n), generator=gen, device=dev)
    f_plan, b_plan = fl.plans()
    got = fleet_precondition(fl.arrays, fidx, R, f_plan=f_plan,
                             b_plan=b_plan)
    scheds = {h.fleet_row: build_schedules_batched(
        [h.factor.to_device(dev)])[0] for h in (h0, h1)}
    levels = tuple(torch.stack([scheds[int(f)][i].level_of
                                for f in fidx.tolist()])
                   for i in (0, 1))
    full = full_row_apply(h0, levels, fidx, R)
    check(bitwise_equal(got, full),
          "serve: the two-factor 8-lane apply differs from the full-row "
          "composition")
    for lane, h in enumerate(order):
        alone = h.precondition(R[lane, :h.n])
        check(bitwise_equal(alone, got[lane, :h.n]),
              f"serve: lane {lane} of the two-factor apply differs from "
              f"its right-hand side applied alone")
    log(f"[serve] 8 lanes of rows {a} and {b} interleaved in one apply: "
        f"each lane == the lane alone == the full-row composition, bit for "
        f"bit; {card}")


# kernels that must not launch in the [cluster] phase: the factor tier's
# construction runs the fused round, the replicas' ticks the fleet sweep
CLUSTER_SILENT = ("sample_clique", "ell_spmv_fleet", "ell_sweep",
                  "ell_sweep_multi", "ell_spmv", "ell_spmv_multi",
                  "flash_attention")
# hot-factor replication threshold of the [cluster] phase (requests per
# second on one graph over the 1 s rate window): once the factors are
# live the trace's 15 remaining requests on its first graph arrive within
# a second and cross it, the second graph's 5 do not
CLUSTER_REPLICATE_ABOVE = 8.0
# single right-hand sides on the first graph once both replicas hold it
CLUSTER_WARM = 8
FACTOR_FIELDS = ("col_ptr", "rows", "vals", "D")


def host_factor(f) -> dict:
    """Copies of a factor's host CSC arrays and diagonal."""
    import numpy as np
    return {k: np.array(getattr(f, k)) for k in FACTOR_FIELDS}


def same_factor(f, ref: dict) -> bool:
    import numpy as np
    return all(np.array_equal(np.asarray(getattr(f, k)).view(np.uint8),
                              ref[k].view(np.uint8)) for k in FACTOR_FIELDS)


def cluster_trace(n: int, gids):
    """The [cluster] trace: 24 (graph id, rhs block, tol).  Requests 0 and
    1 open on the two graphs (the burst whose cold placements share one
    tier batch), the rest pick the first graph with probability 3/4
    (seeded); requests 3, 7, ..., 23 are blocks of 4 right-hand sides
    (42 columns in all); tol 1e-6 and 1e-4 alternate."""
    import numpy as np
    rng = np.random.default_rng(3)
    out = []
    for i in range(24):
        gi = i if i < 2 else int(rng.random() >= 0.75)
        nrhs = 4 if i % 4 == 3 else 1
        b = rng.normal(size=(nrhs, n) if nrhs > 1 else n).astype(np.float32)
        out.append((gids[gi], b, (1e-6, 1e-4)[i % 2]))
    return out


def timed_adopts(cl, record):
    """Record (replica, graph id, seconds) of every adoption onto the
    cluster's solve replicas: the driver-thread wall of ``cache.adopt``."""
    for rep in cl.replicas:
        adopt = rep.cache.adopt

        def timed(g, f, *, _adopt=adopt, _i=rep.index, **kw):
            t0 = time.perf_counter()
            out = _adopt(g, f, **kw)
            record.append((_i, kw["graph_id"], time.perf_counter() - t0))
            return out
        rep.cache.adopt = timed


class SweepTally:
    """While the ``with`` block runs, tallies per calling thread the
    ``ell_sweep_fleet`` launches that its callers ask for (one per entry
    of each call's plan that has rows, and the call's lane grouping where
    any has), apart from the runtime's counter,
    so the counter's total under concurrent threads can be held against
    it."""

    def __init__(self):
        self.by_thread = {}

    def __enter__(self):
        from repro_torch.kernels import spmv
        self._orig = orig = spmv.ell_sweep_fleet

        def tallied(*args, **kw):
            plan = args[7] if len(args) > 7 else kw["plan"]
            levels = int((plan[:, 1] > 0).sum())
            tid = threading.get_ident()     # each thread writes its own key
            self.by_thread[tid] = (self.by_thread.get(tid, 0) + levels
                                   + (levels > 0))
            return orig(*args, **kw)
        spmv.ell_sweep_fleet = tallied
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import spmv
        spmv.ell_sweep_fleet = self._orig


def phase_cluster(dev, g0, main_f, card):
    """The [cluster] phase (see the module docstring)."""
    import concurrent.futures as cf
    import numpy as np
    import torch
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.data import graphs
    from repro_torch.kernels import runtime
    from repro_torch.obs import percentile
    from repro_torch.serve import SolveCluster
    from repro_torch.serve.cluster import factor_tier
    t_phase = time.time()
    g1 = permuted(graphs.grid3d(64, 64, 64, "uniform", seed=3))
    gs = {"g64_s2": g0, "g64_s3": g1}
    gids = list(gs)
    # the tier worker's first take waits for the gate (as the tests'
    # _gated_tier holds it), so both cold placements are queued when it
    # takes; the worker enters its take when the cluster starts it
    gate = threading.Event()
    take = factor_tier.FactorTier._take_batch
    factor_tier.FactorTier._take_batch = (
        lambda self: (gate.wait(600), take(self))[1])
    cl = None
    adopts = []
    try:
        cl = SolveCluster(replicas=2, factor_replicas=1,
                          devices=[dev] * 3, routing="affinity",
                          slots=8, iters_per_tick=8,
                          replicate_above=CLUSTER_REPLICATE_ABOVE,
                          replica_ttl_s=600.0,
                          cache_kw=dict(chunk=256, fill_slack=32,
                                        strict=True))
        for i, (gid, g) in enumerate(gs.items()):
            cl.register(g, key_from_seed(i), graph_id=gid)
        timed_adopts(cl, adopts)
        trace = cluster_trace(g0.n, gids)
        rng = np.random.default_rng(5)
        warm = [rng.normal(size=g0.n).astype(np.float32)
                for _ in range(CLUSTER_WARM)]
        cols = sum(np.atleast_2d(b).shape[0] for _, b, _ in trace)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        runtime.reset_launches()
        with FactorProbe() as probe, SweepTally() as tally:
            t0 = time.perf_counter()
            # submitted from a pool: a cold submit waits for its factor to
            # land, a warm one only queues its request
            with cf.ThreadPoolExecutor(max_workers=4) as pool:
                subs = [pool.submit(cl.submit, gid, b, tol=tol, maxiter=500)
                        for gid, b, tol in trace]
                t_wait = time.time()
                while (cl.factor_tier.queue_depth < 2
                       and time.time() - t_wait < 60):
                    time.sleep(0.01)
                queued = cl.factor_tier.queue_depth
                gate.set()
                futs = [f.result(timeout=600) for f in subs]
            done = [f.result(timeout=600) for f in futs]
            t_trace = time.perf_counter() - t0
            check(queued == 2, f"cluster: {queued} cold placements queued "
                               f"at the tier's first take, not 2")
            check(cl.drain(timeout=300), "cluster: the replicas did not "
                                         "drain")
            # the hot copy's construction and adoption outlast the trace
            t_wait = time.time()
            while cl.factor_tier.queue_depth and time.time() - t_wait < 300:
                time.sleep(0.05)
            holders0 = [rep for rep in cl.replicas
                        if rep.cache.peek(gids[0])]
            check(len(holders0) == 2, "cluster: the hot copy never landed")
            # both replicas hold the first graph: least-loaded among the
            # holders splits a burst between them
            t1 = time.perf_counter()
            wfuts = [cl.submit(gids[0], b, tol=1e-6, maxiter=500)
                     for b in warm]
            warm_done = [f.result(timeout=600) for f in wfuts]
            t_warm = time.perf_counter() - t1
            check(cl.drain(timeout=300), "cluster: the replicas did not "
                                         "drain after the warm burst")
            torch.cuda.synchronize()
        launches = dict(runtime.LAUNCHES)
        st = cl.stats()
        tier = st.factor_tier
        peak = torch.cuda.max_memory_allocated(dev)
        rounds = sum(a["rounds_run"] for a in probe.attempts)
        for k, a in enumerate(probe.attempts):
            log(f"[cluster] tier attempt {k + 1}: B={a['members']} "
                f"fill_slack={a['fill_slack']} W={a['W']} rounds run="
                f"{a['rounds_run']} overflow={a['overflow']} wall "
                f"{a['seconds']:.3f}s")
        w = tier["per_replica"][0]
        log(f"[cluster] factor tier: {w['batches']} batches, "
            f"{w['factored']} factors ({tier['coalesced_factorizations']} "
            f"coalesced) in {w['factor_s']:.2f}s of construction wall, "
            f"{rounds} engine rounds; device {w['device']}; {card}")
        for i, gid, s in adopts:
            log(f"[cluster] adoption of {gid} onto replica {i}: {s:.3f}s")
        sweeps = {rep.index: tally.by_thread.get(rep.frontend._thread.ident,
                                                 0)
                  for rep in cl.replicas}
        log(f"[cluster] launches: {launches}; ell_sweep_fleet asked for "
            f"per replica driver thread: {sweeps}, "
            f"{sum(tally.by_thread.values())} on {len(tally.by_thread)} "
            f"threads in all")
        check(tier["factor_queue_depth"] == 0,
              "cluster: the factor tier did not finish its queue")
        check(launches.get("sample_clique_round", 0) > 0
              and launches.get("ell_sweep_fleet", 0) > 0,
              "cluster: sample_clique_round or ell_sweep_fleet never "
              "launched")
        check(launches.get("sample_clique_round", 0) == rounds,
              f"cluster: sample_clique_round launched "
              f"{launches.get('sample_clique_round', 0)} times for "
              f"{rounds} engine rounds")
        check(launches.get("ell_sweep_fleet", 0)
              == sum(tally.by_thread.values()),
              f"cluster: ell_sweep_fleet counted "
              f"{launches.get('ell_sweep_fleet', 0)} launches, its callers "
              f"asked for {sum(tally.by_thread.values())}")
        check(all(v > 0 for v in sweeps.values()),
              f"cluster: a replica's driver thread launched no sweep "
              f"({sweeps})")
        for name in CLUSTER_SILENT:
            check(launches.get(name, 0) == 0,
                  f"cluster: the {name} kernel launched")
        n_req = len(trace) + CLUSTER_WARM
        check(len(done) == len(trace) and st.submitted == st.routed == n_req
              and st.shed == 0, "cluster: a request was not routed")
        warm_by = [sum(r.replica == rep.index for r in warm_done)
                   for rep in cl.replicas]
        check(all(warm_by), f"cluster: the warm burst was served only by "
                            f"one replica ({warm_by})")
        check(tier["coalesced_factorizations"] >= 2,
              "cluster: the two cold placements did not share a batch")
        check(st.replications >= 1, "cluster: the hot graph never "
                                    "replicated")
        factored = sum(x["factored"] for x in tier["per_replica"])
        check(st.adoptions == factored == 2 + st.replications,
              f"cluster: {st.adoptions} adoptions, {factored} tier "
              f"factorizations, {st.replications} replications")
        for rep in holders0:
            check(same_factor(rep.cache.peek(gids[0]).factor, main_f),
                  f"cluster: replica {rep.index}'s factor of {gids[0]} "
                  f"differs from the [main] factor")
        for rep in cl.replicas:
            es = rep.frontend.stats().engine
            check(es.step_compiles == es.buckets,
                  f"cluster: replica {rep.index} step signatures "
                  f"{es.step_compiles} != buckets {es.buckets}")
        worst = {}
        served = trace + [(gids[0], b, 1e-6) for b in warm]
        for i, ((gid, b, tol), r) in enumerate(zip(served,
                                                   done + warm_done)):
            check(r.status == "converged",
                  f"cluster: request {i} ended {r.status!r}")
            h = cl.replicas[r.replica].cache.peek(gid)
            ref = h.solve(torch.from_numpy(np.atleast_2d(b)).to(dev),
                          tol=tol, maxiter=500)
            check(np.array_equal(np.atleast_2d(r.x).view(np.uint32),
                                 ref.x.cpu().numpy().view(np.uint32))
                  and np.array_equal(np.atleast_1d(r.iters),
                                     ref.iters.cpu().numpy()),
                  f"cluster: request {i} differs from a direct solve on "
                  f"replica {r.replica}")
            for x, bb in zip(np.atleast_2d(r.x), np.atleast_2d(b)):
                rr = true_relres(gs[gid], x, bb)
                worst[tol] = max(worst.get(tol, 0.0), rr)
                check(np.all(np.isfinite(x)) and rr < 1e-4,
                      f"cluster: request {i} true residual {rr:.2e} at "
                      f"tol {tol:.0e}")
        col_iters = sum(int(np.sum(r.iters)) for r in done)
        lat = [r.latency_s for r in done]
        log(f"[cluster] {len(done)} requests ({cols} columns) in "
            f"{t_trace:.3f}s: {len(done) / t_trace:.3f} requests/s, "
            f"{col_iters / t_trace:.1f} column-iterations/s ({col_iters} "
            f"column-iterations); latency p50 {percentile(lat, 50):.3f}s "
            f"p99 {percentile(lat, 99):.3f}s, queue wait p50 "
            f"{percentile([r.queue_wait_s for r in done], 50):.3f}s; "
            f"worst true residual "
            + ", ".join(f"{v:.2e} at tol {t:.0e}"
                        for t, v in sorted(worst.items()))
            + f"; {card}")
        wlat = [r.latency_s for r in warm_done]
        log(f"[cluster] warm burst: {CLUSTER_WARM} requests on {gids[0]} "
            f"in {t_warm:.3f}s, served per replica {warm_by}, latency p50 "
            f"{percentile(wlat, 50):.3f}s p99 {percentile(wlat, 99):.3f}s; "
            f"{card}")
        log(f"[cluster] routing: hit rate {st.hit_rate:.3f} (hits "
            f"{st.affinity_hits}, misses {st.affinity_misses}), "
            f"replications {st.replications} (above "
            f"{CLUSTER_REPLICATE_ABOVE} req/s), dedups {st.factor_dedups}, "
            f"adoptions {st.adoptions}; per replica: "
            + "; ".join(f"{r.index} routed {r.routed}, device {r.device}, "
                        f"{r.cache['handles']} factors, fleet bytes "
                        f"{r.cache['fleet_device_bytes']}"
                        for r in st.per_replica)
            + f"; peak allocated {peak / 2**30:.2f} GiB")
    finally:
        gate.set()
        factor_tier.FactorTier._take_batch = take
        if cl is not None:
            cl.close(drain=False)
    log(f"[cluster] phase passed in {time.time() - t_phase:.1f}s; {card}")


# kernels that must not launch in the [zoo] phase: the families' applies
# run the fleet's two kernels (the full-row ell_spmv_fleet for amg and
# spai, the level sweep for ac and ichol) and the AC factors the fused round
ZOO_SILENT = ("sample_clique", "ell_spmv", "ell_spmv_multi", "ell_sweep",
              "ell_sweep_multi", "flash_attention")
# the (suite graph, family) pairs the [zoo] phase serves through the
# full-row kernel: the two spmv families at the reference's serving scale
# (n = 4096), spai also on the power-law graph (its K tier 2048)
ZOO_SPMV = (("grid3d_uniform_16", "amg"), ("grid3d_uniform_16", "spai"),
            ("powerlaw_4k", "spai"))
ZOO_FAMILIES = ("ac", "ichol", "amg", "spai")


class IcholProbe:
    """While the ``with`` block runs, records each host incomplete-Cholesky
    factorization the ichol family's build function makes: its shift, the
    nnz of its factor and its wall time."""

    def __init__(self):
        self.builds = []

    def __enter__(self):
        from repro_torch.core import ichol as mod
        self._orig = orig = mod.ichol

        def probed(*args, **kw):
            t0 = time.time()
            ic = orig(*args, **kw)
            self.builds.append(dict(shift=ic.shift, nnz=ic.nnz,
                                    seconds=time.time() - t0))
            return ic
        mod.ichol = probed
        return self

    def __exit__(self, *exc):
        from repro_torch.core import ichol as mod
        mod.ichol = self._orig


def fleet_apply_plain(h, R):
    """The handle's factor-kind apply with both triangular solves through
    ``ell_sweep_fleet_plain`` (the same arguments ``ops.trisolve_fleet``
    gives the kernel)."""
    import torch
    from repro_torch.kernels import spmv
    fa = h.fleet.arrays
    f_plan, b_plan = h.plans()
    fidx = torch.full((R.shape[0],), h.fleet_row, dtype=torch.int32,
                      device=R.device)
    f = fidx.long()
    Y = R.clone()
    spmv.ell_sweep_fleet_plain(fa.fcols, fa.fvals, fa.flen, fa.frows,
                               fa.fstart, fidx, Y, f_plan)
    Z = Y * fa.dinv[f]
    spmv.ell_sweep_fleet_plain(fa.bcols, fa.bvals, fa.blen, fa.brows,
                               fa.bstart, fidx, Z, b_plan)
    return Z


def zoo_solves(tag, h, g, b1, B8, card):
    """The 1-rhs solve of ``b1``, the 8-rhs solve of ``B8`` and its lane 0
    alone (tol 1e-6, maxiter 500) on handle ``h``: every lane converged
    with a true residual below 1e-4, lane 0 alone bitwise equal to lane 0
    of the block.  Returns the full-row and sweep launches each solve
    made and the applies it asked for (1 + its largest iteration count)."""
    import numpy as np
    import torch
    from repro_torch.kernels import runtime
    dev = h.device
    out = dict(walls=[], iters=[], spmv=0, sweep=0, applies=0)
    results = []
    for B in (b1, B8, B8[0]):
        torch.cuda.synchronize()
        before = dict(runtime.LAUNCHES)
        t0 = time.time()
        r = h.solve(torch.from_numpy(np.ascontiguousarray(B)).to(dev),
                    tol=1e-6, maxiter=500)
        torch.cuda.synchronize()
        out["walls"].append(time.time() - t0)
        it = np.atleast_1d(r.iters.cpu().numpy())
        out["iters"].append(it)
        out["applies"] += 1 + int(it.max())
        for key, name in (("spmv", "ell_spmv_fleet"),
                          ("sweep", "ell_sweep_fleet")):
            out[key] += runtime.LAUNCHES.get(name, 0) - before.get(name, 0)
        check(bool(r.converged.all()), f"zoo {tag}: a lane did not converge")
        for x, b in zip(np.atleast_2d(r.x.cpu().numpy()), np.atleast_2d(B)):
            rr = true_relres(g, x, b)
            check(np.all(np.isfinite(x)) and rr < 1e-4,
                  f"zoo {tag}: true residual {rr:.2e}")
        results.append(r)
    check(bitwise_equal(results[2].x, results[1].x[0])
          and int(results[2].iters) == int(results[1].iters[0]),
          f"zoo {tag}: lane 0 of the 8-rhs solve differs from the same "
          f"right-hand side solved alone")
    it8 = out["iters"][1]
    log(f"[zoo] {tag}: solve 1 rhs {out['walls'][0]:.3f}s iters "
        f"{int(out['iters'][0][0])}; 8 rhs {out['walls'][1]:.3f}s iters "
        f"{it8.min()}..{it8.max()}; lane 0 alone {out['walls'][2]:.3f}s == "
        f"lane 0 of the block bit for bit; full-row ell_spmv_fleet "
        f"launches {out['spmv']}, ell_sweep_fleet launches {out['sweep']}, "
        f"applies asked for {out['applies']}; {card}")
    return out


def phase_zoo(dev, g64, card):
    """The [zoo] phase (see the module docstring).  Returns the launch
    counts of its path, its spmv handles and the worst kernel errors
    against the plain versions, for the [timing] rows it adds."""
    import numpy as np
    import torch
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.solver import FactorCache
    from repro_torch.data import graphs
    from repro_torch.kernels import runtime, spmv
    from repro_torch.launch.serve import run_service
    from repro_torch.serve import SolveEngine, SolveRequest
    t_phase = time.time()
    rng = np.random.default_rng(0)             # [main]'s right-hand sides
    b1 = rng.normal(size=g64.n).astype(np.float32)
    B8 = rng.normal(size=(8, g64.n)).astype(np.float32)
    cache = FactorCache(device=dev)
    torch.cuda.synchronize()
    runtime.reset_launches()

    # 1. ichol at 64^3, through the fleet's level sweeps
    t0 = time.time()
    with IcholProbe() as probe:
        hi = cache.factor(g64, key_from_seed(0), graph_id="g64::ichol",
                          family="ichol")
        torch.cuda.synchronize()
    t_ic = time.time() - t0
    ic = probe.builds[-1]
    check(len(probe.builds) == 1, "zoo: ichol factored more than once")
    log(f"[zoo] ichol grid3d 64^3 n={g64.n}: host build {ic['seconds']:.2f}s "
        f"(host), admission {t_ic - ic['seconds']:.2f}s, shift "
        f"{ic['shift']}, nnz(L) {ic['nnz']} nnz(G) {hi.factor.nnz}, levels "
        f"fwd={hi.n_levels_fwd} bwd={hi.n_levels_bwd}, panel K fwd="
        f"{hi.fleet.Kf} bwd={hi.fleet.Kb}; {card}")
    ichol = zoo_solves("ichol 64^3", hi, g64, b1, B8, card)
    check(ichol["sweep"] > 0 and ichol["spmv"] == 0,
          "zoo: ichol's solves did not run on the level sweep alone")

    # 2. amg and spai at the reference's serving scale, on the full-row
    # kernel, one launch per apply
    suite = {name: graphs.SUITE[name]() for name in
             ("grid3d_uniform_16", "powerlaw_4k")}
    spmv_handles = {}
    for name, fam in ZOO_SPMV:
        g = suite[name]
        t0 = time.time()
        h = cache.factor(g, key_from_seed(0), graph_id=f"{name}::{fam}",
                         family=fam)
        torch.cuda.synchronize()
        t_build = time.time() - t0
        panel = h.n_pad * h.fleet.Kf * 8
        log(f"[zoo] {fam} {name} n={g.n}: build {t_build:.2f}s (host "
            f"construction and admission), K {h.factor.K}, nnz "
            f"{h.factor.nnz}, fleet K tier {h.fleet.k_tier}, panel bytes "
            f"{panel} (R={h.n_pad} x K={h.fleet.Kf} x 8); {card}")
        zr = np.random.default_rng(1)
        zb1 = zr.normal(size=g.n).astype(np.float32)
        zB8 = zr.normal(size=(8, g.n)).astype(np.float32)
        out = zoo_solves(f"{fam} {name}", h, g, zb1, zB8, card)
        check(out["spmv"] > 0 and out["spmv"] == out["applies"],
              f"zoo {fam} {name}: {out['spmv']} full-row launches for "
              f"{out['applies']} applies asked for")
        check(out["sweep"] == 0, f"zoo {fam} {name}: a level sweep ran")
        spmv_handles[name, fam] = h

    # 3. one engine serving all four families on grid3d_uniform_16
    g16 = suite["grid3d_uniform_16"]
    hs = {fam: cache.factor(g16, key_from_seed(0),
                            graph_id=f"grid3d_uniform_16::{fam}", family=fam)
          for fam in ZOO_FAMILIES}
    er = np.random.default_rng(29)
    eng = SolveEngine(cache, slots=4, iters_per_tick=8)
    reqs = []
    for i, fam in enumerate(ZOO_FAMILIES):
        b = er.normal(size=(2, g16.n)).astype(np.float32)
        reqs.append(SolveRequest(rid=i, graph_id=f"grid3d_uniform_16::{fam}",
                                 b=b - b.mean(axis=1, keepdims=True),
                                 tol=1e-6, maxiter=500))
        eng.submit(reqs[-1])
    t0 = time.time()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    t_eng = time.time() - t0
    check(len(done) == len(reqs), "zoo: the engine left requests unserved")
    for r, fam in zip(reqs, ZOO_FAMILIES):
        ref = hs[fam].solve(torch.from_numpy(r.b).to(dev), tol=r.tol,
                            maxiter=r.maxiter)
        check(r.status == "converged"
              and np.array_equal(np.atleast_2d(r.x).view(np.uint32),
                                 ref.x.cpu().numpy().view(np.uint32))
              and np.array_equal(np.atleast_1d(r.iters),
                                 ref.iters.cpu().numpy()),
              f"zoo: the engine's {fam} request differs from its direct "
              f"solve")
    st = eng.stats()
    check(st.buckets == len(ZOO_FAMILIES) and st.step_compiles == st.buckets,
          f"zoo: engine buckets {st.buckets}, step_compiles "
          f"{st.step_compiles}")
    log(f"[zoo] engine: 4 families on grid3d_uniform_16, 4 requests of 2 "
        f"rhs in {t_eng:.3f}s over {st.ticks} ticks, each bitwise equal "
        f"to its direct solve; iters "
        + ", ".join(f"{fam} {np.atleast_1d(r.iters).tolist()}"
                    for r, fam in zip(reqs, ZOO_FAMILIES))
        + f"; buckets {st.buckets} == step_compiles {st.step_compiles}; "
        f"{card}")
    del eng, hs, reqs, done

    # 4. --precond auto through the serve launcher's entry point
    t0 = time.time()
    metrics, done = run_service(suite="small", precond="auto",
                                device=str(dev), requests=12,
                                warmup_requests=12)
    torch.cuda.synchronize()
    t_auto = time.time() - t0
    check(metrics["completed"] == metrics["converged"] == 12,
          f"zoo auto: {metrics['converged']} of {metrics['completed']} "
          f"requests converged (12 sent)")
    sel = metrics["selector"]
    log(f"[zoo] auto: suite small, build {metrics['factor_s']:.2f}s (AC "
        f"batch on the card, ichol/amg/spai on the host), warm-up and "
        f"12-request trace {t_auto - metrics['factor_s']:.2f}s; measured "
        f"trace {metrics['serve_s']:.3f}s, {metrics['requests_per_s']:.3f} "
        f"requests/s, latency p50 {metrics['latency_p50_s']:.3f}s p95 "
        f"{metrics['latency_p95_s']:.3f}s; selector picks_by_family "
        f"{sel['picks_by_family']} (explores {sel['explores']}, cold "
        f"{sel['cold_picks']}); served graph ids "
        f"{sorted({r.graph_id for r in done})}; {card}")
    del done
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    log(f"[zoo] launches over the path: {launches}")
    for name in ("ell_spmv_fleet", "ell_sweep_fleet", "sample_clique_round"):
        check(launches.get(name, 0) > 0,
              f"zoo: the path never launched the {name} kernel")
    for name in ZOO_SILENT:
        check(launches.get(name, 0) == 0,
              f"zoo: the path launched the {name} kernel")

    # comparisons with the plain versions (after the path's counts)
    gen = torch.Generator(device=dev).manual_seed(5)
    R = torch.zeros((1, hi.n_pad), device=dev)
    R[0, :hi.n] = torch.randn(hi.n, generator=gen, device=dev)
    got = hi.precondition(R[0, :hi.n])
    want = fleet_apply_plain(hi, R)[0, :hi.n]
    torch.cuda.synchronize()
    rel = float((got - want).abs().max()) / max(float(want.abs().max()),
                                                1e-30)
    check(rel <= 1e-5, f"zoo: ichol's apply differs from its plain "
                       f"version by {rel:.2e} relative")
    log(f"[zoo] ichol 64^3 apply vs ell_sweep_fleet_plain: relative error "
        f"{rel:.2e}")
    errs = {}
    for (name, fam), h in spmv_handles.items():
        fa = h.fleet.arrays
        X = torch.zeros((8, h.n_pad), device=dev)
        X[:, :h.n] = torch.randn((8, h.n), generator=gen, device=dev)
        fidx = torch.full((8,), h.fleet_row, dtype=torch.int32, device=dev)
        y = spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx, X, fa.flen)
        p = spmv.ell_spmv_fleet_plain(fa.fcols, fa.fvals, fidx, X, fa.flen)
        # all K slots, and x gathered through L1 instead of shared memory
        for other, what in (
                (spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx, X),
                 "all K slots"),
                (spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx, X, fa.flen,
                                     x_smem=False), "x through L1")):
            check(bitwise_equal(y, other),
                  f"zoo {fam} {name}: the full-row kernel over flen with x "
                  f"in shared memory differs from {what}")
        err = (y.double() - p.double()).abs()
        exact, kernel_bound, plain_bound = spmv.ell_spmv_fleet_error_bounds(
            fa.fcols, fa.fvals, fidx, X)
        ratio, plain_ratio = (
            float(((z.double() - exact).abs()
                   / bnd.clamp(min=1e-300)).max())
            for z, bnd in ((y, kernel_bound), (p, plain_bound)))
        check(ratio <= 1.0, f"zoo {fam} {name}: the full-row kernel is "
                            f"{ratio:.3g} times its forward-error bound")
        check(plain_ratio <= 1.0,
              f"zoo {fam} {name}: the plain version is {plain_ratio:.3g} "
              f"times its forward-error bound")
        for lane in range(8):
            alone = spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx[:1],
                                        X[lane:lane + 1].contiguous(),
                                        fa.flen)
            check(bitwise_equal(alone[0], y[lane]),
                  f"zoo {fam} {name}: lane {lane} alone differs from the "
                  f"same lane in the 8-lane batch")
        errs[name, fam] = float(err.max())
        rel = errs[name, fam] / max(float(p.abs().max()), 1e-30)
        log(f"[zoo] {fam} {name} full-row ell_spmv_fleet L=8 R={h.n_pad} "
            f"K={h.fleet.Kf} over flen ({int(fa.flen[h.fleet_row].sum())} "
            f"live slots): max abs err {errs[name, fam]:.3e} (relative "
            f"{rel:.2e}); against the exact float64 row sums, worst ratio "
            f"to its own order's forward-error bound: kernel {ratio:.3e}, "
            f"plain {plain_ratio:.3e}; == all K slots and == x through L1, "
            f"each lane alone == its lane of the batch, bit for bit")
    mixed_factor_lanes(dev, [spmv_handles["grid3d_uniform_16", fam]
                             for fam in ("amg", "spai")], gen)
    log(f"[zoo] phase passed in {time.time() - t_phase:.1f}s; {card}")
    return dict(launches=launches, handles=spmv_handles, errs=errs)


def mixed_factor_lanes(dev, handles, gen):
    """Two spmv panels stacked (the amg and spai rows of grid3d_uniform_16,
    zero-padded to one K) under 8 lanes interleaved, fidx = [0, 1, 0, 1,
    ...]: one launch, and each lane bitwise equal to that lane launched
    alone and to its lane of its factor's 8-lane launch."""
    import torch
    from repro_torch.kernels import spmv
    K = max(h.fleet.arrays.fcols.shape[2] for h in handles)
    n_pad = handles[0].n_pad
    rows = [(h.fleet.arrays, h.fleet_row) for h in handles]
    pad = [(0, K - fa.fcols.shape[2]) for fa, _ in rows]
    cols = torch.stack([torch.nn.functional.pad(fa.fcols[r], p)
                        for (fa, r), p in zip(rows, pad)])
    vals = torch.stack([torch.nn.functional.pad(fa.fvals[r], p)
                        for (fa, r), p in zip(rows, pad)])
    lens = torch.stack([fa.flen[r] for fa, r in rows])
    X = torch.zeros((8, n_pad), device=dev)
    X[:, :handles[0].n] = torch.randn((8, handles[0].n), generator=gen,
                                      device=dev)
    fidx = torch.tensor([0, 1] * 4, dtype=torch.int32, device=dev)
    y = spmv.ell_spmv_fleet(cols, vals, fidx, X, lens)
    per_factor = [spmv.ell_spmv_fleet(cols, vals, torch.full_like(fidx, f),
                                      X, lens) for f in (0, 1)]
    for lane in range(8):
        f = lane % 2
        alone = spmv.ell_spmv_fleet(cols, vals, fidx[lane:lane + 1],
                                    X[lane:lane + 1].contiguous(), lens)
        check(bitwise_equal(alone[0], y[lane])
              and bitwise_equal(per_factor[f][lane], y[lane]),
              f"zoo: lane {lane} of the interleaved two-factor launch "
              f"differs from the lane alone or from its factor's 8-lane "
              f"launch")
    log(f"[zoo] amg and spai panels stacked (K={K}), 8 lanes interleaved: "
        f"each lane == the lane alone == its lane of its factor's 8-lane "
        f"launch, bit for bit")


def zoo_timing(dev, zoo):
    """The [timing] rows of the full-row ell_spmv_fleet at the shapes the
    [zoo] path gives it: the amg panel of grid3d_uniform_16 and the spai
    panel of powerlaw_4k, over each row's live slots (flen), 8 lanes each,
    against the plain version and torch.sparse.mm on the same rows in CSR
    (live slots only).  Also printed: the same at 1 lane, the wrapper's
    host time per call, and 8 lanes with x gathered through L1."""
    import torch
    from repro_torch.kernels import spmv
    rows = []
    for key in (("grid3d_uniform_16", "amg"), ("powerlaw_4k", "spai")):
        h = zoo["handles"][key]
        fa = h.fleet.arrays
        n_pad, K = h.n_pad, fa.fcols.shape[2]
        L = 8
        X = torch.zeros((L, n_pad), device=dev)
        X[:, :h.n] = torch.randn((L, h.n), device=dev)
        fidx = torch.full((L,), h.fleet_row, dtype=torch.int32, device=dev)

        def kernel(lanes=L, **kw):
            return spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx[:lanes],
                                       X[:lanes], fa.flen, **kw)
        ms = time_ms(kernel)
        device_ms = device_ms_per_launch(kernel)
        busy, events = device_busy_ms(lambda: [kernel() for _ in range(20)])
        log(f"[timing] ell_spmv_fleet {key[1]} panel L=8: one trace of 20 "
            f"calls held {events} device events, {busy} ms busy")
        plain_ms = time_ms(lambda: spmv.ell_spmv_fleet_plain(
            fa.fcols, fa.fvals, fidx, X, fa.flen), reps=2)
        c = fa.fcols[h.fleet_row].reshape(-1)
        v = fa.fvals[h.fleet_row].reshape(-1)
        # a row's kept entries are its first slots, all nonzero: row-major
        # order of the live slots is CSR order
        live = v != 0
        crow = torch.zeros(n_pad + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum((fa.fvals[h.fleet_row] != 0).sum(1), 0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            csr = torch.sparse_csr_tensor(crow, c[live].long(), v[live],
                                          size=(n_pad, n_pad),
                                          check_invariants=False)
        XT = X.T.contiguous()
        y_lib = torch.sparse.mm(csr, XT).T
        torch.cuda.synchronize()
        # cuSPARSE's summation order and product roundings are not known:
        # the plain version's bound (K roundings a term) covers any order
        # of a row's K terms, with or without FMA
        exact, _, any_order = spmv.ell_spmv_fleet_error_bounds(
            fa.fcols, fa.fvals, fidx, X)
        check(bool(((y_lib.double() - exact).abs() <= any_order).all()),
              f"torch.sparse.mm is beyond the forward-error bound of the "
              f"exact row sums on the {key[1]} panel")
        lib_ms = time_ms(lambda: torch.sparse.mm(csr, XT))
        nnz = int(live.sum())
        x_bytes = L * gathered_bytes(c, v, 1)
        nbytes = nnz * 8 + x_bytes + L * 4 + L * n_pad * 4
        # one lane (x_bytes of one lane), the wrapper's host time, and the
        # gathers through L1
        one = bound(nnz * 8 + x_bytes // L + 4 + n_pad * 4, 2 * nnz)
        log(f"[timing] ell_spmv_fleet {key[1]} panel L=1: kernel "
            f"{time_ms(lambda: kernel(1)):.4f} ms (device time "
            f"{device_ms_per_launch(lambda: kernel(1))} ms per launch), "
            f"bound {one['bound_ms']:.5f} ms; L=8 device time {device_ms} "
            f"ms; wrapper host time {host_ms_per_call(kernel):.4f} ms a "
            f"call; L=8 with x through L1: device time "
            f"{device_ms_per_launch(lambda: kernel(x_smem=False))} ms")
        rows.append(dict(
            name="ell_spmv_fleet", route="cuda",
            source="src/repro_torch/csrc/ell_spmv_fleet.cu",
            replaces="src/repro/kernels/spmv.py:104",
            launches=zoo["launches"].get("ell_spmv_fleet", 0),
            max_abs_err=zoo["errs"][key], ms=ms, plain_ms=plain_ms,
            **bound(nbytes, 2 * L * nnz), library_ms=lib_ms,
            shape=f"{key[1]} {key[0]} panel: L={L} R={n_pad} K={K} "
                  f"nnz={nnz} x_bytes={x_bytes} (padded panel bytes "
                  f"{n_pad * K * 8})",
            device_ms=device_ms))
    log_rows(rows)
    return rows


def host_ms_per_call(fn, reps: int = 20) -> float:
    """Host wall time per call of ``fn``, ``reps`` calls enqueued without
    a sync (the card's queue takes them), after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


DIST_SILENT = ("sample_clique", "ell_spmv_fleet", "ell_sweep_fleet",
               "ell_spmv", "ell_spmv_multi", "flash_attention")
# the world-4 run on one card: ranks, keys (two a rank), the graph's side
# and the time the spawned ranks get before the phase fails
DIST_WORLD = 4
DIST_KEYS = 8
DIST_SIDE = 32
DIST_LIMIT_S = 300
EXAMPLES = (("torch_quickstart", ("sample_clique_round", "ell_sweep")),
            ("torch_sparsify", ("sample_clique_round", "ell_sweep_multi")),
            ("torch_spectral_embedding", ("sample_clique_round",
                                          "ell_sweep_multi")))


class AllReduceTally:
    """Counts torch.distributed.all_reduce calls while the ``with`` block
    runs (the port's dist module calls it through the module)."""

    def __enter__(self):
        import torch.distributed as tdist
        self.count = 0
        self._real = tdist.all_reduce

        def counted(*a, **kw):
            self.count += 1
            return self._real(*a, **kw)

        tdist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        import torch.distributed as tdist
        tdist.all_reduce = self._real
        return False


def digest(*arrays) -> str:
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).view(np.uint8))
    return h.hexdigest()


def factor_digest(f) -> str:
    return digest(*(getattr(f, k) for k in FACTOR_FIELDS))


def dist_graph(side: int):
    from repro_torch.data import graphs
    return permuted(graphs.grid3d(side, side, side, "uniform", seed=2))


def dist_vectors(n: int):
    """The world-4 run's seeded x (for the matvec) and b (for the PCG)."""
    import numpy as np
    rng = np.random.default_rng(0)
    return (rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


def dist_rank(rank: int, world: int, port: int, dev: str, side: int,
              factor: dict, slack: int, keys, out) -> None:
    """One rank of the world-4 run (a spawned process): gloo over one
    store, every rank on ``dev`` (the one card).  Puts (rank, results) on
    ``out``."""
    import traceback
    try:
        sys.path.insert(0, str(SRC))
        import numpy as np
        import torch
        import torch.distributed as tdist
        from repro_torch.core import dist as D
        from repro_torch.core.convert import factor_from_numpy
        from repro_torch.core.laplacian import laplacian_matvec_np
        from repro_torch.core.trisolve import make_preconditioner
        from repro_torch.kernels import runtime
        from repro_torch.launch.mesh import init_group, make_host_mesh
        store = tdist.TCPStore("127.0.0.1", port, world, is_master=False)
        dev = init_group(dev, rank=rank, world_size=world, store=store,
                         backend="gloo")
        mesh = make_host_mesh(world, 1, device=dev)
        g = dist_graph(side)
        x, b = dist_vectors(g.n)
        apply = make_preconditioner(factor_from_numpy(**factor), device=dev)
        runtime.reset_launches()
        y = D.make_sharded_matvec(g, mesh)(torch.from_numpy(x).to(dev))
        y = y.cpu().numpy()
        y_host = laplacian_matvec_np(g, x.astype(np.float64))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = D.sharded_pcg(g, mesh, apply, torch.from_numpy(b).to(dev),
                            tol=1e-6, maxiter=500)
        torch.cuda.synchronize()
        t_pcg = time.perf_counter() - t0
        t0 = time.perf_counter()
        st = D.batched_factorize(g, keys, mesh, chunk=256, fill_slack=slack)
        torch.cuda.synchronize()
        t_bf = time.perf_counter() - t0
        out.put((rank, dict(
            mv_ok=bool(np.allclose(y, y_host, rtol=2e-4, atol=2e-4)),
            mv_err=float(np.abs(y - y_host).max()), y=digest(y),
            x=res.x.cpu().numpy(), iters=int(res.iters),
            relres=float(res.relres), converged=bool(res.converged),
            t_pcg=t_pcg, t_bf=t_bf,
            state=digest(*(t.cpu().numpy() for t in st)),
            rounds=st.n_rounds.tolist(), overflow=st.overflow.tolist(),
            factors=[factor_digest(D.ensemble_factor(g, st, k))
                     for k in range(len(keys))],
            launches=dict(runtime.LAUNCHES))))
        tdist.destroy_process_group()
    except BaseException:
        out.put((rank, dict(error=traceback.format_exc())))


def dist_world1(dev, g, main_f, b1):
    """[dist] part 1: NCCL, world size 1, in this process, at 64^3."""
    import numpy as np
    import torch
    import torch.distributed as tdist
    from repro_torch.core import dist as D
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.convert import factor_from_numpy
    from repro_torch.core.pcg import laplacian_pcg
    from repro_torch.core.trisolve import make_preconditioner
    from repro_torch.kernels import runtime
    from repro_torch.launch.mesh import init_group, make_host_mesh
    init_group(dev, rank=0, world_size=1, store=tdist.HashStore())
    try:
        mesh = make_host_mesh(1, 1, device=dev)
        group = mesh.get_group("data")
        backend = tdist.get_backend(group)
        check(backend == "nccl", f"dist: the world-1 mesh runs on {backend}")
        # the communicator is set up at the group's first collective: once
        # per group, outside the timed solves
        t0 = time.perf_counter()
        tdist.all_reduce(torch.zeros(1, device=dev), group=group)
        torch.cuda.synchronize()
        log(f"[dist] world 1: NCCL communicator set-up (first all-reduce) "
            f"{time.perf_counter() - t0:.3f}s")
        apply = make_preconditioner(factor_from_numpy(**main_f), device=dev)
        b = torch.from_numpy(b1).to(dev)
        solves = {"sharded_pcg": lambda: D.sharded_pcg(
                      g, mesh, apply, b, tol=1e-6, maxiter=500),
                  "laplacian_pcg": lambda: laplacian_pcg(
                      g, apply, b, tol=1e-6, maxiter=500)}
        # A B B A: the first solve after make_preconditioner pays its
        # first-use costs; the first of each is the one checked
        runs, walls = {}, {}
        for name in ("sharded_pcg", "laplacian_pcg", "laplacian_pcg",
                     "sharded_pcg"):
            torch.cuda.synchronize()
            runtime.reset_launches()
            with AllReduceTally() as tally:
                t0 = time.perf_counter()
                r = solves[name]()
                torch.cuda.synchronize()
                walls.setdefault(name, []).append(time.perf_counter() - t0)
            runs.setdefault(name, (r, tally.count, dict(runtime.LAUNCHES)))
        (rs, ar, l_sh), (rl, _, l_lib) = (runs["sharded_pcg"],
                                          runs["laplacian_pcg"])
        it = int(rs.iters)
        t_sh, t_lib = (" / ".join(f"{t:.3f}" for t in walls[k])
                       for k in ("sharded_pcg", "laplacian_pcg"))
        log(f"[dist] world 1 (nccl) 64^3 n={g.n}: sharded_pcg {t_sh}s "
            f"(first / last of A B B A) iters={it} "
            f"relres={float(rs.relres):.3e}, {ar} all-reduces of "
            f"{g.n * 4 / 2**20:.2f} MiB; laplacian_pcg {t_lib}s "
            f"iters={int(rl.iters)}; launches {l_sh} / {l_lib}")
        check(bool(rs.converged), "dist: world-1 sharded_pcg did not converge")
        check(it == int(rl.iters) and bitwise_equal(rs.x, rl.x)
              and bitwise_equal(rs.relres, rl.relres),
              "dist: world-1 sharded_pcg differs from laplacian_pcg")
        check(ar == it, f"dist: {ar} all-reduces for {it} iterations")
        check(l_sh.get("ell_sweep", 0) > 0
              and l_sh.get("ell_sweep", 0) == l_lib.get("ell_sweep", 0),
              f"dist: ell_sweep launches {l_sh} against laplacian_pcg's "
              f"{l_lib}")
        rr = true_relres(g, rs.x.cpu().numpy(), b1)
        check(rr < 1e-4, f"dist: world-1 true residual {rr:.2e}")
        log("[dist] world-1 sharded_pcg == laplacian_pcg bit for bit (x, "
            f"iterations, relres); true residual {rr:.2e}")

        keys = np.stack([key_from_seed(0), key_from_seed(1)])
        torch.cuda.synchronize()
        runtime.reset_launches()
        with AllReduceTally() as tally:
            t0 = time.perf_counter()
            st = D.batched_factorize(g, keys, mesh, chunk=256,
                                     fill_slack=256)
            torch.cuda.synchronize()
            t_bf = time.perf_counter() - t0
        l_bf = dict(runtime.LAUNCHES)
        f0 = D.ensemble_factor(g, st, 0)
        rounds = st.n_rounds.tolist()
        launched = l_bf.get("sample_clique_round", 0)
        log(f"[dist] world 1 batched_factorize of 2 keys 64^3 (chunk 256, "
            f"fill_slack 256, W 512): {t_bf:.3f}s, rounds {rounds}, "
            f"overflow {st.overflow.tolist()}, {tally.count} all-reduce "
            f"({st.pool_row.numel() * 8 / 2**30:.2f} GiB of pool); "
            f"launches {l_bf}")
        check(same_factor(f0, main_f),
              "dist: key 0 of batched_factorize differs from [main]'s factor")
        check(max(rounds) <= launched < max(rounds) + 8,
              f"dist: {launched} sample_clique_round launches for "
              f"{max(rounds)} rounds")
        check(l_bf.get("sample_clique", 0) == 0,
              "dist: batched_factorize launched the standalone sample_clique")
        log("[dist] key 0 of batched_factorize == [main]'s factor bit for "
            "bit (col_ptr, rows, vals, D)")
        launches = {k: l_sh.get(k, 0) + l_bf.get(k, 0)
                    for k in set(l_sh) | set(l_bf)}
        return launches
    finally:
        tdist.destroy_process_group()


def dist_world4(dev, card):
    """[dist] part 2: gloo, world size 4 on one card, spawned ranks, at
    32^3; the kernels are built before (the ranks only load them)."""
    import multiprocessing as mp
    import queue
    import numpy as np
    import torch
    import torch.distributed as tdist
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.parac import factorize_wavefront
    g = dist_graph(DIST_SIDE)
    t0 = time.perf_counter()
    f = factorize_wavefront(g, key_from_seed(0), chunk=256, fill_slack=32,
                            strict=True, device=dev)
    slack = f.stats["fill_slack"]
    keys = np.stack([key_from_seed(k) for k in range(DIST_KEYS)])
    single = [factorize_wavefront(g, k, chunk=256, fill_slack=slack,
                                  strict=False, device=dev) for k in keys]
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    check(factor_digest(single[0]) == factor_digest(f),
          "dist: key 0's non-strict factor differs from its strict one")
    store = tdist.TCPStore("127.0.0.1", 0, None, True,
                           wait_for_workers=False)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=dist_rank, args=(
        r, DIST_WORLD, store.port, str(dev), DIST_SIDE, host_factor(f), slack,
        keys, out)) for r in range(DIST_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    res = {}
    try:
        while len(res) < DIST_WORLD:
            check(time.perf_counter() - t0 < DIST_LIMIT_S,
                  f"dist: world-{DIST_WORLD} ranks {sorted(res)} of "
                  f"{DIST_WORLD} reported within {DIST_LIMIT_S}s")
            try:
                r, d = out.get(timeout=1)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in res]
                check(not dead, f"dist: ranks {dead} exited without a "
                                f"result")
                continue
            check("error" not in d, f"dist: rank {r} failed:\n"
                                    f"{d.get('error')}")
            res[r] = d
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    t_world = time.perf_counter() - t0
    r0 = res[0]
    t_pcg, t_bf = (", ".join(f"{res[r][k]:.3f}" for r in range(DIST_WORLD))
                   for k in ("t_pcg", "t_bf"))
    log(f"[dist] world {DIST_WORLD} (gloo, one card) {DIST_SIDE}^3 n={g.n}: "
        f"ranks done in {t_world:.1f}s (spawn included); sharded matvec max "
        f"abs err {r0['mv_err']:.3e} against the float64 host matvec; "
        f"sharded_pcg iters={r0['iters']} relres={r0['relres']:.3e} "
        f"{t_pcg}s; batched_factorize of {DIST_KEYS} keys (fill_slack "
        f"{slack}) {t_bf}s, "
        f"rounds {r0['rounds']}, overflow {r0['overflow']}; single-device "
        f"factors {t_single:.2f}s; rank 0 launches {r0['launches']}")
    for r in range(DIST_WORLD):
        d = res[r]
        check(d["mv_ok"], f"dist: rank {r}'s sharded matvec is {d['mv_err']:.3e}"
                          f" from the host matvec (limit 2e-4)")
        check(d["converged"], f"dist: rank {r}'s sharded_pcg did not converge")
        check(d["iters"] == r0["iters"] and d["y"] == r0["y"]
              and np.array_equal(d["x"].view(np.uint32),
                                 r0["x"].view(np.uint32)),
            f"dist: rank {r}'s matvec or PCG differs from rank 0's")
        check(d["state"] == r0["state"],
              f"dist: rank {r}'s batched state differs from rank 0's")
        for name in ("sample_clique_round", "ell_sweep"):
            check(d["launches"].get(name, 0) > 0,
                  f"dist: rank {r} never launched {name}")
    for k, fk in enumerate(single):
        check(r0["factors"][k] == factor_digest(fk)
              and r0["rounds"][k] == fk.stats["rounds"],
              f"dist: key {k}'s slice differs from the single-device "
              f"engine's factor")
    rr = true_relres(g, r0["x"], dist_vectors(g.n)[1])
    check(rr < 1e-4, f"dist: world-{DIST_WORLD} true residual {rr:.2e}")
    log(f"[dist] world {DIST_WORLD}: every rank's x and batched state equal "
        f"bit for bit; each key's slice == the single-device engine's factor "
        f"bit for bit; true residual {rr:.2e}; {card}")


def dist_examples(dev):
    """[dist] part 3: the three examples through their main()."""
    import importlib.util
    import torch
    from repro_torch.kernels import runtime
    for name, kernels in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        torch.cuda.synchronize()
        runtime.reset_launches()
        t0 = time.perf_counter()
        res = mod.main(device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(runtime.LAUNCHES)
        log(f"[dist] example {name}: {wall:.2f}s, iterations "
            f"{res['iters']}, launches {launches}")
        check(res["converged"], f"dist: example {name} did not converge")
        for k in kernels:
            check(launches.get(k, 0) > 0,
                  f"dist: example {name} never launched {k}")


def phase_dist(dev, g64, main_f, card):
    """The [dist] phase (see the module docstring).  Returns the world-1
    path's launch counts."""
    import numpy as np
    from repro_torch.kernels import runtime
    t_phase = time.time()
    b1 = np.random.default_rng(0).normal(size=g64.n).astype(np.float32)
    launches = dist_world1(dev, g64, main_f, b1)
    for name in DIST_SILENT:
        check(launches.get(name, 0) == 0,
              f"dist: the world-1 path launched {name}")
    dist_world4(dev, card)
    dist_examples(dev)
    runtime.reset_launches()
    log(f"[dist] phase passed in {time.time() - t_phase:.1f}s; {card}")
    return launches


# ---------------------------------------------------------------------------
# [lm]: the LM serving path (models/, configs/), no kernel of the port
# ---------------------------------------------------------------------------

# part 2's depth: one period of each arch's layer pattern (whisper whole)
LM_DEPTH = {"mamba2-1.3b": 2, "qwen1.5-4b": 2, "qwen3-14b": 2,
            "phi3-medium-14b": 2, "gemma3-27b": 6, "moonshot-v1-16b-a3b": 2,
            "llama4-scout-17b-a16e": 2, "recurrentgemma-2b": 3,
            "chameleon-34b": 2, "whisper-tiny": 4}
LM_TOKENS = 4096          # train_4k's length: a multiple of both windows
LM_PREFILL = 3968         # 31 of mamba2's 128-token chunks
LM_PROMPTS, LM_PROMPT_LEN, LM_STEPS = 2, 2048, 32     # part 3
# float32, card against CPU: the CPU parity tests' bounds (normwise,
# of the largest |value|): 1e-3, 1e-2 for recurrentgemma's RG-LRU state
LM_F32_TOL, LM_F32_RGLRU_TOL = 1e-3, 1e-2
LM_SELF_TOL = 2e-2        # prefill + decode against fwd_train (float32)
# bf16, a decode step's (or prefill's last) logits against fwd_train's row
# at its position, normwise of the row's largest |logit|: the two paths
# round differently (other matmul shapes, the S=1 SSD step, the cache's
# single-query softmax), and a near-tie of an MoE router can flip; on the
# H100 the worst rows read 1.9e-2 (dense and recurrent archs, 2-6
# layers), 4.8e-2 (qwen3-14b, 40 layers) and 7.3e-2 (llama4's top-1
# router, one row; its other rows equal bit for bit)
LM_BF16_TOL = 0.15


def lm_rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def lm_inputs(cfg, dev, B, S, seed, dtype):
    """Seeded tokens [B, S] (int32) and, for whisper, frames scaled by
    0.02, on ``dev``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                              .astype(np.int32)).to(dev)
    enc = None
    if cfg.is_encoder_decoder:
        enc = torch.from_numpy((rng.normal(size=(B, cfg.encoder_len,
                                                 cfg.d_model)) * 0.02)
                               .astype(np.float32)).to(dev, dtype)
    return tokens, enc


def lm_smoke_configs(dev):
    """Part 1: every smoke config in float32 on the card against the same
    parameters on the CPU in this run."""
    import torch
    from repro_torch.configs import get_smoke_config, list_archs
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import init_params, tree_map, tree_paths
    cpu = torch.device("cpu")
    for arch in list_archs():
        cfg = get_smoke_config(arch)
        host = init_params(tf.pdefs(cfg), torch.Generator().manual_seed(0),
                           torch.float32, cpu)
        card = tree_map(lambda a: a.to(dev), host)
        tokens, enc = lm_inputs(cfg, cpu, 2, 32, 7, torch.float32)
        targets = torch.roll(tokens, -1, 1)
        out = {}
        for where, params in (("cpu", host), ("gpu", card)):
            d = cpu if where == "cpu" else dev
            args = [a.to(d) if a is not None else None
                    for a in (tokens, targets, enc)]
            with torch.no_grad():
                logits, _ = tf.fwd_train(params, cfg, args[0], args[2])
                loss, _ = tf.loss_fn(params, cfg, *args)
            out[where] = (logits.cpu(), float(loss))
        tol = LM_F32_RGLRU_TOL if arch == "recurrentgemma-2b" else LM_F32_TOL
        err = lm_rel_err(out["gpu"][0], out["cpu"][0])
        lerr = abs(out["gpu"][1] - out["cpu"][1]) / abs(out["cpu"][1])
        check(err <= tol, f"lm: {arch} card logits {err:.3e} from the CPU's "
                          f"(> {tol})")
        check(lerr <= 1e-4, f"lm: {arch} card loss {lerr:.3e} from the CPU's")
        # one backward on the card
        params = tree_map(lambda a: a.clone().requires_grad_(True), card)
        loss, _ = tf.loss_fn(params, cfg, tokens.to(dev), targets.to(dev),
                             None if enc is None else enc.to(dev))
        loss.backward()
        check(all(torch.isfinite(a.grad).all() for _, a in tree_paths(params)),
              f"lm: {arch} gradients not finite on the card")
        check(float(params["embed"].grad.abs().max()) > 0,
              f"lm: {arch} gradient does not reach the embedding")
        del params, loss
        # prefill (S = 16) + one decode step against fwd_train, as the
        # reference's test; whisper's prefill orders cross-attention and
        # MLP unlike its forward, so it is held to decoding finite logits
        tk = tokens.to(dev)[:, :17]
        encd = None if enc is None else enc.to(dev)
        with torch.no_grad():
            full, _ = tf.fwd_train(card, cfg, tk, encd)
            pre, caches = tf.prefill(card, cfg, tk[:, :16], 32, encd,
                                     dtype=torch.float32)
            enc_out = None if encd is None else tf.encode(card, cfg, encd)
            step, _ = tf.decode_step(card, cfg, caches, tk[:, 16:], 16,
                                     enc_out)
        check(bool(torch.isfinite(step).all()),
              f"lm: {arch} decode logits not finite")
        if not cfg.is_encoder_decoder:
            for got, want, what in ((pre[:, -1], full[:, 15], "prefill"),
                                    (step, full[:, 16], "decode")):
                check(torch.allclose(got, want, rtol=LM_SELF_TOL,
                                     atol=LM_SELF_TOL),
                      f"lm: {arch} {what} logits differ from fwd_train")
        log(f"[lm] {arch} smoke float32: card logits {err:.2e} and loss "
            f"{lerr:.2e} from the CPU's, gradients finite, prefill+decode "
            f"against fwd_train max "
            f"{float((step - full[:, 16]).abs().max()):.2e}")


def lm_matmul_params(cfg) -> int:
    """Parameters a token's forward multiplies by: the active parameters,
    less an input embedding table that is only looked up (not tied)."""
    n = cfg.active_param_count()
    return n if cfg.tie_embeddings else n - cfg.padded_vocab * cfg.d_model


def lm_weight_bytes(params, cfg) -> int:
    """Bytes of the weights one decode step reads: every parameter but an
    untied input embedding table (one row of it)."""
    from repro_torch.models.common import tree_paths
    return sum(a.numel() * a.element_size() for p, a in tree_paths(params)
               if not (p == ("embed",) and not cfg.tie_embeddings))


def lm_report(tag, cfg, params, tokens, pre_ms, steps, dec_ms, card):
    import torch
    n = lm_matmul_params(cfg)
    bound_pre = 2 * n * tokens / BF16_TC_OPS_PER_S * 1e3
    wbytes = lm_weight_bytes(params, cfg)
    bound_dec = wbytes / HBM_BYTES_PER_S * 1e3
    log(f"[lm] {tag}: prefill {tokens} tokens {pre_ms:.2f} ms, "
        f"{tokens / pre_ms * 1e3:.0f} tokens/s (bound {bound_pre:.2f} ms: "
        f"2·{n}·tokens flops at 989 TFLOP/s; {bound_pre / pre_ms:.3f} of "
        f"it); decode {dec_ms:.3f} ms a step over {steps} steps (bound "
        f"{bound_dec:.3f} ms: {wbytes} weight bytes at 3.35 TB/s; "
        f"{bound_dec / dec_ms:.3f} of it); peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")


def lm_full_width(dev, arch, card):
    """Part 2: ``arch`` at full width in bf16, B = 1, depth cut to one
    period; fwd_train over LM_TOKENS, prefill of LM_PREFILL, then a
    decode step at every later position against fwd_train's row."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import init_params
    cfg = dataclasses.replace(get_config(arch), n_layers=LM_DEPTH[arch])
    torch.cuda.reset_peak_memory_stats()
    params = init_params(tf.pdefs(cfg),
                         torch.Generator(device=dev).manual_seed(11),
                         torch.bfloat16, dev)
    tokens, enc = lm_inputs(cfg, dev, 1, LM_TOKENS, 11, torch.bfloat16)
    with torch.no_grad():
        full, _ = tf.fwd_train(params, cfg, tokens, enc)
        torch.cuda.synchronize()
        t0 = time.time()
        pre, caches = tf.prefill(params, cfg, tokens[:, :LM_PREFILL],
                                 LM_TOKENS, enc, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        pre_ms = (time.time() - t0) * 1e3
        pre_last = pre[:, -1]
        del pre
        enc_out = None if enc is None else tf.encode(params, cfg, enc)
        steps = []
        torch.cuda.synchronize()
        t0 = time.time()
        for i in range(LM_PREFILL, LM_TOKENS):
            logits, caches = tf.decode_step(params, cfg, caches,
                                            tokens[:, i:i + 1], i, enc_out)
            steps.append(logits)
        torch.cuda.synchronize()
        dec_ms = (time.time() - t0) * 1e3 / len(steps)
    steps = torch.stack(steps, 1)                       # [1, 128, V]
    want = full[:, LM_PREFILL:]
    check(bool(torch.isfinite(steps).all() and torch.isfinite(full).all()),
          f"lm: {arch} logits not finite")
    errs = [lm_rel_err(steps[:, j], want[:, j]) for j in range(steps.shape[1])]
    pre_err = lm_rel_err(pre_last, full[:, LM_PREFILL - 1])
    worst = max(range(len(errs)), key=errs.__getitem__)
    log(f"[lm] {arch} full width bf16, {cfg.n_layers} layers: decode "
        f"against fwd_train max {errs[worst]:.3e} (position "
        f"{LM_PREFILL + worst}), median {sorted(errs)[len(errs) // 2]:.3e}; "
        f"prefill's last row {pre_err:.3e}")
    if not cfg.is_encoder_decoder:
        check(max(errs) <= LM_BF16_TOL and pre_err <= LM_BF16_TOL,
              f"lm: {arch} bf16 decode differs from fwd_train by "
              f"{max(errs):.3e} (> {LM_BF16_TOL})")
    lm_report(f"{arch} ({cfg.n_layers} layers)", cfg, params, LM_PREFILL,
              pre_ms, len(errs), dec_ms, card)


def lm_whole_model(dev, card):
    """Part 3: qwen3-14b at full width and depth serves LM_PROMPTS prompts
    of LM_PROMPT_LEN tokens, then LM_STEPS greedy decode steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import init_params, tree_paths
    cfg = get_config("qwen3-14b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_params(tf.pdefs(cfg),
                         torch.Generator(device=dev).manual_seed(12),
                         torch.bfloat16, dev)
    torch.cuda.synchronize()
    nbytes = sum(a.numel() * a.element_size() for _, a in tree_paths(params))
    log(f"[lm] qwen3-14b: {cfg.param_count()} parameters "
        f"({nbytes / 2**30:.2f} GiB bf16) initialized in "
        f"{time.time() - t0:.2f}s")
    prompts, _ = lm_inputs(cfg, dev, LM_PROMPTS, LM_PROMPT_LEN, 12,
                           torch.bfloat16)
    max_len = LM_PROMPT_LEN + LM_STEPS
    with torch.no_grad():
        tf.prefill(params, cfg, prompts[:, :64], max_len)   # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        pre, caches = tf.prefill(params, cfg, prompts, max_len)
        nxt = pre[:, -1].argmax(-1)
        torch.cuda.synchronize()
        pre_ms = (time.time() - t0) * 1e3
        pre_last = pre[:, -1]
        del pre
        first = None
        generated = [nxt]
        torch.cuda.synchronize()
        t0 = time.time()
        for i in range(LM_STEPS):
            logits, caches = tf.decode_step(
                params, cfg, caches, nxt[:, None].to(torch.int32),
                LM_PROMPT_LEN + i)
            if first is None:
                first = logits
            nxt = logits.argmax(-1)
            generated.append(nxt)
        torch.cuda.synchronize()
        dec_ms = (time.time() - t0) * 1e3 / LM_STEPS
        check(bool(torch.isfinite(first).all() and
                   torch.isfinite(logits).all()),
              "lm: qwen3-14b decode logits not finite")
        del caches
        seq = torch.cat([prompts, generated[0][:, None].to(torch.int32)], 1)
        full, _ = tf.fwd_train(params, cfg, seq)
    err = lm_rel_err(first, full[:, LM_PROMPT_LEN])
    pre_err = lm_rel_err(pre_last, full[:, LM_PROMPT_LEN - 1])
    log(f"[lm] qwen3-14b {cfg.n_layers} layers: first decode step against "
        f"fwd_train over {LM_PROMPT_LEN + 1} tokens {err:.3e}, prefill's "
        f"last row {pre_err:.3e}; generated "
        f"{torch.stack(generated, 1)[:, :8].tolist()}")
    check(err <= LM_BF16_TOL and pre_err <= LM_BF16_TOL,
          f"lm: qwen3-14b first decode step differs from fwd_train by "
          f"{err:.3e} (> {LM_BF16_TOL})")
    lm_report(f"qwen3-14b ({cfg.n_layers} layers, {LM_PROMPTS} prompts)",
              cfg, params, LM_PROMPTS * LM_PROMPT_LEN, pre_ms, LM_STEPS,
              dec_ms, card)


def phase_lm(dev, card):
    """The [lm] phase (see the module docstring)."""
    import torch
    from repro_torch.configs import list_archs
    from repro_torch.kernels import runtime
    t_phase = time.time()
    runtime.reset_launches()
    check(not any(runtime.LAUNCHES.values()), "lm: counters not reset")
    lm_smoke_configs(dev)
    log(f"[lm] part 1 (smoke configs, float32) {time.time() - t_phase:.1f}s")
    for arch in list_archs():
        t0 = time.time()
        lm_full_width(dev, arch, card)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[lm] {arch} part 2 {time.time() - t0:.1f}s")
    t0 = time.time()
    lm_whole_model(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[lm] part 3 (qwen3-14b) {time.time() - t0:.1f}s")
    launched = {k: v for k, v in runtime.LAUNCHES.items() if v}
    check(not launched, f"lm: kernels of the port launched: {launched}")
    log(f"[lm] phase passed in {time.time() - t_phase:.1f}s, no kernel "
        f"launched; {card}")


# ---------------------------------------------------------------------------
# [train]: the LM training path (optim/, checkpoint/, distributed/steps,
# train/, launch/train.py, examples/torch_train_lm.py), no kernel of the port
# ---------------------------------------------------------------------------

TRAIN_CELL = (4, 32)                      # part 1: B, S (the reference tests')
TRAIN_CPU_STEPS, TRAIN_DECREASE_STEPS = 5, 30
TRAIN_RESUME_STEPS, TRAIN_CRASH_AT = 10, 6
TRAIN_EXAMPLE_ARGS = ["--steps", "100", "--crash-at", "40"]
# float32, card against the CPU after TRAIN_CPU_STEPS steps: each step's
# metrics within 1e-5 relative; the parameters within 1e-3 of the largest
# |value| (the LM parity bound through the stack: an AdamW step amplifies a
# gradient that is zero up to rounding to a move of up to lr either way)
TRAIN_METRIC_TOL, TRAIN_PARAM_TOL = 1e-5, 1e-3
# parts 2 and 3: (arch, layers or None for whole, B, S), bf16 parameters,
# float32 moments, grad_accum 2, TRAIN_BIG_STEPS steps
TRAIN_BIG = (("qwen3-14b", 2, 2, 4096), ("mamba2-1.3b", None, 2, 2048))
TRAIN_BIG_STEPS, TRAIN_BIG_ACCUM = 3, 2
TRAIN_LOSS_TOL = 2e-2     # step 1's loss against loss_fn of the initial
                          # parameters on the same batch, relative (bf16)


def tiny_train_cfg():
    """The reference trainer tests' ``_tiny_cfg``: qwen3's smoke family at
    2 layers, d_model 64, vocab 256."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("qwen3-14b"), n_layers=2,
                               d_model=64, n_heads=4, n_kv_heads=2,
                               head_dim=16, d_ff=128, vocab=256,
                               remat=False)


def tiny_trainer(dev, steps, ckpt_dir=None, ckpt_every=100, grad_accum=1,
                 log_every=1):
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.train import Trainer, TrainConfig
    return Trainer(tiny_train_cfg(), None, ShapeCell("t", "train",
                                                     TRAIN_CELL[1],
                                                     TRAIN_CELL[0]),
                   TrainConfig(steps=steps, ckpt_every=ckpt_every,
                               ckpt_dir=ckpt_dir, lr=1e-3,
                               grad_accum=grad_accum, log_every=log_every),
                   device=dev)


def state_bits_equal(a, b) -> bool:
    """Two trees of tensors equal bit for bit, leaf for leaf."""
    from repro_torch.models.common import tree_paths
    pa, pb = list(tree_paths(a)), list(tree_paths(b))
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        x.dtype == y.dtype and bitwise_equal(x, y)
        for (_, x), (_, y) in zip(pa, pb))


def train_tiny(dev, tmp):
    """Part 1: the tiny config in float32 on the card: against the CPU,
    loss decreasing, resume bit for bit, the example and the launcher."""
    import torch
    from repro_torch.models.common import tree_map, tree_paths
    from repro_torch.optim import adamw_init
    metrics = ("loss", "ce", "aux", "gnorm")
    # (a) the same CPU-initialized parameters on the CPU and on the card
    t0 = time.time()
    hist, params = {}, {}
    cpu = tiny_trainer("cpu", TRAIN_CPU_STEPS, grad_accum=2)
    cpu.init_or_restore()
    card = tiny_trainer(dev, TRAIN_CPU_STEPS, grad_accum=2)
    card.params = tree_map(lambda a: a.to(dev), cpu.params)
    card.opt = adamw_init(card.params)
    for where, tr in (("cpu", cpu), ("card", card)):
        hist[where] = tr.run()
        params[where] = dict(tree_paths(tr.params))
    merr = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in
               zip(hist["card"], hist["cpu"]) for k in metrics if w[k])
    check(len(hist["card"]) == TRAIN_CPU_STEPS and all(
        g[k] == w[k] for g, w in zip(hist["card"], hist["cpu"])
        for k in metrics if not w[k]), "train: metric histories differ")
    scale = max(float(a.abs().max()) for a in params["cpu"].values())
    perr = max(float((params["card"][p].cpu() - a).abs().max())
               for p, a in params["cpu"].items()) / scale
    log(f"[train] tiny config, {TRAIN_CPU_STEPS} steps at grad_accum 2: "
        f"card metrics within {merr:.2e} relative of the CPU's, parameters "
        f"{perr:.2e} of the largest ({perr * scale / 1e-3:.3f} lr); "
        f"{time.time() - t0:.1f}s")
    check(merr <= TRAIN_METRIC_TOL,
          f"train: card metrics {merr:.3e} from the CPU's (> "
          f"{TRAIN_METRIC_TOL})")
    check(perr <= TRAIN_PARAM_TOL,
          f"train: card parameters {perr:.3e} from the CPU's (> "
          f"{TRAIN_PARAM_TOL})")
    # (b) loss decreases
    t0 = time.time()
    tr = tiny_trainer(dev, TRAIN_DECREASE_STEPS, log_every=5)
    tr.init_or_restore()
    h = tr.run()
    check(h[-1]["ce"] < h[0]["ce"] and all(
        torch.isfinite(torch.tensor(x["loss"])) for x in h),
          f"train: CE did not decrease on the card ({h[0]['ce']:.4f} -> "
          f"{h[-1]['ce']:.4f})")
    log(f"[train] tiny config, {TRAIN_DECREASE_STEPS} steps on the card: CE "
        f"{h[0]['ce']:.4f} (step 5) -> {h[-1]['ce']:.4f}; "
        f"{time.time() - t0:.1f}s")
    # (c) resume: 10 steps == 6 steps, a checkpoint, a fresh Trainer, 4
    t0 = time.time()
    full = tiny_trainer(dev, TRAIN_RESUME_STEPS)
    full.init_or_restore()
    h_full = full.run()
    d = str(Path(tmp) / "resume")
    part = tiny_trainer(dev, TRAIN_CRASH_AT, d, ckpt_every=TRAIN_CRASH_AT)
    part.init_or_restore()
    part.run()
    res = tiny_trainer(dev, TRAIN_RESUME_STEPS, d)
    check(res.init_or_restore() and res.step == TRAIN_CRASH_AT,
          "train: no resume from the card's checkpoint")
    check(all(a.device.type == "cuda" for _, a in
              tree_paths((res.params, res.opt))),
          "train: the checkpoint was not restored onto the card")
    h_res = res.run()
    same_metrics = [(g["step"], k) for g, w in
                    zip(h_res, h_full[TRAIN_CRASH_AT:]) for k in metrics
                    if g[k] != w[k]]
    same_state = state_bits_equal(res.params, full.params) and \
        state_bits_equal(res.opt, full.opt)
    log(f"[train] resume on the card: {TRAIN_RESUME_STEPS} steps against "
        f"{TRAIN_CRASH_AT} + checkpoint + {TRAIN_RESUME_STEPS - TRAIN_CRASH_AT}"
        f": metrics differing {same_metrics or 'none'}, parameters and "
        f"moments bitwise {'equal' if same_state else 'DIFFERENT'}; "
        f"{time.time() - t0:.1f}s")
    check(not same_metrics and same_state,
          "train: the card's resume is not bit for bit")
    # (d) the example, (e) the launcher, through their mains on the card
    t0 = time.time()
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_train_lm
    finally:
        sys.path.pop(0)
    out = torch_train_lm.main(TRAIN_EXAMPLE_ARGS + [
        "--ckpt-dir", str(Path(tmp) / "example")])
    crash = int(TRAIN_EXAMPLE_ARGS[TRAIN_EXAMPLE_ARGS.index("--crash-at") + 1])
    check(out["resumed_at"] == crash and all(
        torch.isfinite(torch.tensor(x["ce"])) for x in out["hist"]),
          "train: the example did not resume at its crash step")
    log(f"[train] examples/torch_train_lm.py {' '.join(TRAIN_EXAMPLE_ARGS)} "
        f"on the card: resumed at {out['resumed_at']}, CE "
        f"{out['hist'][0]['ce']:.3f} -> {out['hist'][-1]['ce']:.3f}; "
        f"{time.time() - t0:.1f}s")
    t0 = time.time()
    from repro_torch.launch import train as launch_train
    h = launch_train.main(["--smoke", "--steps", "4"])
    check(h[-1]["step"] == 4 and bool(torch.isfinite(
        torch.tensor(h[-1]["loss"]))), "train: the launcher failed")
    log(f"[train] launch/train.py --smoke --steps 4 on the card: loss "
        f"{h[-1]['loss']:.4f}; {time.time() - t0:.1f}s")


def train_big(dev, arch, layers, B, S, card):
    """Parts 2 and 3: ``arch`` at full width (``layers`` deep, or whole) in
    the reference's train layout: bf16 parameters, float32 moments."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_map, tree_paths
    from repro_torch.optim import adamw_update
    from repro_torch.train import Trainer, TrainConfig
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t_part = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, None, ShapeCell("train", "train", S, B),
                 TrainConfig(steps=TRAIN_BIG_STEPS, ckpt_dir=None,
                             grad_accum=TRAIN_BIG_ACCUM, log_every=1),
                 param_dtype=torch.bfloat16, device=dev)
    tr.init_or_restore()
    n = sum(a.numel() for _, a in tree_paths(tr.params))
    n_mul = lm_matmul_params(cfg)
    init = tree_map(torch.clone, tr.params)
    tokens, targets = tr._host_batch(0)
    with torch.no_grad():
        want, _ = tf.loss_fn(tr.params, cfg, tokens, targets)
    want = float(want)
    del tokens, targets
    stamps = []

    def on_step(step, m):
        torch.cuda.synchronize()
        stamps.append(time.time())

    torch.cuda.synchronize()
    t0 = time.time()
    hist = tr.run(on_step=on_step)
    walls = [b - a for a, b in zip([t0] + stamps, stamps)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    ok_finite = all(torch.isfinite(torch.tensor([m["loss"], m["ce"],
                                                 m["gnorm"]])).all()
                    for m in hist)
    before = dict(tree_paths(init))
    # a leaf may stay put only where bf16 rounding absorbs any AdamW move:
    # a step moves a weight by at most about 3 lr, and a bf16 weight
    # moves only by more than |p| 2^-9
    lr = tr.tcfg.lr
    unchanged = [(p, float(a.abs().min())) for p, a in tree_paths(tr.params)
                 if torch.equal(a, before[p])]
    stuck = [p for p, m in unchanged if m < 512 * 3 * lr]
    no_grad = [p for p, a in tree_paths(tr.opt.mu) if not bool(a.any())]
    dtypes = {str(a.dtype) for _, a in tree_paths((tr.opt.mu, tr.opt.nu))}
    pdtypes = {str(a.dtype) for _, a in tree_paths(tr.params)}
    lerr = abs(hist[0]["loss"] - want) / abs(want)
    del init, before
    tokens = B * S
    wall = statistics.median(walls[1:])         # steps 2-3: warm
    # where a step's time goes: one more step (batch 3) under the
    # profiler, its device busy share; the AdamW update alone (the first
    # moments standing in for gradients), synchronized
    batch = tr._host_batch(TRAIN_BIG_STEPS)
    t0 = time.time()
    busy, events = device_busy_ms(
        lambda: tr.step_fn(tr.params, tr.opt, *batch), host_ops=False)
    traced_ms = (time.time() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.time()
    out = adamw_update(tr.opt.mu, tr.opt, tr.params, lr=lr)
    torch.cuda.synchronize()
    adamw_ms = (time.time() - t0) * 1e3
    del out, batch
    bound = 6 * n_mul * tokens / BF16_TC_OPS_PER_S
    tag = f"{arch} ({cfg.n_layers} layers, B {B} x S {S})"
    log(f"[train] {tag}: {n} parameters ({n_mul} multiplied per token), "
        f"bf16 parameters {sorted(pdtypes)}, moments {sorted(dtypes)}; "
        f"losses {[round(m['loss'], 5) for m in hist]}, ce "
        f"{[round(m['ce'], 5) for m in hist]}, gnorm "
        f"{[round(m['gnorm'], 4) for m in hist]}; step 1's loss "
        f"{lerr:.3e} from loss_fn of the initial parameters ({want:.5f}); "
        f"leaves unchanged (smallest |p|) {unchanged or 'none'}")
    log(f"[train] {tag}: step walls {[round(w * 1e3, 1) for w in walls]} ms;"
        f" steps 2-3 median {wall * 1e3:.1f} ms, {tokens / wall:.0f} "
        f"tokens/s (bound {bound * 1e3:.1f} ms: 6·{n_mul}·{tokens} = "
        f"{6 * n_mul * tokens:.3e} flops at 989 TFLOP/s; {bound / wall:.3f} "
        f"of it); peak allocated {peak:.2f} GiB; a traced step "
        f"{traced_ms:.1f} ms with the device busy {busy or 0:.1f} ms "
        f"({(busy or 0) / (wall * 1e3):.3f} of the untraced step; {events} "
        f"device events); AdamW alone {adamw_ms:.1f} ms; part "
        f"{time.time() - t_part:.1f}s; {card}")
    check(ok_finite, f"train: {arch} loss, ce or gnorm not finite")
    check(not stuck, f"train: {arch} leaves unchanged: {stuck}")
    check(not no_grad, f"train: {arch} leaves with no gradient: {no_grad}")
    check(dtypes == {"torch.float32"} and pdtypes == {"torch.bfloat16"},
          f"train: {arch} dtypes {pdtypes} / {dtypes}")
    check(lerr <= TRAIN_LOSS_TOL, f"train: {arch} step 1's loss {lerr:.3e} "
          f"from loss_fn's (> {TRAIN_LOSS_TOL})")
    del tr
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(dev, card):
    """The [train] phase (see the module docstring)."""
    import tempfile
    import torch
    from repro_torch.kernels import runtime
    t_phase = time.time()
    runtime.reset_launches()
    check(not any(runtime.LAUNCHES.values()), "train: counters not reset")
    tmp = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        train_tiny(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] part 1 (tiny config, float32) {time.time() - t_phase:.1f}s")
    for arch, layers, B, S in TRAIN_BIG:
        train_big(dev, arch, layers, B, S, card)
    launched = {k: v for k, v in runtime.LAUNCHES.items() if v}
    check(not launched, f"train: kernels of the port launched: {launched}")
    log(f"[train] phase passed in {time.time() - t_phase:.1f}s, no kernel "
        f"launched; {card}")


# ---------------------------------------------------------------------------
# [mesh]: the LM sharding layer (distributed.ctx, the step builders and the
# Trainer over DeviceMeshes, the dry run), no kernel of the port
# ---------------------------------------------------------------------------

MESH_ARCHS = ("qwen3-14b", "moonshot-v1-16b-a3b", "mamba2-1.3b",
              "recurrentgemma-2b", "gemma3-27b", "whisper-tiny")
MESH_SHAPES = {"2x2": ((2, 2), ("data", "model")),
               "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
MESH_WORLD = 4
MESH_B, MESH_S, MESH_LR, MESH_ACCUM = 4, 32, 1e-3, 2
MESH_PREFILL, MESH_DECODE, MESH_MAX_LEN = 16, 4, 32
MESH_TRAIN_STEPS = 3                      # part 1's Trainer steps
# part 2 against the one-device steps on the card (float32, float32
# caches): the CPU mesh files' bounds
MESH_METRIC_TOL, MESH_PARAM_TOL, MESH_LOGIT_TOL = 1e-5, 1e-3, 1e-4
MESH_MOMENT_TOL, MESH_RGLRU_TOL, MESH_LR_MULTIPLE = 1e-3, 1e-2, 2.1
# where part 2's and part 3's gloo ranks keep their tensors.  Not the
# card: DTensor's collectives go through torch's functional collectives,
# and on torch 2.11.0+cu128 gloo's all_gather_into_tensor of CUDA tensors
# through them (_c10d_functional.all_gather_into_tensor, then wait_tensor)
# kills every rank with a segmentation fault (exit -11), though the same
# call through torch.distributed and an all_reduce through them run
# (scripts/gloo_cuda_collectives.py).  So these ranks run on the card's
# host; the one-device runs they are held against run on the card.
MESH_RANK_DEVICE = "cpu"
MESH_RANK_REASON = ("gloo's functional all_gather_into_tensor of CUDA "
                    "tensors segfaults on torch 2.11 (every rank exit -11)")
MESH_RANK_THREADS = 2                     # intra-op threads a host rank
# part 3: arch, layers, mesh (data, model), B, prompt, decode steps
MESH_TP = ("qwen3-14b", 2, (1, 4), 2, 512, 8)
# part 4: (arch, cell, multi-pod) dry runs, each its own process
MESH_DRYRUN = (("qwen3-14b", "train_4k", False),
               ("qwen3-14b", "train_4k", True),
               ("qwen3-14b", "decode_32k", False),
               ("qwen3-14b", "decode_32k", True),
               ("moonshot-v1-16b-a3b", "train_4k", False))
MESH_LIMIT_S = 600


def mesh_inputs(arch: str, dev):
    """(cfg, params, opt, tokens, targets, enc_frames, enc_out) of the
    arch's smoke config in float32: parameters from the CPU generator
    (seed 0) and seeded inputs, moved to ``dev``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import init_params, tree_map
    from repro_torch.optim import adamw_init
    cfg = get_smoke_config(arch)
    p = tree_map(lambda a: a.to(dev), init_params(
        tf.pdefs(cfg), torch.Generator().manual_seed(0), torch.float32,
        "cpu"))
    tokens, enc = lm_inputs(cfg, dev, MESH_B, MESH_S, 1, torch.float32)
    targets = torch.roll(tokens, -1, 1)
    enc_out = None
    if enc is not None:
        with torch.no_grad():
            enc_out = tf.encode(p, cfg, enc)
    return cfg, p, adamw_init(p), tokens, targets, enc, enc_out


def mesh_cells():
    from repro_torch.configs.shapes import ShapeCell
    return (ShapeCell("t", "train", MESH_S, MESH_B),
            ShapeCell("p", "prefill", MESH_MAX_LEN, MESH_B))


def mesh_run(arch: str, mesh, dev):
    """One arch's train step (grad_accum 2), prefill and decode steps on
    ``mesh`` (None: one device), all results whole on the host as numpy."""
    import torch
    from repro_torch.distributed import ctx
    from repro_torch.distributed import steps as S
    from repro_torch.models.common import tree_paths
    cfg, p, o, tok, tgt, enc, enc_out = mesh_inputs(arch, dev)
    train, serve = mesh_cells()
    faults = 0
    if mesh is not None:
        ps, os_ = S.train_state_specs(cfg, mesh)
        p, o = S.shard_state(p, ps, mesh), S.shard_state(o, os_, mesh)
        faults = mesh_shard_faults(mesh, (p, o), (ps, os_))
    step = S.make_train_step(cfg, mesh, train, lr=MESH_LR,
                             grad_accum=MESH_ACCUM)
    p2, o2, m = step(p, o, tok, tgt, enc)
    p2, o2 = S.unshard(p2), S.unshard(o2)
    r = {f"m_{k}": float(v) for k, v in m.items()}
    r["faults"] = faults
    for name, tree in (("p", p2), ("mu", o2.mu), ("nu", o2.nu)):
        for path, a in tree_paths(tree):
            r[f"{name}/{'/'.join(map(str, path))}"] = a.detach().cpu().numpy()
    for path, a in tree_paths(S.unshard(p)):
        r[f"before/{'/'.join(map(str, path))}"] = a.detach().cpu().numpy()
    pre = S.make_prefill(cfg, mesh, serve, cache_dtype=torch.float32)
    dec = S.make_decode_step(cfg, mesh, serve)
    logits, caches = pre(p, tok[:, :MESH_PREFILL], enc)
    r["logits0"] = ctx.full(logits).cpu().numpy()
    for i in range(MESH_DECODE):
        pos = MESH_PREFILL + i
        lg, caches = dec(p, caches, tok[:, pos:pos + 1], pos, enc_out)
        r[f"logits{i + 1}"] = ctx.full(lg).cpu().numpy()
    return r


def mesh_shard_faults(mesh, state, specs) -> int:
    """How many leaves of ``state`` (DTensors) this rank holds at another
    shape than their spec in ``specs`` divides out."""
    from repro_torch.distributed.pspec import mesh_shape
    from repro_torch.models.common import tree_paths
    sizes = mesh_shape(mesh).shape
    bad = 0
    for (_, a), (_, spec) in zip(tree_paths(state), tree_paths(specs)):
        want = []
        for n, part in zip(a.shape, spec):
            ext = 1
            for ax in ((part,) if isinstance(part, str) else (part or ())):
                ext *= sizes[ax]
            want.append(n // ext)
        bad += tuple(a.to_local().shape) != tuple(want)
    return bad


def mesh_rank(rank: int, port: int, dev: str, out) -> None:
    """One rank of [mesh] part 2 (a spawned process): gloo over one store,
    every rank on ``dev``; every arch on both meshes.  Puts (rank, results)
    on ``out``: rank 0's whole results, every rank's shard faults."""
    import traceback
    try:
        dev = rank_start(rank, port, dev)
        import torch.distributed as tdist
        from torch.distributed.device_mesh import init_device_mesh
        res, walls, faults = {}, {}, 0
        for mname, (shape, names) in MESH_SHAPES.items():
            mesh = init_device_mesh(dev.type, shape, mesh_dim_names=names)
            for arch in MESH_ARCHS:
                t0 = time.perf_counter()
                r = mesh_run(arch, mesh, dev)
                walls[(mname, arch)] = time.perf_counter() - t0
                faults += r["faults"]
                if rank == 0:
                    res[(mname, arch)] = r
        out.put((rank, dict(res=res, walls=walls, faults=faults,
                            peak=rank_peak_gib(dev))))
        tdist.destroy_process_group()
    except BaseException:
        out.put((rank, dict(error=traceback.format_exc())))


def mesh_tp_rank(rank: int, port: int, dev: str, out) -> None:
    """One rank of [mesh] part 3: qwen3-14b at full width on the (1, 4)
    mesh; puts (rank, logits of rank 0, walls, peak GiB) on ``out``."""
    import traceback
    try:
        dev = rank_start(rank, port, dev)
        import torch.distributed as tdist
        from repro_torch.distributed import ctx
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(*MESH_TP[2], device=dev)
        logits, walls = mesh_tp_run(mesh, dev)
        peak = rank_peak_gib(dev)
        # a collective: every rank gathers, rank 0 reports
        logits = [ctx.full(l).float().cpu().numpy() for l in logits]
        out.put((rank, dict(logits=logits if rank == 0 else None,
                            walls=walls, peak=peak)))
        tdist.destroy_process_group()
    except BaseException:
        out.put((rank, dict(error=traceback.format_exc())))


def mesh_tp_run(mesh, dev):
    """Part 3 on ``mesh`` (None: one device): parameters from init_params
    on the card (seed 11) moved to ``dev``, a prefill of B x prompt tokens
    and the decode steps (teacher-forced).  (logits, walls)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.distributed import steps as S
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import init_params
    from repro_torch.models.common import tree_map
    arch, layers, _, B, prompt, n = MESH_TP
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    # drawn on the card wherever the ranks keep their tensors, so that
    # every rank and the one-device run hold the same parameters
    gen_dev = torch.device("cuda", 0) if torch.cuda.is_available() else dev
    gen = torch.Generator(device=gen_dev).manual_seed(11)
    p = tree_map(lambda a: a.to(dev),
                 init_params(tf.pdefs(cfg), gen, torch.bfloat16, gen_dev))
    if mesh is not None:
        p = S.shard_state(p, S.train_state_specs(cfg, mesh)[0], mesh)
    tokens, _ = lm_inputs(cfg, dev, B, prompt + n, 12, torch.bfloat16)
    cell = ShapeCell("p", "prefill", prompt + n, B)
    pre, dec = S.make_prefill(cfg, mesh, cell), S.make_decode_step(cfg, mesh,
                                                                   cell)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    lg, caches = pre(p, tokens[:, :prompt])
    sync()
    walls = {"prefill": time.perf_counter() - t0, "decode": []}
    logits = [lg[:, -1]]
    for i in range(n):
        t0 = time.perf_counter()
        lg, caches = dec(p, caches, tokens[:, prompt + i:prompt + i + 1],
                         prompt + i)
        sync()
        walls["decode"].append(time.perf_counter() - t0)
        logits.append(lg)
    return logits, walls


def mesh_rank_device(dev) -> str:
    """Where parts 2 and 3 put their ranks' tensors, said on its line."""
    if MESH_RANK_DEVICE == "card":
        return str(dev)
    log(f"[mesh] gloo ranks on the card's host, not the card: "
        f"{MESH_RANK_REASON}")
    return "cpu"


def rank_peak_gib(dev) -> float:
    """This rank's peak: allocated on a card, the process's largest
    resident set on the host."""
    import resource
    import torch
    if dev.type == "cuda":
        return torch.cuda.max_memory_allocated() / 2**30
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def rank_start(rank: int, port: int, dev: str):
    """A spawned rank's set-up: the package on the path, TF32 off, a
    host rank's threads capped, the gloo group joined.  Its device."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist
    from repro_torch.launch.mesh import init_group
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev == "cpu":
        torch.set_num_threads(MESH_RANK_THREADS)
    store = tdist.TCPStore("127.0.0.1", port, MESH_WORLD, is_master=False)
    return init_group(dev, rank=rank, world_size=MESH_WORLD, store=store,
                      backend="gloo")


def spawn_ranks(target, dev, limit_s: int):
    """Run ``target(rank, port, dev, out)`` in MESH_WORLD spawned ranks;
    their results by rank.  Fails on a rank's error or the time limit."""
    import multiprocessing as mp
    import queue
    import torch.distributed as tdist
    store = tdist.TCPStore("127.0.0.1", 0, None, True,
                           wait_for_workers=False)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, store.port, dev, out))
             for r in range(MESH_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    res = {}
    try:
        while len(res) < MESH_WORLD:
            check(time.perf_counter() - t0 < limit_s,
                  f"mesh: ranks {sorted(res)} of {MESH_WORLD} reported "
                  f"within {limit_s}s")
            try:
                r, d = out.get(timeout=1)
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in res}
                check(not dead, f"mesh: ranks exited without a result "
                                f"(rank: exit code) {dead}")
                continue
            check("error" not in d, f"mesh: rank {r} failed:\n"
                                    f"{d.get('error')}")
            res[r] = d
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return res, time.perf_counter() - t0


def mesh_world1(dev, card):
    """[mesh] part 1: NCCL, world 1, a (1, 1) mesh on the card: bit for
    bit the mesh=None path."""
    import torch
    import torch.distributed as tdist
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.distributed import steps as S
    from repro_torch.launch.mesh import init_group, make_host_mesh
    from repro_torch.train import Trainer, TrainConfig
    init_group(dev, rank=0, world_size=1, store=tdist.HashStore())
    try:
        t0 = time.time()
        mesh = make_host_mesh(1, 1, device=dev)
        backend = tdist.get_backend(mesh.get_group("data"))
        check(backend == "nccl", f"mesh: the world-1 mesh runs on {backend}")
        hist, state = {}, {}
        for name, m in (("mesh", mesh), ("none", None)):
            tr = Trainer(tiny_train_cfg(), m,
                         ShapeCell("t", "train", TRAIN_CELL[1],
                                   TRAIN_CELL[0]),
                         TrainConfig(steps=MESH_TRAIN_STEPS, ckpt_dir=None,
                                     lr=1e-3, grad_accum=2, log_every=1),
                         device=dev)
            tr.init_or_restore()
            hist[name] = tr.run()
            state[name] = S.unshard((tr.params, tr.opt))
        metrics = ("loss", "ce", "aux", "gnorm")
        same_m = all(a[k] == b[k] for a, b in zip(hist["mesh"], hist["none"])
                     for k in metrics)
        same_s = state_bits_equal(state["mesh"], state["none"])
        log(f"[mesh] world 1 (nccl, (1, 1)): tiny config, "
            f"{MESH_TRAIN_STEPS} Trainer steps at grad_accum 2 over the mesh "
            f"against mesh=None: metrics {'equal' if same_m else 'DIFFER'}, "
            f"parameters and moments bitwise "
            f"{'equal' if same_s else 'DIFFERENT'}; losses "
            f"{[round(h['loss'], 6) for h in hist['mesh']]}")
        check(same_m and same_s, "mesh: world-1 Trainer steps differ from "
                                 "mesh=None")
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import transformer as tf
        from repro_torch.models.common import init_params
        cfg = get_smoke_config("qwen3-14b")
        p = init_params(tf.pdefs(cfg), torch.Generator(device=dev)
                        .manual_seed(0), torch.float32, dev)
        tokens, _ = lm_inputs(cfg, dev, MESH_B, MESH_PREFILL + MESH_DECODE,
                              2, torch.float32)
        _, cell = mesh_cells()
        outs = {}
        for name, m in (("mesh", mesh), ("none", None)):
            pp = p if m is None else S.shard_state(
                p, S.train_state_specs(cfg, m)[0], m)
            pre, dec = S.make_prefill(cfg, m, cell), S.make_decode_step(
                cfg, m, cell)
            lg, caches = pre(pp, tokens[:, :MESH_PREFILL])
            got = [S.unshard(lg)]
            for i in range(MESH_DECODE):
                pos = MESH_PREFILL + i
                lg, caches = dec(pp, caches, tokens[:, pos:pos + 1], pos)
                got.append(S.unshard(lg))
            outs[name] = got
        same = all(bitwise_equal(a, b) for a, b in zip(outs["mesh"],
                                                        outs["none"]))
        log(f"[mesh] world 1: qwen3 smoke prefill of {MESH_PREFILL} + "
            f"{MESH_DECODE} decode steps (bf16 caches) over the mesh against "
            f"mesh=None: logits bitwise {'equal' if same else 'DIFFERENT'}; "
            f"part 1 {time.time() - t0:.1f}s; {card}")
        check(same, "mesh: world-1 prefill/decode differ from mesh=None")
    finally:
        tdist.destroy_process_group()


def mesh_compare(arch: str, got: dict, want: dict):
    """(metric, parameter, moment, logit) errors of part 2's comparison,
    each checked against its bound."""
    import numpy as np
    merr, mkey = max((abs(got[k] - want[k]) / abs(want[k]), k[2:])
                     for k in want if k.startswith("m_") and want[k])
    check(got["faults"] == 0, f"mesh: {arch} shards off their specs")
    check(all(got[k] == want[k] for k in want if k.startswith("m_")
              and not want[k]), f"mesh: {arch} metrics that are 0 differ")
    errs = {}
    for name in ("p", "mu", "nu"):
        keys = [k for k in want if k.startswith(name + "/")]
        check(keys and set(keys) == {k for k in got
                                     if k.startswith(name + "/")},
              f"mesh: {arch} {name} trees differ")
        scale = max(float(np.abs(want[k]).max()) for k in keys)
        errs[name] = max(float(np.abs(got[k].astype(np.float64)
                                      - want[k]).max()) for k in keys) / scale
        if name == "p":
            lr_mult = max(float(np.abs(got[k].astype(np.float64)
                                       - want[k]).max()) for k in keys) / \
                MESH_LR
    lerr = max(float(np.abs(got[f"logits{i}"].astype(np.float64)
                            - want[f"logits{i}"]).max()
                     / np.abs(want[f"logits{i}"]).max())
               for i in range(MESH_DECODE + 1))
    mom = MESH_RGLRU_TOL if arch == "recurrentgemma-2b" else MESH_MOMENT_TOL
    check(merr <= MESH_METRIC_TOL, f"mesh: {arch} {mkey} {merr:.3e} relative "
                                   f"(> {MESH_METRIC_TOL})")
    check(errs["p"] <= MESH_PARAM_TOL and lr_mult <= MESH_LR_MULTIPLE,
          f"mesh: {arch} parameters {errs['p']:.3e} of the largest, "
          f"{lr_mult:.2f} lr")
    check(max(errs["mu"], errs["nu"]) <= mom,
          f"mesh: {arch} moments {errs['mu']:.3e} / {errs['nu']:.3e}")
    check(lerr <= MESH_LOGIT_TOL, f"mesh: {arch} logits {lerr:.3e} (> "
                                  f"{MESH_LOGIT_TOL})")
    return merr, errs["p"], lr_mult, max(errs["mu"], errs["nu"]), lerr


def mesh_world4(dev, card):
    """[mesh] part 2: gloo, 4 ranks spawned on one card, the six smoke
    configs on the (2, 2) and (2, 1, 2) meshes against the one-device
    steps on the card."""
    import torch
    rank_dev = mesh_rank_device(dev)
    # the one-device runs on the device the ranks use: this part holds the
    # mesh path against mesh=None ([lm] and [train] hold card against host)
    t0 = time.perf_counter()
    want = {arch: mesh_run(arch, None, torch.device(rank_dev))
            for arch in MESH_ARCHS}
    t_one = time.perf_counter() - t0
    torch.cuda.synchronize()
    res, wall = spawn_ranks(mesh_rank, rank_dev, MESH_LIMIT_S)
    faults = sum(d["faults"] for d in res.values())
    log(f"[mesh] world {MESH_WORLD} (gloo, ranks' tensors on {rank_dev}): "
        f"ranks done in {wall:.1f}s (spawn included); one-device runs on "
        f"{rank_dev} {t_one:.1f}s; rank peaks "
        f"{[round(res[r]['peak'], 3) for r in range(MESH_WORLD)]} GiB "
        f"({'allocated' if rank_dev != 'cpu' else 'host max RSS'}); local "
        f"shards off their spec's division: {faults}")
    check(faults == 0, f"mesh: {faults} local shards off the specs")
    for (mname, arch), got in sorted(res[0]["res"].items()):
        merr, perr, lr_mult, moerr, lerr = mesh_compare(arch, got,
                                                        want[arch])
        log(f"[mesh] {mname} {arch}: train step metrics {merr:.2e} "
            f"relative, parameters {perr:.2e} of the largest ({lr_mult:.2f} "
            f"lr), moments {moerr:.2e}; prefill + {MESH_DECODE} decode "
            f"logits {lerr:.2e}; rank 0 {res[0]['walls'][(mname, arch)]:.1f}s")
    log(f"[mesh] world {MESH_WORLD}: {len(res[0]['res'])} (mesh, arch) runs "
        f"within the bounds; {card}")


def mesh_tp(dev, card):
    """[mesh] part 3: qwen3-14b at full width, 2 layers, bf16 on a (1, 4)
    mesh of gloo ranks against one device."""
    import torch
    rank_dev = mesh_rank_device(dev)
    torch.cuda.reset_peak_memory_stats()
    want, walls1 = mesh_tp_run(None, dev)
    peak1 = torch.cuda.max_memory_allocated() / 2**30
    want = [w.float().cpu() for w in want]
    gc.collect()
    torch.cuda.empty_cache()
    res, wall = spawn_ranks(mesh_tp_rank, rank_dev, MESH_LIMIT_S)
    got = [torch.from_numpy(g) for g in res[0]["logits"]]
    errs = [lm_rel_err(g, w) for g, w in zip(got, want)]
    arch, layers, shape, B, prompt, n = MESH_TP
    dec = [statistics.median(res[r]["walls"]["decode"])
           for r in range(MESH_WORLD)]
    log(f"[mesh] {arch} full width, {layers} layers, bf16, {shape} mesh of "
        f"gloo ranks (tensors on {rank_dev}): prefill of {B} x {prompt} "
        f"{[round(res[r]['walls']['prefill'], 3) for r in range(MESH_WORLD)]}"
        f" s a rank (one device {walls1['prefill']:.3f} s), decode step "
        f"median {[round(d * 1e3, 1) for d in dec]} ms (one device "
        f"{statistics.median(walls1['decode']) * 1e3:.1f} ms); rank peaks "
        f"{[round(res[r]['peak'], 2) for r in range(MESH_WORLD)]} GiB "
        f"({'allocated' if rank_dev != 'cpu' else 'host max RSS'}; one "
        f"device {peak1:.2f} GiB); logits {max(errs):.3e} of the largest "
        f"from one device (bound {LM_BF16_TOL}); ranks {wall:.1f}s; "
        f"host-bound by gloo, recorded, not judged; {card}")
    check(all(torch.isfinite(g).all() for g in got),
          "mesh: TP logits not finite")
    check(max(errs) <= LM_BF16_TOL, f"mesh: TP logits {max(errs):.3e} from "
                                    f"one device (> {LM_BF16_TOL})")


def mesh_dryrun_start(tmp):
    """Part 4's dry runs, each a process of its own at low priority, started
    at the phase's start: (process, tag, record path) each."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, mp in MESH_DRYRUN:
        out = Path(tmp) / f"{arch}_{shape}_{int(mp)}"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--device", "cpu", "--out", str(out)]
        if mp:
            cmd.append("--multi-pod")
        procs.append((subprocess.Popen(
            cmd, env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            preexec_fn=lambda: os.nice(10)), (arch, shape, mp), out))
    return procs, time.time()


def mesh_dryrun_finish(procs, t_start, card):
    """Part 4: wait for the dry runs and print their records."""
    import torch
    total = torch.cuda.get_device_properties(0).total_memory
    try:
        for p, (arch, shape, mp), out in procs:
            left = MESH_LIMIT_S - (time.time() - t_start)
            try:
                log_text = p.communicate(timeout=max(left, 1))[0]
            except subprocess.TimeoutExpired:
                fail(f"mesh: the dry run of {arch} {shape} did not end "
                     f"within {MESH_LIMIT_S}s of the phase's start")
            tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
            check(p.returncode == 0, f"mesh: dry run {tag} exited "
                                     f"{p.returncode}:\n{log_text[-3000:]}")
            rec = json.loads((out / f"{tag}.json").read_text())
            check(rec["status"] == "ok", f"mesh: dry run {tag}: "
                                         f"{rec.get('error')}")
            mem, t = rec["mem"], rec["roofline"]
            log(f"[mesh] dry run {arch} {shape} {rec['mesh']}: per-device "
                f"peak {mem['peak_bytes'] / 1e9:.2f} GB (arguments "
                f"{mem['argument_bytes'] / 1e9:.2f}, temporaries "
                f"{mem['temp_bytes'] / 1e9:.2f}) of the card's "
                f"{total / 1e9:.1f} GB; estimate at the H100's datasheet "
                f"constants, not a measurement: compute {t['compute_s']:.4g}"
                f" s, memory {t['memory_s']:.4g} s, collective "
                f"{t['collective_s']:.4g} s, dominant {t['dominant']}; "
                f"flops {rec['cost']['flops']:.4g}, collective bytes "
                f"{rec['cost']['coll_by_op']}; the dry run's own wall "
                f"{rec['wall_s']} s (step {rec['compile_s']} s)")
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
    log(f"[mesh] part 4: {len(procs)} dry runs in "
        f"{time.time() - t_start:.1f}s (in parallel, from the phase's "
        f"start); {card}")


def phase_mesh(dev, card):
    """The [mesh] phase (see the module docstring)."""
    import tempfile
    import torch
    from repro_torch.kernels import runtime
    t_phase = time.time()
    runtime.reset_launches()
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        procs, t_dry = mesh_dryrun_start(tmp)
        mesh_world1(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        mesh_world4(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        mesh_tp(dev, card)
        mesh_dryrun_finish(procs, t_dry, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launched = {k: v for k, v in runtime.LAUNCHES.items() if v}
    check(not launched, f"mesh: kernels of the port launched: {launched}")
    log(f"[mesh] phase passed in {time.time() - t_phase:.1f}s, no kernel "
        f"launched; {card}")


def device_ms_per_launch(fn, n: int = 20, tries: int = 3):
    """Device time of one call of ``fn`` (one or more kernel launches):
    the busy time of ``n`` back-to-back calls in one trace over ``n``, so
    the host's work between launches is not counted.  A trace of one call
    first counts its device events; a trace of the ``n`` calls that holds
    fewer than ``n`` times as many has lost some, and its busy time reads
    short: it is taken again, up to ``tries`` traces; None when none holds
    them all."""
    fn()
    _, per_call = device_busy_ms(fn)
    want = n * max(per_call, 1)
    for attempt in range(tries):
        busy, events = device_busy_ms(lambda: [fn() for _ in range(n)])
        if busy is not None and events >= want:
            if attempt:
                log(f"[timing] device time read from trace {attempt + 1}: "
                    f"the earlier traces held fewer than {want} device "
                    f"events")
            return busy / n
        log(f"[timing] a trace of {n} calls held {events} of {want} device "
            f"events ({busy} ms busy); taken again")
    return None


def device_busy_ms(fn, host_ops: bool = True):
    """(busy ms, events) of one call of ``fn`` on the card: the union of
    the time spans of the device events (kernels, copies, fills) in a
    torch.profiler trace of the call; (None, 0) when the trace holds none.
    ``host_ops=False`` leaves the host's operators out of the trace (a
    training step's hundred thousand of them take the profiler tens of
    seconds to record)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host_ops else [])) as prof:
        fn()
        torch.cuda.synchronize()
    return union_ms([(e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA])


def union_ms(spans):
    """(ms covered by the union of the (start, end) µs spans, span count);
    (None, 0) for no span."""
    spans = sorted(spans)
    if not spans:
        return None, 0
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e3, len(spans)


def phase_timing(dev, main, spmv_errs):
    import numpy as np
    import torch
    from repro_torch.core import parac
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.kernels import sample_clique as sc, spmv
    from repro_torch.kernels.ops import interleaved
    h = main["handle"]
    g = main["graph"]
    rows = []

    # sample_clique at the main path's shapes: one real round of the
    # main graph's engine at the slack the strict retry settled on
    f = h.factor
    built = parac._build_pool(parac._pool_edges(g, np.float32, dev),
                              f.stats["fill_slack"])
    s, st = parac._init_engine([built], [key_from_seed(0)], n_pad=g.n,
                               P_pad=built.P,
                               W=max(parac._next_pow2(built.dmax), 2),
                               chunk=256)
    parac._run_engine_batched(s, st, max_rounds=max(f.stats["rounds"] // 2,
                                                    1))
    cand, ok = parac._round_ready(s.elim, s.dep, parac._live(s, st),
                                  chunk=256)
    ids, ws, fill, u, _, _ = sc.round_gather(s, st, cand, ok)
    err = clique_rows(ids, ws, fill, u)
    R, W = ids.shape
    ms = time_ms(lambda: sc.sample_clique(ids, ws, fill, u))
    device_ms = device_ms_per_launch(lambda: sc.sample_clique(ids, ws, fill,
                                                              u))
    plain_ms = time_ms(lambda: sc.sample_clique_plain(ids, ws, fill, u),
                       reps=5)
    nbytes = R * W * (4 + 4 + 4) + R * 4 + R * W * (5 * 4 + 1) + R * 8
    lg = int(np.log2(W))
    ops = R * (2 * (W // 2) * lg * (lg + 1) // 2 + 3 * W * lg
               + 2 * W * (lg + 1) + 10 * W)
    rows.append(dict(
        name="sample_clique", route="cuda",
        source="src/repro_torch/csrc/sample_clique.cu",
        replaces="src/repro/kernels/sample_clique.py:218",
        launches=main["launches"].get("sample_clique", 0),
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(nbytes, ops), library_ms=None, shape=f"R={R} W={W}",
        device_ms=device_ms))
    rows.append(round_timing(main, s, st, cand, ok, fill))
    log(f"[timing] sample_clique_round bound over the padded lanes (R={R} "
        f"W={W}, as sample_clique's): {bound(nbytes, ops)['bound_ms']:.5f} "
        f"ms")
    log_engine_rounds("timing", f.stats["rounds"] // 2,
                      engine_rounds_busy(s, st))

    # ell_spmv_fleet at the main path's shapes: the 8-lane forward sweep
    fa = h.fleet.arrays
    n_pad = h.n_pad
    K = fa.fcols.shape[2]
    L = 8
    X = torch.randn((L, n_pad), device=dev)
    fidx = torch.full((L,), h.fleet_row, dtype=torch.int32, device=dev)

    def full_row():
        return spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx, X, fa.flen)
    ms = time_ms(full_row)
    device_ms = device_ms_per_launch(full_row)
    plain_ms = time_ms(lambda: spmv.ell_spmv_fleet_plain(
        fa.fcols, fa.fvals, fidx, X, fa.flen), reps=3)
    one_lane = device_ms_per_launch(lambda: spmv.ell_spmv_fleet(
        fa.fcols, fa.fvals, fidx[:1], X[:1], fa.flen))
    log(f"[timing] ell_spmv_fleet [main] panel L=1: device time {one_lane} "
        f"ms per launch; L=8 wrapper host time "
        f"{host_ms_per_call(full_row):.4f} ms a call")
    # the library yardstick: the same rows' live slots in CSR,
    # torch.sparse.mm
    lens = fa.flen[h.fleet_row]
    live = torch.arange(K, device=dev)[None, :] < lens[:, None]
    c = fa.fcols[h.fleet_row][live].long()
    v = fa.fvals[h.fleet_row][live]
    crow = torch.zeros(n_pad + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(lens.long(), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        csr = torch.sparse_csr_tensor(crow, c, v, size=(n_pad, n_pad),
                                      check_invariants=False)
    XT = X.T.contiguous()
    y_lib = torch.sparse.mm(csr, XT).T
    y_k = full_row()
    torch.cuda.synchronize()
    lib_rel = float((y_lib - y_k).abs().max()) / max(
        float(y_k.abs().max()), 1e-30)
    check(lib_rel <= 1e-4, f"torch.sparse.mm disagrees with the kernel "
                           f"({lib_rel:.2e})")
    lib_ms = time_ms(lambda: torch.sparse.mm(csr, XT))
    # a sparse product: the bound counts the panel's nonzero slots (index
    # and value read once for all lanes), not its padding, and the x
    # entries they gather in each lane
    nnz = int((v != 0).sum())
    x_bytes = L * gathered_bytes(c, v, 1)
    nbytes = nnz * 8 + x_bytes + L * 4 + L * n_pad * 4
    ops = 2 * L * nnz
    rows.append(dict(
        name="ell_spmv_fleet", route="cuda",
        source="src/repro_torch/csrc/ell_spmv_fleet.cu",
        replaces="src/repro/kernels/spmv.py:104",
        launches=main["launches"].get("ell_spmv_fleet", 0),
        comparison_launches=main["full_row_launches"].get("ell_spmv_fleet",
                                                          0),
        max_abs_err=spmv_errs["full_row"], ms=ms, plain_ms=plain_ms,
        **bound(nbytes, ops), library_ms=lib_ms,
        shape=f"L={L} R={n_pad} K={K} nnz={nnz} x_bytes={x_bytes}",
        device_ms=device_ms))

    # ell_sweep_fleet at the largest and at an average forward level, the
    # 8 lanes of the main path's 8-rhs solve, interleaved as the apply
    # keeps them
    XI = interleaved(X)
    for tag, lv in sweep_levels(h).items():
        sw = sweep_call(h, lv, X)
        Yp = X.clone()
        ms = time_ms(lambda: sw(spmv.ell_sweep_fleet, XI))
        device_ms = device_ms_per_launch(
            lambda: sw(spmv.ell_sweep_fleet, XI))
        level_ms = kernel_device_ms(lambda: sw(spmv.ell_sweep_fleet, XI),
                                    lambda: None, "ell_sweep_fleet_kernel")
        k_level = int(level_entry(h, lv)[0, 2])
        plain_ms = time_ms(lambda: sw(spmv.ell_sweep_fleet_plain, Yp),
                           reps=3)
        lo = int(fa.fstart[h.fleet_row, lv])
        hi = int(fa.fstart[h.fleet_row, lv + 1])
        r = fa.frows[h.fleet_row, lo:hi].long()
        lc, lvals = fa.fcols[h.fleet_row, r], fa.fvals[h.fleet_row, r]
        live = int(fa.flen[h.fleet_row, r].sum())
        # live slots (index and value) read once for all lanes, with the
        # rows' list entries and lengths; the y sectors they gather, a
        # column's L lanes side by side in interleaved y; the level's y
        # rows read and written
        y_bytes = gathered_bytes(lc, lvals, L)
        nbytes = live * 8 + (hi - lo) * 8 + y_bytes + 2 * L * (hi - lo) * 4
        # the library yardstick: the level's live slots in CSR times the
        # 8 lanes' x as columns (the product the sweep subtracts)
        lens = fa.flen[h.fleet_row, r]
        mask = (torch.arange(K, device=dev)[None, :] < lens[:, None])
        crow = torch.zeros(hi - lo + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(lens.long(), 0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            lcsr = torch.sparse_csr_tensor(crow, lc[mask].long(),
                                           lvals[mask],
                                           size=(hi - lo, n_pad),
                                           check_invariants=False)
        Yl, Xc = X.clone(), X.T.contiguous()
        sw(spmv.ell_sweep_fleet, Yl)
        prod = torch.sparse.mm(lcsr, Xc)
        torch.cuda.synchronize()
        scale = max(float(X[:, r].abs().max()), float(prod.abs().max()),
                    1e-30)
        lib_rel = float(((X[:, r] - Yl[:, r]).T - prod).abs().max()) / scale
        check(lib_rel <= 1e-4, f"torch.sparse.mm disagrees with "
                               f"ell_sweep_fleet at the {tag} level "
                               f"({lib_rel:.2e})")
        lib_ms = time_ms(lambda: torch.sparse.mm(lcsr, Xc))
        rows.append(dict(
            name="ell_sweep_fleet", route="cuda",
            source="src/repro_torch/csrc/ell_spmv_fleet.cu",
            replaces="src/repro/kernels/spmv.py:104",
            launches=main["launches"].get("ell_sweep_fleet", 0),
            max_abs_err=spmv_errs["sweep"], ms=ms, plain_ms=plain_ms,
            **bound(nbytes, 2 * L * live), library_ms=lib_ms,
            shape=f"{tag} forward level {lv}: L={L} rows={hi - lo} K={K} "
                  f"level_k={k_level} G={spmv.group_width(k_level)} "
                  f"live_slots={live} y_bytes={y_bytes} (y interleaved; "
                  f"the level kernel alone {level_ms} ms a call, the rest "
                  f"of device_ms the solve's lane grouping)",
            device_ms=device_ms))
    log_rows(rows)
    return rows


def round_timing(main, s, st, cand, ok, fill):
    """The timing row of the fused round (sample_clique_round) at a real
    round of the 64^3 final attempt: CUDA-event mean and device time per
    launch of the kernel alone, each call on the same engine state
    (restored before every call, outside the timed span), against the
    plain composition's time, and the bound over the live lanes."""
    import torch
    from repro_torch.kernels import sample_clique as sc
    snap = engine_clone(s)

    def restore():
        for a, b in zip(s, snap):
            a.copy_(b)

    def timed(fn, reps):
        total = 0.0
        for k in range(reps + 1):                       # the first warms up
            restore()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b) if k else 0.0
        return total / reps

    a, b = engine_clone(s), engine_clone(s)
    got = sc.eliminate_round(a, st, cand, ok)
    want = sc.eliminate_round_plain(b, st, cand, ok)
    torch.cuda.synchronize()
    same = all(bitwise_equal(x[:, :-1] if x.dim() == 2 else x,
                             y[:, :-1] if y.dim() == 2 else y)
               for x, y in zip(a, b))
    same &= all(bitwise_equal(x, y) for x, y in zip(got, want))
    check(same, "sample_clique_round differs from its plain composition "
                "at the timed round")
    e_valid = want.e_valid.view(ok.shape[0], ok.shape[1], -1) & ok[:, :, None]
    n_edges = int(e_valid.sum())
    okf = ok.view(-1)
    fl = fill[okf].long()
    m = torch.gather(b.col_fill, 1, cand).view(-1)[okf].long()
    del a, b, got, want
    ms = timed(lambda: sc.eliminate_round(s, st, cand, ok), 20)
    plain_ms = timed(lambda: sc.eliminate_round_plain(s, st, cand, ok), 5)
    device_ms = kernel_device_ms(
        lambda: sc.eliminate_round(s, st, cand, ok), restore,
        "sample_clique_round_kernel")
    restore()
    # the live lanes: per real row its slab base and fill, its fill slab
    # slots (id and weight) and one dependency counter read and written
    # per slot, the m - 1 uniforms it samples with, the factor column
    # written back (m slots) with col_fill, D and elim; per row its
    # candidate and flag; the sampled edges (lo, hi, w, valid)
    n_ok = int(okf.sum())
    R = okf.numel()
    nbytes = (R * 9 + n_ok * (8 + 4) + int(fl.sum()) * (8 + 8)
              + int((m - 1).clamp(min=0).sum()) * 4 + int(m.sum()) * 8
              + n_ok * 9 + n_edges * 13)
    # sample_clique's operation count, each row at its own width
    ops = 0
    for f in fl.tolist():
        w = max(1 << max(f - 1, 0).bit_length(), 2)
        lg = w.bit_length() - 1
        ops += (2 * (w // 2) * lg * (lg + 1) // 2 + 3 * w * lg
                + 2 * w * (lg + 1) + 10 * w)
    return dict(
        name="sample_clique_round", route="cuda",
        source="src/repro_torch/csrc/sample_clique.cu",
        replaces="src/repro/kernels/sample_clique.py:218",
        launches=main["launches"].get("sample_clique_round", 0),
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, **bound(nbytes, ops),
        library_ms=None,
        shape=f"B=1 chunk={ok.shape[1]} W={st.W}: {n_ok} live rows, fill "
              f"max {int(fl.max())} mean {float(fl.float().mean()):.1f}, "
              f"{n_edges} edges, live bytes {nbytes}",
        device_ms=device_ms)


def kernel_device_ms(fn, setup, name: str, n: int = 20):
    """Device time per launch of the kernel named ``name`` in one
    torch.profiler trace of ``n`` calls of ``fn``, each after ``setup``
    (whose own device work is not counted); None when the trace holds no
    such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    setup()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            setup()
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    if not spans:
        return None
    return sum(spans) / len(spans) / 1e3


def log_rows(rows) -> None:
    for r in rows:
        fp32 = ("" if "bound_fp32_ms" not in r else
                f", fp32 bound {r['bound_fp32_ms']:.4f} ms")
        log(f"[timing] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms "
            f"(device time {r['device_ms']} ms per launch), plain "
            f"{r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}){fp32}, launches {r['launches']}"
            + ("" if "comparison_launches" not in r else
               f" (comparison launches {r['comparison_launches']})"))


def gathered_bytes(cols, vals, B: int) -> int:
    """Bytes of x ``[n, B]`` (float32, row-major) that a sparse product
    must read: the distinct rows its nonzero slots gather, in whole 32-byte
    sectors (B is 1, 2, 4 or a multiple of 8, so no row straddles two)."""
    import torch
    used = torch.unique(cols[vals != 0].long())
    row = 4 * B
    if row >= 32:
        return used.numel() * -(-row // 32) * 32
    return torch.unique(used * row // 32).numel() * 32


def bound(nbytes: float, ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        sys.exit(2)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke test runs on a GPU only",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_start = time.time()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    card = phase_build(runtime)
    from repro_torch.data import graphs
    g64 = permuted(graphs.grid3d(64, 64, 64, "uniform", seed=2))
    phase_clique(dev, g64)
    phase_factor16(dev)
    main_res = phase_main(dev, g64)
    spmv_errs = phase_spmv(dev, main_res["handle"])
    lib_res = phase_library(dev, main_res)
    slabs = phase_slabs(dev, lib_res)
    attn = phase_attention(dev)
    kernels = phase_timing(dev, main_res, spmv_errs)
    kernels += slab_rows_timing(dev, slabs, lib_res)
    kernels += sweep_rows_timing(dev, slabs, lib_res)
    kernels += sweep_solve_timing(dev, slabs, lib_res)
    kernels += attention_timing(dev, attn)
    apply_timing(dev, main_res, slabs)
    phase_serve(dev, main_res, card)
    # release the earlier phases' device state; [main]'s host factor stays
    # for the [cluster] phase's comparison
    main_f = host_factor(main_res["handle"].factor)
    del main_res, spmv_errs, lib_res, slabs, attn
    gc.collect()
    torch.cuda.empty_cache()
    phase_cluster(dev, g64, main_f, card)
    gc.collect()
    torch.cuda.empty_cache()
    zoo = phase_zoo(dev, g64, card)
    kernels += zoo_timing(dev, zoo)
    gc.collect()
    torch.cuda.empty_cache()
    dist_launches = phase_dist(dev, g64, main_f, card)
    for r in kernels:
        if r["name"] in ("sample_clique_round", "ell_sweep"):
            r["dist_launches"] = dist_launches.get(r["name"], 0)
    gc.collect()
    torch.cuda.empty_cache()
    phase_lm(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_mesh(dev, card)
    log(f"[done] all phases passed in {time.time() - t_start:.1f}s on {card}")
    print(json.dumps({"kernels": [{k: r[k] for k in ROW_KEYS + EXTRA_KEYS
                                   if k in r} for r in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
