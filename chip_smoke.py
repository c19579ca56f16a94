#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one GPU

Phases (any failure exits non-zero; nothing falls back to the CPU path or
to a plain version while a GPU is present):

  build    nvcc-builds every kernel of the port from src/repro_torch/csrc,
           one process per source, all at once; prints the build time, the
           compiler's register/spill report and the card's name and power
           limit.
  clique   sample_clique kernel vs its plain version on the card: random
           rows at W in {2, 32, 128, 512, 1024, 4096, 8192, 16384} and rows
           gathered from a real engine round — all eight outputs bitwise equal.
  factor16 the card's factor of grid3d_uniform_16 (nnz-sort, key 0) vs the
           one the port builds on the CPU in this run — col_ptr, rows, vals,
           D, rounds and overflow equal bit for bit.
  main     the main path through the user entry points, launch counts
           reset just before and read just after: Solver().factor of
           grid3d(64,64,64,'uniform',seed=2) (nnz-sort, chunk 256,
           fill_slack 32, strict), then solves of 1 and 8 right-hand sides
           (tol 1e-6, maxiter 500).  Every lane must converge, its true
           residual (float64 edge-list matvec on the host) must agree, and
           both kernels must have launched.
  spmv     ell_spmv_fleet kernel vs its plain version at the main path's
           shapes (its forward panels, 1 and 8 lanes): relative error
           <= 1e-5, and a lane alone bitwise equal to the same lane inside
           the 8-lane batch.
  library  the library path through the user entry points, launch counts
           reset just before and read just after: factorize_wavefront of
           the main path's graph with its settings and key (bit-identical to
           the main path's handle factor), make_preconditioner (level-sorted
           device schedules), then laplacian_pcg (1 rhs) and
           laplacian_pcg_batched (the same 8 rhs as the main path), tol
           1e-6, maxiter 500.  Every lane must converge with a true residual
           below 1e-4, ell_spmv and ell_spmv_multi must have launched, and
           lane 0 of the block, solved alone afterwards, must take the same
           iterates bit for bit.
  slabs    ell_spmv and ell_spmv_multi (8 columns) vs their plain versions
           on level slabs of the library path's schedules (the largest
           forward and backward slabs and a small ragged one): relative
           error <= 1e-5; ell_spmv bitwise equal to ell_spmv_fleet's lane
           on the same slab, and each ell_spmv_multi column bitwise equal to
           ell_spmv of that column.
  timing   each kernel, its plain version and (where one exists) one
           PyTorch library call for the same function, timed with CUDA
           events at the main path's shapes (the library path's largest
           forward slab for ell_spmv and ell_spmv_multi), beside the least
           time the card could take (bytes over 3.35 TB/s, or fp32
           operations over 67 TFLOP/s, whichever is larger); and one
           preconditioner apply of each path on the same factor, with its
           device busy time from a torch.profiler trace of one apply.

The last three lines are the kernel table as JSON, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_OPS_PER_S = 67e12             # H100 SXM fp32, outside the tensor cores


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


KERNELS = ("sample_clique", "ell_spmv_fleet", "ell_spmv", "ell_spmv_multi")


def phase_build(runtime):
    t0 = time.time()
    reports = runtime.build(KERNELS)
    log(f"[build] {len(KERNELS)} kernels built in {time.time() - t0:.1f}s "
        f"(nvcc, sm_90a, one process each, in parallel)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    for name in KERNELS:
        runtime.load(name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


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


def phase_clique(dev):
    import numpy as np
    import torch
    from repro_torch.core import parac
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.data import graphs
    rng = np.random.default_rng(0)
    for W in (2, 32, 128, 512, 1024, 4096, 8192, 16384):
        R = 256 if W <= 1024 else 16
        fill = rng.integers(0, W + 1, R).astype(np.int32)
        ids = rng.integers(0, max(2, W // 2), (R, W)).astype(np.int32)
        ws = rng.uniform(0.1, 3.0, (R, W)).astype(np.float32)
        u = rng.uniform(0.0, 1.0, (R, W)).astype(np.float32)
        clique_rows(*(torch.from_numpy(a).to(dev) for a in (ids, ws, fill,
                                                             u)))
        log(f"[clique] random rows R={R} W={W}: 8/8 outputs bitwise equal")
    # rows of a real engine round: grid3d 16^3 after 40 rounds
    g = permuted(graphs.SUITE["grid3d_uniform_16"]())
    built = parac._build_pool(g, 32, np.float32)
    s, st = parac._init_engine([built], [g.n], [key_from_seed(0)], n_pad=g.n,
                               P_pad=built[6],
                               W=max(parac._next_pow2(built[7]), 2),
                               chunk=256, device=dev)
    parac._run_engine_batched(s, st, max_rounds=40)
    cand, ok = parac._round_ready(s.elim, s.dep, parac._live(s), chunk=256)
    ids, ws, fill, u, _, _ = parac._round_gather(s, st, cand, ok)
    clique_rows(ids, ws, fill, u)
    log(f"[clique] engine round 41 of grid3d_uniform_16 (R={ids.shape[0]} "
        f"W={ids.shape[1]}, {int(ok.sum())} live rows): 8/8 outputs "
        f"bitwise equal")


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


def phase_main(dev):
    import numpy as np
    import torch
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.solver import Solver
    from repro_torch.data import graphs
    from repro_torch.kernels import runtime
    g = permuted(graphs.grid3d(64, 64, 64, "uniform", seed=2))
    rng = np.random.default_rng(0)
    b1 = rng.normal(size=g.n).astype(np.float32)
    B8 = rng.normal(size=(8, g.n)).astype(np.float32)
    torch.cuda.synchronize()
    runtime.reset_launches()
    t0 = time.time()
    solver = Solver(chunk=256, fill_slack=32, strict=True, device=dev)
    h = solver.factor(g, key_from_seed(0))
    torch.cuda.synchronize()
    t_factor = time.time() - t0
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
    for name in ("sample_clique", "ell_spmv_fleet"):
        check(launches.get(name, 0) > 0,
              f"main path never launched the {name} kernel")
    return dict(solver=solver, handle=h, launches=launches,
                t_factor=t_factor, t_solve1=t_solve1, t_solve8=t_solve8,
                graph=g, b1=b1, B8=B8, r1=r1, r8=r8)


def phase_spmv(dev, h):
    import torch
    from repro_torch.kernels import spmv
    fa = h.fleet.arrays
    n_pad = h.n_pad
    gen = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((8, n_pad), generator=gen, device=dev)
    fidx8 = torch.full((8,), h.fleet_row, dtype=torch.int32, device=dev)
    worst = 0.0
    for L in (1, 8):
        y = spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx8[:L], X[:L])
        p = spmv.ell_spmv_fleet_plain(fa.fcols, fa.fvals, fidx8[:L], X[:L])
        torch.cuda.synchronize()
        err = float((y - p).abs().max())
        rel = err / max(float(p.abs().max()), 1e-30)
        check(rel <= 1e-5, f"ell_spmv_fleet L={L}: relative error {rel:.2e}")
        worst = max(worst, err)
        log(f"[spmv] L={L} R={n_pad} K={fa.fcols.shape[2]}: max abs err "
            f"{err:.3e} (relative {rel:.2e})")
    y1 = spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx8[:1], X[:1].clone())
    y8 = spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx8, X)
    for lane in range(8):
        yl = spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx8[:1],
                                 X[lane:lane + 1].contiguous())
        check(bitwise_equal(yl[0], y8[lane]),
              f"ell_spmv_fleet: lane {lane} alone differs from the same "
              f"lane in the 8-lane batch")
    check(bitwise_equal(y1[0], y8[0]), "ell_spmv_fleet: lane 0 differs")
    log("[spmv] each of 8 lanes alone == the same lane in the 8-lane batch, "
        "bit for bit")
    return worst


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
    f = factorize_wavefront(g, key_from_seed(0), chunk=256, fill_slack=32,
                            strict=True, device=dev)
    torch.cuda.synchronize()
    t_factor = time.time() - t0
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
    log(f"[library] launches: {launches}; ell_spmv per 1-rhs apply "
        f"{launches.get('ell_spmv', 0) / (it1 + 1):.1f}")
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
    for name in ("ell_spmv", "ell_spmv_multi"):
        check(launches.get(name, 0) > 0,
              f"library path never launched the {name} kernel")
    return dict(factor=f, launches=launches, t_factor=t_factor,
                t_prec=t_prec, t_solve1=t_solve1, t_solve8=t_solve8)


def slab_rows(sched, which: str):
    """(lo, hi) of the schedule's largest level slab, or of a small ragged
    one (2 to 63 rows, not a multiple of 8; else the smallest)."""
    import numpy as np
    sizes = np.diff(sched.row_ptr)
    lv = np.arange(sizes.size)
    live = (lv >= 1) & (sizes > 0)
    if which == "largest":
        pick = int(lv[live][np.argmax(sizes[live])])
    else:
        ragged = live & (sizes > 1) & (sizes < 64) & (sizes % 8 != 0)
        pool = lv[ragged] if ragged.any() else lv[live]
        pick = int(pool[np.argmin(sizes[pool])])
    return int(sched.row_ptr[pick]), int(sched.row_ptr[pick + 1])


def phase_slabs(dev, lib):
    import torch
    from repro_torch.core.trisolve import build_schedules_device
    from repro_torch.kernels import spmv
    fwd, bwd = build_schedules_device(lib["factor"])
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
    return dict(fwd=fwd, bwd=bwd, worst=worst)


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
            max_abs_err=slabs["worst"][name], ms=ms, plain_ms=plain_ms,
            **bound(nbytes, 2 * B * nnz), library_ms=lib_ms,
            shape=f"R={R} K={K} B={B} nnz={nnz} x_bytes={x_bytes} "
                  f"padded_bytes={R * K * 8}"))
    log_rows(rows)
    return rows


def apply_timing(dev, main, slabs):
    """One preconditioner apply of each path on the same factor, 1 and 8
    right-hand sides: the main path's masked fleet sweeps and the library
    path's level slabs."""
    import torch
    from repro_torch.core.trisolve import make_preconditioner_from_schedules
    from repro_torch.kernels import runtime
    h = main["handle"]
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
        fn()
        torch.cuda.synchronize()
        launches = dict(runtime.LAUNCHES)
        busy, n_dev = device_busy_ms(fn)
        out[tag] = dict(ms=ms, busy_ms=busy)
        idle = ("device time not measured (the trace holds no device event)"
                if busy is None else
                f"device busy {busy:.2f} ms in {n_dev} device events, idle "
                f"share {1 - busy / ms:.3f} of the unprofiled mean")
        log(f"[timing] preconditioner apply, {tag}: {ms:.2f} ms, launches "
            f"{launches}; {idle}")
    return out


def device_busy_ms(fn):
    """(busy ms, events) of one call of ``fn`` on the card: the union of
    the time spans of the device events (kernels, copies, fills) in a
    torch.profiler trace of the call; (None, 0) when the trace holds none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
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


def phase_timing(dev, main, spmv_err):
    import numpy as np
    import torch
    from repro_torch.core import parac
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.kernels import sample_clique as sc, spmv
    h = main["handle"]
    g = main["graph"]
    rows = []

    # sample_clique at the main path's shapes: one real round of the
    # main graph's engine at the slack the strict retry settled on
    f = h.factor
    built = parac._build_pool(g, f.stats["fill_slack"], np.float32)
    s, st = parac._init_engine([built], [g.n], [key_from_seed(0)], n_pad=g.n,
                               P_pad=built[6],
                               W=max(parac._next_pow2(built[7]), 2),
                               chunk=256, device=dev)
    parac._run_engine_batched(s, st, max_rounds=max(f.stats["rounds"] // 2,
                                                    1))
    cand, ok = parac._round_ready(s.elim, s.dep, parac._live(s), chunk=256)
    ids, ws, fill, u, _, _ = parac._round_gather(s, st, cand, ok)
    err = clique_rows(ids, ws, fill, u)
    R, W = ids.shape
    ms = time_ms(lambda: sc.sample_clique(ids, ws, fill, u))
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
        **bound(nbytes, ops), library_ms=None, shape=f"R={R} W={W}"))

    # ell_spmv_fleet at the main path's shapes: the 8-lane forward sweep
    fa = h.fleet.arrays
    n_pad = h.n_pad
    K = fa.fcols.shape[2]
    L = 8
    X = torch.randn((L, n_pad), device=dev)
    fidx = torch.full((L,), h.fleet_row, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx, X))
    plain_ms = time_ms(lambda: spmv.ell_spmv_fleet_plain(
        fa.fcols, fa.fvals, fidx, X), reps=3)
    # the library yardstick: the same matrix in CSR, torch.sparse.mm
    c = fa.fcols[h.fleet_row].reshape(-1).long()
    v = fa.fvals[h.fleet_row].reshape(-1)
    crow = torch.arange(0, n_pad * K + 1, K, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        csr = torch.sparse_csr_tensor(crow, c, v, size=(n_pad, n_pad),
                                      check_invariants=False)
    XT = X.T.contiguous()
    y_lib = torch.sparse.mm(csr, XT).T
    y_k = spmv.ell_spmv_fleet(fa.fcols, fa.fvals, fidx, X)
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
        max_abs_err=spmv_err, ms=ms, plain_ms=plain_ms,
        **bound(nbytes, ops), library_ms=lib_ms,
        shape=f"L={L} R={n_pad} K={K} nnz={nnz} x_bytes={x_bytes}"))
    log_rows(rows)
    return rows


def log_rows(rows) -> None:
    for r in rows:
        log(f"[timing] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"launches {r['launches']}")


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


def bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
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
    phase_clique(dev)
    phase_factor16(dev)
    main_res = phase_main(dev)
    spmv_err = phase_spmv(dev, main_res["handle"])
    lib_res = phase_library(dev, main_res)
    slabs = phase_slabs(dev, lib_res)
    kernels = phase_timing(dev, main_res, spmv_err)
    kernels += slab_rows_timing(dev, slabs, lib_res)
    apply_timing(dev, main_res, slabs)
    log(f"[done] all phases passed in {time.time() - t_start:.1f}s on {card}")
    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k != "shape"} for r in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
