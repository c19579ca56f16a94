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
  timing   each kernel, its plain version and (where one exists) one
           PyTorch library call for the same function, timed with CUDA
           events at the main path's shapes, beside the least time the
           card could take (bytes over 3.35 TB/s, or fp32 operations over
           67 TFLOP/s, whichever is larger).

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


def phase_build(runtime):
    t0 = time.time()
    reports = runtime.build(["sample_clique", "ell_spmv_fleet"])
    log(f"[build] both kernels built in {time.time() - t0:.1f}s (nvcc, "
        f"sm_90a, parallel)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    for name in ("sample_clique", "ell_spmv_fleet"):
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
                graph=g)


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
    # and value read once for all lanes), not its padding
    nnz = int((v != 0).sum())
    nbytes = nnz * 8 + L * n_pad * 4 + L * 4 + L * n_pad * 4
    ops = 2 * L * nnz
    rows.append(dict(
        name="ell_spmv_fleet", route="cuda",
        source="src/repro_torch/csrc/ell_spmv_fleet.cu",
        replaces="src/repro/kernels/spmv.py:104",
        launches=main["launches"].get("ell_spmv_fleet", 0),
        max_abs_err=spmv_err, ms=ms, plain_ms=plain_ms,
        **bound(nbytes, ops), library_ms=lib_ms,
        shape=f"L={L} R={n_pad} K={K} nnz={nnz}"))
    for r in rows:
        log(f"[timing] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"launches {r['launches']}")
    return rows


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
    kernels = phase_timing(dev, main_res, spmv_err)
    log(f"[done] all phases passed in {time.time() - t_start:.1f}s on {card}")
    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k != "shape"} for r in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
