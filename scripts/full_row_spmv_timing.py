#!/usr/bin/env python3
"""The full-row ell_spmv_fleet kernel on one GPU, for any tree of the port.

    python3 scripts/full_row_spmv_timing.py             # this checkout
    python3 scripts/full_row_spmv_timing.py --src OTHER/src --cache DIR

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``)
and times its full-row ``kernels.spmv.ell_spmv_fleet`` on the three
panels chip_smoke.py holds it at: the amg panel of grid3d_uniform_16 and
the spai panel of powerlaw_4k (n = 4,096, the ``[zoo]`` phase's), and the
forward panel of the 64^3 main factor (``[main]``'s comparison applies:
grid3d(64,64,64,'uniform',seed=2), nnz-sort, chunk 256, fill_slack 32,
strict, key 0).  ``--cache DIR`` saves the three panels there on the
first run and loads them on later ones, so trees compared in one call
read the same bytes and the host builds run once.

For each panel and L in (1, 8) lanes of seeded x: the kernel's device
time per launch (busy time of 20 back-to-back launches in one
torch.profiler trace, over 20), its CUDA-event mean over 20 wrapper calls,
the same through the C entry point alone (the wrapper's checks left out),
the wrapper's host time per call (20 calls enqueued without a sync),
torch.sparse.mm on the panel's live slots in CSR (the lanes as columns)
and the bound: the live slots (8 B each) read once, the x sectors they
gather in each lane and Y written, over 3.35 TB/s.  A tree whose wrapper
takes ``lens`` is timed with the panel's live lengths (the path's call),
without them, with x gathered through L1 where the path would stage it
in shared memory, and with every length 0 (the launch's fixed cost: the
lanes grouped, x staged, every row's zero written).  Prints one JSON
line per measurement; the card's name and power limit first.  To compare
two trees, run them in one call on one card, in turns (A, B, B, A).
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PANELS = ("amg", "spai", "main")


def build_panels(dev):
    """{name: (cols, vals, lens)} of the three panels, one factor each
    ``[1, R, K]``; lens the live slots per row (last nonzero + 1)."""
    import torch
    import chip_smoke as cs
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.solver import FactorCache, Solver
    from repro_torch.data import graphs
    out = {}
    cache = FactorCache(device=dev)
    for name, graph, fam in (("amg", "grid3d_uniform_16", "amg"),
                             ("spai", "powerlaw_4k", "spai")):
        h = cache.factor(graphs.SUITE[graph](), key_from_seed(0),
                         graph_id=f"{graph}::{fam}", family=fam)
        fa = h.fleet.arrays
        out[name] = (fa.fcols[h.fleet_row:h.fleet_row + 1].clone(),
                     fa.fvals[h.fleet_row:h.fleet_row + 1].clone())
    g = cs.permuted(graphs.grid3d(64, 64, 64, "uniform", seed=2))
    solver = Solver(chunk=256, fill_slack=32, strict=True, device=dev)
    h = solver.factor(g, key_from_seed(0))
    fa = h.fleet.arrays
    out["main"] = (fa.fcols[h.fleet_row:h.fleet_row + 1].clone(),
                   fa.fvals[h.fleet_row:h.fleet_row + 1].clone())
    torch.cuda.synchronize()
    return {k: (c, v, live_lengths(v)) for k, (c, v) in out.items()}


def live_lengths(vals):
    """Each row's index of its last nonzero value plus one, int32."""
    import torch
    K = vals.shape[-1]
    nz = vals != 0
    last = K - torch.argmax(nz.flip(-1).to(torch.int8), dim=-1)
    return torch.where(nz.any(-1), last, 0).to(torch.int32).contiguous()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--cache", default=None,
                    help="directory to save the panels to or load them from")
    ap.add_argument("--tag", default="", help="label printed on each line")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures on a GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import chip_smoke as cs
    from repro_torch.kernels import runtime, spmv
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runtime.build(["ell_spmv_fleet"])
    has_lens = "lens" in inspect.signature(spmv.ell_spmv_fleet).parameters
    path = Path(args.cache) / "panels.pt" if args.cache else None
    t0 = time.time()
    if path is not None and path.exists():
        panels = {k: tuple(t.to(dev) for t in v)
                  for k, v in torch.load(path).items()}
    else:
        panels = build_panels(dev)
        if path is not None:
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save({k: tuple(t.cpu() for t in v)
                        for k, v in panels.items()}, path)
    print(f"panels ready in {time.time() - t0:.1f}s", flush=True)
    rng = np.random.default_rng(0)
    for name in PANELS:
        cols, vals, lens = panels[name]
        _, R, K = cols.shape
        nnz = int(lens.long().sum())
        n = R
        X8 = torch.from_numpy(rng.normal(size=(8, n)).astype(np.float32)
                              ).to(dev)
        live = torch.arange(K, device=dev)[None, :] < lens[0, :, None]
        crow = torch.zeros(R + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(lens[0].long(), 0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            csr = torch.sparse_csr_tensor(crow, cols[0][live].long(),
                                          vals[0][live], size=(R, n),
                                          check_invariants=False)
        for L in (1, 8):
            X = X8[:L].contiguous()
            XT = X.T.contiguous()
            fidx = torch.zeros(L, dtype=torch.int32, device=dev)
            x_bytes = L * cs.gathered_bytes(cols[0][live], vals[0][live], 1)
            b = cs.bound(nnz * 8 + x_bytes + L * 4 + L * R * 4, 2 * L * nnz)
            runs = [("all K", None, {})]
            if has_lens:
                runs += [("live", lens, {}),
                         ("live, x through L1", lens, dict(x_smem=False)),
                         ("none (lens 0)", torch.zeros_like(lens), {})]
            for how, ln, kw in runs:
                if ln is None:
                    def fn():
                        return spmv.ell_spmv_fleet(cols, vals, fidx, X)
                else:
                    def fn():
                        return spmv.ell_spmv_fleet(cols, vals, fidx, X, ln,
                                                   **kw)
                y = fn()
                lib = torch.sparse.mm(csr, XT).T
                torch.cuda.synchronize()
                rel = float((y - lib).abs().max()) / max(
                    float(lib.abs().max()), 1e-30)
                raw = raw_launch(spmv, cols, vals, ln, fidx, X, has_lens,
                                 kw.get("x_smem"))
                rec = dict(
                    tag=args.tag, src=args.src, panel=name, L=L, R=R, K=K,
                    nnz=nnz, reads=how,
                    device_ms=cs.device_ms_per_launch(fn),
                    event_ms=cs.time_ms(fn),
                    raw_event_ms=cs.time_ms(raw),
                    host_ms=cs.host_ms_per_call(fn),
                    library_ms=cs.time_ms(lambda: torch.sparse.mm(csr, XT)),
                    library_rel=rel, card=card, **b)
                print(json.dumps(rec), flush=True)


def raw_launch(spmv, cols, vals, lens, fidx, X, has_lens, x_smem=None):
    """The wrapper's launch without its checks: the C entry point called
    with the pointers taken once (the output reused)."""
    import torch
    from repro_torch.kernels import runtime
    L, n = X.shape
    _, R, K = cols.shape
    y = torch.empty((L, R), device=X.device)
    stream = runtime.stream_ptr(X)
    if has_lens:
        gather, ld = spmv._fleet_gather(L, n, x_smem)
        xt = torch.empty(max(n * ld, 1), device=X.device)
        f = spmv._launcher("ell_spmv_fleet", 7, 5)
        args = (cols.data_ptr(), vals.data_ptr(),
                None if lens is None else lens.data_ptr(), fidx.data_ptr(),
                X.data_ptr(), xt.data_ptr(), y.data_ptr(), L, R, K, n,
                gather, stream)
    else:
        f = spmv._launcher("ell_spmv_fleet", 5, 4)
        args = (cols.data_ptr(), vals.data_ptr(), fidx.data_ptr(),
                X.data_ptr(), y.data_ptr(), L, R, K, n, stream)

    def call():
        err = f(*args)
        if err:
            raise RuntimeError(f"ell_spmv_fleet launch failed: {err}")
    return call


if __name__ == "__main__":
    main()
