#!/usr/bin/env python3
"""The fleet level sweep ell_sweep_fleet on one GPU, for any tree of the port.

    python3 scripts/fleet_sweep_timing.py             # this checkout
    python3 scripts/fleet_sweep_timing.py --src OTHER/src --cache DIR

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``)
and times its ``kernels.spmv.ell_sweep_fleet`` on the main path's 64^3
factors (grid3d(64,64,64,'uniform',seed=2), nnz-sort, chunk 256,
fill_slack 32, strict; key 0, and key 1 as the ``[serve]`` phase's second
factor), both admitted to one fleet.  ``--cache DIR`` saves the two
factors' host arrays there on the first run and loads them on later
ones, so trees compared in one call sweep the same bytes and factor once.

Three lane sets: 1 lane and 8 lanes of the key-0 factor, and 8 lanes of
the two factors interleaved in fidx ([a, b, a, b, b, a, a, b], a served
bucket).  For each, at key 0's largest and average forward levels (one
level a call): the sweep's device time per call (busy time of 20
back-to-back calls in one torch.profiler trace, over 20; and the level
kernel's own, without a tree's other launches such as its lane grouping),
its CUDA-event
mean over 20 calls, the wrapper's host time per call (20 calls enqueued
without a sync), torch.sparse.mm on the level's live slots in CSR (the
lanes as columns; one product per factor) and the bound: the live slots
(8 B each) and each row's list entry and length read once per factor,
the y sectors the slots gather and the level's y rows read and written,
over 3.35 TB/s, for each layout of y: lane-major (each lane gathers its
own sectors) and interleaved (a column's lanes side by side, one row of
y gathered whole for all of them); each line gives both and, as
``bound_ms``, the one of the layout it timed.  A tree that takes an
interleaved y is timed with both layouts.  Then one whole
preconditioner apply per lane set: its wall time per call (CUDA events),
its device busy time (one traced call), the idle share, the launches and
the ctypes calls into the sweep's C entry point (one per level in a tree
whose level loop runs in Python, one per triangular solve in one whose
loop runs in C), and, in a tree with an interleaved apply, the same apply
with a lane-major working vector.  Prints one JSON line per measurement;
the card's name and power limit first.  To compare two trees, run them
in one call on one card, in turns (A, B, B, A).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("n", "col_ptr", "rows", "vals", "D")
SIDE = 64                  # the main path's grid3d side
DEVICE = "cuda"
LAYOUTS = ("lane-major", "interleaved")   # of y [L, R]


def load_factors(dev, cache):
    """The host arrays of the two 64^3 factors (keys 0 and 1), built on
    the card by this tree on the first run, else read from ``cache``."""
    import numpy as np
    path = Path(cache) / "factors.npz" if cache else None
    if path is not None and path.exists():
        z = np.load(path)
        return [{k: z[f"{i}_{k}"] for k in FIELDS} for i in range(2)]
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.parac import factorize_wavefront
    g = main_graph()
    out = []
    for key in (0, 1):
        f = factorize_wavefront(g, key_from_seed(key), chunk=256,
                                fill_slack=32, strict=True, device=dev)
        out.append({"n": np.array(f.n), **{k: np.array(getattr(f, k))
                                           for k in FIELDS[1:]}})
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **{f"{i}_{k}": v for i, f in enumerate(out)
                          for k, v in f.items()})
    return out


def graphs():
    from repro_torch.data import graphs as mod
    return mod


def main_graph():
    import chip_smoke as cs
    return cs.permuted(graphs().grid3d(SIDE, SIDE, SIDE, "uniform", seed=2))


def sweep_api(fl):
    """(plan-taking tree?, level(lv)): the sweep's argument for forward
    level ``lv`` alone: a plan entry in a tree that keeps host plans, else
    the per-level row maxima with one level kept."""
    if hasattr(fl, "f_plan"):
        plan = fl.f_plan

        def level(lv):
            return plan[plan[:, 0] == lv]
        return True, level
    rows = fl.f_rows

    def level(lv):
        only = [0] * len(rows)
        only[lv] = rows[lv]
        return only
    return False, level


def level_csr(fa, f, lv, dev):
    """(rows, live slots, csr, cols, vals) of factor row ``f``'s forward
    level ``lv``: its live slots in CSR, for torch.sparse.mm."""
    import torch
    lo, hi = int(fa.fstart[f, lv]), int(fa.fstart[f, lv + 1])
    r = fa.frows[f, lo:hi].long()
    K = fa.fcols.shape[2]
    lc, lvals = fa.fcols[f, r], fa.fvals[f, r]
    lens = fa.flen[f, r]
    mask = torch.arange(K, device=dev)[None, :] < lens[:, None]
    crow = torch.zeros(hi - lo + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(lens.long(), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        csr = torch.sparse_csr_tensor(crow, lc[mask].long(), lvals[mask],
                                      size=(hi - lo, fa.fcols.shape[1]),
                                      check_invariants=False)
    return hi - lo, int(lens.sum()), csr, lc, lvals


def device_spans(fn):
    """The device events of one call of ``fn``: [(name, start µs, end µs)]
    from a torch.profiler trace, in start order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA), key=lambda t: t[1])


class CCalls:
    """Counts the ctypes calls into the sweep's C entry point while the
    ``with`` block runs (the cached launcher wrapped)."""

    def __init__(self, spmv):
        self.spmv, self.n = spmv, 0

    def __enter__(self):
        self.saved = {}
        for key, f in list(self.spmv._LAUNCHERS.items()):
            if "ell_sweep_fleet" in key:
                self.saved[key] = f

                def call(*a, _f=f):
                    self.n += 1
                    return _f(*a)
                self.spmv._LAUNCHERS[key] = call
        return self

    def __exit__(self, *exc):
        self.spmv._LAUNCHERS.update(self.saved)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--cache", default=None,
                    help="directory to save the factors to or load them from")
    ap.add_argument("--tag", default="", help="label printed on each line")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures on a GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import chip_smoke as cs
    from repro_torch.core import pcg
    from repro_torch.core.ref_ac import ACFactor
    from repro_torch.core.solver import FactorCache
    from repro_torch.kernels import ops, runtime, spmv
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runtime.build(["ell_spmv_fleet"])
    t0 = time.time()
    host = load_factors(dev, args.cache)
    g = main_graph()
    cache = FactorCache(chunk=256, fill_slack=32, strict=True, device=dev)
    hs = [cache.attach(g, ACFactor(n=int(f["n"]), col_ptr=f["col_ptr"],
                                   rows=f["rows"], vals=f["vals"], D=f["D"]),
                       graph_id=f"g64_k{i}") for i, f in enumerate(host)]
    torch.cuda.synchronize()
    fl = hs[0].fleet
    if hs[1].fleet is not fl:
        sys.exit("the two factors did not share one fleet")
    fa = fl.arrays
    print(f"factors ready in {time.time() - t0:.1f}s: levels fwd "
          f"{hs[0].n_levels_fwd} / {hs[1].n_levels_fwd}, K {fl.Kf}",
          flush=True)
    has_plan, level = sweep_api(fl)
    a, b = hs[0].fleet_row, hs[1].fleet_row
    lane_sets = {"1 lane": [a], "8 lanes, one factor": [a] * 8,
                 "8 lanes, two factors": [a, b, a, b, b, a, a, b]}
    start = fa.fstart[a].cpu().numpy()
    counts = np.diff(start[:hs[0].n_levels_fwd + 1])[1:]
    levels = {"largest": int(np.argmax(counts)) + 1,
              "average": int(np.argmin(np.abs(counts - counts.mean()))) + 1}
    rng = np.random.default_rng(0)
    n_pad = fl.n_pad
    X8 = torch.zeros((8, n_pad), device=dev)
    X8[:, :g.n] = torch.from_numpy(rng.normal(size=(8, g.n)).astype(
        np.float32)).to(dev)
    layouts = LAYOUTS if has_plan else LAYOUTS[:1]
    common = dict(tag=args.tag, src=args.src, card=card)

    for set_name, rows_of_lanes in lane_sets.items():
        L = len(rows_of_lanes)
        fidx = torch.tensor(rows_of_lanes, dtype=torch.int32, device=dev)
        X = X8[:L].contiguous()
        for which, lv in levels.items():
            only = level(lv)
            # the library call and the bound, per factor of the lanes, for
            # each layout of y: lane-major, each lane gathers its own
            # sectors and moves its own level rows; interleaved, a
            # column's L lanes share one row of y, gathered and moved whole
            nbytes = dict.fromkeys(LAYOUTS, 0)
            ops_n, lib_calls = 0, []
            for f in sorted(set(rows_of_lanes)):
                lanes = [i for i, r in enumerate(rows_of_lanes) if r == f]
                R, live, csr, lc, lvals = level_csr(fa, f, lv, dev)
                Xc = X[lanes].T.contiguous()
                lib_calls.append((csr, Xc))
                nbytes["lane-major"] += (
                    live * 8 + R * 8
                    + len(lanes) * cs.gathered_bytes(lc, lvals, 1)
                    + 2 * len(lanes) * R * 4)
                nbytes["interleaved"] += (
                    live * 8 + R * 8 + cs.gathered_bytes(lc, lvals, L)
                    + 2 * L * R * 4)
                ops_n += 2 * len(lanes) * live
            bnds = {k: cs.bound(v, ops_n) for k, v in nbytes.items()}

            def lib():
                return [torch.sparse.mm(c, x) for c, x in lib_calls]
            lib_ms = cs.time_ms(lib)
            for layout in layouts:
                Y = ops.interleaved(X) if layout == "interleaved" else X.clone()

                def fn(Y=Y, only=only):
                    spmv.ell_sweep_fleet(fa.fcols, fa.fvals, fa.flen,
                                         fa.frows, fa.fstart, fidx, Y, only)
                rec = dict(kind="level", lanes=set_name, level=which, lv=lv,
                           layout=layout, device_ms=cs.device_ms_per_launch(fn),
                           kernel_ms=cs.kernel_device_ms(
                               fn, lambda: None, "ell_sweep_fleet_kernel"),
                           event_ms=cs.time_ms(fn),
                           host_ms=cs.host_ms_per_call(fn),
                           library_ms=lib_ms, **bnds[layout],
                           bound_lane_major_ms=bnds["lane-major"]["bound_ms"],
                           bound_interleaved_ms=bnds["interleaved"][
                               "bound_ms"], **common)
                if has_plan:
                    k = int(only[0, 2])
                    rec.update(level_k=k, G=spmv.group_width(k))
                print(json.dumps(rec), flush=True)

        # one whole apply
        if has_plan:
            f_plan, b_plan = fl.plans()
            kw = dict(f_plan=f_plan, b_plan=b_plan)
        else:
            kw = dict(f_rows=fl.f_rows, b_rows=fl.b_rows)
        applies = {"path": lambda: pcg.fleet_precondition(fa, fidx, X, **kw)}
        if has_plan:
            def lane_major():
                f = fidx.long()
                Y = ops.trisolve_fleet(fa.fcols, fa.fvals, fa.flen, fa.frows,
                                       fa.fstart, fidx, X, plan=f_plan)
                return ops.trisolve_fleet(fa.bcols, fa.bvals, fa.blen,
                                          fa.brows, fa.bstart, fidx,
                                          Y * fa.dinv[f], plan=b_plan)
            applies["lane-major working vector"] = lane_major
        want = applies["path"]()
        for how, fn in applies.items():
            got = fn()
            torch.cuda.synchronize()
            same = bool(torch.equal(got.view(torch.int32),
                                    want.view(torch.int32)))
            wall = cs.time_ms(fn, reps=5)
            runtime.reset_launches()
            with CCalls(spmv) as calls:
                fn()
            torch.cuda.synchronize()
            launches = dict(runtime.LAUNCHES)
            busy, events = cs.device_busy_ms(fn)
            spans = device_spans(fn)
            per_level = [(b - a) for n, a, b in spans
                         if "ell_sweep_fleet_kernel" in n]
            gaps = [b[1] - a[2] for a, b in zip(spans, spans[1:])]
            extra = {}
            if has_plan:
                # each launch's (rows bound, longest live row), in order
                extra["plan"] = np.concatenate([f_plan, b_plan])[
                    :, 1:].tolist()
            print(json.dumps(dict(
                level_kernels_ms=sum(per_level) / 1e3,
                other_kernels_ms=sum(b - a for _, a, b in spans) / 1e3
                - sum(per_level) / 1e3,
                median_gap_us=sorted(gaps)[len(gaps) // 2] if gaps else None,
                level_kernel_us=[round(d, 2) for d in per_level], **extra,
                kind="apply", lanes=set_name, how=how, wall_ms=wall,
                busy_ms=busy, events=events,
                idle_share=None if busy is None else 1 - busy / wall,
                launches=launches.get("ell_sweep_fleet", 0),
                c_calls=calls.n, same_bits_as_path=same, **common)),
                flush=True)


if __name__ == "__main__":
    main()
