"""Kernels against their plain versions on the card.  Marked ``gpu``:
they skip where no CUDA device is present (run them on the GPU machine
with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``;
``python3 chip_smoke.py`` covers the same ground at the main path's
shapes)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)

from repro_torch.kernels import flash_attention as fa          # noqa: E402
from repro_torch.kernels import runtime                        # noqa: E402
from repro_torch.kernels import sample_clique as sc            # noqa: E402
from repro_torch.kernels import spmv                           # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("W", [2, 64, 1024, 8192])
def test_sample_clique_kernel_bitwise(dev, W):
    rng = np.random.default_rng(W)
    R = 64
    fill = rng.integers(0, W + 1, R).astype(np.int32)
    ids = rng.integers(0, max(2, W // 2), (R, W)).astype(np.int32)
    ws = rng.uniform(0.1, 3.0, (R, W)).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (R, W)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (ids, ws, fill, u)]
    before = runtime.LAUNCHES.get("sample_clique", 0)
    k = sc.sample_clique(*args)
    p = sc.sample_clique_plain(*args)
    assert runtime.LAUNCHES["sample_clique"] == before + 1
    for a, b in zip(k, p):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.parametrize("fills", ["1-32", "33-64", "u=0"])
def test_sample_clique_kernel_row_widths(dev, fills):
    """Rows at W = 512 whose own width is a warp's (fills 1-32) or wider
    (33-64), and rows with u = 0 and weights over 33 decades (thresholds
    equal to S1, sums that round): all eight outputs bitwise equal."""
    rng = np.random.default_rng(len(fills))
    R, W = 128, 512
    lo, hi = {"1-32": (1, 32), "33-64": (33, 64), "u=0": (2, 64)}[fills]
    fill = rng.integers(lo, hi + 1, R).astype(np.int32)
    ids = rng.integers(0, 48, (R, W)).astype(np.int32)
    ws = rng.uniform(0.1, 3.0, (R, W)).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (R, W)).astype(np.float32)
    if fills == "u=0":
        ws = (10.0 ** rng.uniform(-30, 3, (R, W))).astype(np.float32)
        u[:] = 0.0
    args = [torch.from_numpy(a).to(dev) for a in (ids, ws, fill, u)]
    k = sc.sample_clique(*args)
    p = sc.sample_clique_plain(*args)
    for a, b in zip(k, p):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def _engine_on(dev, gs, slack):
    from repro_torch.core import parac
    from repro_torch.core.column_math import key_from_seed
    built = [parac._build_pool(parac._pool_edges(g, np.float32, dev), slack)
             for g in gs]
    return parac._init_engine(
        built, [key_from_seed(i) for i in range(len(gs))],
        n_pad=parac._next_pow2(max(g.n for g in gs)),
        P_pad=parac._next_pow2(max(b.P for b in built)),
        W=max(parac._next_pow2(max(b.dmax for b in built)), 2), chunk=256)


@pytest.mark.parametrize("case", ["grid3d16-slack256", "batch2"])
def test_fused_round_bitwise(dev, case):
    """The fused round against its plain composition, round after round:
    the engine state after each (drop entries aside) and the edges bit for
    bit, with rows wider than a warp (slack 256, W = 512) and a B = 2
    batch; one launch per round."""
    from repro_torch.core import parac
    from repro_torch.core.ordering import ORDERINGS
    from repro_torch.data import graphs

    def perm(g):
        return g.permute(ORDERINGS["nnz-sort"](g, seed=0)).coalesce()

    g16 = perm(graphs.SUITE["grid3d_uniform_16"]())
    if case == "batch2":
        s, st = _engine_on(dev, [g16, perm(graphs.grid2d(40, 50, seed=1))],
                           64)
    else:
        s, st = _engine_on(dev, [g16], 256)
        assert st.W == 512
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    widest = 0
    for _ in range(160):
        live = parac._live(s, st)
        cand, ok = parac._round_ready(s.elim, s.dep, live, chunk=st.chunk)
        fill = torch.where(ok, torch.gather(s.col_fill, 1, cand), 0)
        widest = max(widest, int(fill.max()))
        a = type(s)(*(t.clone() for t in s))
        before = runtime.LAUNCHES.get("sample_clique_round", 0)
        got = sc.eliminate_round(s, st, cand, ok)
        assert runtime.LAUNCHES["sample_clique_round"] == before + 1
        want = sc.eliminate_round_plain(a, st, cand, ok)
        for x, y in zip(s, a):
            if x.dim() == 2:                 # the drop entries aside
                x, y = x[:, :-1], y[:, :-1]
            assert torch.equal(bits(x), bits(y))
        for x, y in zip(got, want):
            assert torch.equal(bits(x), bits(y))
        parac._round_scatter(s, st, got, ok)
        s.n_elim.add_(ok.sum(dim=1, dtype=torch.int32))
        s.n_rounds.add_(live.to(torch.int32))
    assert widest > 32


def test_ell_spmv_fleet_kernel(dev):
    rng = np.random.default_rng(0)
    F, R, K, n, L = 3, 1000, 37, 1000, 5
    cols = torch.from_numpy(rng.integers(0, n, (F, R, K)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(F, R, K)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(L, n)).astype(np.float32))
    fidx = torch.tensor([2, 0, 1, 2, 2], dtype=torch.int32)
    cols, vals, x, fidx = (t.to(dev) for t in (cols, vals, x, fidx))
    y = spmv.ell_spmv_fleet(cols, vals, fidx, x)
    p = spmv.ell_spmv_fleet_plain(cols, vals, fidx, x)
    assert torch.allclose(y, p, rtol=1e-5, atol=1e-5)
    y0 = spmv.ell_spmv_fleet(cols, vals, fidx[:1], x[:1].contiguous())
    assert torch.equal(y0[0], y[0])


@pytest.mark.parametrize("K", [5, 33, 1086])
@pytest.mark.parametrize("L", [1, 3, 8, 11])
def test_ell_spmv_fleet_kernel_live_slots_bitwise(dev, K, L):
    """The full-row kernel over each row's live slots on left-packed
    panels of two factors (rows of length 0, 1 and K; the lanes
    interleaved): equal bit for bit to the kernel over all K slots, to
    each lane alone, to the factor's lanes launched together, and between
    x staged in shared memory and gathered through L1; the kernel and the
    plain version each within its own order's forward-error bound of the
    exact row sums; one launch a call."""
    rng = np.random.default_rng(10 * K + L)
    F, R, n = 2, 700, 2048
    lens = rng.integers(0, K + 1, (F, R)).astype(np.int32)
    lens[:, :3] = [0, 1, K]
    live = np.arange(K)[None, None, :] < lens[:, :, None]
    cols = np.where(live, rng.integers(0, n, (F, R, K)), 0).astype(np.int32)
    vals = np.where(live, rng.normal(size=(F, R, K)), 0.0).astype(np.float32)
    x = rng.normal(size=(L, n)).astype(np.float32)
    fidx = (np.arange(L) % 2).astype(np.int32)
    cols, vals, lens, x, fidx = (torch.from_numpy(a).to(dev)
                                 for a in (cols, vals, lens, x, fidx))
    before = runtime.LAUNCHES.get("ell_spmv_fleet", 0)
    y = spmv.ell_spmv_fleet(cols, vals, fidx, x, lens)
    assert runtime.LAUNCHES["ell_spmv_fleet"] == before + 1
    full = spmv.ell_spmv_fleet(cols, vals, fidx, x)
    assert torch.equal(y.view(torch.int32), full.view(torch.int32))
    for smem in (True, False):
        other = spmv.ell_spmv_fleet(cols, vals, fidx, x, lens, x_smem=smem)
        assert torch.equal(other.view(torch.int32), y.view(torch.int32))
    p = spmv.ell_spmv_fleet_plain(cols, vals, fidx, x, lens)
    exact, kernel_bound, plain_bound = spmv.ell_spmv_fleet_error_bounds(
        cols, vals, fidx, x)
    assert bool(((y.double() - exact).abs() <= kernel_bound).all())
    assert bool(((p.double() - exact).abs() <= plain_bound).all())
    for lane in range(L):
        alone = spmv.ell_spmv_fleet(cols, vals, fidx[lane:lane + 1],
                                    x[lane:lane + 1].contiguous(), lens)
        assert torch.equal(alone[0].view(torch.int32),
                           y[lane].view(torch.int32))
    same = torch.nonzero(fidx == 0)[:, 0]
    for smem in (None, False):       # through L1: the lanes' vector reads
        together = spmv.ell_spmv_fleet(cols, vals, fidx[same].contiguous(),
                                       x[same].contiguous(), lens,
                                       x_smem=smem)
        assert torch.equal(together.view(torch.int32),
                           y[same].view(torch.int32))


def test_ell_spmv_fleet_lane_limit(dev):
    """One launch takes at most FLEET_MAX_LANES lanes; above it the
    wrapper raises before any launch."""
    L = spmv.FLEET_MAX_LANES + 1
    cols = torch.zeros((1, 4, 3), dtype=torch.int32, device=dev)
    x = torch.zeros((L, 4), device=dev)
    fidx = torch.zeros(L, dtype=torch.int32, device=dev)
    before = runtime.LAUNCHES.get("ell_spmv_fleet", 0)
    with pytest.raises(ValueError):
        spmv.ell_spmv_fleet(cols, cols.float(), fidx, x)
    assert runtime.LAUNCHES.get("ell_spmv_fleet", 0) == before
    y = spmv.ell_spmv_fleet(cols, cols.float(), fidx[:-1], x[:-1])
    assert bool((y == 0).all())


def _sweep_fleet(dev):
    """A three-factor fleet of one bucket on the card (the CPU file
    test_torch_fleet_sweep.py builds the same one), its handles, and each
    member's level per row, forward and backward ``[2, F, n_pad]``, from
    its packed schedules built anew (the stack keeps only the level row
    lists)."""
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.solver import FactorCache
    from repro_torch.core.trisolve import build_schedules_batched
    from repro_torch.data import graphs
    c = FactorCache(chunk=16, k_tiering=False, device=dev)
    hs = [c.factor(graphs.grid2d(a, b, seed=s), key_from_seed(i))
          for i, (a, b, s) in enumerate([(9, 9, 1), (8, 16, 2),
                                         (10, 12, 3)])]
    fl = hs[0].fleet
    levels = torch.zeros((2, fl.capacity, fl.n_pad), dtype=torch.int32,
                         device=dev)
    for h in hs:
        fwd, bwd = build_schedules_batched([h.factor.to_device(dev)])[0]
        levels[0, h.fleet_row] = fwd.level_of
        levels[1, h.fleet_row] = bwd.level_of
    return fl, hs, levels


@pytest.mark.parametrize("half", ["fwd", "bwd"])
def test_ell_sweep_fleet_kernel(dev, half):
    """The level sweep on the card: each level against its plain version
    on the same input (relative 1e-5: the plain version sums a row left to
    right, the kernel in the full-row kernel's order), the whole solve
    against the full-row kernel + where bit for bit, and a lane alone
    against the same lane in the batch bit for bit."""
    from repro_torch.kernels import ops
    fl, _hs, levels = _sweep_fleet(dev)
    fa = fl.arrays
    p = half[0]
    cols, vals, lens, rows, starts = (
        getattr(fa, p + name) for name in ("cols", "vals", "len", "rows",
                                           "start"))
    level = levels[0 if p == "f" else 1]
    plan = fl.f_plan if p == "f" else fl.b_plan
    n_levels = fl.f_levels if p == "f" else fl.b_levels
    fidx = torch.tensor([2, 0, 2, 1, 3], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    y0 = torch.randn((5, fl.n_pad), generator=gen, device=dev)
    y = y0.clone()
    before = runtime.LAUNCHES.get("ell_sweep_fleet", 0)
    for e in range(plan.shape[0]):
        only = plan[e:e + 1]
        want = y.clone()
        spmv.ell_sweep_fleet_plain(cols, vals, lens, rows, starts, fidx,
                                   want, only)
        spmv.ell_sweep_fleet(cols, vals, lens, rows, starts, fidx, y, only)
        assert torch.allclose(y, want, rtol=1e-5, atol=1e-5)
        y = want
    # each call: the lane grouping, then its one level
    assert runtime.LAUNCHES["ell_sweep_fleet"] == before + 2 * plan.shape[0]
    got = ops.trisolve_fleet(cols, vals, lens, rows, starts, fidx, y0,
                             plan=plan)
    masked = ops.trisolve_fleet_masked(cols, vals, fidx, level[fidx.long()],
                                       y0, n_levels=n_levels)
    assert torch.equal(got.view(torch.int32), masked.view(torch.int32))
    assert torch.equal(got[4], y0[4])            # the fleet's empty row
    alone = ops.trisolve_fleet(cols, vals, lens, rows, starts, fidx[:1],
                               y0[:1].contiguous(), plan=plan)
    assert torch.equal(alone[0].view(torch.int32), got[0].view(torch.int32))
    inter = ops.trisolve_fleet(cols, vals, lens, rows, starts, fidx,
                               ops.interleaved(y0), plan=plan)
    assert torch.equal(inter.view(torch.int32), got.view(torch.int32))


def test_ell_sweep_fleet_rejects_short_starts(dev):
    """A plan level lv reads starts[:, lv + 1]: a level at starts' last
    column is refused before any launch, as are more lanes than one call
    takes and a y of neither layout."""
    fl, _hs, _ = _sweep_fleet(dev)
    fa = fl.arrays
    fidx = torch.zeros(1, dtype=torch.int32, device=dev)
    y = torch.zeros((1, fl.n_pad), device=dev)
    before = runtime.LAUNCHES.get("ell_sweep_fleet", 0)
    args = (fa.fcols, fa.fvals, fa.flen, fa.frows, fa.fstart)
    with pytest.raises(ValueError):
        spmv.ell_sweep_fleet(*args, fidx, y, np.array(
            [[fa.fstart.shape[1] - 1, 1, 1]], np.int32))
    many = spmv.FLEET_MAX_LANES + 1
    with pytest.raises(ValueError):
        spmv.ell_sweep_fleet(*args, torch.zeros(many, dtype=torch.int32,
                                                device=dev),
                             torch.zeros((many, fl.n_pad), device=dev),
                             fl.f_plan)
    with pytest.raises(ValueError):
        spmv.ell_sweep_fleet(*args, torch.zeros(2, dtype=torch.int32,
                                                device=dev),
                             torch.zeros((2, 2 * fl.n_pad), device=dev)[:, ::2],
                             fl.f_plan)
    assert runtime.LAUNCHES.get("ell_sweep_fleet", 0) == before


@pytest.mark.parametrize("layout", ["lane-major", "interleaved"])
def test_ell_sweep_fleet_lanes_alone_and_two_factors(dev, layout):
    """8 lanes of two factors interleaved in fidx, one apply's both
    solves: every lane bitwise equal to itself alone and to ell_sweep of
    its factor's level-sorted schedule, and the whole solve bitwise equal
    to the full-row composition."""
    from repro_torch.core.trisolve import build_schedules_device
    from repro_torch.kernels import ops
    fl, hs, levels = _sweep_fleet(dev)
    fa = fl.arrays
    a, b = hs[1].fleet_row, hs[2].fleet_row
    fidx = torch.tensor([a, b, a, b, b, a, a, b], dtype=torch.int32,
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    y0 = torch.randn((8, fl.n_pad), generator=gen, device=dev)
    for p, plan in (("f", fl.f_plan), ("b", fl.b_plan)):
        args = tuple(getattr(fa, p + name) for name in
                     ("cols", "vals", "len", "rows", "start"))
        y = ops.interleaved(y0) if layout == "interleaved" else y0
        got = ops.trisolve_fleet(*args, fidx, y, plan=plan)
        level = levels[0 if p == "f" else 1][fidx.long()]
        masked = ops.trisolve_fleet_masked(
            args[0], args[1], fidx, level, y0,
            n_levels=fl.f_levels if p == "f" else fl.b_levels)
        assert torch.equal(got.view(torch.int32), masked.view(torch.int32))
        for lane in range(8):
            alone = ops.trisolve_fleet(*args, fidx[lane:lane + 1],
                                       y0[lane:lane + 1].contiguous(),
                                       plan=plan)
            assert torch.equal(alone[0].view(torch.int32),
                               got[lane].view(torch.int32))
        for h in (hs[1], hs[2]):
            # the library path's schedule of the same factor (its backward
            # solve in flipped index space): ell_sweep's lane
            sched = build_schedules_device(h.factor.to_device(dev))[
                0 if p == "f" else 1]
            lane = int((fidx == h.fleet_row).nonzero()[0, 0])
            lib = ops.trisolve_panels(sched, y0[lane, :h.n].contiguous(),
                                      flip=p == "b")
            assert torch.equal(lib.view(torch.int32),
                               got[lane, :h.n].view(torch.int32))


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(TypeError):
        spmv.ell_spmv_fleet(torch.zeros((1, 2, 2), device=dev),
                            torch.zeros((1, 2, 2), device=dev),
                            torch.zeros(1, dtype=torch.int32, device=dev),
                            torch.zeros((1, 2), device=dev))
    ids = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        sc.sample_clique(ids, ids.float(), ids[:, 0].contiguous(),
                         ids.float())


@pytest.mark.parametrize("R,K", [(1, 1), (37, 5), (1000, 33), (300, 700)])
def test_ell_spmv_kernel(dev, R, K):
    rng = np.random.default_rng(R + K)
    n = 2000
    cols = torch.from_numpy(rng.integers(0, n, (R, K)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(R, K)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    cols, vals, x = (t.to(dev) for t in (cols, vals, x))
    before = runtime.LAUNCHES.get("ell_spmv", 0)
    y = spmv.ell_spmv(cols, vals, x)
    assert runtime.LAUNCHES["ell_spmv"] == before + 1
    p = spmv.ell_spmv_plain(cols, vals, x)
    assert torch.allclose(y, p, rtol=1e-5, atol=1e-5)
    # one row-reduction order: ell_spmv is the fleet kernel's lane
    lane = spmv.ell_spmv_fleet(cols[None], vals[None],
                               torch.zeros(1, dtype=torch.int32, device=dev),
                               x[None])[0]
    assert torch.equal(y, lane)
    # a row range of the panel is read in place
    lo, hi = R // 3, R
    assert torch.equal(spmv.ell_spmv(cols[lo:hi], vals[lo:hi], x), y[lo:hi])


@pytest.mark.parametrize("B", [1, 3, 8, 11])
def test_ell_spmv_multi_kernel(dev, B):
    rng = np.random.default_rng(B)
    R, K, n = 777, 45, 1500
    cols = torch.from_numpy(rng.integers(0, n, (R, K)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(R, K)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n, B)).astype(np.float32))
    cols, vals, x = (t.to(dev) for t in (cols, vals, x))
    before = runtime.LAUNCHES.get("ell_spmv_multi", 0)
    Y = spmv.ell_spmv_multi(cols, vals, x)
    assert runtime.LAUNCHES["ell_spmv_multi"] == before + 1
    assert torch.allclose(Y, spmv.ell_spmv_multi_plain(cols, vals, x),
                          rtol=1e-5, atol=1e-5)
    for b in range(B):
        assert torch.equal(Y[:, b], spmv.ell_spmv(cols, vals,
                                                  x[:, b].contiguous()))


def test_library_path_on_card(dev):
    """make_preconditioner → laplacian_pcg / laplacian_pcg_batched on the
    card: converges as on the CPU, every lane within 1e-4 of the CPU's
    solution, and through the two sweep kernels (the full-row slab
    kernels do not launch)."""
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.parac import factorize_wavefront
    from repro_torch.core.pcg import laplacian_pcg, laplacian_pcg_batched
    from repro_torch.core.trisolve import make_preconditioner
    from repro_torch.data import graphs
    g = graphs.grid3d(8, 8, 8, "contrast", seed=0)
    B = np.random.default_rng(0).normal(size=(3, g.n)).astype(np.float32)
    res = {}
    for d in ("cpu", dev):
        f = factorize_wavefront(g, key_from_seed(0), chunk=64, device=d)
        apply = make_preconditioner(f)
        runtime.reset_launches()
        r1 = laplacian_pcg(g, apply, torch.from_numpy(B[0]).to(d), tol=1e-6,
                           maxiter=300)
        rb = laplacian_pcg_batched(g, lambda R: apply(R.T).T,
                                   torch.from_numpy(B).to(d), tol=1e-6,
                                   maxiter=300)
        res[str(d)] = r1, rb, dict(runtime.LAUNCHES)
    (c1, cb, _), (g1, gb, launches) = res["cpu"], res[str(dev)]
    assert launches["ell_sweep"] > 0 and launches["ell_sweep_multi"] > 0
    assert launches.get("ell_spmv", 0) == 0
    assert launches.get("ell_spmv_multi", 0) == 0
    assert bool(g1.converged) and bool(gb.converged.all())
    for xc, xg in ((c1.x, g1.x), *zip(cb.x, gb.x)):
        xc, xg = xc.double(), xg.cpu().double()
        assert float((xc - xg).norm() / xc.norm()) <= 1e-4
    # lane independence on the card: lane 0 of the block is its own
    # single-rhs solve bit for bit
    assert int(g1.iters) == int(gb.iters[0]) and torch.equal(g1.x, gb.x[0])


def _library_schedules(dev, name):
    """Forward and backward level-sorted schedules of a factor made on the
    card: powerlaw_micro (panels 42 and 34 slots wide, so some levels give
    a thread several live slots) or grid3d(8, 8, 8)."""
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.parac import factorize_wavefront
    from repro_torch.core.trisolve import build_schedules_device
    from repro_torch.data import graphs
    g = (graphs.SUITE_MICRO["powerlaw_micro"]() if name == "powerlaw_micro"
         else graphs.grid3d(8, 8, 8, "contrast", seed=0))
    f = factorize_wavefront(g, key_from_seed(7), chunk=64, device=dev)
    return build_schedules_device(f)


@pytest.mark.parametrize("B", [None, 1, 3, 8, 11], ids=lambda B: f"B{B}")
@pytest.mark.parametrize("name", ["powerlaw_micro", "grid3d_8"])
def test_ell_sweep_kernels(dev, name, B):
    """The library path's sweeps on the card: each level alone against the
    plain version on the same input (relative 1e-5: the plain version sums
    a row left to right, the kernel in ell_row.cuh's order), the whole
    solve against the full-row composition (ell_spmv / ell_spmv_multi,
    then y[rows] -= Y) bit for bit, forward and backward, one launch per
    triangular solve, and each column of a block equal to ell_sweep of
    that column bit for bit."""
    from repro_torch.kernels import ops
    name_k = "ell_sweep" if B is None else "ell_sweep_multi"
    kernel = spmv.ell_sweep if B is None else spmv.ell_sweep_multi
    gen = torch.Generator(device=dev).manual_seed(B or 0)
    for s, flip in zip(_library_schedules(dev, name), (False, True)):
        args = (s.cols, s.vals, s.row_len, s.row_ids)
        shape = (s.n,) if B is None else (s.n, B)
        y0 = torch.randn(shape, generator=gen, device=dev)
        y = y0.clone()
        for p in range(s.plan.shape[0]):
            one = s.plan[p:p + 1]
            want = y.clone()
            spmv.ell_sweep_plain(*args, want, one)
            kernel(*args, y, spmv.sweep_walk(one, dev))
            assert torch.allclose(y, want, rtol=1e-5, atol=1e-5)
            y = want
        before = runtime.LAUNCHES.get(name_k, 0)
        got = ops.trisolve_panels(s, y0, flip=flip)
        assert runtime.LAUNCHES[name_k] == before + 1
        full = ops.trisolve_panels_full(s, y0, flip=flip)
        assert torch.equal(got.view(torch.int32), full.view(torch.int32))
        if B is not None:
            for c in range(B):
                col = ops.trisolve_panels(s, y0[:, c].contiguous(), flip=flip)
                assert torch.equal(got[:, c].view(torch.int32),
                                   col.view(torch.int32))


def _walk_solves(dev, name, B):
    """(schedule, flip, y0, the full-row composition's solve) for both
    triangular solves of ``name``'s factor, y0 seeded ``[n]`` or
    ``[n, B]``."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(17 + (B or 0))
    out = []
    for s, flip in zip(_library_schedules(dev, name), (False, True)):
        y0 = torch.randn((s.n,) if B is None else (s.n, B), generator=gen,
                         device=dev)
        out.append((s, flip, y0, ops.trisolve_panels_full(s, y0, flip=flip)))
    return out


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("B", [None, 8])
def test_ell_sweep_walk_repeated_calls(dev, B):
    """Ten solves in a row on one schedule, each with its own workspace
    zeroed on the stream: every one bitwise equal to the full-row
    composition, one launch each."""
    from repro_torch.kernels import ops
    name_k = "ell_sweep" if B is None else "ell_sweep_multi"
    for s, flip, y0, want in _walk_solves(dev, "grid3d_8", B):
        before = runtime.LAUNCHES.get(name_k, 0)
        got = [ops.trisolve_panels(s, y0, flip=flip) for _ in range(10)]
        torch.cuda.synchronize()
        assert runtime.LAUNCHES[name_k] == before + 10
        assert all(_bits_equal(g, want) for g in got)


@pytest.mark.parametrize("B", [None, 8])
def test_ell_sweep_walk_two_streams(dev, B):
    """Two streams sweep one schedule at once, 8 solves each on their own
    right-hand sides: every result bitwise equal to the full-row
    composition (the two calls share no workspace)."""
    from repro_torch.kernels import ops
    for s, flip, y0, want in _walk_solves(dev, "powerlaw_micro", B):
        y1 = torch.flip(y0, (0,)).contiguous()
        want1 = ops.trisolve_panels_full(s, y1, flip=flip)
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream(device=dev) for _ in range(2)]
        got = {0: [], 1: []}
        for _ in range(8):
            for k, st in enumerate(streams):
                with torch.cuda.stream(st):
                    got[k].append(ops.trisolve_panels(
                        s, y0 if k == 0 else y1, flip=flip))
        torch.cuda.synchronize()
        assert all(_bits_equal(g, want) for g in got[0])
        assert all(_bits_equal(g, want1) for g in got[1])


def test_ell_sweep_walk_beside_a_full_card(dev):
    """A solve enqueued on one stream while another stream keeps the card
    full (large matrix products and a larger schedule's solves, which
    take every resident block): both finish, and both sweeps equal the
    full-row composition bit for bit."""
    from repro_torch.kernels import ops
    big = _walk_solves(dev, "grid3d_8", 8)
    small = _walk_solves(dev, "powerlaw_micro", None)
    a = torch.randn((4096, 4096), device=dev)
    torch.cuda.synchronize()
    busy, side = torch.cuda.Stream(device=dev), torch.cuda.Stream(device=dev)
    with torch.cuda.stream(busy):
        filler = [a @ a for _ in range(4)]
        got_big = [ops.trisolve_panels(s, y0, flip=flip)
                   for s, flip, y0, _ in big for _ in range(4)]
    with torch.cuda.stream(side):
        got_small = [ops.trisolve_panels(s, y0, flip=flip)
                     for s, flip, y0, _ in small]
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(f).all()) for f in filler)
    for k, (_, _, _, want) in enumerate(big):
        assert all(_bits_equal(g, want) for g in got_big[4 * k:4 * k + 4])
    for g, (_, _, _, want) in zip(got_small, small):
        assert _bits_equal(g, want)


@pytest.mark.parametrize("B", [None, 8, 11])
def test_ell_sweep_walk_runs(dev, B):
    """A path of 300 one-row levels, each row also reading 40 rows of
    level 0 (41 live slots: G = 32, up to two slots a thread): the walk
    sweeps it in runs of up to 64 levels, one block each, bitwise equal to
    the full-row composition, in one launch."""
    from repro_torch.core.trisolve import _schedule_from_edges_device
    from repro_torch.kernels import ops
    n0, levels = 40, 300
    i = torch.arange(n0 + 1, n0 + levels + 1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    far = torch.randint(0, n0, (levels, n0), generator=gen, device=dev)
    dst = torch.cat([i, i.repeat_interleave(n0)])
    src = torch.cat([i - 1, far.reshape(-1)])
    val = torch.rand(dst.numel(), generator=gen, device=dev) * 0.05
    s = _schedule_from_edges_device(n0 + levels + 1, dst, src, val)
    assert bool((s.walk.items[:, 3] < 0).any())
    name_k = "ell_sweep" if B is None else "ell_sweep_multi"
    y0 = torch.randn((s.n,) if B is None else (s.n, B), generator=gen,
                     device=dev)
    before = runtime.LAUNCHES.get(name_k, 0)
    got = ops.trisolve_panels(s, y0)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES[name_k] == before + 1
    assert _bits_equal(got, ops.trisolve_panels_full(s, y0))


@pytest.mark.parametrize("B", [None, 3])
def test_ell_sweep_walk_one_level_and_empty_plans(dev, B):
    """A plan of one level (the first with rows, and the one with the
    longest rows) takes one launch and changes only that level's rows, as
    the plain version does within 1e-5; an empty plan, and a plan whose
    only entry holds no rows, launch nothing and leave y as it was."""
    import numpy as np
    name_k = "ell_sweep" if B is None else "ell_sweep_multi"
    kernel = spmv.ell_sweep if B is None else spmv.ell_sweep_multi
    s, _ = _library_schedules(dev, "powerlaw_micro")
    args = (s.cols, s.vals, s.row_len, s.row_ids)
    gen = torch.Generator(device=dev).manual_seed(23)
    y0 = torch.randn((s.n,) if B is None else (s.n, B), generator=gen,
                     device=dev)
    for p in (0, int(np.argmax(s.plan[:, 2]))):
        one = s.plan[p:p + 1]
        y, want = y0.clone(), y0.clone()
        before = runtime.LAUNCHES.get(name_k, 0)
        kernel(*args, y, spmv.sweep_walk(one, dev))
        spmv.ell_sweep_plain(*args, want, one)
        torch.cuda.synchronize()
        assert runtime.LAUNCHES[name_k] == before + 1
        lo, count = int(one[0, 0]), int(one[0, 1])
        rows = s.row_ids[lo:lo + count].long()
        other = torch.ones(s.n, dtype=torch.bool, device=dev)
        other[rows] = False
        assert torch.allclose(y, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(y[other], y0[other])
        assert not torch.equal(y[rows], y0[rows])
    for plan in (np.zeros((0, 3), np.int32),
                 np.array([[0, 0, 1]], np.int32)):
        y = y0.clone()
        before = runtime.LAUNCHES.get(name_k, 0)
        kernel(*args, y, spmv.sweep_walk(plan, dev))
        torch.cuda.synchronize()
        assert runtime.LAUNCHES.get(name_k, 0) == before
        assert torch.equal(y, y0)


def test_ell_sweep_wrappers_reject_bad_input(dev):
    """Bad input raises before any launch: a host tensor among the card's,
    a float64 y, a walk of an int64 plan, a walk of a plan entry past the
    panel, a bare plan in place of its walk."""
    import numpy as np
    s, _ = _library_schedules(dev, "powerlaw_micro")
    args = (s.cols, s.vals, s.row_len, s.row_ids)
    before = dict(runtime.LAUNCHES)
    for fn, y in ((spmv.ell_sweep, torch.zeros(s.n, device=dev)),
                  (spmv.ell_sweep_multi, torch.zeros((s.n, 3), device=dev))):
        with pytest.raises(ValueError):
            fn(s.cols, s.vals, s.row_len.cpu(), s.row_ids, y, s.walk)
        with pytest.raises(TypeError):
            fn(*args, y.double(), s.walk)
        with pytest.raises(ValueError):
            fn(*args, y, spmv.sweep_walk(s.plan.astype(np.int64), dev))
        past = s.plan.copy()
        past[-1, 0] = s.n
        with pytest.raises(ValueError):
            fn(*args, y, spmv.sweep_walk(past, dev))
        with pytest.raises(TypeError):
            fn(*args, y, s.plan)
    assert runtime.LAUNCHES.get("ell_sweep", 0) == before.get("ell_sweep", 0)
    assert (runtime.LAUNCHES.get("ell_sweep_multi", 0)
            == before.get("ell_sweep_multi", 0))


def test_fleet_lanes_do_not_depend_on_their_batch(dev):
    """The Solver's fleet PCG on the card: a column solved alone takes
    the same iterates as inside a batch of three."""
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.solver import Solver
    from repro_torch.data import graphs
    g = graphs.grid2d(12, 12, seed=3)
    solver = Solver(chunk=32, device=dev)
    solver.factor(g, key_from_seed(7))
    B = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, g.n)).astype(np.float32)).to(dev)
    rb = solver.solve(B, tol=1e-6, maxiter=300)
    for c in range(3):
        r1 = solver.solve(B[c], tol=1e-6, maxiter=300)
        assert int(r1.iters) == int(rb.iters[c])
        assert torch.equal(r1.x, rb.x[c])


def test_engine_serves_two_buckets_bitwise_on_card(dev):
    """The serving engine on the card: two factors of one bucket and one
    of another, lanes of both factors of a bucket stepped together with
    a partly empty slot set, through the engine and the async frontend;
    every request bitwise equal to its direct solve, the level sweep
    launched and nothing run on the CPU."""
    import asyncio
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.solver import FactorCache
    from repro_torch.data import graphs
    from repro_torch.serve import SolveEngine, SolveFrontend, SolveRequest
    gs = {"a": graphs.grid2d(12, 12, seed=3), "b": graphs.grid2d(12, 12,
                                                                 seed=8),
          "pl": graphs.powerlaw(300, 5, seed=3)}
    c = FactorCache(chunk=32, k_tiering=False, device=dev)
    c.factor_batched(list(gs.values()), [key_from_seed(i) for i in range(3)],
                     graph_ids=list(gs))
    assert c.get("a").fleet is c.get("b").fleet
    rng = np.random.default_rng(7)
    spec = [("a", 2, 1e-6), ("b", 1, 1e-4), ("pl", 3, 1e-6), ("b", 2, 1e-6),
            ("a", 1, 1e-5), ("pl", 1, 1e-4)]
    blocks = [(gid, rng.normal(size=(nr, gs[gid].n)).astype(np.float32),
               tol) for gid, nr, tol in spec]

    def check(req):
        ref = c.get(req.graph_id).solve(
            torch.from_numpy(np.atleast_2d(req.b)).to(dev), tol=req.tol,
            maxiter=req.maxiter)
        assert req.status == "converged"
        assert np.array_equal(np.atleast_2d(req.x).view(np.uint32),
                              ref.x.cpu().numpy().view(np.uint32))
        assert np.array_equal(np.atleast_1d(req.iters), ref.iters.cpu())
        assert np.array_equal(np.atleast_1d(req.relres),
                              ref.relres.cpu().numpy().astype(np.float64))

    runtime.reset_launches()
    eng = SolveEngine(c, slots=6, iters_per_tick=4)
    reqs = [SolveRequest(rid=i, graph_id=gid, b=b, tol=tol, maxiter=300)
            for i, (gid, b, tol) in enumerate(blocks)]
    for r in reqs:
        eng.submit(r)
    assert len(eng.run_until_drained()) == len(reqs)

    async def drive(fe):
        return await asyncio.gather(*[fe.solve(gid, b, tol=tol, maxiter=300)
                                      for gid, b, tol in blocks])

    with SolveFrontend(SolveEngine(c, slots=6, iters_per_tick=4)) as fe:
        served = asyncio.run(drive(fe))
    launches = dict(runtime.LAUNCHES)
    assert launches.get("ell_sweep_fleet", 0) > 0
    assert launches.get("ell_spmv_fleet", 0) == 0
    st = eng.stats()
    assert st.buckets == st.step_compiles == 2
    for r in reqs + served:
        check(r)


def _cluster_on_cards(devices):
    """Two solve replicas and one factor replica on ``devices``, the two
    n = 36 micro graphs (one bucket) served once each: every request
    converged and bitwise equal to a direct solve on its replica, every
    construction on the tier and adopted.  Returns the cluster's stats
    and the launch counts over the trace."""
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.data import graphs
    from repro_torch.serve import SolveCluster
    gs = {"g2d": graphs.grid2d(6, 6, seed=3),
          "road": graphs.road_like(6, seed=4)}
    cl = SolveCluster(replicas=2, factor_replicas=1, routing="affinity",
                      slots=4, iters_per_tick=8, devices=devices,
                      cache_kw=dict(chunk=32, fill_slack=64, strict=False))
    try:
        for i, (name, g) in enumerate(gs.items()):
            cl.register(g, key_from_seed(i), graph_id=name)
        rng = np.random.default_rng(0)
        runtime.reset_launches()
        for name, g in gs.items():
            b = rng.normal(size=g.n).astype(np.float32)
            b -= b.mean()
            r = cl.submit(name, b, tol=1e-6, maxiter=300).result(timeout=600)
            assert r.status == "converged"
            rep = cl.replicas[r.replica]
            # the kernels launch on the calling thread's current device,
            # as the replica's driver thread enters its own
            with torch.cuda.device(rep.device):
                ref = rep.cache.get(name).solve(
                    torch.from_numpy(b[None]).to(rep.device), tol=1e-6,
                    maxiter=300)
            assert np.array_equal(np.atleast_2d(r.x).view(np.uint32),
                                  ref.x.cpu().numpy().view(np.uint32))
        assert cl.drain(timeout=120)
        launches = dict(runtime.LAUNCHES)
        st = cl.stats()
        assert sum(w["factored"] for w in st.factor_tier["per_replica"]) \
            == st.adoptions == 2
        for rep in cl.replicas:
            es = rep.frontend.stats().engine
            assert es.step_compiles == es.buckets
        return st, launches
    finally:
        cl.close(drain=False)


def test_cluster_on_one_card_bitwise(dev):
    """Every replica of the cluster on ``cuda:0``: the tier constructs
    there, the fleet bytes live there and only the fused round and the
    level sweep launch."""
    st, launches = _cluster_on_cards("cuda:0,cuda:0,cuda:0")
    assert st.factor_tier["per_replica"][0]["device"] == "cuda:0"
    # the second cold graph goes to the roomier replica: both serve
    for rs in st.per_replica:
        assert rs.device == "cuda:0" and rs.cache["device"] == "cuda:0"
        assert rs.routed == 1
        assert set(rs.cache["fleet_device_bytes_by_device"]) == {"cuda:0"}
    assert launches.get("sample_clique_round", 0) > 0
    assert launches.get("ell_sweep_fleet", 0) > 0
    for name in ("sample_clique", "ell_spmv_fleet", "ell_spmv",
                 "ell_spmv_multi"):
        assert launches.get(name, 0) == 0, name


def test_cluster_pins_replicas_to_two_cards(dev):
    """Solve replicas on ``cuda:0`` and ``cuda:1``, the factor replica on
    ``cuda:1``: an adoption onto replica 0 crosses cards, each replica's
    fleet bytes stay on its own card, and serving stays bitwise."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    st, _ = _cluster_on_cards("cuda:0,cuda:1,cuda:1")
    assert st.factor_tier["per_replica"][0]["device"] == "cuda:1"
    for rs, want in zip(st.per_replica, ("cuda:0", "cuda:1")):
        assert rs.device == want and rs.cache["device"] == want
        assert rs.routed == 1
        assert set(rs.cache["fleet_device_bytes_by_device"]) == {want}


def test_cluster_ichol_tier_builds_on_card(dev, monkeypatch):
    """A fixed ``"ichol"`` cluster on ``cuda:0`` with one factor replica:
    the tier moves the host-built factor to the card and builds its
    schedules there, the adopted handle's compact factor stays resident
    on the card, and a request converges bitwise equal to a direct solve
    on its replica."""
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.data import graphs
    from repro_torch.serve import SolveCluster
    from repro_torch.serve.cluster import factor_tier
    built_on = []
    real = factor_tier.build_schedules_batched

    def record(devs):
        built_on.extend(str(d.device) for d in devs)
        return real(devs)

    monkeypatch.setattr(factor_tier, "build_schedules_batched", record)
    g = graphs.grid2d(6, 6, seed=3)
    b = np.random.default_rng(0).normal(size=g.n).astype(np.float32)
    b -= b.mean()
    with SolveCluster(precond="ichol", devices="cuda:0,cuda:0", replicas=1,
                      factor_replicas=1, slots=2,
                      cache_kw=dict(chunk=32, fill_slack=64,
                                    strict=False)) as cl:
        cl.register(g, key_from_seed(0), graph_id="g")
        r = cl.submit("g", b, tol=1e-6, maxiter=300).result(timeout=600)
        assert r.status == "converged" and r.graph_id == "g::ichol"
        assert cl.stats().adoptions == 1
        rep = cl.replicas[r.replica]
        h = rep.cache.peek(r.graph_id)
        assert all(t.device.type == "cuda" for t in h.factor)
        with torch.cuda.device(rep.device):
            ref = h.solve(torch.from_numpy(b[None]).to(rep.device),
                          tol=1e-6, maxiter=300)
        assert np.array_equal(np.atleast_2d(r.x).view(np.uint32),
                              ref.x.cpu().numpy().view(np.uint32))
    assert built_on == ["cuda:0"]


def test_spmv_wrappers_reject_bad_input(dev):
    c = torch.zeros((4, 3), dtype=torch.int32, device=dev)
    v = torch.zeros((4, 3), device=dev)
    with pytest.raises(TypeError):
        spmv.ell_spmv(c, v, torch.zeros(5, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        spmv.ell_spmv(c, v[:, :2].contiguous(), torch.zeros(5, device=dev))
    with pytest.raises(ValueError):
        spmv.ell_spmv_multi(c, v, torch.zeros(5, device=dev))


def _within_bound(got, want, v):
    """float32: max |diff| <= 2e-5 max|want| + 1e-6 (the kernel sums in
    another order than the plain version's tiles and matmuls).  bfloat16:
    the kernel rounds P to bf16 before P·V and the plain version does not,
    so elementwise |diff| <= u (|got| + |want|) + (u + (S + d) 2**-24)
    max|v|, with u = 2**-8 the bf16 unit roundoff and max|v| over the
    (batch, head): P's rounding moves a row's output by at most
    u·max|v| (the weights p_c / l sum to 1), each side's rounding of the
    output by u·|o|, and the fp32 sums of d-term scores and S-term rows
    by at most (S + d) 2**-24 of max|v|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if got.dtype == torch.float32 and v.dtype == torch.float32:
        return float(diff.max()) <= 2e-5 * float(want.abs().max()) + 1e-6
    u = 2.0 ** -8
    S, d = v.shape[-2:]
    vmax = v.float().abs().amax(dim=(-2, -1), keepdim=True)
    bound = u * (got.abs() + want.abs()) + (u + (S + d) * 2.0 ** -24) * vmax
    return bool((diff <= bound).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_attention_kernel(dev, d, causal, dtype):
    """Kernel vs plain on the card (bf16 on the tensor cores, float32 on
    fp32 FMAs); S = 200 is not a multiple of the kernel's 64-row tiles, so
    its ragged last q and kv tiles are masked (and, in bf16, arrive by TMA
    as zeros past S)."""
    gen = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (torch.randn((2, 3, 200, d), generator=gen, device=dev
                           ).to(dtype) for _ in range(3))
    before = runtime.LAUNCHES.get("flash_attention", 0)
    o = fa.flash_attention(q, k, v, causal=causal, q_tile=40, block_k=40)
    assert runtime.LAUNCHES["flash_attention"] == before + 1
    p = fa.flash_attention_plain(q, k, v, causal=causal, block_k=40)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    assert bool(torch.isfinite(o.float()).all())
    assert _within_bound(o, p, v)
    if dtype == torch.bfloat16:
        # against the float64 reference of the kernel's own numerics (P
        # rounded to bf16): the output's rounding plus the slack derived
        # from its fp32 steps, elementwise
        ref, slack = fa.flash_attention_bf16_reference(q, k, v,
                                                       causal=causal)
        got = o.double()
        assert bool(((got - ref).abs() <= 2.0 ** -8 * got.abs()
                     + slack).all())


def test_flash_attention_rejects_bad_input(dev):
    q = torch.zeros((1, 2, 64, 48), device=dev)
    with pytest.raises(ValueError):                      # head dim 48
        fa.flash_attention(q, q, q, q_tile=64, block_k=64)
    q = torch.zeros((1, 2, 64, 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q, q_tile=64, block_k=64)
    q = torch.zeros((1, 64, 2, 64), device=dev).transpose(1, 2)
    with pytest.raises(ValueError):                      # not contiguous
        fa.flash_attention(q, q, q, q_tile=64, block_k=64)
    q = torch.zeros((1, 2, 64, 64), device=dev)
    with pytest.raises(TypeError):                       # k in another dtype
        fa.flash_attention(q, q.to(torch.bfloat16), q, q_tile=64,
                           block_k=64)
    buf = torch.zeros(2 * 64 * 64 + 1, device=dev, dtype=torch.bfloat16)
    q = buf[1:].view(1, 2, 64, 64)                       # 2 bytes off 16
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, q_tile=64, block_k=64)


# ---------------------------------------------------------------------------
# The preconditioner zoo on the card: the full-row fleet kernel at the
# amg / spai panel widths, and every family through the cache and engine
# ---------------------------------------------------------------------------

def test_full_row_fleet_kernel_within_forward_error_bound(dev):
    """The full-row ``ell_spmv_fleet`` at amg's panel width (K = 4096),
    rows of mixed signs that nearly cancel (each row's values made
    mean-zero, as amg's deflated operator's are): the kernel and its plain
    version each within their own summation order's forward-error bound of
    the exact row sums on 8 lanes over two panels, one launch, and each
    lane alone bitwise equal to the same lane in the batch."""
    rng = np.random.default_rng(5)
    F, R, K, n, L = 2, 512, 4096, 4096, 8
    cols = np.stack([np.stack([rng.permutation(n)[:K] for _ in range(R)])
                     for _ in range(F)]).astype(np.int32)
    vals = rng.normal(size=(F, R, K))
    vals = (vals - vals.mean(axis=2, keepdims=True)).astype(np.float32)
    x = rng.normal(size=(L, n)).astype(np.float32)
    fidx = np.array([0, 1, 1, 0, 1, 0, 0, 1], np.int32)
    cols, vals, x, fidx = (torch.from_numpy(a).to(dev)
                           for a in (cols, vals, x, fidx))
    before = runtime.LAUNCHES.get("ell_spmv_fleet", 0)
    y = spmv.ell_spmv_fleet(cols, vals, fidx, x)
    assert runtime.LAUNCHES["ell_spmv_fleet"] == before + 1
    p = spmv.ell_spmv_fleet_plain(cols, vals, fidx, x)
    exact, kernel_bound, plain_bound = spmv.ell_spmv_fleet_error_bounds(
        cols, vals, fidx, x)
    assert bool(((y.double() - exact).abs() <= kernel_bound).all())
    assert bool(((p.double() - exact).abs() <= plain_bound).all())
    for lane in (0, 5):
        alone = spmv.ell_spmv_fleet(cols, vals, fidx[lane:lane + 1],
                                    x[lane:lane + 1].contiguous())
        assert torch.equal(alone[0].view(torch.int32),
                           y[lane].view(torch.int32))


@pytest.mark.parametrize("fam", ["ac", "ichol", "amg", "spai"])
def test_family_on_card(dev, fam):
    """Each family factored into a cache on the card: its fleet lives
    there, a 3-rhs solve converges with a lane alone taking the batch's
    iterates bit for bit, and the apply runs where it should — an spmv
    family one full-row ``ell_spmv_fleet`` launch per apply (1 + the
    iterations of each solve) and no level sweep, a factor family the
    level sweep and no full-row kernel."""
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.solver import FactorCache
    from repro_torch.data import graphs
    g = graphs.grid2d(12, 12, seed=3)
    c = FactorCache(chunk=32, strict=False, device=dev)
    h = c.factor(g, key_from_seed(7), family=fam)
    assert h.fleet.resident_device.startswith("cuda")
    B = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, g.n)).astype(np.float32)).to(dev)
    runtime.reset_launches()
    rb = h.solve(B, tol=1e-6, maxiter=300)
    counts = dict(runtime.LAUNCHES)
    assert bool(rb.converged.all())
    if h.kind == "spmv":
        assert counts.get("ell_spmv_fleet", 0) == 1 + int(rb.iters.max())
        assert counts.get("ell_sweep_fleet", 0) == 0
    else:
        assert counts.get("ell_sweep_fleet", 0) > 0
        assert counts.get("ell_spmv_fleet", 0) == 0
    r1 = h.solve(B[1], tol=1e-6, maxiter=300)
    assert int(r1.iters) == int(rb.iters[1])
    assert torch.equal(r1.x.view(torch.int32), rb.x[1].view(torch.int32))


def test_engine_serves_every_family_bitwise_on_card(dev):
    """One engine on the card serving all four families at once: each
    request bitwise equal to its handle's direct solve, one bucket per
    family, ``step_compiles == buckets``."""
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.solver import FactorCache
    from repro_torch.data import graphs
    from repro_torch.serve import SolveEngine, SolveRequest
    g = graphs.grid2d(12, 12, seed=3)
    c = FactorCache(chunk=32, strict=False, device=dev)
    fams = ("ac", "ichol", "amg", "spai")
    hs = {f: c.factor(g, key_from_seed(7), graph_id=f"g::{f}", family=f)
          for f in fams}
    rng = np.random.default_rng(29)
    eng = SolveEngine(c, slots=4, iters_per_tick=8)
    reqs = []
    for i, f in enumerate(fams):
        b = rng.normal(size=(2, g.n)).astype(np.float32)
        reqs.append(SolveRequest(rid=i, graph_id=f"g::{f}",
                                 b=b - b.mean(axis=1, keepdims=True),
                                 tol=1e-6, maxiter=500))
        eng.submit(reqs[-1])
    assert len(eng.run_until_drained()) == len(fams)
    for r, f in zip(reqs, fams):
        ref = hs[f].solve(torch.from_numpy(r.b).to(dev), tol=r.tol,
                          maxiter=r.maxiter)
        assert np.array_equal(np.atleast_2d(r.x).view(np.uint32),
                              ref.x.cpu().numpy().view(np.uint32)), f
        assert np.array_equal(np.atleast_1d(r.iters),
                              ref.iters.cpu().numpy()), f
    st = eng.stats()
    assert st.buckets == st.families == len(fams)
    assert st.step_compiles == st.buckets


def _one_rank_mesh(d):
    """A one-rank group (NCCL on a card, gloo on the CPU) and its mesh."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import init_group, make_host_mesh
    init_group(d, rank=0, world_size=1, store=tdist.HashStore())
    return make_host_mesh(1, 1, device=d)


def test_sharded_pcg_nccl_one_rank_equals_laplacian_pcg(dev):
    """NCCL, one rank: ``sharded_pcg`` takes ``laplacian_pcg``'s iterates
    bit for bit (x, iterations, relres) through the same ``ell_sweep``
    launches."""
    import torch.distributed as tdist
    from repro_torch.core import dist as D
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.parac import factorize_wavefront
    from repro_torch.core.pcg import laplacian_pcg
    from repro_torch.core.trisolve import make_preconditioner
    from repro_torch.data import graphs
    g = graphs.grid3d(8, 8, 8, "contrast", seed=0)
    b = torch.from_numpy(np.random.default_rng(0).normal(size=g.n).astype(
        np.float32)).to(dev)
    mesh = _one_rank_mesh(dev)
    try:
        assert tdist.get_backend(mesh.get_group("data")) == "nccl"
        apply = make_preconditioner(factorize_wavefront(
            g, key_from_seed(0), chunk=64, device=dev))
        runs = []
        for solve in (lambda: D.sharded_pcg(g, mesh, apply, b, tol=1e-6,
                                            maxiter=300),
                      lambda: laplacian_pcg(g, apply, b, tol=1e-6,
                                            maxiter=300)):
            runtime.reset_launches()
            runs.append((solve(), runtime.LAUNCHES.get("ell_sweep", 0)))
    finally:
        tdist.destroy_process_group()
    (rs, ls), (rl, ll) = runs
    assert bool(rs.converged) and ls > 0 and ls == ll
    assert int(rs.iters) == int(rl.iters)
    assert torch.equal(rs.x.view(torch.int32), rl.x.view(torch.int32))
    assert torch.equal(rs.relres.view(torch.int32),
                       rl.relres.view(torch.int32))


def test_batched_factorize_on_card_equals_cpu(dev):
    """One rank each: the card's ``batched_factorize`` state (NCCL) equals
    the CPU's (gloo) bit for bit, through ``sample_clique_round``."""
    import torch.distributed as tdist
    from repro_torch.core import dist as D
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.data import graphs
    g = graphs.grid2d(12, 12, seed=1)
    keys = np.stack([key_from_seed(k) for k in range(3)])
    states = {}
    for d in (dev, "cpu"):
        mesh = _one_rank_mesh(d)
        try:
            runtime.reset_launches()
            states[str(d)] = D.batched_factorize(g, keys, mesh, chunk=32)
            launched = runtime.LAUNCHES.get("sample_clique_round", 0)
        finally:
            tdist.destroy_process_group()
        assert (launched > 0) == (d == dev)
    for a, c in zip(states[str(dev)], states["cpu"]):
        a = a.cpu()
        if a.dtype == torch.float32:
            a, c = a.view(torch.int32), c.view(torch.int32)
        assert torch.equal(a, c)


def _tiny_train_cfg():
    """The reference trainer tests' ``_tiny_cfg``."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("qwen3-14b"), n_layers=2,
                               d_model=64, n_heads=4, n_kv_heads=2,
                               head_dim=16, d_ff=128, vocab=256,
                               remat=False)


def test_trainer_on_card_matches_cpu(dev):
    """5 steps at grad_accum 2 of the tiny config, float32, TF32 off, from
    the same CPU-initialized parameters: every metric within 1e-5
    relative, the parameters within 1e-3 of the largest |value|; no
    kernel of the port launches."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.models.common import tree_map, tree_paths
    from repro_torch.optim import adamw_init
    from repro_torch.train import Trainer, TrainConfig
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runtime.reset_launches()
        hist, params = {}, {}
        host = None
        for d in ("cpu", dev):
            tr = Trainer(_tiny_train_cfg(), None, ShapeCell("t", "train", 32, 4),
                         TrainConfig(steps=5, ckpt_dir=None, lr=1e-3,
                                     grad_accum=2, log_every=1), device=d)
            if host is None:
                tr.init_or_restore()
                host = tr.params
            else:
                tr.params = tree_map(lambda a: a.to(dev), host)
                tr.opt = adamw_init(tr.params)
            hist[str(d)] = tr.run()
            params[str(d)] = dict(tree_paths(tr.params))
        assert not any(runtime.LAUNCHES.values())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for got, want in zip(hist[str(dev)], hist["cpu"]):
        for k in ("loss", "ce", "aux", "gnorm"):
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got)
    scale = max(float(a.abs().max()) for a in params["cpu"].values())
    for path, a in params["cpu"].items():
        b = params[str(dev)][path]
        assert b.device.type == "cuda"
        assert float((b.cpu() - a).abs().max()) <= 1e-3 * scale, path


def test_checkpoint_of_card_tensors_restores_onto_card(dev, tmp_path):
    """CUDA leaves go to the host to be written and come back on the
    ``tree_like`` leaves' device, bf16 and int32 bit for bit."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.optim import adamw_init
    g = torch.Generator(device=dev).manual_seed(0)
    params = {"w": torch.randn(64, 32, device=dev, generator=g)
              .to(torch.bfloat16),
              "b": [torch.randn(7, device=dev, generator=g)]}
    opt = adamw_init(params)
    save_checkpoint(str(tmp_path), 2, (params, opt, 2))
    like = ({"w": torch.empty(64, 32, dtype=torch.bfloat16, device=dev),
             "b": [torch.empty(7, device=dev)]}, adamw_init(params), 0)
    (p2, o2, step), s = restore_checkpoint(str(tmp_path), like)
    assert s == 2 and int(step) == 2
    assert p2["w"].device.type == "cuda" and p2["w"].dtype == torch.bfloat16
    assert torch.equal(p2["w"].view(torch.int16), params["w"].view(torch.int16))
    assert torch.equal(p2["b"][0].view(torch.int32),
                       params["b"][0].view(torch.int32))
    assert o2.count.device.type == "cuda" and o2.count.dtype == torch.int32
