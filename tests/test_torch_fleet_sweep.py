"""The fleet's triangular solves over level rows, on CPU tensors (the plain
versions): the level row lists and the host sweep plans that admission
builds, and the level sweep against the full-row composition it replaces
(``ell_spmv_fleet`` on the whole padded panel, then ``where(level_of ==
lv, y - Y, y)`` per level), bit for bit; and numpy models of the kernel's
sum order (its group width per level, its reduce-scatter over lanes)
against the orders they replace.  The fleet PCG's parity with the
reference ``Solver`` (``tests/test_torch_solver.py``) runs through the
same lists."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)

from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.core.pcg import fleet_precondition            # noqa: E402
from repro_torch.core.solver import FactorCache, _level_lists  # noqa: E402
from repro_torch.core.trisolve import build_schedules_batched  # noqa: E402
from repro_torch.data import graphs                            # noqa: E402
from repro_torch.kernels import ops, spmv                      # noqa: E402

# three factors of one n_pad = 128 bucket, of 81, 128 and 120 vertices and
# 62, 73 and 103 levels each way; admitted one at a time, so the stack
# grows along the level axis twice and keeps one empty row (capacity 4)
GRAPHS = [(9, 9, 1), (8, 16, 2), (10, 12, 3)]


@pytest.fixture(scope="module")
def fleet():
    c = FactorCache(chunk=16, k_tiering=False, device="cpu")
    hs = [c.factor(graphs.grid2d(a, b, seed=s), key_from_seed(i))
          for i, (a, b, s) in enumerate(GRAPHS)]
    assert len({id(h.fleet) for h in hs}) == 1
    fl = hs[0].fleet
    # each member's level per row, forward and backward, from its packed
    # schedules built anew (the stack keeps only the level row lists);
    # the spare row is all level 0
    levels = torch.zeros((2, fl.capacity, fl.n_pad), dtype=torch.int32)
    for h in hs:
        fwd, bwd = build_schedules_batched([h.factor.to_device("cpu")])[0]
        levels[0, h.fleet_row] = fwd.level_of
        levels[1, h.fleet_row] = bwd.level_of
    return fl, hs, levels


def _bits(t):
    return t.view(torch.int32)


def _halves(fa, levels):
    """(name, cols, vals, level_of, lens, rows, starts) of both solves."""
    return (("fwd", fa.fcols, fa.fvals, levels[0], fa.flen, fa.frows,
             fa.fstart),
            ("bwd", fa.bcols, fa.bvals, levels[1], fa.blen, fa.brows,
             fa.bstart))


def _plan(fl, half):
    return fl.f_plan if half == 0 else fl.b_plan


def _member_stats(h):
    """A member's (row counts, longest live rows) per level, forward and
    backward, from its packed schedules built anew."""
    out = []
    for sched in build_schedules_batched([h.factor.to_device("cpu")])[0]:
        _, _, counts, level_k = _level_lists(sched.level_of, sched.row_len,
                                             sched.n_levels,
                                             sched.n_levels + 1)
        out.append((counts, level_k))
    return out


def _plans_from_scratch(stats):
    """The sweep plans over members of the given ``_member_stats``: each
    level's largest row count and longest live row, as
    ``spmv.sweep_plan`` lays them out."""
    plans = []
    for half in (0, 1):
        n = max(s[half][0].size for s in stats)
        counts = np.zeros(n, np.int64)
        level_k = np.zeros(n, np.int64)
        for s in stats:
            c, k = s[half]
            counts[:c.size] = np.maximum(counts[:c.size], c)
            level_k[:k.size] = np.maximum(level_k[:k.size], k)
        plans.append(spmv.sweep_plan(counts, level_k))
    return plans


def test_fleet_members_differ(fleet):
    fl, hs, _ = fleet
    assert len({h.n for h in hs}) == 3
    assert len({h.n_levels_fwd for h in hs}) == 3
    assert fl.capacity == 4 and fl.live_rows == 3


@pytest.mark.parametrize("half", [0, 1], ids=["fwd", "bwd"])
def test_level_lists_against_levels(fleet, half):
    """Each member's row list is its rows sorted stably by level, each
    level's start offset counts the rows below it (n_pad past the last
    level), the host plan's row counts and longest live rows bound every
    member's, and a row's live length covers exactly its nonzero slots."""
    fl, hs, levels = fleet
    _, cols, vals, level, lens, rows, starts = _halves(fl.arrays, levels)[half]
    plan = _plan(fl, half)
    bound_rows = dict(zip(plan[:, 0].tolist(), plan[:, 1].tolist()))
    bound_k = dict(zip(plan[:, 0].tolist(), plan[:, 2].tolist()))
    n_pad = fl.n_pad
    for h in hs:
        f = h.fleet_row
        n_levels = h.n_levels_fwd if half == 0 else h.n_levels_bwd
        lv = level[f].long()
        want = torch.sort(lv, stable=True).indices
        assert torch.equal(rows[f].long(), want)
        counts = torch.bincount(lv, minlength=n_levels)
        assert counts.numel() == n_levels
        want_start = torch.full((starts.shape[1],), n_pad, dtype=torch.int64)
        want_start[0] = 0
        want_start[1:n_levels + 1] = torch.cumsum(counts, 0)
        assert torch.equal(starts[f].long(), want_start)
        for v, c in enumerate(counts.tolist()[1:], start=1):
            assert c <= bound_rows.get(v, 0)
            if c:
                k_max = int(lens[f][lv == v].max())
                assert k_max <= bound_k[v]
        k = torch.arange(cols.shape[2])[None, :]
        live = k < lens[f].long()[:, None]
        assert bool((vals[f][~live] == 0).all())
        last = (lens[f].long() - 1).clamp(min=0)
        has = lens[f] > 0
        assert bool((vals[f][has, last[has]] != 0).all())
    depth = max((h.n_levels_fwd if half == 0 else h.n_levels_bwd)
                for h in hs)
    assert (fl.f_levels if half == 0 else fl.b_levels) == depth
    assert int(plan[-1, 0]) == depth - 1
    for lv, m in bound_rows.items():
        got = max(int(starts[h.fleet_row, lv + 1] - starts[h.fleet_row, lv])
                  for h in hs)
        assert m == got
    # the stack's spare row has no rows at any level
    spare = ({0, 1, 2, 3} - {h.fleet_row for h in hs}).pop()
    assert bool((starts[spare] == n_pad).all())


def _lanes(fl, hs, fidx, seed):
    rng = np.random.default_rng(seed)
    y = torch.zeros((len(fidx), fl.n_pad))
    n_of = {h.fleet_row: h.n for h in hs}
    for lane, f in enumerate(fidx):
        n = n_of.get(f, fl.n_pad)
        y[lane, :n] = torch.from_numpy(
            rng.normal(size=n).astype(np.float32))
    return torch.tensor(fidx, dtype=torch.int32), y


# lanes sharing a factor, every member, and the stack's spare row (a lane
# whose level ranges are all empty)
FIDX = [2, 0, 2, 1, 3]


@pytest.mark.parametrize("half", [0, 1], ids=["fwd", "bwd"])
def test_sweep_equals_full_row_composition(fleet, half):
    fl, hs, levels = fleet
    _, cols, vals, level, lens, rows, starts = _halves(fl.arrays, levels)[half]
    plan = _plan(fl, half)
    n_levels = fl.f_levels if half == 0 else fl.b_levels
    fidx, y = _lanes(fl, hs, FIDX, seed=half)
    got = ops.trisolve_fleet(cols, vals, lens, rows, starts, fidx, y,
                             plan=plan)
    want = ops.trisolve_fleet_masked(cols, vals, fidx, level[fidx.long()], y,
                                     n_levels=n_levels)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(got[4], y[4])             # the empty lane: unchanged
    assert not torch.equal(got[0], y[0])
    # lanes of one factor agree with that factor's lane alone
    alone = ops.trisolve_fleet(cols, vals, lens, rows, starts, fidx[:1],
                               y[:1], plan=plan)
    assert torch.equal(_bits(alone[0]), _bits(got[0]))


@pytest.mark.parametrize("half", [0, 1], ids=["fwd", "bwd"])
def test_full_row_composition_over_live_slots(fleet, half):
    """The full-row composition reading each row's live slots (the
    stack's flen / blen, as chip_smoke.py's [main] runs it) equals the
    sweep and the composition over all K slots bit for bit."""
    fl, hs, levels = fleet
    _, cols, vals, level, lens, rows, starts = _halves(fl.arrays, levels)[half]
    n_levels = fl.f_levels if half == 0 else fl.b_levels
    fidx, y = _lanes(fl, hs, FIDX, seed=10 + half)
    got = ops.trisolve_fleet_masked(cols, vals, fidx, level[fidx.long()], y,
                                    n_levels=n_levels, lens=lens)
    full = ops.trisolve_fleet_masked(cols, vals, fidx, level[fidx.long()],
                                     y, n_levels=n_levels)
    sweep = ops.trisolve_fleet(cols, vals, lens, rows, starts, fidx, y,
                               plan=_plan(fl, half))
    assert torch.equal(_bits(got), _bits(full))
    assert torch.equal(_bits(got), _bits(sweep))
    # the panel has padding for the live lengths to skip
    assert int(lens.long().sum()) < lens.numel() * cols.shape[2]


@pytest.mark.parametrize("half", [0, 1], ids=["fwd", "bwd"])
def test_plain_sweep_on_tensors_equals_numpy_route(fleet, half):
    """The plain sweep's level loop on tensors with the torch row sums
    (its route on the card) equals its CPU route on numpy views, bit for
    bit."""
    fl, hs, levels = fleet
    _, cols, vals, _, lens, rows, starts = _halves(fl.arrays, levels)[half]
    plan = _plan(fl, half)
    fidx, y = _lanes(fl, hs, FIDX, seed=half)
    want = y.clone()
    spmv.ell_sweep_fleet_plain(cols, vals, lens, rows, starts, fidx, want,
                               plan)
    got = y.clone()
    spmv._sweep_levels(cols, vals, lens, rows, starts, got, fidx.tolist(),
                       plan, spmv._row_sums_torch)
    assert torch.equal(_bits(got), _bits(want))
    assert not torch.equal(got, y)


def test_one_level_of_the_sweep(fleet):
    """A single level, through the plain sweep in place: exactly the rows
    of that level change, each as the full-row product's commit."""
    fl, hs, levels = fleet
    fa = fl.arrays
    fidx, y = _lanes(fl, hs, FIDX, seed=5)
    lv = 7
    only = fl.f_plan[fl.f_plan[:, 0] == lv]
    assert only.shape == (1, 3)
    got = y.clone()
    spmv.ell_sweep_fleet(fa.fcols, fa.fvals, fa.flen, fa.frows, fa.fstart,
                         fidx, got, only)
    Y = spmv.ell_spmv_fleet_plain(fa.fcols, fa.fvals, fidx, y)
    at = levels[0][fidx.long()] == lv
    assert torch.equal(_bits(got), _bits(torch.where(at, y - Y, y)))
    assert int(at.sum()) > 0


def test_level_bound_from_lane_levels(fleet):
    """Cutting the plan to the lanes' own depth (the host's level count of
    their factor, as a handle's solve does) changes nothing."""
    fl, hs, _ = fleet
    fa = fl.arrays
    h = hs[0]
    fidx, y = _lanes(fl, hs, [h.fleet_row] * 2, seed=6)
    full = ops.trisolve_fleet(fa.fcols, fa.fvals, fa.flen, fa.frows,
                              fa.fstart, fidx, y, plan=fl.f_plan)
    f_cut, _ = h.plans()
    cut = ops.trisolve_fleet(fa.fcols, fa.fvals, fa.flen, fa.frows,
                             fa.fstart, fidx, y, plan=f_cut)
    assert h.n_levels_fwd < fl.f_levels
    assert f_cut.shape[0] < fl.f_plan.shape[0]
    assert int(f_cut[-1, 0]) < h.n_levels_fwd
    assert f_cut.flags.c_contiguous
    assert torch.equal(_bits(full), _bits(cut))


@pytest.mark.parametrize("L", [1, 8])
def test_apply_equals_full_row_apply(fleet, L):
    """One preconditioner apply of 1 and 8 lanes (the main path's shapes,
    at this fleet's size): the level sweeps equal the full-row
    composition's apply bit for bit."""
    fl, hs, levels = fleet
    fa = fl.arrays
    h = hs[1]
    fidx, R = _lanes(fl, hs, [h.fleet_row] * L, seed=L)
    f_plan, b_plan = h.plans()
    got = fleet_precondition(fa, fidx, R, f_plan=f_plan, b_plan=b_plan)
    assert got.is_contiguous()
    f = fidx.long()
    Y = ops.trisolve_fleet_masked(fa.fcols, fa.fvals, fidx, levels[0][f], R,
                                  n_levels=fl.f_levels,
                                  lane_levels=fa.fnlv[f])
    want = ops.trisolve_fleet_masked(fa.bcols, fa.bvals, fidx, levels[1][f],
                                     Y * fa.dinv[f], n_levels=fl.b_levels,
                                     lane_levels=fa.bnlv[f])
    assert torch.equal(_bits(got), _bits(want))


def test_sweep_rejects_other_devices(fleet):
    """The wrapper raises for a device it has no path for."""
    fl, _, _ = fleet
    fa = fl.arrays
    y = torch.zeros((1, fl.n_pad), device="meta")
    with pytest.raises(ValueError):
        spmv.ell_sweep_fleet(fa.fcols, fa.fvals, fa.flen, fa.frows,
                             fa.fstart, torch.zeros(1, dtype=torch.int32), y,
                             fl.f_plan)


@pytest.mark.parametrize("plain", [False, True], ids=["wrapper", "plain"])
def test_sweep_rejects_short_starts(fleet, plain):
    """A plan level lv reads starts[:, lv + 1]: a level at starts' last
    column is refused (not read one past the row)."""
    fl, _, _ = fleet
    fa = fl.arrays
    fn = spmv.ell_sweep_fleet_plain if plain else spmv.ell_sweep_fleet
    y = torch.zeros((1, fl.n_pad))
    past = np.array([[fa.fstart.shape[1] - 1, 1, 1]], np.int32)
    with pytest.raises(ValueError):
        fn(fa.fcols, fa.fvals, fa.flen, fa.frows, fa.fstart,
           torch.zeros(1, dtype=torch.int32), y, past)
    assert bool((y == 0).all())


def test_plan_tracks_live_members():
    """The host plans that FactorFleet keeps bound every live member's
    level lists and live lengths, level by level, after admission, a free,
    the freed row's reuse, growth of the stack (rows and levels) and
    compaction: they equal a from-scratch maximum over every member ever
    admitted (running maxima, which a handle's death does not touch); the
    level ceilings only grow."""
    c = FactorCache(chunk=16, k_tiering=False, compact_threshold=None,
                    device="cpu")
    gs = [graphs.grid2d(a, b, seed=s) for a, b, s in GRAPHS]
    admitted = []

    def admit(g, key, gid):
        h = c.factor(g, key_from_seed(key), graph_id=gid)
        admitted.append(_member_stats(h))
        return h

    def bounds(plan, counts, level_k):
        rows = dict(zip(plan[:, 0].tolist(), plan[:, 1].tolist()))
        k = dict(zip(plan[:, 0].tolist(), plan[:, 2].tolist()))
        for lv in range(1, counts.size):
            if counts[lv]:
                assert counts[lv] <= rows[lv] and level_k[lv] <= k[lv]

    def check(live):
        fl = live[0].fleet
        f_want, b_want = _plans_from_scratch(admitted)
        assert np.array_equal(fl.f_plan, f_want)
        assert np.array_equal(fl.b_plan, b_want)
        assert fl.f_plan.dtype == np.int32 and fl.f_plan.flags.c_contiguous
        for h in live:
            (fc, fk), (bc, bk) = _member_stats(h)
            bounds(fl.f_plan, fc, fk)
            bounds(fl.b_plan, bc, bk)
        return fl

    h0 = admit(gs[0], 0, "a")
    h1 = admit(gs[1], 1, "b")
    fl = check([h0, h1])
    assert fl.capacity == 2
    deep = fl.f_levels
    assert deep > h0.n_levels_fwd
    c.evict("b")
    del h1                                    # frees its stack row
    check([h0])
    assert fl.f_levels == deep                # ceilings keep every member
    assert int(fl.f_plan[-1, 0]) == deep - 1  # and so does the plan
    h2 = admit(gs[2], 2, "c")
    assert h2.fleet_row == 1                  # the freed row, reused
    check([h0, h2])
    h3 = admit(gs[1], 3, "d")
    h4 = admit(graphs.grid2d(11, 11, seed=4), 4, "e")
    assert h4.fleet is fl and fl.capacity == 4     # grown from 2
    check([h0, h2, h3, h4])
    for gid in ("a", "d", "e"):
        c.evict(gid)
    del h0, h3, h4
    before = fl.generation
    assert c.compact() == 1 and fl.generation == before + 1
    assert h2.fleet_row == 0 and fl.capacity == 1
    check([h2])


@pytest.mark.parametrize("half", [0, 1], ids=["fwd", "bwd"])
def test_plan_route_equals_level_rows_route(fleet, half):
    """The plain sweep driven by the plan equals the route it replaced (a
    loop over every level of the ceiling, skipping those whose bucket
    row maximum is 0) bit for bit."""
    fl, hs, levels = fleet
    _, cols, vals, _, lens, rows, starts = _halves(fl.arrays, levels)[half]
    fidx, y = _lanes(fl, hs, FIDX, seed=20 + half)
    got = y.clone()
    spmv.ell_sweep_fleet_plain(cols, vals, lens, rows, starts, fidx, got,
                               _plan(fl, half))
    # the level_rows route: per-level row maxima over the members, one
    # entry per level of the ceiling
    level_rows = np.diff(starts.numpy(), axis=1).max(0)
    level_rows = level_rows[:fl.f_levels if half == 0 else fl.b_levels]
    want = y.clone().numpy()
    c, v, ln, rw, st = (t.numpy() for t in (cols, vals, lens, rows, starts))
    for lv in range(1, len(level_rows)):
        if not level_rows[lv]:
            continue
        for lane, f in enumerate(fidx.tolist()):
            lo, hi = int(st[f, lv]), int(st[f, lv + 1])
            if hi <= lo:
                continue
            r = rw[f, lo:hi]
            k = int(ln[f, r].max())
            if k:
                want[lane, r] = want[lane, r] - spmv._row_sums_np(
                    c[f, r, :k], v[f, r, :k], want[lane])
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_apply_reads_no_level_counts(fleet):
    """An apply runs from the host plans alone: the stack's device level
    counts (``fnlv`` / ``bnlv``, which the solve once read back to bound
    its levels) are not touched, and the result is the same bit for bit
    as the lanes' own bound gives."""
    fl, hs, levels = fleet
    fa = fl.arrays
    fidx, R = _lanes(fl, hs, FIDX, seed=30)
    want = fleet_precondition(fa, fidx, R, f_plan=fl.f_plan,
                              b_plan=fl.b_plan)
    blind = fa._replace(fnlv=None, bnlv=None)
    got = fleet_precondition(blind, fidx, R, f_plan=fl.f_plan,
                             b_plan=fl.b_plan)
    assert torch.equal(_bits(got), _bits(want))
    f = fidx.long()
    Y = ops.trisolve_fleet_masked(fa.fcols, fa.fvals, fidx, levels[0][f], R,
                                  n_levels=fl.f_levels,
                                  lane_levels=fa.fnlv[f])
    old = ops.trisolve_fleet_masked(fa.bcols, fa.bvals, fidx, levels[1][f],
                                    Y * fa.dinv[f], n_levels=fl.b_levels,
                                    lane_levels=fa.bnlv[f])
    assert torch.equal(_bits(got), _bits(old))


@pytest.mark.parametrize("half", [0, 1], ids=["fwd", "bwd"])
def test_interleaved_y_equals_lane_major(fleet, half):
    """The sweep on an interleaved working vector (a column's lanes side by
    side) gives the lane-major sweep's bits and keeps its layout."""
    fl, hs, levels = fleet
    _, cols, vals, _, lens, rows, starts = _halves(fl.arrays, levels)[half]
    fidx, y = _lanes(fl, hs, FIDX, seed=40 + half)
    want = ops.trisolve_fleet(cols, vals, lens, rows, starts, fidx, y,
                              plan=_plan(fl, half))
    yi = ops.interleaved(y)
    assert yi.stride() == (1, len(FIDX)) and torch.equal(yi, y)
    got = ops.trisolve_fleet(cols, vals, lens, rows, starts, fidx, yi,
                             plan=_plan(fl, half))
    assert got.stride() == yi.stride()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(yi, y)                  # the input is not modified


@pytest.mark.parametrize("bad", ["falling", "level_k", "level0", "dtype"])
def test_sweep_rejects_bad_plans(fleet, bad):
    """A plan whose levels do not rise from 1, whose longest live row
    exceeds K, or that is not int32 is refused before any work."""
    fl, _, _ = fleet
    fa = fl.arrays
    plan = fl.f_plan.copy()
    if bad == "falling":
        plan = np.ascontiguousarray(plan[::-1])
    elif bad == "level_k":
        plan[0, 2] = fa.fcols.shape[2] + 1
    elif bad == "level0":
        plan[0, 0] = 0
    else:
        plan = plan.astype(np.int64)
    y = torch.zeros((1, fl.n_pad))
    with pytest.raises(ValueError):
        spmv.ell_sweep_fleet(fa.fcols, fa.fvals, fa.flen, fa.frows,
                             fa.fstart, torch.zeros(1, dtype=torch.int32), y,
                             plan)


def _fma(a, b, c):
    """float32 fused multiply-add, modeled in float64: the product of two
    float32 values is exact there; the sum is rounded to float64, then to
    float32 (as the plain versions compute it)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _butterfly(part):
    """The fixed xor butterfly over the last axis (a power of two wide):
    at offsets G/2 .. 1 each thread adds its partner's value (own +
    partner, float32); every thread ends with the sum."""
    G = part.shape[-1]
    idx = np.arange(G)
    off = G // 2
    while off:
        part = (part + part[..., idx ^ off]).astype(np.float32)
        off //= 2
    return part


def _kernel_row_sums(v, x, lens, G):
    """The kernel's order for rows ``v`` / gathered ``x`` ``[rows, S]``:
    thread g of a G-wide group sums the slots g, g + G, ... below each
    row's ``lens`` by fused multiply-adds from +0, then the butterfly;
    returns thread 0's sum."""
    rows, S = v.shape
    S2 = -(-S // G) * G
    live = np.arange(S2)[None, :] < lens[:, None]
    vp = np.zeros((rows, S2), np.float32)
    xp = np.zeros((rows, S2), np.float32)
    vp[:, :S], xp[:, :S] = v, x
    part = np.zeros((rows, G), np.float32)
    for j in range(S2 // G):
        s = slice(j * G, (j + 1) * G)
        part = np.where(live[:, s], _fma(vp[:, s], xp[:, s], part), part)
    return _butterfly(part)[:, 0]


@pytest.mark.parametrize("half", [0, 1], ids=["fwd", "bwd"])
def test_sum_order_at_level_width_equals_panel_width(fleet, half):
    """A numpy model of the kernel's sum order: each row's live slots at
    G = group_width(level_k), level_k the plan's longest live row, equal
    all K slots at G = group_width(K) bit for bit, on every level of
    every member."""
    fl, hs, levels = fleet
    _, cols, vals, _, lens, rows, starts = _halves(fl.arrays, levels)[half]
    plan = _plan(fl, half)
    K = cols.shape[2]
    rng = np.random.default_rng(50 + half)
    c, v, ln, rw, st = (t.numpy() for t in (cols, vals, lens, rows, starts))
    widths = set()
    for h in hs:
        f = h.fleet_row
        x = rng.normal(size=fl.n_pad).astype(np.float32)
        for lv, _, level_k in plan.tolist():
            r = rw[f, st[f, lv]:st[f, lv + 1]]
            if not r.size:
                continue
            G = spmv.group_width(level_k)
            widths.add(G)
            narrow = _kernel_row_sums(v[f, r], x[c[f, r]], ln[f, r], G)
            full = _kernel_row_sums(v[f, r], x[c[f, r]],
                                    np.full(r.size, K), spmv.group_width(K))
            assert np.array_equal(narrow.view(np.int32), full.view(np.int32))
    # the levels exercise narrow groups as well as the panel's
    assert len(widths) >= 2 and min(widths) < spmv.group_width(K)


def _reduce_scatter(acc, G):
    """A model of the kernel's group_reduce: ``acc`` ``[G, NB]`` (thread,
    lane).  Halving steps at offsets G/2, G/4, ... while the group has
    offsets and more than one lane is held (each thread keeps the half of
    its lanes named by its offset bit and adds its partner's values of
    them: own + partner), then the butterfly on one value.  Returns
    {(thread, lane): sum} of the sums each thread holds."""
    NB = acc.shape[1]
    held = [list(range(NB)) for _ in range(G)]
    vals = [list(acc[g]) for g in range(G)]
    off = G // 2
    while off and len(held[0]) > 1:
        new_h, new_v = [], []
        for g in range(G):
            p = g ^ off
            half = len(held[g]) // 2
            keep = slice(half, None) if g & off else slice(0, half)
            lanes = held[g][keep]
            mine = dict(zip(held[g], vals[g]))
            theirs = dict(zip(held[p], vals[p]))
            new_h.append(lanes)
            new_v.append([np.float32(mine[b] + theirs[b]) for b in lanes])
        held, vals, off = new_h, new_v, off // 2
    while off:
        vals = [[np.float32(vals[g][0] + vals[g ^ off][0])]
                for g in range(G)]
        off //= 2
    return {(g, b): x for g in range(G) for b, x in zip(held[g], vals[g])}


@pytest.mark.parametrize("NB", [1, 2, 4, 8])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 32])
def test_reduce_scatter_model_equals_butterfly(NB, G):
    """The lanes' shared reduction: every lane's sum, in every thread that
    holds it, equals that lane's own butterfly bit for bit, and every
    lane is held by some thread (the kernel's writer)."""
    rng = np.random.default_rng(NB * 100 + G)
    acc = (rng.normal(size=(G, NB)) * 10.0 ** rng.integers(-3, 4, (G, NB))
           ).astype(np.float32)
    got = _reduce_scatter(acc, G)
    want = _butterfly(acc.T.copy())            # [NB, G]: each lane alone
    assert {b for _, b in got} == set(range(NB))
    lg = G.bit_length() - 1
    steps = min(lg, NB.bit_length() - 1)
    held = NB >> steps
    for (g, b), x in got.items():
        assert np.float32(x).view(np.int32) == want[b, g].view(np.int32)
        # the lanes a thread holds, as the kernel computes them
        first = (g >> (lg - steps)) * held
        assert first <= b < first + held
