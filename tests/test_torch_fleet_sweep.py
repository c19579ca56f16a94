"""The fleet's triangular solves over level rows, on CPU tensors (the plain
versions): the level row lists that admission builds, and the level sweep
against the full-row composition it replaces (``ell_spmv_fleet`` on the
whole padded panel, then ``where(level_of == lv, y - Y, y)`` per level),
bit for bit.  The fleet PCG's parity with the reference ``Solver``
(``tests/test_torch_solver.py``) runs through the same lists."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)

from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.core.pcg import fleet_precondition            # noqa: E402
from repro_torch.core.solver import FactorCache                # noqa: E402
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


def test_fleet_members_differ(fleet):
    fl, hs, _ = fleet
    assert len({h.n for h in hs}) == 3
    assert len({h.n_levels_fwd for h in hs}) == 3
    assert fl.capacity == 4 and fl.live_rows == 3


@pytest.mark.parametrize("half", [0, 1], ids=["fwd", "bwd"])
def test_level_lists_against_levels(fleet, half):
    """Each member's row list is its rows sorted stably by level, each
    level's start offset counts the rows below it (n_pad past the last
    level), the host row maxima bound every member's counts, and a row's
    live length covers exactly its nonzero slots."""
    fl, hs, levels = fleet
    _, cols, vals, level, lens, rows, starts = _halves(fl.arrays, levels)[half]
    level_rows = fl.f_rows if half == 0 else fl.b_rows
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
        assert all(c <= m for c, m in zip(counts.tolist(), level_rows))
        k = torch.arange(cols.shape[2])[None, :]
        live = k < lens[f].long()[:, None]
        assert bool((vals[f][~live] == 0).all())
        last = (lens[f].long() - 1).clamp(min=0)
        has = lens[f] > 0
        assert bool((vals[f][has, last[has]] != 0).all())
    assert len(level_rows) == max((h.n_levels_fwd if half == 0
                                   else h.n_levels_bwd) for h in hs)
    for lv, m in enumerate(level_rows):
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
    level_rows = fl.f_rows if half == 0 else fl.b_rows
    fidx, y = _lanes(fl, hs, FIDX, seed=half)
    got = ops.trisolve_fleet(cols, vals, lens, rows, starts, fidx, y,
                             level_rows=level_rows)
    want = ops.trisolve_fleet_masked(cols, vals, fidx, level[fidx.long()], y,
                                     n_levels=len(level_rows))
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(got[4], y[4])             # the empty lane: unchanged
    assert not torch.equal(got[0], y[0])
    # lanes of one factor agree with that factor's lane alone
    alone = ops.trisolve_fleet(cols, vals, lens, rows, starts, fidx[:1],
                               y[:1], level_rows=level_rows)
    assert torch.equal(_bits(alone[0]), _bits(got[0]))


@pytest.mark.parametrize("half", [0, 1], ids=["fwd", "bwd"])
def test_full_row_composition_over_live_slots(fleet, half):
    """The full-row composition reading each row's live slots (the
    stack's flen / blen, as chip_smoke.py's [main] runs it) equals the
    sweep and the composition over all K slots bit for bit."""
    fl, hs, levels = fleet
    _, cols, vals, level, lens, rows, starts = _halves(fl.arrays, levels)[half]
    level_rows = fl.f_rows if half == 0 else fl.b_rows
    fidx, y = _lanes(fl, hs, FIDX, seed=10 + half)
    got = ops.trisolve_fleet_masked(cols, vals, fidx, level[fidx.long()], y,
                                    n_levels=len(level_rows), lens=lens)
    full = ops.trisolve_fleet_masked(cols, vals, fidx, level[fidx.long()],
                                     y, n_levels=len(level_rows))
    sweep = ops.trisolve_fleet(cols, vals, lens, rows, starts, fidx, y,
                               level_rows=level_rows)
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
    level_rows = fl.f_rows if half == 0 else fl.b_rows
    fidx, y = _lanes(fl, hs, FIDX, seed=half)
    want = y.clone()
    spmv.ell_sweep_fleet_plain(cols, vals, lens, rows, starts, fidx, want,
                               level_rows)
    got = y.clone()
    spmv._sweep_levels(cols, vals, lens, rows, starts, got, fidx.tolist(),
                       level_rows, spmv._row_sums_torch)
    assert torch.equal(_bits(got), _bits(want))
    assert not torch.equal(got, y)


def test_one_level_of_the_sweep(fleet):
    """A single level, through the plain sweep in place: exactly the rows
    of that level change, each as the full-row product's commit."""
    fl, hs, levels = fleet
    fa = fl.arrays
    fidx, y = _lanes(fl, hs, FIDX, seed=5)
    lv = 7
    only = [0] * len(fl.f_rows)
    only[lv] = fl.f_rows[lv]
    got = y.clone()
    spmv.ell_sweep_fleet(fa.fcols, fa.fvals, fa.flen, fa.frows, fa.fstart,
                         fidx, got, only)
    Y = spmv.ell_spmv_fleet_plain(fa.fcols, fa.fvals, fidx, y)
    at = levels[0][fidx.long()] == lv
    assert torch.equal(_bits(got), _bits(torch.where(at, y - Y, y)))
    assert int(at.sum()) > 0


def test_level_bound_from_lane_levels(fleet):
    """Lowering the level bound to the lanes' own depth changes nothing."""
    fl, hs, _ = fleet
    fa = fl.arrays
    fidx, y = _lanes(fl, hs, [0, 0], seed=6)
    full = ops.trisolve_fleet(fa.fcols, fa.fvals, fa.flen, fa.frows,
                              fa.fstart, fidx, y, level_rows=fl.f_rows)
    cut = ops.trisolve_fleet(fa.fcols, fa.fvals, fa.flen, fa.frows,
                             fa.fstart, fidx, y, level_rows=fl.f_rows,
                             lane_levels=fa.fnlv[fidx.long()])
    assert hs[0].n_levels_fwd < fl.f_levels
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
    got = fleet_precondition(fa, fidx, R, f_rows=fl.f_rows,
                             b_rows=fl.b_rows)
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
                             fl.f_rows)


@pytest.mark.parametrize("plain", [False, True], ids=["wrapper", "plain"])
def test_sweep_rejects_short_starts(fleet, plain):
    """Levels 1 .. len(level_rows) - 1 read starts[:, lv + 1]: a level
    list as long as starts' rows is refused (not read one past the row)."""
    fl, _, _ = fleet
    fa = fl.arrays
    fn = spmv.ell_sweep_fleet_plain if plain else spmv.ell_sweep_fleet
    y = torch.zeros((1, fl.n_pad))
    with pytest.raises(ValueError):
        fn(fa.fcols, fa.fvals, fa.flen, fa.frows, fa.fstart,
           torch.zeros(1, dtype=torch.int32), y, [1] * fa.fstart.shape[1])
    assert bool((y == 0).all())
