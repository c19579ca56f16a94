"""The library path's triangular solves as level sweeps, on CPU tensors (the
plain versions): the live-row metadata of a level-sorted
``DeviceSchedule`` (``row_len``, ``level_k``, the sweep's ``plan``)
against its panels, and ``ops.trisolve_panels`` (one ``ell_sweep`` /
``ell_sweep_multi`` per triangular solve) against the per-level full-row
composition it replaced (``ops.trisolve_panels_full``) bit for bit.  The
parity with the reference runs through the same path in
``tests/test_torch_trisolve_device.py``; the kernels are held to the same
composition on the card in ``tests/test_torch_gpu.py``.

``powerlaw_micro``'s forward and backward panels are 42 and 34 slots wide,
so levels longer than 32 live slots (several slots per thread on the
card) occur."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)

from repro_torch.core import ref_ac as tref                    # noqa: E402
from repro_torch.core import trisolve as ttri                  # noqa: E402
from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.data import graphs as tgraphs                 # noqa: E402
from repro_torch.kernels import ops, spmv                      # noqa: E402

NAMES = ["grid2d_tiny", "road_tiny", "powerlaw_micro"]
SUITE = {**tgraphs.SUITE_MICRO, **tgraphs.SUITE_TINY}


@pytest.fixture(scope="module")
def schedules():
    """name -> (factor, forward schedule, backward schedule) on the CPU."""
    out = {}
    for name in NAMES:
        f = tref.factorize_sequential(SUITE[name](), key_from_seed(7))
        out[name] = (f, *ttri.build_schedules_device(f, device="cpu"))
    return out


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("name", NAMES)
def test_live_rows_against_panels(schedules, name):
    """Every slot past a row's live length holds col 0 and val 0.0, the
    live lengths are the rows' in-degrees (they add up to the factor's
    off-diagonal entries), each level's longest row is its slab's maximum,
    and the plan lists the levels >= 1 with rows, in order."""
    f, fwd, bwd = schedules[name]
    for s in (fwd, bwd):
        K = s.K
        k = torch.arange(K)[None, :]
        live = k < s.row_len.long()[:, None]
        assert bool((s.cols[~live] == 0).all())
        assert bool((s.vals[~live] == 0).all())
        assert int(s.row_len.sum()) == len(f.rows)
        assert int(s.row_len.max()) == K
        assert s.level_k.shape == (s.n_levels,)
        for lv in range(s.n_levels):
            lo, hi = int(s.row_ptr[lv]), int(s.row_ptr[lv + 1])
            want = int(s.row_len[lo:hi].max()) if hi > lo else 0
            assert int(s.level_k[lv]) == want
        assert int(s.level_k[0]) == 0           # level 0 has no in-edges
        want_plan = [(int(s.row_ptr[lv]),
                      int(s.row_ptr[lv + 1] - s.row_ptr[lv]),
                      int(s.level_k[lv]))
                     for lv in range(1, s.n_levels)
                     if s.row_ptr[lv + 1] > s.row_ptr[lv]]
        assert s.plan.dtype == np.int32 and s.plan.flags.c_contiguous
        assert [tuple(r) for r in s.plan.tolist()] == want_plan
    if name == "powerlaw_micro":
        assert (fwd.K, bwd.K) == (42, 34)
        assert int(fwd.level_k.max()) > 32 and int(bwd.level_k.max()) > 32


@pytest.mark.parametrize("B", [None, 1, 3, 8, 11], ids=lambda B: f"B{B}")
@pytest.mark.parametrize("name", NAMES)
def test_sweep_equals_full_row_composition(schedules, name, B):
    """trisolve_panels (one sweep per solve) equals the per-level full-row
    composition bit for bit, forward and flipped backward, for one rhs
    ``(n,)`` and blocks ``(n, B)``; the input is not modified."""
    _, fwd, bwd = schedules[name]
    rng = np.random.default_rng(B or 0)
    shape = (fwd.n,) if B is None else (fwd.n, B)
    b = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    b0 = b.clone()
    for s, flip in ((fwd, False), (bwd, True)):
        got = ops.trisolve_panels(s, b, flip=flip)
        want = ops.trisolve_panels_full(s, b, flip=flip)
        assert got.shape == b.shape
        assert torch.equal(_bits(got), _bits(want))
        assert not torch.equal(got, b)
    assert torch.equal(b, b0)


@pytest.mark.parametrize("name", NAMES)
def test_block_columns_equal_single_solves(schedules, name):
    """Each column of an 11-column block (two column chunks on the card)
    is its own single-rhs solve bit for bit."""
    _, fwd, bwd = schedules[name]
    B = torch.from_numpy(np.random.default_rng(11).normal(
        size=(fwd.n, 11)).astype(np.float32))
    for s, flip in ((fwd, False), (bwd, True)):
        Y = ops.trisolve_panels(s, B, flip=flip)
        for c in range(11):
            y = ops.trisolve_panels(s, B[:, c].contiguous(), flip=flip)
            assert torch.equal(_bits(Y[:, c]), _bits(y))


def test_sweep_of_one_level(schedules):
    """One plan entry changes exactly that level's rows, each by the
    full-row product's commit."""
    _, fwd, _ = schedules["powerlaw_micro"]
    lv = int(np.argmax(fwd.level_k))
    lo, hi = int(fwd.row_ptr[lv]), int(fwd.row_ptr[lv + 1])
    plan = fwd.plan[fwd.plan[:, 0] == lo]
    y0 = torch.from_numpy(np.random.default_rng(3).normal(
        size=fwd.n).astype(np.float32))
    y = y0.clone()
    spmv.ell_sweep(fwd.cols, fwd.vals, fwd.row_len, fwd.row_ids, y,
                   spmv.sweep_walk(plan, "cpu"))
    rows = fwd.row_ids[lo:hi].long()
    want = y0.clone()
    want[rows] -= spmv.ell_spmv(fwd.cols[lo:hi], fwd.vals[lo:hi], y0)
    assert torch.equal(_bits(y), _bits(want))
    others = torch.ones(fwd.n, dtype=torch.bool)
    others[rows] = False
    assert torch.equal(y[others], y0[others])


def test_sweep_wrappers_reject_bad_input(schedules):
    _, fwd, _ = schedules["grid2d_tiny"]
    args = (fwd.cols, fwd.vals, fwd.row_len, fwd.row_ids)
    n = fwd.n

    def walk(plan):
        return spmv.sweep_walk(plan, "cpu")
    for fn, y in ((spmv.ell_sweep, torch.zeros(n, device="meta")),
                  (spmv.ell_sweep_multi, torch.zeros((n, 2), device="meta"))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*args, y, fwd.walk)
    for fn, y in ((spmv.ell_sweep, torch.zeros(n)),
                  (spmv.ell_sweep_multi, torch.zeros((n, 2)))):
        with pytest.raises(ValueError):                  # y shorter than R
            fn(*args, y[:-1], fwd.walk)
        with pytest.raises(ValueError):                  # row_len [R - 1]
            fn(fwd.cols, fwd.vals, fwd.row_len[:-1], fwd.row_ids, y,
               fwd.walk)
        with pytest.raises(ValueError):                  # vals [R, K - 1]
            fn(fwd.cols, fwd.vals[:, 1:].contiguous(), fwd.row_len,
               fwd.row_ids, y, fwd.walk)
        with pytest.raises(ValueError):                  # plan int64
            fn(*args, y, walk(fwd.plan.astype(np.int64)))
        with pytest.raises(TypeError):                   # a plan, no walk
            fn(*args, y, fwd.plan)
        past = fwd.plan.copy()
        past[-1, 1] += 1                                 # slab past R
        with pytest.raises(ValueError):
            fn(*args, y, walk(past))
        wide = fwd.plan.copy()
        wide[0, 2] = fwd.K + 1                           # longer than K
        with pytest.raises(ValueError):
            fn(*args, y, walk(wide))
