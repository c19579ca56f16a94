"""The library path's level walk, on the CPU: the item table that
``_schedule_from_edges_device`` builds beside each ``DeviceSchedule``'s
plan (``spmv.sweep_walk``), the plan-order invariant the walk's waits rely
on (every live column of a row lies in level 0 or in an earlier plan
entry), on real factors' forward and flipped backward schedules and on
hypothesis-drawn solve graphs, and a numpy model of ``ell_sweep_multi``'s
sum order (one accumulator a column, the reduce-scatter, one writer a
column) against the order it replaced (one butterfly a column).  The
kernel itself runs on the card only (``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)

try:  # hypothesis is a dev-only extra: the drawn-graph test skips without it
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover
    given = None

from repro_torch.core import ref_ac as tref                    # noqa: E402
from repro_torch.core import trisolve as ttri                  # noqa: E402
from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.data import graphs as tgraphs                 # noqa: E402
from repro_torch.kernels import spmv                           # noqa: E402

NAMES = ["grid2d_tiny", "road_tiny", "powerlaw_micro"]
SUITE = {**tgraphs.SUITE_MICRO, **tgraphs.SUITE_TINY}


@pytest.fixture(scope="module")
def schedules():
    """name -> (forward schedule, backward schedule) on the CPU."""
    out = {}
    for name in NAMES:
        f = tref.factorize_sequential(SUITE[name](), key_from_seed(7))
        out[name] = ttri.build_schedules_device(f, device="cpu")
    return out


def _expand(s):
    """(slab row, entry) of every row the walk's items sweep, in item
    order: a piece's rows, or each entry of a run whole, in turn."""
    entries = s.walk.entries.numpy()
    rows, ents = [], []
    for lo, count, e, k in s.walk.items.numpy().tolist():
        pieces = ([(lo, count, e)] if k >= 0 else
                  [(entries[q, 0], entries[q, 1], q)
                   for q in range(e, e + count)])
        for lo_, count_, e_ in pieces:
            rows.extend(range(lo_, lo_ + count_))
            ents.extend([e_] * count_)
    return np.array(rows, np.int64), np.array(ents, np.int64)


def _check_items(s):
    """The walk's tables against the plan: the entries are the plan's
    levels with rows, in order; the items, in order, sweep each entry's
    slab rows exactly once and in order; a piece holds at most one block's
    rows at its entry's group width and never spans two entries; a run
    holds 2 to WALK_RUN whole consecutive entries whose rows each fit one
    block."""
    items = s.walk.items.numpy()
    entries = s.walk.entries.numpy()
    assert s.walk.items.dtype == torch.int32 and items.shape[1:] == (4,)
    assert s.walk.entries.dtype == torch.int32
    assert s.walk.plan is s.plan
    live = s.plan[s.plan[:, 1] > 0]
    assert np.array_equal(entries[:, :3], live)
    assert not entries[:, 3].any()
    per = np.array([spmv.WALK_THREADS // spmv.group_width(int(k))
                    for k in live[:, 2]], np.int64)
    for lo, count, e, k in items.tolist():
        if k >= 0:
            assert k == live[e, 2] and 1 <= count <= per[e]
            assert live[e, 0] <= lo and lo + count <= live[e, 0] + live[e, 1]
        else:
            assert k == -1 and 2 <= count <= spmv.WALK_RUN
            assert lo == live[e, 0]
            assert np.all(live[e:e + count, 1] <= per[e:e + count])
    rows, ents = _expand(s)
    assert np.all(np.diff(rows) > 0) and np.all(np.diff(ents) >= 0)
    assert np.array_equal(np.bincount(ents, minlength=live.shape[0]),
                          live[:, 1])
    for e, (lo, count, _) in enumerate(live.tolist()):
        assert np.array_equal(rows[ents == e], np.arange(lo, lo + count))
    # the rows outside every item are level 0's (no in-edges)
    swept = np.zeros(s.n, bool)
    swept[rows] = True
    assert np.all(s.row_len.numpy()[~swept] == 0)


def _check_plan_order(s):
    """Every live column of a slab row of entry e lies in level 0 or in a
    slab row of an entry before e."""
    rows, ents = _expand(s)
    entry_of = np.full(s.n, -1)                       # by slab row
    entry_of[rows] = ents
    slab_of = np.empty(s.n, np.int64)                 # by vertex
    slab_of[s.row_ids.numpy()] = np.arange(s.n)
    cols, row_len = s.cols.numpy(), s.row_len.numpy()
    live = np.arange(s.K)[None, :] < row_len[:, None]
    r, k = np.nonzero(live)
    src = entry_of[slab_of[cols[r, k]]]
    assert np.all(src < entry_of[r])
    assert np.all(s.level_of.numpy()[cols[r, k][src < 0]] == 0)
    assert np.all(entry_of[row_len > 0] >= 0)


@pytest.mark.parametrize("half", ["fwd", "bwd"])
@pytest.mark.parametrize("name", NAMES)
def test_walk_items_cover_each_entry(schedules, name, half):
    _check_items(schedules[name][half == "bwd"])


@pytest.mark.parametrize("half", ["fwd", "bwd"])
@pytest.mark.parametrize("name", NAMES)
def test_plan_order_invariant(schedules, name, half):
    _check_plan_order(schedules[name][half == "bwd"])


def test_walk_splits_large_levels():
    """A level of 600 rows, each reading 5 columns of level 0 (G = 8, 32
    rows a block): 19 pieces of 32, 32, ..., 24 rows; an empty plan; a
    plan of one small level with rows (one piece)."""
    n0, n1 = 8, 600
    dst = np.repeat(np.arange(n0, n0 + n1), 5)
    src = np.tile(np.arange(5), n1)
    s = ttri._schedule_from_edges_device(
        n0 + n1, torch.from_numpy(dst), torch.from_numpy(src),
        torch.ones(dst.size, dtype=torch.float32))
    _check_items(s)
    _check_plan_order(s)
    count = s.walk.items.numpy()[:, 1]
    assert count.tolist() == [32] * 18 + [24]
    items, entries = spmv.walk_items(np.zeros((0, 3), np.int32))
    assert items.shape == (0, 4) and entries.shape == (0, 4)
    items, entries = spmv.walk_items(np.array([[3, 0, 2], [3, 5, 40]],
                                              np.int32))
    assert items.tolist() == [[3, 5, 0, 40]]
    assert entries.tolist() == [[3, 5, 40, 0]]


def test_walk_runs_of_small_levels():
    """Consecutive entries whose rows fit one block become runs of at most
    WALK_RUN entries; a larger entry between them is cut into pieces; a
    lone small entry stays a piece."""
    plan = [[0, 3, 2], [3, 5, 40], [8, 300, 5], [308, 2, 7], [310, 9, 40],
            [319, 1, 1]]
    lo = 320
    for _ in range(70):                          # 70 one-row levels
        plan.append([lo, 1, 3])
        lo += 1
    plan.append([lo, 40, 5])                     # 40 rows at G = 8: 2 pieces
    items, entries = spmv.walk_items(np.array(plan, np.int32))
    assert entries[:, :3].tolist() == plan
    want = [[0, 2, 0, -1]]                       # 3 rows at G 2, 5 at G 32
    want += [[8 + 32 * j, min(32, 300 - 32 * j), 2, 5] for j in range(10)]
    want += [[308, 2, 3, 7]]                     # alone: 9 rows at G 32 next
    want += [[310, 8, 4, 40], [318, 1, 4, 40]]
    want += [[319, 64, 5, -1], [383, 7, 69, -1]]
    want += [[390, 32, 76, 5], [422, 8, 76, 5]]
    assert items.tolist() == want


def _plan_order_on_drawn_graph(n, per_row, hubs, seed):
    """A random lower-triangular solve graph (about ``per_row`` in-edges a
    row, and ``hubs`` rows reading up to 60 earlier rows, so some levels
    hold rows wider than 32 slots): its forward schedule and the flipped
    backward one, as ``build_schedules_device`` builds them, keep the item
    table and the plan-order invariant."""
    rng = np.random.default_rng(seed)
    m = int(per_row * n) if n > 1 else 0
    i = rng.integers(1, max(n, 2), m)
    k = (rng.random(m) * i).astype(np.int64)
    for h in rng.integers(0, n, hubs):
        w = rng.permutation(h)[:60]
        i = np.concatenate([i, np.full(w.size, h)])
        k = np.concatenate([k, w])
    pairs = np.unique(np.stack([i, k], 1), axis=0) if i.size else \
        np.zeros((0, 2), np.int64)
    i, k = pairs[:, 0], pairs[:, 1]
    val = torch.from_numpy(rng.normal(size=i.size).astype(np.float32))
    fwd = ttri._schedule_from_edges_device(
        n, torch.from_numpy(i), torch.from_numpy(k), val)
    bwd = ttri._schedule_from_edges_device(
        n, torch.from_numpy((n - 1) - k), torch.from_numpy((n - 1) - i), val)
    for s in (fwd, bwd):
        _check_items(s)
        _check_plan_order(s)


if given is None:  # pragma: no cover
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_plan_order_on_drawn_graphs():
        pass
else:
    test_plan_order_on_drawn_graphs = settings(
        max_examples=30, deadline=None)(given(
            n=st.integers(1, 700), per_row=st.floats(0.0, 4.0),
            hubs=st.integers(0, 3), seed=st.integers(0, 2**31 - 1))(
                _plan_order_on_drawn_graph))


# ---- ell_sweep_multi's sum order ------------------------------------------

def _fma(a, b, c):
    """float32 fused multiply-add, modeled in float64: the product of two
    float32 values is exact there; the sum is rounded to float64, then to
    float32 (as the plain versions compute it)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _butterfly(part):
    """The fixed xor butterfly over the last axis (own + partner at
    offsets G/2 .. 1): every thread ends with the sum."""
    G = part.shape[-1]
    idx = np.arange(G)
    off = G // 2
    while off:
        part = (part + part[..., idx ^ off]).astype(np.float32)
        off //= 2
    return part


def _reduce_scatter(acc):
    """ell::group_reduce over ``acc`` ``[G, NB]`` (thread, accumulator):
    halving steps while the group has offsets and a thread holds more than
    one accumulator (keep the half named by the offset bit, add the
    partner's values of it: own + partner), then the butterfly on one
    value.  Returns, per thread, {accumulator: sum} of what it holds."""
    G, NB = acc.shape
    held = [list(range(NB)) for _ in range(G)]
    vals = [list(acc[g]) for g in range(G)]
    off = G // 2
    while off and len(held[0]) > 1:
        new_h, new_v = [], []
        for g in range(G):
            p = g ^ off
            half = len(held[g]) // 2
            keep = slice(half, None) if g & off else slice(0, half)
            mine = dict(zip(held[g], vals[g]))
            theirs = dict(zip(held[p], vals[p]))
            new_h.append(held[g][keep])
            new_v.append([np.float32(mine[b] + theirs[b])
                          for b in held[g][keep]])
        held, vals, off = new_h, new_v, off // 2
    while off:
        vals = [[np.float32(vals[g][0] + vals[g ^ off][0])] for g in range(G)]
        off //= 2
    return [dict(zip(held[g], vals[g])) for g in range(G)]


def _held_sums(NB, g, G):
    """ell::held_sums: (first, count, writer) of thread g."""
    h, lg = NB.bit_length() - 1, G.bit_length() - 1
    steps = min(lg, h)
    count = NB >> steps
    return (g >> (lg - steps)) * count, count, g & ((1 << (lg - steps)) - 1) == 0


def _walk_nb(B):
    """The columns a chunk takes (ell_sweep_multi_launch)."""
    return 8 if B >= 5 else 4 if B >= 3 else B


def _multi_row(v, c, y_rows, own, G):
    """The walk's commit of one row for y ``[.., B]``: chunks of NB
    columns, thread g's accumulators over its slots g, g + G, ... by fused
    multiply-adds from +0, the reduce-scatter, and each held column
    written by its writer as own - sum.  Returns the row and how many
    times each column was written."""
    B = own.size
    NB = _walk_nb(B)
    out, writes = own.copy(), np.zeros(B, np.int64)
    for cb in range(0, B, NB):
        nb = min(NB, B - cb)
        acc = np.zeros((G, NB), np.float32)
        for g in range(G):
            for k in range(g, v.size, G):
                for b in range(nb):
                    acc[g, b] = _fma(v[k], y_rows[c[k], cb + b], acc[g, b])
        held = _reduce_scatter(acc)
        for g in range(G):
            first, count, writer = _held_sums(NB, g, G)
            assert set(held[g]) == set(range(first, first + count))
            if not writer:
                continue
            for b in range(first, first + count):
                if b < nb:
                    out[cb + b] = np.float32(own[cb + b] - held[g][b])
                    writes[cb + b] += 1
    return out, writes


def _column_butterflies(v, c, y_rows, own, G):
    """The order the walk replaced: each column alone, thread g's slots by
    fused multiply-adds, then that column's own butterfly."""
    B = own.size
    out = own.copy()
    for b in range(B):
        part = np.zeros(G, np.float32)
        for g in range(G):
            for k in range(g, v.size, G):
                part[g] = _fma(v[k], y_rows[c[k], b], part[g])
        out[b] = np.float32(own[b] - _butterfly(part)[0])
    return out


@pytest.mark.parametrize("B", [1, 2, 3, 4, 7, 8, 11, 16])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_multi_sum_order_equals_column_butterflies(B, G):
    """Rows of 0 to 3 G live slots, with values over seven decades: every
    column is written exactly once and equals its own butterfly's commit
    bit for bit, for each chunking of B columns."""
    rng = np.random.default_rng(B * 64 + G)
    n = 40
    y_rows = (rng.normal(size=(n, B))
              * 10.0 ** rng.integers(-3, 4, (n, B))).astype(np.float32)
    for length in sorted({0, 1, G - 1, G, G + 1, 3 * G} - {-1}):
        if length > G and G < 32:
            continue             # a row longer than G only at G = 32
        v = (rng.normal(size=length)
             * 10.0 ** rng.integers(-2, 3, length)).astype(np.float32)
        c = rng.integers(0, n, length)
        own = rng.normal(size=B).astype(np.float32)
        got, writes = _multi_row(v, c, y_rows, own, G)
        want = _column_butterflies(v, c, y_rows, own, G)
        assert writes.tolist() == [1] * B
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
