"""The engine's elimination round as the fused kernel computes it, on the
CPU: each row eliminated at its own width ``max(next_pow2(fill), 2)``
gives the bits of the bucket width; a strict attempt that will be retried
stops within ``check_every`` rounds of its first overflow and the kept
factor and stats stay the reference's; the engine state after k rounds
equals the reference engine's."""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.core import parac as jparac                         # noqa: E402
from repro.core.ordering import ORDERINGS as JORDER            # noqa: E402
from repro.data import graphs as jgraphs                       # noqa: E402
from repro_torch.core import column_math as tcm                # noqa: E402
from repro_torch.core import parac as tparac                   # noqa: E402
from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.core.ordering import ORDERINGS as TORDER      # noqa: E402
from repro_torch.data import graphs as tgraphs                 # noqa: E402
from repro_torch.kernels import sample_clique as tsc           # noqa: E402

FACTOR = ("col_ptr", "rows", "vals", "D")
STATS = ("rounds", "overflow", "fill_slack", "pool_size", "dmax")
# grid3d_uniform_16, nnz-sort, chunk 256, key 0: at fill_slack 32 the engine
# drops its first sampled edge in round 51 of 145; at 64 nothing drops
KW = dict(chunk=256, fill_slack=32, strict=True)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _permuted(graphs, order, g):
    return g.permute(order["nnz-sort"](g, seed=0)).coalesce()


@pytest.fixture(scope="module")
def g16():
    return _permuted(tgraphs, TORDER, tgraphs.SUITE["grid3d_uniform_16"]())


@pytest.fixture(scope="module")
def g16_ref():
    return _permuted(jgraphs, JORDER, jgraphs.SUITE["grid3d_uniform_16"]())


def _engine(gs, slack, chunk=256, keys=None, **kw):
    built = [tparac._build_pool(tparac._pool_edges(g, np.float32, "cpu"),
                                slack) for g in gs]
    keys = keys or [key_from_seed(i) for i in range(len(gs))]
    n_pad = max(g.n for g in gs)
    P_pad = max(b.P for b in built)
    if len(gs) > 1:
        n_pad, P_pad = tparac._next_pow2(n_pad), tparac._next_pow2(P_pad)
    W = max(tparac._next_pow2(max(b.dmax for b in built)), 2)
    return tparac._init_engine(built, keys, n_pad=n_pad, P_pad=P_pad, W=W,
                               chunk=chunk, **kw)


# ---------------------------------------------------------------------------
# (a) a row at its own width gives the bucket width's bits
# ---------------------------------------------------------------------------

def _at_own_width(ids, ws, fill, u):
    """Each row eliminated by ``eliminate_column`` at ``w = max(
    next_pow2(fill), 2)`` (rows grouped by w), as ``ColumnElim`` fields
    of width w per row."""
    out = [None] * ids.shape[0]
    w_of = [max(tparac._next_pow2(int(f)), 2) for f in fill]
    for w in sorted(set(w_of)):
        rows = [r for r, x in enumerate(w_of) if x == w]
        ix = torch.tensor(rows)
        res = tsc.sample_clique_plain(ids[ix, :w], ws[ix, :w], fill[ix],
                                      u[ix, :w])
        for k, r in enumerate(rows):
            out[r] = [getattr(res, f)[k] for f in res._fields]
    return out


def _assert_width_independent(ids, ws, fill, u):
    full = tsc.sample_clique_plain(ids, ws, fill, u)
    W = ids.shape[1]
    own = _at_own_width(ids, ws, fill, u)
    for r, (g_rows, g_vals, m, ell, e_lo, e_hi, e_w, e_valid) in \
            enumerate(own):
        w = g_rows.shape[0]
        assert int(m) == int(full.m[r]) and int(m) <= w
        assert _bits(ell.numpy()) == _bits(full.ell_kk[r].numpy())
        # the row's valid prefix (and the rest of the w lanes) ...
        assert torch.equal(g_rows, full.g_rows[r, :w])
        assert np.array_equal(_bits(g_vals.numpy()),
                              _bits(full.g_vals[r, :w].numpy()))
        # ... the bucket's lanes past w hold nothing
        assert bool((full.g_rows[r, w:] == tcm.INVALID_ID).all())
        assert not bool(full.e_valid[r, :W - w].any())
        # the edge list in order (right-aligned at both widths)
        sel, ful = e_valid, full.e_valid[r]
        assert torch.equal(sel, ful[W - w:])
        for a, b in ((e_lo, full.e_lo[r]), (e_hi, full.e_hi[r]),
                     (e_w, full.e_w[r])):
            assert np.array_equal(_bits(a[sel].numpy()),
                                  _bits(b[ful].numpy()))


def _gathered_rows(s, st):
    cand, ok = tparac._round_ready(s.elim, s.dep, tparac._live(s, st),
                                   chunk=st.chunk)
    ids, ws, fill, u, _, _ = tsc.round_gather(s, st, cand, ok)
    keep = ok.view(-1)
    return ids[keep], ws[keep], fill[keep], u[keep]


def test_engine_rows_at_own_width_bitwise(g16):
    """Real rows of grid3d 16^3 at fill_slack 256 (W = 512), from rounds
    spread over the factor."""
    s, st = _engine([g16], 256)
    assert st.W == 512
    rows, done = [], 0
    for stop in (1, 30, 60, 90, 120):
        done += tparac._run_engine_batched(s, st, max_rounds=stop - done)
        rows.append(_gathered_rows(s, st))
    ids, ws, fill, u = (torch.cat(x) for x in zip(*rows))
    assert int(fill.max()) > 32 and int(fill.min()) >= 1
    _assert_width_independent(ids, ws, fill, u)


@pytest.mark.parametrize("W", [2, 16, 64, 512])
def test_random_rows_at_own_width_bitwise(W):
    rng = np.random.default_rng(W)
    R = 64
    fill = rng.integers(1, W + 1, R).astype(np.int32)
    ids = rng.integers(0, max(2, W // 2), (R, W)).astype(np.int32)
    ws = rng.uniform(0.1, 3.0, (R, W)).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (R, W)).astype(np.float32)
    u[:8] = 0.0                        # thresholds equal to S1
    _assert_width_independent(*(torch.from_numpy(a)
                                 for a in (ids, ws, fill, u)))


@pytest.mark.parametrize("w,W", [(2, 8), (4, 64), (32, 512), (64, 1024)])
def test_padded_scan_is_the_narrow_scan_plus_zero(w, W):
    """The lemma the kernel's search rests on: with lanes >= w zero, the
    W-wide Hillis-Steele scan equals the w-wide one + 0 on lanes < w and
    its total + 0 at every block end c*w - 1."""
    rng = np.random.default_rng(w * W)
    x = np.zeros((16, W), np.float32)
    for r in range(16):
        m = rng.integers(1, w + 1)
        x[r, w - m:w] = 10.0 ** rng.uniform(-6, 3, m)
    x[0, :w] = -0.0                     # -0 sums become +0 at the wider width
    xt = torch.from_numpy(x)
    wide = tcm.hs_cumsum(xt)
    narrow = tcm.hs_cumsum(xt[:, :w]) + 0.0
    assert np.array_equal(_bits(wide[:, :w].numpy()), _bits(narrow.numpy()))
    ends = wide[:, w - 1::w]
    assert np.array_equal(_bits(ends.numpy()),
                          _bits(narrow[:, -1:].expand_as(ends).numpy()))


# ---------------------------------------------------------------------------
# (b) a discarded strict attempt stops at its first overflow
# ---------------------------------------------------------------------------

class _Rounds:
    """Counts engine rounds (calls of ``parac._engine_round``)."""

    def __init__(self, monkeypatch):
        self.n = 0
        inner = tparac._engine_round

        def counted(s, st):
            self.n += 1
            inner(s, st)
        monkeypatch.setattr(tparac, "_engine_round", counted)


def _first_overflow_round(g, slack):
    """Rounds run by a frozen attempt and the round of its first drop."""
    s, st = _engine([g], slack, freeze_on_overflow=True)
    run = tparac._run_engine_batched(s, st)
    first = int(s.n_rounds[0])
    assert int(s.overflow[0]) > 0
    # one round fewer drops nothing
    s2, st2 = _engine([g], slack)
    tparac._run_engine_batched(s2, st2, max_rounds=first - 1)
    assert int(s2.overflow[0]) == 0
    return run, first


def test_early_stop_wavefront_matches_reference(g16, g16_ref, monkeypatch):
    run, first = _first_overflow_round(g16, 32)
    assert first == 51 and first <= run < first + 8
    rounds = _Rounds(monkeypatch)
    ft = tparac.factorize_wavefront(g16, key_from_seed(0), device="cpu",
                                    **KW)
    strict_rounds = rounds.n
    fj = jparac.factorize_wavefront(g16_ref, jax.random.key(0), **KW)
    for f in FACTOR:
        assert np.array_equal(_bits(getattr(fj, f)), _bits(getattr(ft, f))), f
    for k in STATS:
        assert ft.stats[k] == fj.stats[k], k
    assert ft.stats["fill_slack"] == 64
    # the kept attempt runs to its end, to the next check
    kept = 8 * -(-ft.stats["rounds"] // 8)
    assert strict_rounds == run + kept
    # before: the discarded attempt ran to its end as well
    rounds.n = 0
    tparac.factorize_wavefront(g16, key_from_seed(0), device="cpu",
                               chunk=256, fill_slack=32, strict=False)
    assert rounds.n == 8 * -(-145 // 8)
    assert strict_rounds < rounds.n + kept


def test_early_stop_batched_matches_reference(g16, g16_ref, monkeypatch):
    """B = 2: grid3d 16^3 overflows at slack 32 and retries alone; the
    small grid beside it runs on to its end in the first attempt."""
    small_t = tgraphs.grid2d(12, 12, seed=3)
    small_j = jgraphs.grid2d(12, 12, seed=3)
    rounds = _Rounds(monkeypatch)
    ft = tparac.factorize_batched([g16, small_t],
                                  [key_from_seed(0), key_from_seed(1)],
                                  device="cpu", **KW)
    strict_rounds = rounds.n
    fj = jparac.factorize_batched(
        [g16_ref, small_j], jnp.stack([jax.random.key(0), jax.random.key(1)]),
        **KW)
    for a, b in zip(fj, ft):
        for f in FACTOR:
            assert np.array_equal(_bits(getattr(a, f)),
                                  _bits(getattr(b, f))), f
        for k in STATS + ("n_pad", "P_pad", "dmax_pad", "batch_size"):
            assert a.stats[k] == b.stats[k], k
    assert ft[0].stats["fill_slack"] == 64 and ft[1].stats["fill_slack"] == 32
    # the first attempt lasts as long as its longer-running lane: the small
    # grid's rounds or the frozen lane's first overflow, to the next check
    first = _first_overflow_round(g16, 32)[1]
    attempt1 = 8 * -(-max(first, ft[1].stats["rounds"]) // 8)
    attempt2 = 8 * -(-ft[0].stats["rounds"] // 8)
    assert strict_rounds == attempt1 + attempt2
    assert strict_rounds < 8 * -(-145 // 8) + attempt2


# ---------------------------------------------------------------------------
# (c) the engine state after k rounds is the reference engine's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 37, 60])
def test_engine_state_after_k_rounds_matches_reference(g16, g16_ref, k):
    slack = 32
    s, st = _engine([g16], slack, keys=[key_from_seed(0)])
    tparac._run_engine_batched(s, st, max_rounds=k)
    pr, pv, fill, dep, cb, cap, _, dmax = jparac._build_pool(g16_ref, slack,
                                                             np.float32)
    js = jparac._init_state(jnp.asarray(pr), jnp.asarray(pv),
                            jnp.asarray(fill), jnp.asarray(dep))
    step = jax.jit(partial(jparac._engine_round, dmax=dmax, chunk=256))
    for _ in range(k):
        js = step(js, jnp.asarray(cb), jnp.asarray(cap), jax.random.key(0))
    for f in ("pool_row", "pool_val", "col_fill", "dep", "elim", "D"):
        assert np.array_equal(_bits(getattr(js, f)),
                              _bits(getattr(s, f)[0, :-1].numpy())), f
    for f in ("n_elim", "n_rounds", "overflow"):
        assert int(getattr(js, f)) == int(getattr(s, f)[0]), f
