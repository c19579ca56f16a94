"""Port parity and invariants of the solve path: the fleet PCG against the
reference ``Solver`` (same convergence and iteration counts, x within
1e-4), stepped == one-shot and lane independence bit for bit inside the
port, the cache lifecycle, and a reference-built factor carried across."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.data import graphs as jgraphs                       # noqa: E402
from repro.core.solver import Solver as JSolver                # noqa: E402
from repro.core.ref_ac import factorize_sequential as jseq     # noqa: E402
from repro_torch.data import graphs as tgraphs                 # noqa: E402
from repro_torch.core.solver import (                          # noqa: E402
    Solver, FactorCache, graph_fingerprint)
from repro_torch.core import pcg as tpcg                       # noqa: E402
from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.core.convert import factor_from_numpy, key_from_jax  # noqa
from repro_torch.core.laplacian import laplacian_matvec_np     # noqa: E402
from repro_torch.core.trisolve import precond_apply_np         # noqa: E402

NAMES = ["grid2d_tiny", "road_tiny", "powerlaw_micro"]
SUITE_J = {**jgraphs.SUITE_MICRO, **jgraphs.SUITE_TINY}
SUITE_T = {**tgraphs.SUITE_MICRO, **tgraphs.SUITE_TINY}


def _rhs(n, k, seed=1):
    return np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_pcg_matches_reference_solver(name):
    g_j, g_t = SUITE_J[name](), SUITE_T[name]()
    B = _rhs(g_t.n, 3)
    js = JSolver(chunk=32)
    js.factor(g_j, jax.random.key(0))
    rj = js.solve(jnp.asarray(B), tol=1e-6, maxiter=300)
    ts = Solver(chunk=32, device="cpu")
    ts.factor(g_t, key_from_seed(0))
    rt = ts.solve(torch.from_numpy(B), tol=1e-6, maxiter=300)
    assert np.array_equal(np.asarray(rj.converged), rt.converged.numpy())
    assert np.array_equal(np.asarray(rj.iters), rt.iters.numpy())
    xj = np.asarray(rj.x)
    err = np.linalg.norm(xj - rt.x.numpy(), axis=1) / np.linalg.norm(xj,
                                                                       axis=1)
    assert err.max() <= 1e-4
    # single rhs: same answer as its lane
    r1 = ts.solve(torch.from_numpy(B[0]), tol=1e-6, maxiter=300)
    assert int(r1.iters) == int(rt.iters[0])


@pytest.fixture(scope="module")
def cache():
    c = FactorCache(chunk=16, device="cpu")
    hs = c.factor_batched([SUITE_T[n]() for n in ("grid2d_micro",
                                                  "road_micro",
                                                  "grid2d_tiny")],
                          [key_from_seed(i) for i in range(3)])
    return c, hs


def test_stepped_equals_one_shot_bitwise(cache):
    c, hs = cache
    h = hs[2]
    fa = h.fleet.arrays
    B = torch.zeros((3, h.n_pad))
    B[:, :h.n] = torch.from_numpy(_rhs(h.n, 3, seed=4))
    fidx = torch.full((3,), h.fleet_row, dtype=torch.int32)
    kw = dict(f_levels=h.fleet.f_levels, b_levels=h.fleet.b_levels)
    tol = torch.full((3,), 1e-6)
    mi = torch.full((3,), 200, dtype=torch.int32)
    one = tpcg.pcg_fleet_solve(fa, fidx, B, tol, mi, **kw)
    s = tpcg.pcg_fleet_init(fa, fidx, B, tol, mi, **kw)
    while bool(s.active.any()):
        s = tpcg.pcg_fleet_step(fa, s, k=3, **kw)
    for a, b in zip(one, s):
        assert torch.equal(a, b)


def test_lane_independence_bitwise(cache):
    """A lane's trajectory does not depend on which lanes share its batch
    (other factors of the bucket, other right-hand sides)."""
    c, hs = cache
    fleet = hs[0].fleet
    mates = [h for h in hs if h.fleet is fleet]
    assert len(mates) >= 2
    fa = fleet.arrays
    n_pad = fleet.n_pad
    rows = [h.fleet_row for h in mates]
    rhs = [torch.from_numpy(_rhs(h.n, 1, seed=9 + i)[0])
           for i, h in enumerate(mates)]
    kw = dict(f_levels=fleet.f_levels, b_levels=fleet.b_levels)

    def run(lanes):
        B = torch.zeros((len(lanes), n_pad))
        for j, i in enumerate(lanes):
            B[j, :mates[i].n] = rhs[i]
        fidx = torch.tensor([rows[i] for i in lanes], dtype=torch.int32)
        L = len(lanes)
        return tpcg.pcg_fleet_solve(fa, fidx, B, torch.full((L,), 1e-6),
                                    torch.full((L,), 200, dtype=torch.int32),
                                    **kw)

    alone = [run([i]) for i in range(len(mates))]
    mixed = run(list(range(len(mates)))[::-1] + [0])
    for j, i in enumerate(list(range(len(mates)))[::-1] + [0]):
        assert torch.equal(mixed.X[j], alone[i].X[0])
        assert int(mixed.it[j]) == int(alone[i].it[0])


def test_cache_lifecycle(cache):
    c, hs = cache
    st = c.stats()
    assert st["handles"] == 3 and st["misses"] == 3
    # resubmitting a known (graph, key) is a hit
    again = c.factor_batched([SUITE_T["road_micro"]()], [key_from_seed(1)])
    assert again[0] is hs[1] and c.stats()["hits"] == 1
    assert graph_fingerprint(hs[1].graph, key_from_seed(1)) == hs[1].graph_id
    # solves route by graph id; results agree with the host preconditioner
    h = hs[0]
    b = _rhs(h.n, 1, seed=2)[0]
    res = c.solve(h.graph_id, torch.from_numpy(b), tol=1e-6, maxiter=200)
    assert bool(res.converged)
    x = res.x.numpy().astype(np.float64)
    bb = b - b.mean()
    assert np.linalg.norm(laplacian_matvec_np(h.graph, x) - bb) \
        <= 1e-4 * np.linalg.norm(bb)
    r = _rhs(h.n, 1, seed=3)[0]
    assert np.allclose(h.precondition(torch.from_numpy(r)).numpy(),
                       precond_apply_np(h.factor, r.astype(np.float64)),
                       rtol=1e-4, atol=1e-5)


def test_budget_and_count_eviction():
    gs = [SUITE_T[n]() for n in ("grid2d_micro", "powerlaw_micro",
                                 "road_micro")]
    c = FactorCache(chunk=16, max_handles=2, device="cpu")
    hs = [c.factor(g, key_from_seed(0)) for g in gs]
    assert len(c) == 2 and hs[0].graph_id not in c and c.evictions == 1
    c2 = FactorCache(chunk=16, memory_budget_bytes=1, device="cpu")
    for g in gs:
        c2.factor(g, key_from_seed(0))
    assert len(c2) == 1                       # the newest always survives
    c2.evict(c2.graph_ids[0])
    assert len(c2) == 0 and c2.evictions == 3
    with pytest.raises(KeyError):
        c2.get("missing")
    s = Solver(chunk=16, device="cpu")
    with pytest.raises(RuntimeError):
        s.solve(torch.zeros(3))


def test_carry_across_reference_factor():
    """A factor built by the reference package, handed over as numpy
    arrays, solves in the port as the reference Solver solves with it."""
    g_j, g_t = SUITE_J["grid2d_micro"](), SUITE_T["grid2d_micro"]()
    kd = jax.random.key_data(jax.random.key(5))
    fj = jseq(g_j, jax.random.key(5))
    f = factor_from_numpy(fj.col_ptr, fj.rows, fj.vals, fj.D)
    B = _rhs(g_t.n, 2, seed=6)
    ts = Solver(device="cpu")
    ts.attach(g_t, f)
    rt = ts.solve(torch.from_numpy(B), tol=1e-6, maxiter=200)
    js = JSolver()
    js.attach(g_j, fj)
    rj = js.solve(jnp.asarray(B), tol=1e-6, maxiter=200)
    assert np.array_equal(np.asarray(rj.iters), rt.iters.numpy())
    assert bool(rt.converged.all())
    xj = np.asarray(rj.x)
    assert np.linalg.norm(xj - rt.x.numpy()) <= 1e-4 * np.linalg.norm(xj)
    # the port's own factor for the same key is the reference's, bit for bit
    own = Solver(device="cpu", chunk=8, fill_slack=64).factor(
        g_t, key_from_jax(kd)).factor
    assert np.array_equal(own.rows, fj.rows)
    assert np.array_equal(own.vals.view(np.uint32),
                          np.asarray(fj.vals).view(np.uint32))
    with pytest.raises(ValueError):
        factor_from_numpy(fj.col_ptr[:-1], fj.rows, fj.vals, fj.D)


def test_pcg_np_against_fleet():
    g = SUITE_T["road_micro"]()
    h = Solver(chunk=16, device="cpu").factor(g, key_from_seed(2))
    b = _rhs(g.n, 1, seed=8)[0].astype(np.float64)
    host = tpcg.pcg_np(lambda x: laplacian_matvec_np(g, x),
                       lambda r: precond_apply_np(h.factor, r), b, tol=1e-6)
    fleet = h.solve(torch.from_numpy(b.astype(np.float32)), tol=1e-6)
    assert host.converged and bool(fleet.converged)
    assert abs(int(host.iters) - int(fleet.iters)) <= 1
    assert np.allclose(host.x, fleet.x.numpy(), rtol=1e-3, atol=1e-4)


def test_launcher_on_cpu(capsys):
    from repro_torch.launch import solve
    solve.main(["--graph", "grid2d_64", "--device", "cpu", "--batch", "2"])
    out = capsys.readouterr().out
    assert "graph=grid2d_64 n=4096" in out
    assert "batched construction: 2 factors" in out
