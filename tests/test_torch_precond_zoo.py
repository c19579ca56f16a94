"""The port's preconditioner zoo on the CPU: every registered family (ac /
ichol / amg / spai) serves through the same cache and engine lifecycle —
SPD-consistent applies, eviction/re-attach round trips, distinct
fingerprints, per-family memory, one engine serving all four bit for bit
(the cases of the reference's ``tests/test_precond_zoo.py``) — and the
three host-built families against the reference package on the same
graphs: the payloads bit for bit, one preconditioner apply and the fleet
PCG's iterations and iterates (the reference side computed once, in a
module fixture)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.core.solver import FactorCache as JCache            # noqa: E402
from repro.data import graphs as jgraphs                       # noqa: E402
from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.core.solver import (                          # noqa: E402
    PRECOND_FAMILIES, FactorCache, get_family, graph_fingerprint)
from repro_torch.core.spai import EllPrecond                   # noqa: E402
from repro_torch.data import graphs                            # noqa: E402
from repro_torch.kernels import runtime                        # noqa: E402
from repro_torch.serve import SolveEngine, SolveRequest        # noqa: E402

FAMILIES = sorted(PRECOND_FAMILIES)
HOST_FAMILIES = ("ichol", "amg", "spai")
CACHE_KW = dict(chunk=32, fill_slack=64, strict=False)
# the parity graphs: (port graph, reference graph)
PARITY = {
    "grid2d_8": (lambda: graphs.grid2d(8, 8, seed=5),
                 lambda: jgraphs.grid2d(8, 8, seed=5)),
    "powerlaw_micro": (graphs.SUITE_MICRO["powerlaw_micro"],
                       jgraphs.SUITE_MICRO["powerlaw_micro"]),
}
# amg's rows are dense (K = n): the reference's interpret-mode kernel sums
# them with XLA:CPU's reduction, whose order for long rows is not known to
# be the port's left-to-right one, so its iterates may differ in the last
# bits.  On both parity graphs the iterations agree and x differs by at
# most 1.03e-7 relative (powerlaw_micro; 9.7e-8 on grid2d_8): the limit
# keeps about 10x headroom over that reading
AMG_X_RTOL = 1e-6


@pytest.fixture(scope="module")
def g():
    return graphs.grid2d(8, 8, seed=5)          # n = 64


@pytest.fixture(scope="module")
def key():
    return key_from_seed(7)


@pytest.fixture(scope="module")
def zoo(g, key):
    """One cache holding the same graph under all four families."""
    c = FactorCache(device="cpu", **CACHE_KW)
    handles = {fam: c.factor(g, key, graph_id=f"g::{fam}", family=fam)
               for fam in FAMILIES}
    return c, handles


def _rhs(rng, n, nrhs=1):
    b = rng.normal(size=(nrhs, n) if nrhs > 1 else n).astype(np.float32)
    return b - b.mean(axis=-1, keepdims=True)


def test_zoo_covers_expected_families():
    assert set(FAMILIES) == {"ac", "ichol", "amg", "spai"}
    assert {f: get_family(f).kind for f in FAMILIES} == {
        "ac": "factor", "ichol": "factor", "amg": "spmv", "spai": "spmv"}


@pytest.mark.parametrize("fam", ["ac", "ichol", "amg", "spai"])
def test_family_apply_spd_consistent(zoo, g, fam):
    """Each family's preconditioned CG converges, and the returned
    iterate solves the Laplacian system (float64 edge-list residual)."""
    _, handles = zoo
    h = handles[fam]
    rng = np.random.default_rng(17)
    b = _rhs(rng, g.n)
    res = h.solve(torch.from_numpy(b[None]), tol=1e-6, maxiter=500)
    relres = float(res.relres.max())
    assert relres <= 1e-5, f"{fam}: relres={relres}"
    x = res.x.numpy()[0].astype(np.float64)
    Lx = np.zeros(g.n, np.float64)
    w = np.asarray(g.w, np.float64)
    src, dst = np.asarray(g.src), np.asarray(g.dst)
    np.add.at(Lx, src, w * (x[src] - x[dst]))
    np.add.at(Lx, dst, w * (x[dst] - x[src]))
    resid = np.linalg.norm(b - Lx) / np.linalg.norm(b)
    assert resid < 1e-4, f"{fam}: true residual {resid}"
    # the apply is symmetric on mean-zero vectors: <u, M v> = <M u, v>
    u, v = _rhs(rng, g.n), _rhs(rng, g.n)
    Mu = h.precondition(torch.from_numpy(u)).numpy().astype(np.float64)
    Mv = h.precondition(torch.from_numpy(v)).numpy().astype(np.float64)
    assert abs(u @ Mv - Mu @ v) <= 1e-4 * np.linalg.norm(u) * \
        np.linalg.norm(Mv)


@pytest.mark.parametrize("fam", ["ac", "ichol", "amg", "spai"])
def test_family_cache_evict_reattach_roundtrip(g, key, fam):
    """Evicting a family handle frees its fleet row; re-attaching the
    same payload admits a fresh handle that solves identically."""
    c = FactorCache(device="cpu", **CACHE_KW)
    h1 = c.factor(g, key, graph_id="gg", family=fam)
    rng = np.random.default_rng(23)
    b = torch.from_numpy(_rhs(rng, g.n)[None])
    r1 = h1.solve(b, tol=1e-6, maxiter=500)
    payload = h1.factor
    c.evict("gg")
    assert not c.fresh("gg")
    h2 = c.attach(g, payload, graph_id="gg", family=fam)
    assert c.fresh("gg") and h2.family == fam
    r2 = h2.solve(b, tol=1e-6, maxiter=500)
    assert torch.equal(r1.x.view(torch.int32), r2.x.view(torch.int32))
    assert torch.equal(r1.iters, r2.iters)


def test_family_fingerprints_distinct(g, key):
    """Same graph under different families (or params) occupies distinct
    cache rows — family and params are part of the identity."""
    fps = {graph_fingerprint(g, key if f == "ac" else None, family=f)
           for f in FAMILIES}
    assert len(fps) == len(FAMILIES)
    assert graph_fingerprint(g, family="ichol") != \
        graph_fingerprint(g, family="ichol", params={"droptol": 0.02})


def test_cache_accounts_memory_per_family(zoo):
    c, handles = zoo
    st = c.stats()
    by_fam = st["device_bytes_by_family"]
    assert set(by_fam) == set(FAMILIES)
    assert all(v > 0 for v in by_fam.values())
    assert sum(by_fam.values()) == st["device_bytes"]
    assert st["handles_by_family"] == {f: 1 for f in FAMILIES}
    # an spmv handle is its fleet row (its payload is host-side), and its
    # panel is the operator's K slots per padded row
    for fam in ("amg", "spai"):
        h = handles[fam]
        assert h.kind == "spmv" and h.n_levels == 1
        assert h.device_bytes == h.fleet.bytes_per_row
        assert h.fleet.Kf == h.factor.K


def test_engine_serves_every_family_bit_exact(zoo, g):
    """Acceptance: one engine serving all four families concurrently —
    each request reproduces its handle's direct solve bit for bit, and
    lanes group per (family, shape-bucket): 4 buckets for one graph."""
    c, handles = zoo
    eng = SolveEngine(c, slots=4, iters_per_tick=8)
    rng = np.random.default_rng(29)
    reqs = [SolveRequest(rid=i, graph_id=f"g::{fam}",
                         b=_rhs(rng, g.n, nrhs=2), tol=1e-6, maxiter=500)
            for i, fam in enumerate(FAMILIES)]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    assert len(done) == len(reqs)
    for r, fam in zip(reqs, FAMILIES):
        ref = handles[fam].solve(torch.from_numpy(np.atleast_2d(r.b)),
                                 tol=r.tol, maxiter=r.maxiter)
        assert np.array_equal(np.atleast_2d(r.x).view(np.uint32),
                              ref.x.numpy().view(np.uint32)), fam
        assert np.array_equal(np.atleast_1d(r.iters),
                              ref.iters.numpy()), fam
    st = eng.stats()
    assert st.buckets == len(FAMILIES)        # (family, n_pad) grouping
    assert st.families == len(FAMILIES)
    assert st.step_compiles == st.buckets


# ---------------------------------------------------------------------------
# Parity with the reference package
# ---------------------------------------------------------------------------

def _payload(fam, f):
    """A family payload as a dict of numpy arrays (reference or port)."""
    if fam == "ichol":
        return {k: np.asarray(getattr(f, k))
                for k in ("col_ptr", "rows", "vals", "D")}
    return dict(cols=f.cols, vals=f.vals, nnz=np.int64(f.nnz))


@pytest.fixture(scope="module")
def reference():
    """The reference's payload, one apply and one 2-rhs fleet solve for
    each (parity graph, host family), in one reference cache per graph."""
    out = {}
    for name, (_, make_ref) in PARITY.items():
        jg = make_ref()
        jc = JCache(**CACHE_KW)
        rng = np.random.default_rng(31)
        B = _rhs(rng, jg.n, nrhs=2)
        r = _rhs(rng, jg.n)
        for fam in HOST_FAMILIES:
            h = jc.factor(jg, jax.random.key(7), graph_id=f"{name}::{fam}",
                          family=fam)
            res = h.solve(jnp.asarray(B), tol=1e-6, maxiter=500)
            out[name, fam] = dict(
                payload=_payload(fam, h.factor), B=B, r=r,
                apply=np.asarray(h.precondition(jnp.asarray(r))),
                x=np.asarray(res.x), iters=np.asarray(res.iters),
                K=h.fleet.Kf)
    return out


@pytest.fixture(scope="module")
def port_zoo():
    """The port's handles for each (parity graph, host family)."""
    out = {}
    for name, (make, _) in PARITY.items():
        g0 = make()
        c = FactorCache(device="cpu", **CACHE_KW)
        for fam in HOST_FAMILIES:
            out[name, fam] = c.factor(g0, key_from_seed(7),
                                      graph_id=f"{name}::{fam}", family=fam)
    return out


@pytest.mark.parametrize("fam", HOST_FAMILIES)
@pytest.mark.parametrize("name", list(PARITY))
def test_payload_matches_reference(reference, port_zoo, name, fam):
    """The host build is the reference's numpy/scipy code on the same
    graph: ichol's ``(col_ptr, rows, vals, D)`` and amg's and spai's
    ``(cols, vals, nnz)`` are the reference's bit for bit, and the fleet
    panel is as wide."""
    h = port_zoo[name, fam]
    got, want = _payload(fam, h.factor), reference[name, fam]["payload"]
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    if fam != "ichol":
        assert isinstance(h.factor, EllPrecond)
        assert h.fleet.Kf == reference[name, fam]["K"]


@pytest.mark.parametrize("fam", HOST_FAMILIES)
@pytest.mark.parametrize("name", list(PARITY))
def test_apply_matches_reference(reference, port_zoo, name, fam):
    """One preconditioner apply against the reference's on the same
    vector: within 1e-5 of the largest entry (the port's plain sums and
    the reference's interpret-mode kernel may round differently); an
    spmv family's apply goes through ``ell_spmv_fleet`` once."""
    ref = reference[name, fam]
    before = runtime.LAUNCHES.get("ell_spmv_fleet", 0)
    got = port_zoo[name, fam].precondition(torch.from_numpy(ref["r"]))
    want = ref["apply"]
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    # the CPU path runs the plain version: no kernel launch is counted
    assert runtime.LAUNCHES.get("ell_spmv_fleet", 0) == before


@pytest.mark.parametrize("fam", HOST_FAMILIES)
@pytest.mark.parametrize("name", list(PARITY))
def test_solve_matches_reference(reference, port_zoo, name, fam):
    """The fleet PCG against the reference's ``handle.solve`` on the same
    2-rhs block: every family takes the same iterations; ichol and spai
    give x within 1e-5 relative, amg within ``AMG_X_RTOL``."""
    ref = reference[name, fam]
    res = port_zoo[name, fam].solve(torch.from_numpy(ref["B"]), tol=1e-6,
                                    maxiter=500)
    assert bool(res.converged.all())
    iters, x = res.iters.numpy(), res.x.numpy()
    rel = np.linalg.norm(x - ref["x"], axis=1) / np.linalg.norm(
        ref["x"], axis=1)
    assert np.array_equal(iters, ref["iters"])
    assert rel.max() <= (AMG_X_RTOL if fam == "amg" else 1e-5)


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precond", ["amg", "auto"])
def test_serve_launcher_serves_family(capsys, tmp_path, precond):
    """``--precond amg`` and ``--precond auto`` through the serve launcher
    on the micro suite: every request served and converged; under
    ``auto`` every family is resident for every graph and the selector
    made one pick per request."""
    import json
    from repro_torch.launch import serve
    out = tmp_path / "m.json"
    serve.main(["--suite", "micro", "--requests", "6", "--slots", "4",
                "--device", "cpu", "--precond", precond, "--json",
                str(out)])
    text = capsys.readouterr().out
    assert f"precond={precond} device=cpu" in text
    assert "served 6/6 requests" in text
    m = json.loads(out.read_text())
    assert m["converged"] == m["completed"] == 6
    if precond == "auto":
        assert "selector: picks=6" in text
        assert sum(m["selector"]["picks_by_family"].values()) == 6
        assert m["cache"]["handles_by_family"] == {f: 3 for f in FAMILIES}
    else:
        assert m["selector"] is None
        assert m["cache"]["handles_by_family"] == {"amg": 3}


def test_auto_warmup_serves_every_family():
    """``run_service(precond="auto", warmup_requests=k)`` first serves
    every family on every graph at every pow2 width (outside the
    selector), then a k-request warm trace and the measured trace through
    the selector: every family's bucket was stepped, and the selector saw
    one pick per warm and measured request."""
    from repro_torch.launch.serve import run_service
    m, done, eng = run_service(suite="micro", requests=4, warmup_requests=3,
                               slots=4, max_nrhs=2, precond="auto",
                               device="cpu", return_engine=True)
    assert m["completed"] == m["converged"] == 4
    assert sum(m["selector"]["picks_by_family"].values()) == 3 + 4
    st = eng.stats()
    # the warm-up pass: 3 graphs x 4 families x widths {1, 2}
    assert st.families == len(FAMILIES)
    assert st.completed >= 3 * len(FAMILIES) * 2 + 3 + 4
    assert st.step_compiles == st.buckets
