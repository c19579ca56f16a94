"""Port parity of the distributed paths (``repro_torch.core.dist`` on
``torch.distributed``, gloo on the CPU) against the reference's
``repro.core.dist`` on a one-device mesh:

* one rank: the sharded matvec equals ``laplacian_pcg``'s operator bit for
  bit (also on a graph whose edges leave vertices untouched) and the
  reference's sharded matvec within 1e-6 relative; ``ensemble_factor``
  reads the fill slack off the pool and refuses a pool of no slack;
* four ranks (separate processes, a 180 s limit): the matvec within 2e-4
  of the float64 host matvec, ``sharded_pcg`` converged with every
  rank's x bitwise equal and its iterations within one of the
  reference's, and ``batched_factorize`` of eight keys split from one
  reference key bitwise equal to the reference's, field by field, on
  every rank."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import torch.distributed as tdist                              # noqa: E402
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.core import dist as jdist                           # noqa: E402
from repro.core.parac import factorize_wavefront as jwave      # noqa: E402
from repro.core.trisolve import make_preconditioner as jprec   # noqa: E402
from repro.data import graphs as jgraphs                       # noqa: E402
from repro.launch.mesh import mesh_axis_types                  # noqa: E402
from repro_torch.core import dist as tdistmod                  # noqa: E402
from repro_torch.core import pcg as tpcg                       # noqa: E402
from repro_torch.core.convert import keys_from_jax             # noqa: E402
from repro_torch.core.laplacian import Graph                   # noqa: E402
from repro_torch.core.laplacian import laplacian_matvec_np     # noqa: E402
from repro_torch.core.parac import factorize_wavefront as twave  # noqa
from repro_torch.data import graphs as tgraphs                 # noqa: E402
from repro_torch.launch.mesh import init_group, make_host_mesh  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
LIMIT_S = 180
STATE_FIELDS = ("col_fill", "pool_row", "pool_val", "D", "n_rounds",
                "overflow")

# one rank of the four-rank group: the port alone, its results to a file
WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.core import dist as D
from repro_torch.core.column_math import key_from_seed
from repro_torch.core.parac import factorize_wavefront
from repro_torch.core.trisolve import make_preconditioner
from repro_torch.data import graphs
from repro_torch.launch.mesh import init_group, make_host_mesh

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
store = dist.TCPStore("127.0.0.1", port, world, is_master=False)
init_group("cpu", rank=rank, world_size=world, store=store)
mesh = make_host_mesh(world, 1, device="cpu")
g = graphs.grid2d(12, 12, seed=1)
x = np.random.default_rng(0).normal(size=g.n).astype(np.float32)
y = D.make_sharded_matvec(g, mesh)(torch.from_numpy(x))
f = factorize_wavefront(g, key_from_seed(0), fill_slack=64, device="cpu")
b = np.random.default_rng(1).normal(size=g.n).astype(np.float32)
b -= b.mean()
res = D.sharded_pcg(g, mesh, make_preconditioner(f, device="cpu"),
                    torch.from_numpy(b), tol=1e-5, maxiter=300)
st = D.batched_factorize(g, np.load(out + "/keys.npy"), mesh)
np.savez(f"{out}/rank{rank}.npz", y=y.numpy(), x=res.x.numpy(),
         iters=int(res.iters), converged=bool(res.converged),
         **{k: getattr(st, k).numpy() for k in st._fields})
dist.destroy_process_group()
"""


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _jax_mesh():
    return jax.make_mesh((1,), ("data",), **mesh_axis_types(1))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four ranks' results (started first, so they run while the
    reference's side is computed) and the reference's: its sharded matvec,
    sharded PCG and batched factorization on a one-device mesh."""
    out = tmp_path_factory.mktemp("dist")
    jkeys = jax.random.split(jax.random.key(7), 8)
    np.save(out / "keys.npy", keys_from_jax(jax.random.key_data(jkeys)))
    store = tdist.TCPStore("127.0.0.1", 0, None, True,
                           wait_for_workers=False)
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}"
               f"{os.environ.get('PYTHONPATH', '')}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(WORLD), str(store.port),
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        g = jgraphs.grid2d(12, 12, seed=1)
        mesh = _jax_mesh()
        f = jwave(g, jax.random.key(0), fill_slack=64)
        b = np.random.default_rng(1).normal(size=g.n).astype(np.float32)
        b -= b.mean()
        ref_pcg = jax.jit(lambda bb: jdist.sharded_pcg(
            g, mesh, jprec(f), bb, tol=1e-5, maxiter=300))(jnp.asarray(b))
        ref_state = jdist.batched_factorize(g, jkeys, mesh)
        logs = [p.communicate(timeout=LIMIT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, ref_pcg, ref_state


@pytest.fixture
def one_rank():
    init_group("cpu", rank=0, world_size=1, store=tdist.HashStore())
    try:
        yield make_host_mesh(1, 1, device="cpu")
    finally:
        tdist.destroy_process_group()


def test_sharded_matvec_one_rank(one_rank):
    """One shard: ``laplacian_pcg``'s operator bit for bit, and the
    reference's sharded matvec within 1e-6 relative."""
    g = tgraphs.grid2d(12, 12, seed=1)
    x = np.random.default_rng(0).normal(size=g.n).astype(np.float32)
    xt = torch.from_numpy(x)
    y = tdistmod.make_sharded_matvec(g, one_rank)(xt)
    y_op = tpcg._laplacian_operator(g, xt)(xt)
    assert torch.equal(y.view(torch.int32), y_op.view(torch.int32))
    y_ref = np.asarray(jax.jit(jdist.make_sharded_matvec(
        jgraphs.grid2d(12, 12, seed=1), _jax_mesh()))(jnp.asarray(x)))
    assert (np.linalg.norm(y.numpy() - y_ref)
            <= 1e-6 * np.linalg.norm(y_ref))


@pytest.mark.parametrize("nrhs", [0, 3])
def test_sharded_matvec_one_rank_isolated_vertices(one_rank, nrhs):
    """A shard that leaves vertices untouched (three isolated ones here)
    still gives ``laplacian_pcg``'s operator bit for bit, for one
    right-hand side and a block: its rows are written once each into a
    zero ``y``, the untouched rows stay zero."""
    g = tgraphs.grid2d(8, 8, seed=4)
    g = Graph(g.n + 3, g.src, g.dst, g.w)
    shape = (nrhs, g.n) if nrhs else (g.n,)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=shape).astype(np.float32))
    y = tdistmod.make_sharded_matvec(g, one_rank)(x)
    y_op = tpcg._laplacian_operator(g, x)(x)
    assert torch.equal(y.view(torch.int32), y_op.view(torch.int32))
    assert not y[..., -3:].any()


def test_ensemble_factor_refuses_a_pool_of_no_slack(one_rank):
    """The fill slack is read off the pool's width ``m + n·slack``; a
    width that is no such sum raises instead of compacting wrong rows."""
    g = tgraphs.grid2d(6, 6, seed=1)
    keys = keys_from_jax(jax.random.key_data(
        jax.random.split(jax.random.key(3), 1)))
    st = tdistmod.batched_factorize(g, keys, one_rank, fill_slack=4)
    assert tdistmod.ensemble_factor(g, st, 0).stats["fill_slack"] == 4
    cut = st._replace(pool_row=st.pool_row[:, :-1],
                      pool_val=st.pool_val[:, :-1])
    with pytest.raises(ValueError, match="fill slack"):
        tdistmod.ensemble_factor(g, cut, 0)


def test_ensemble_factor_is_the_single_engine_factor(one_rank):
    """A key's slice of ``batched_factorize``, compacted, is
    ``factorize_wavefront``'s non-strict factor under that key bit for bit
    (``col_ptr``, ``rows``, ``vals``, ``D`` and its rounds)."""
    g = tgraphs.grid2d(12, 12, seed=1)
    keys = keys_from_jax(jax.random.key_data(
        jax.random.split(jax.random.key(3), 2)))
    st = tdistmod.batched_factorize(g, keys, one_rank, fill_slack=8)
    for b in range(2):
        f = tdistmod.ensemble_factor(g, st, b)
        ref = twave(g, keys[b], chunk=256, fill_slack=8, strict=False,
                    device="cpu")
        for k in ("col_ptr", "rows", "vals", "D"):
            assert np.array_equal(_bits(getattr(f, k)), _bits(getattr(ref, k)))
        assert f.stats["rounds"] == ref.stats["rounds"]
        assert f.stats["overflow"] == ref.stats["overflow"]


def test_keys_from_jax_takes_a_batch_only():
    keys = keys_from_jax(jax.random.key_data(jax.random.split(
        jax.random.key(7), 3)))
    assert keys.shape == (3, 2) and keys.dtype == np.uint32
    with pytest.raises(ValueError, match=r"\(B, 2\)"):
        keys_from_jax(jax.random.key_data(jax.random.key(7)))


def test_mesh_needs_a_group_of_its_size():
    with pytest.raises(RuntimeError, match="no process group"):
        make_host_mesh(1, 1, device="cpu")
    init_group("cpu", rank=0, world_size=1, store=tdist.HashStore())
    try:
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_host_mesh(2, 1, device="cpu")
    finally:
        tdist.destroy_process_group()


def test_four_rank_matvec_within_host(four_ranks):
    ranks, _, _ = four_ranks
    g = tgraphs.grid2d(12, 12, seed=1)
    x = np.random.default_rng(0).normal(size=g.n).astype(np.float32)
    y_host = laplacian_matvec_np(g, x.astype(np.float64))
    for r in ranks:
        assert np.allclose(r["y"], y_host, rtol=2e-4, atol=2e-4)
        assert np.array_equal(_bits(r["y"]), _bits(ranks[0]["y"]))


def test_four_rank_pcg_lockstep(four_ranks):
    """Converged at tol 1e-5 on every rank with the same x bit for bit and
    the reference's iteration count within one (the four partial sums
    round in another order than one)."""
    ranks, ref, _ = four_ranks
    assert bool(ref.converged)
    for r in ranks:
        assert bool(r["converged"])
        assert int(r["iters"]) == int(ranks[0]["iters"])
        assert np.array_equal(_bits(r["x"]), _bits(ranks[0]["x"]))
    assert abs(int(ranks[0]["iters"]) - int(ref.iters)) <= 1
    np.testing.assert_allclose(ranks[0]["x"], np.asarray(ref.x), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(ref.x)).max())


@pytest.mark.parametrize("field", STATE_FIELDS)
def test_four_rank_batched_factorize_bitwise(four_ranks, field):
    """Keys ``split(key(7), 8)`` carried across, two a rank: every rank
    holds all eight states, each equal to the reference's bit for bit."""
    ranks, _, ref_state = four_ranks
    want = _bits(getattr(ref_state, field))
    for r in ranks:
        assert r[field].shape == want.shape
        assert np.array_equal(_bits(r[field]), want)
