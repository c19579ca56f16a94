"""The port's roofline arithmetic (``repro_torch.launch.roofline``) against
the reference's ``repro.launch.roofline``, and its per-device counts:

* ``model_flops`` equal for every arch, cell and chip count;
  ``extrapolate`` equal on the same probe points; ``roofline_terms`` equal
  with the reference's constants set to the port's, and each term the
  reference's scaled by the ratio of the constants with its own.  Exact
  but for the last (1e-12 relative: a product against a quotient).
* the constants are the H100 SXM's datasheet figures, none the TPU's.
* ``CostCounter`` on a fake process group: a redistribution's collective
  bytes are its operands' local bytes by kind; a sharded einsum's flops
  are the global count over the mesh's extent (the counter sees the
  local shards, not the DTensor-level product).  Exact.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import torch.distributed as tdist                              # noqa: E402

from repro.configs import get_config as ref_get_config         # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES          # noqa: E402
from repro.launch import roofline as rrl                       # noqa: E402
from repro_torch.configs import get_config, list_archs         # noqa: E402
from repro_torch.configs.shapes import SHAPES                  # noqa: E402
from repro_torch.distributed import ctx                        # noqa: E402
from repro_torch.launch import roofline as rl                  # noqa: E402
from repro_torch.launch.mesh import init_fake_group            # noqa: E402

POINTS = [
    (dict(flops=3.0e12, bytes_accessed=4.5e11, coll_bytes=2.0e10,
          coll_by_op={"all-gather": 1.5e10, "all-reduce": 5e9}),
     dict(flops=5.5e12, bytes_accessed=8.0e11, coll_bytes=3.5e10,
          coll_by_op={"all-gather": 2.5e10, "reduce-scatter": 1e10})),
    (dict(flops=1.0e9, bytes_accessed=7.0e12, coll_bytes=0.0, coll_by_op={}),
     dict(flops=1.9e9, bytes_accessed=9.1e12, coll_bytes=4e6,
          coll_by_op={"all-reduce": 4e6})),
]


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_match_reference(arch):
    cfg, rcfg = get_config(arch, production=True), ref_get_config(
        arch, production=True)
    for name, cell in SHAPES.items():
        for chips in (256, 512):
            assert rl.model_flops(cfg, cell, chips) == \
                rrl.model_flops(rcfg, REF_SHAPES[name], chips)


@pytest.mark.parametrize("pair", range(len(POINTS)))
@pytest.mark.parametrize("layers,period", [(40, 1), (62, 6), (26, 3),
                                           (48, 1), (4, 4)])
def test_extrapolate_matches_reference(pair, layers, period):
    a, b = POINTS[pair]
    got = rl.extrapolate(rl.CostPoint(**a), rl.CostPoint(**b), layers,
                         period)
    want = rrl.extrapolate(rrl.CostPoint(**a), rrl.CostPoint(**b), layers,
                           period)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("pair", range(len(POINTS)))
def test_roofline_terms_match_reference(pair, monkeypatch):
    for p in POINTS[pair]:
        own = rrl.roofline_terms(rrl.CostPoint(**p))
        got = rl.roofline_terms(rl.CostPoint(**p))
        for term, port_c, ref_c in (
                ("compute_s", rl.PEAK_FLOPS, rrl.PEAK_FLOPS),
                ("memory_s", rl.HBM_BW, rrl.HBM_BW),
                ("collective_s", rl.LINK_BW, rrl.LINK_BW)):
            assert got[term] == pytest.approx(own[term] * ref_c / port_c,
                                              rel=1e-12)
        with monkeypatch.context() as m:
            m.setattr(rrl, "PEAK_FLOPS", rl.PEAK_FLOPS)
            m.setattr(rrl, "HBM_BW", rl.HBM_BW)
            m.setattr(rrl, "LINK_BW", rl.LINK_BW)
            assert got == rrl.roofline_terms(rrl.CostPoint(**p))


def test_constants_are_the_h100s():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12, 450e9)
    tpu = {197e12, 819e9, 50e9}
    assert not tpu & {rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW}


@pytest.fixture
def fake_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    init_fake_group(4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                             "model"))
    finally:
        tdist.destroy_process_group()


def _dt(mesh, shape, places, dtype=torch.float32):
    """A DTensor of global ``shape`` whose local shard is zeros."""
    from torch.distributed.tensor import DTensor
    local, _ = ctx.shard_extent(shape, mesh, places)
    return DTensor.from_local(torch.zeros(local, dtype=dtype), mesh, places,
                              run_check=False, shape=torch.Size(shape),
                              stride=ctx.contiguous_strides(shape))


def test_collective_bytes_of_a_redistribution(fake_mesh):
    from torch.distributed.tensor import Partial, Replicate, Shard
    x = _dt(fake_mesh, (8, 6), (Shard(0), Replicate()))
    with rl.CostCounter() as c:
        x.redistribute(fake_mesh, (Replicate(), Replicate()))
    # an all-gather over data of the 4 x 6 float32 shard
    assert c.coll_by_op == {"all-gather": 4 * 6 * 4} and c.flops == 0
    y = _dt(fake_mesh, (8, 6), (Shard(0), Partial()), torch.bfloat16)
    with rl.CostCounter() as c:
        y.redistribute(fake_mesh, (Shard(0), Replicate()))
    assert c.coll_by_op == {"all-reduce": 4 * 6 * 2}
    with rl.CostCounter() as c:
        y.redistribute(fake_mesh, (Shard(0), Shard(1)))
    assert c.coll_by_op == {"reduce-scatter": 4 * 6 * 2}
    assert c.point().coll_bytes == 4 * 6 * 2


def test_sharded_einsum_flops_are_local(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    B, S, D, F = 8, 16, 32, 24
    x = _dt(fake_mesh, (B, S, D), (Shard(0), Replicate()))
    w = _dt(fake_mesh, (D, F), (Replicate(), Shard(1)))
    with rl.CostCounter() as c:
        with ctx.use(fake_mesh, {}, ("data",)):
            out = ctx.einsum("bsd,df->bsf", x, w)
    whole = 2 * B * S * D * F
    assert c.flops == whole / 4
    assert c.coll_by_op == {}
    assert tuple(out.to_local().shape) == (B // 2, S, F // 2)
    with FlopCounterMode(display=False) as g:
        torch.einsum("bsd,df->bsf", torch.zeros(B, S, D), torch.zeros(D, F))
    assert g.get_total_flops() == whole
    # a contraction over a sharded dim: the local product and one
    # all-reduce of the local result
    h = _dt(fake_mesh, (B, S, F), (Shard(0), Shard(2)))
    v = _dt(fake_mesh, (F, D), (Replicate(), Shard(0)))
    with rl.CostCounter() as c:
        with ctx.use(fake_mesh, {}, ("data",)):
            ctx.einsum("bsf,fd->bsd", h, v)
    assert c.flops == whole / 4
    assert c.coll_by_op == {"all-reduce": (B // 2) * S * D * 4}
