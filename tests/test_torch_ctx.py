"""The port's activation-sharding context (``repro_torch.distributed.ctx``)
against the reference's ``repro.distributed.ctx``:

* ``constrain``'s parts equal the reference's spec for a grid of mesh
  stand-ins, rule sets (the step builders' overrides), batch axes, the
  model's own logical axes and shapes of every divisibility.  The
  reference's ``P`` is captured by standing recorders in for its
  ``NamedSharding`` and ``jax.lax.with_sharding_constraint``.  Exact.
* ``install`` / ``use`` / ``clear`` keep and restore the state as the
  reference's do, and with no mesh every helper is the plain op (the
  identity for ``constrain`` and ``gather``), bit for bit.
* ``placements``: a spec as DTensor placements (axes of extent 1
  replicated; an axis named twice, or one the mesh lacks, refused).
* four gloo ranks on a ``(2, 2)`` mesh (one spawn): each helper on
  DTensors against the plain op on the whole tensors, values and
  gradients, within 1e-5 of the largest |value| (float32; a partial sum
  over ranks adds in another order), ``gold_logit`` and ``embed`` bit for
  bit (one value and exact zeros).
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402
import torch.distributed as tdist                              # noqa: E402

from repro.distributed import ctx as rctx                      # noqa: E402
from repro.models import common as rcommon                     # noqa: E402
from repro_torch.distributed import ctx                        # noqa: E402
from repro_torch.distributed.pspec import P, placements        # noqa: E402
from repro_torch.distributed.steps import (batch_axes_for,     # noqa: E402
                                           kv_seq_axes)
from repro_torch.models.common import rules_for_mesh           # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
LIMIT_S = 600                   # a hang guard: alone the ranks take ~15 s
TOL = 1e-5


class FakeMesh:
    """Mesh stand-in: shape dict + axis names (no devices needed)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x2": {"data": 2, "model": 2},
    "2x1x2": {"pod": 2, "data": 1, "model": 2},
    "1x4": {"data": 1, "model": 4},
    "4x1": {"data": 4, "model": 1},
}

# every logical-axis tuple the port's models constrain with, and a few
# that exercise the used-axis and extent rules
AXES = [
    ("batch", None, "act_embed"), ("batch", None, "heads", None),
    ("batch", "heads", None, None), ("batch", None, "mlp"),
    ("batch", "experts", None, None), ("batch", None, None),
    ("batch", None, "vocab"), ("batch", None, None, None, "ssm_heads"),
    ("batch", None, "ssm_heads", None), ("batch", None, "rec"),
    ("batch", "kv_seq", None, None), ("batch", "kv_seq", "kv_heads", None),
    ("embed", "mlp"), ("vocab", "embed"), ("heads", "heads"),
    ("batch", "batch"), (None, "embed", "act_embed"), ("layers", "seq"),
]
SIZES = (1, 2, 3, 4, 8, 16, 32, 48, 256, 4096)


def _rule_sets(mesh):
    """The rules each step builder installs (the reference's overrides)."""
    base = rules_for_mesh(mesh)
    out = {"base": base, "no_fsdp": dict(base, embed=None),
           "moe_gather": dict(base, experts=None)}
    for b in (1, 128):
        dec = dict(base, kv_seq=tuple(kv_seq_axes(mesh, b)))
        if "data" not in batch_axes_for(mesh, b):
            dec["act_embed"] = "data"
        out[f"decode_b{b}"] = dec
    return out


@pytest.fixture
def ref_recorder(monkeypatch):
    """The reference's constrain returning the spec it would pin."""
    monkeypatch.setattr(rctx, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    yield
    rctx.clear()


@pytest.mark.parametrize("rules_name", ["base", "no_fsdp", "moe_gather",
                                        "decode_b1", "decode_b128"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_constrain_parts_match_reference(ref_recorder, mesh_name,
                                         rules_name):
    mesh = FakeMesh(MESHES[mesh_name])
    rules = _rule_sets(mesh)[rules_name]
    assert rules_for_mesh(mesh) == rcommon.rules_for_mesh(mesh)
    rng = np.random.default_rng(0)
    n = 0
    for batch in (1, 2, 4, 32, 256):
        b_axes = batch_axes_for(mesh, batch)
        rctx.install(mesh, rules, b_axes)
        for axes in AXES:
            for _ in range(6):
                shape = tuple(int(rng.choice(SIZES)) for _ in axes)
                want = rctx.constrain(types.SimpleNamespace(shape=shape),
                                      *axes)
                got = ctx.constrain_parts(shape, axes, mesh, rules, b_axes)
                assert got == tuple(want), (shape, axes, b_axes, got, want)
                n += 1
        rctx.clear()
    assert n == 5 * len(AXES) * 6


def test_install_use_clear():
    mesh = FakeMesh(MESHES["2x2"])
    rules = rules_for_mesh(mesh)
    assert ctx.mesh() is None and ctx.batch_axes() == ()
    with ctx.use(mesh, rules, ["data"]):
        assert ctx.mesh() is mesh and ctx.batch_axes() == ("data",)
        inner = FakeMesh(MESHES["1x4"])
        with ctx.use(inner, rules_for_mesh(inner), ()):
            assert ctx.mesh() is inner and ctx.batch_axes() == ()
        assert ctx.mesh() is mesh
        with ctx.suspended():
            assert ctx.mesh() is None
        assert ctx.mesh() is mesh
    assert ctx.mesh() is None
    ctx.install(mesh, rules, ("data",))
    assert ctx._STATE == {"mesh": mesh, "rules": rules,
                          "batch_axes": ("data",)}
    assert ctx._STATE["rules"] is not rules          # a copy, as the ref's
    ctx.clear()
    assert ctx._STATE == {"mesh": None, "rules": None, "batch_axes": None}
    # a failure inside restores the state too
    with pytest.raises(RuntimeError):
        with ctx.use(mesh, rules, ()):
            raise RuntimeError("inside")
    assert ctx.mesh() is None


def test_helpers_are_the_plain_ops_with_no_mesh():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 8, generator=g)
    w = torch.randn(8, 6, generator=g)
    assert ctx.constrain(x, "batch", None, "act_embed") is x
    tree = {"a": x, "b": [w]}
    assert ctx.gather(tree) is tree
    assert torch.equal(ctx.einsum("bsd,df->bsf", x, w),
                       torch.einsum("bsd,df->bsf", x, w))
    tok = torch.randint(0, 6, (2, 5), generator=g, dtype=torch.int32)
    emb = torch.randn(6, 8, generator=g)
    assert torch.equal(ctx.embed(tok, emb),
                       torch.nn.functional.embedding(tok, emb))
    assert torch.equal(ctx.logsumexp(x), torch.logsumexp(x, dim=-1))
    tgt = torch.randint(0, 8, (2, 5), generator=g)
    assert torch.equal(ctx.gold_logit(x, tgt),
                       torch.gather(x, -1, tgt[..., None])[..., 0])
    assert torch.equal(ctx.local_op(torch.sort, x, work_dims=[(2,)])[0],
                       torch.sort(x)[0])
    cache = torch.zeros(2, 7, 8)
    ctx.write_seq(cache, x[:, :3], 2)
    assert torch.equal(cache[:, 2:5], x[:, :3]) and not cache[:, :2].any() \
        and not cache[:, 5:].any()
    assert ctx.full(x) is x


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh(MESHES["2x1x2"])
    R = Replicate()
    assert placements(P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), R, Shard(2))                 # data has extent 1
    assert placements(P(None, ("model", "pod")), mesh) == \
        (Shard(1), R, Shard(1))
    assert placements(P(), mesh) == (R, R, R)
    with pytest.raises(ValueError, match="twice"):
        placements(P("model", "model"), mesh)
    with pytest.raises(ValueError, match="lacks"):
        placements(P("expert"), mesh)


# one rank of the (2, 2) group: every helper on DTensors against the plain
# op on whole tensors; the largest errors to a file
WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.nn.functional as F
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.distributed import ctx
from repro_torch.distributed.pspec import P, placements
from repro_torch.launch.mesh import init_group, make_host_mesh
from repro_torch.models.common import rules_for_mesh

rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
store = dist.TCPStore("127.0.0.1", port, 4, is_master=False)
init_group("cpu", rank=rank, world_size=4, store=store)
mesh = make_host_mesh(2, 2, device="cpu")
g = torch.Generator().manual_seed(0)
err = {}


def place(t, *parts):
    return distribute_tensor(t, mesh, placements(P(*parts), mesh),
                             src_data_rank=None)


def rel(a, b):
    a, b = ctx.full(a).double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def grads(fn_mesh, fn_plain, *whole, parts):
    # values and gradients of sum(out * seeded weights) on both sides
    leaves = [w.clone().requires_grad_(True) for w in whole]
    ref = fn_plain(*leaves)
    wt = torch.randn(ref.shape, generator=torch.Generator().manual_seed(9))
    (ref * wt).sum().backward()
    dl = [place(w.detach(), *p).requires_grad_(True)
          for w, p in zip(whole, parts)]
    with ctx.use(mesh, rules_for_mesh(mesh), ("data",)):
        got = fn_mesh(*dl)
        (got * wt).sum().backward()
    return [rel(got, ref)] + [rel(d.grad, l.grad) for d, l in zip(dl, leaves)]


x = torch.randn(4, 6, 8, generator=g)
w = torch.randn(8, 12, generator=g)
err["einsum_free"] = grads(lambda a, b: ctx.einsum("bsd,df->bsf", a, b),
                           lambda a, b: torch.einsum("bsd,df->bsf", a, b),
                           x, w, parts=[("data", None, None),
                                        (None, "model")])
err["einsum_contract"] = grads(
    lambda a, b: ctx.einsum("bsf,fd->bsd", a, b),
    lambda a, b: torch.einsum("bsf,fd->bsd", a, b),
    torch.randn(4, 6, 12, generator=g), torch.randn(12, 8, generator=g),
    parts=[("data", None, "model"), ("model", None)])
err["einsum_conflict"] = grads(
    lambda a, b: ctx.einsum("bsd,df->bsf", a, b),
    lambda a, b: torch.einsum("bsd,df->bsf", a, b),
    x, w, parts=[("data", None, "model"), ("data", "model")])
logits = torch.randn(4, 6, 16, generator=g)
err["logsumexp"] = grads(ctx.logsumexp,
                         lambda a: torch.logsumexp(a, dim=-1), logits,
                         parts=[("data", None, "model")])
tgt = torch.randint(0, 16, (4, 6), generator=g)
err["gold_logit"] = grads(
    lambda a: ctx.gold_logit(a, place(tgt, "data", None)),
    lambda a: torch.gather(a, -1, tgt[..., None])[..., 0], logits,
    parts=[("data", None, "model")])
tok = torch.randint(0, 16, (4, 6), generator=g, dtype=torch.int32)
emb = torch.randn(16, 8, generator=g)
err["embed"] = grads(lambda e: ctx.embed(place(tok, "data", None), e),
                     lambda e: F.embedding(tok, e), emb,
                     parts=[("model", None)])
err["embed_feature_sharded"] = grads(
    lambda e: ctx.embed(place(tok, None, None), e),
    lambda e: F.embedding(tok, e), emb, parts=[("model", "data")])
err["constrain"] = grads(
    lambda a: ctx.constrain(a * 2.0, "batch", None, "act_embed"),
    lambda a: a * 2.0, x, parts=[("data", None, "model")])
err["gather"] = grads(lambda b: ctx.einsum("bsd,df->bsf",
                                           place(x, "data", None, None),
                                           ctx.gather(b)),
                      lambda b: torch.einsum("bsd,df->bsf", x, b), w,
                      parts=[("data", "model")])
err["local_op"] = grads(
    lambda a: ctx.local_op(lambda t: torch.sort(t, dim=-1)[0], a,
                           work_dims=[(2,)]),
    lambda a: torch.sort(a, dim=-1)[0], x, parts=[("data", None, "model")])
cache, blk = torch.zeros(4, 10, 3), torch.randn(4, 5, 3, generator=g)
want = cache.clone()
want[:, 3:8] = blk
dc = place(cache, "data", "model", None)
with ctx.use(mesh, rules_for_mesh(mesh), ("data",)):
    ctx.write_seq(dc, place(blk, "data", None, None), 3)
err["write_seq"] = [rel(dc, want)]
# exact: one value and zeros summed over the vocab shards
with ctx.use(mesh, rules_for_mesh(mesh), ("data",)):
    gl = ctx.gold_logit(place(logits, "data", None, "model"),
                        place(tgt, "data", None))
    em = ctx.embed(place(tok, "data", None), place(emb, "model", None))
err["exact"] = [float(not torch.equal(ctx.full(gl), torch.gather(
                    logits, -1, tgt[..., None])[..., 0])),
                float(not torch.equal(ctx.full(em), F.embedding(tok, emb)))]
if rank == 0:
    np.savez(out + "/ctx.npz", **{k: np.array(v) for k, v in err.items()})
dist.destroy_process_group()
"""
CHECKS = ("einsum_free", "einsum_contract", "einsum_conflict", "logsumexp",
          "gold_logit", "embed", "embed_feature_sharded", "constrain",
          "gather", "local_op", "write_seq")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ctx")
    store = tdist.TCPStore("127.0.0.1", 0, None, True,
                           wait_for_workers=False)
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}"
               f"{os.environ.get('PYTHONPATH', '')}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(store.port), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=LIMIT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    return dict(np.load(out / "ctx.npz"))


@pytest.mark.parametrize("check", CHECKS)
def test_helper_on_dtensors_equals_plain_op(four_ranks, check):
    errs = four_ranks[check]
    assert errs.size >= 1 and (errs <= TOL).all(), (check, errs)


def test_gold_logit_and_embed_are_exact_on_shards(four_ranks):
    assert four_ranks["exact"].tolist() == [0.0, 0.0]
