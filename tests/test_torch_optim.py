"""The port's AdamW and LR schedules (``repro_torch.optim``) against the
reference's (``repro.optim``) on the CPU, plus the counterparts of
``tests/test_substrates.py``'s optimizer tests.

Inputs are numpy from ``default_rng`` carried to both sides.  XLA:CPU
contracts ``a*b + c`` into fused multiply-adds and sums a leaf in another
order than torch, so equality is not bitwise.  Tolerances:

* every new parameter, ``mu`` and ``nu`` leaf within ``F32_TOL = 16 ·
  2^-24`` (about 1e-6) of the leaf's largest |value|, normwise; the worst
  seen is 12 · 2^-24, for ``nu`` when clipping binds on bf16 gradients
  (the clip scale carries the global norm's summation order into g²);
* bf16 parameters within one bf16 rounding (2^-8) of the largest |value|
  (seen: equal);
* the global norm within 1e-6 relative (seen: 3.2e-7); ``count`` equal;
* the schedules within 4 · 2^-24 · peak_lr (seen: 2 ulp at 3 of 106
  steps, XLA's and torch's float32 cosines).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.optim import adamw_update as ref_adamw_update       # noqa: E402
from repro.optim.adamw import OptState as RefOptState          # noqa: E402
from repro.optim.schedule import (cosine_schedule as ref_cosine,  # noqa: E402
                                  wsd_schedule as ref_wsd)
from repro_torch.models.common import tree_paths               # noqa: E402
from repro_torch.optim import (OptState, adamw_init,           # noqa: E402
                               adamw_update, global_norm)
from repro_torch.optim.schedule import (cosine_schedule,       # noqa: E402
                                        wsd_schedule)

F32_TOL = 16 * 2.0 ** -24
BF16_TOL = 2.0 ** -8
SHAPES = {"a": (64, 33), "b": [(17,), (5, 4, 3)], "c": {"d": (128,)}}


def _tree(fn):
    return {"a": fn(SHAPES["a"]), "b": [fn(s) for s in SHAPES["b"]],
            "c": {"d": fn(SHAPES["c"]["d"])}}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


def _normwise(got, want, tol, what):
    g, w = dict(tree_paths(got)), dict(tree_paths(want))
    assert set(g) == set(w), what
    for path in w:
        a, b = _np(g[path]), _np(w[path])
        assert a.shape == b.shape, (what, path)
        err = np.abs(a - b).max()
        assert err <= tol * np.abs(b).max(), \
            f"{what}{path}: {err:.3e} > {tol:.3e} * {np.abs(b).max():.3e}"


@pytest.mark.parametrize("count", [0, 6])
@pytest.mark.parametrize("clip", ["binds", "free"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, clip, count):
    """One update on the same parameters, gradients and moments; ``count``
    goes to 1 and 7; gradients of global norm ~480 (clip 1.0 binds) or
    ~0.05 (it does not)."""
    rng = np.random.default_rng([count, len(clip), len(dtype)])
    gscale = 10.0 if clip == "binds" else 1e-3
    p = _tree(lambda s: rng.normal(size=s).astype(np.float32))
    g = _tree(lambda s: (rng.normal(size=s) * gscale).astype(np.float32))
    mu = _tree(lambda s: (rng.normal(size=s) * 0.01).astype(np.float32))
    nu = _tree(lambda s: (rng.uniform(size=s) * 1e-4).astype(np.float32))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p)
    rg = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), g)
    rs = RefOptState(mu=jax.tree.map(jnp.asarray, mu),
                     nu=jax.tree.map(jnp.asarray, nu), count=jnp.int32(count))
    rp2, rs2, rgn = jax.jit(
        lambda g_, s_, p_: ref_adamw_update(g_, s_, p_, lr=1e-2))(rg, rs, rp)

    def carry(tree, d):   # the reference's (rounded) values, as tensors
        return jax.tree.map(
            lambda a: torch.from_numpy(_np(a).copy()).to(d), tree)

    tp, tg = carry(rp, tdt), carry(rg, tdt)
    ts = OptState(mu=carry(rs.mu, torch.float32),
                  nu=carry(rs.nu, torch.float32),
                  count=torch.tensor(count, dtype=torch.int32))
    before = {k: _np(v).copy() for k, v in tree_paths(tp)}
    tp2, ts2, tgn = adamw_update(tg, ts, tp, lr=1e-2)

    assert (float(rgn) > 1.0) == (clip == "binds")
    np.testing.assert_allclose(float(tgn), float(rgn), rtol=1e-6)
    assert ts2.count.dtype == torch.int32 and ts2.count.shape == ()
    assert int(ts2.count) == int(rs2.count) == count + 1
    _normwise(tp2, rp2, F32_TOL if dtype == "float32" else BF16_TOL,
              "params")
    _normwise(ts2.mu, rs2.mu, F32_TOL, "mu")
    _normwise(ts2.nu, rs2.nu, F32_TOL, "nu")
    for path, leaf in tree_paths(tp2):
        assert leaf.dtype == tdt, path
    for path, leaf in tree_paths((ts2.mu, ts2.nu)):
        assert leaf.dtype == torch.float32, path
    # new tensors: the inputs are left as they were
    for path, leaf in tree_paths(tp):
        np.testing.assert_array_equal(_np(leaf), before[path])
    assert int(ts.count) == count


def test_adamw_init_moments_are_float32():
    params = {"w": torch.zeros((3, 2), dtype=torch.bfloat16),
              "l": [torch.zeros(4)]}
    st = adamw_init(params)
    assert st.count.dtype == torch.int32 and int(st.count) == 0
    for path, leaf in tree_paths((st.mu, st.nu)):
        assert leaf.dtype == torch.float32 and not leaf.any(), path
    assert st.mu["w"].shape == (3, 2) and st.nu["l"][0].shape == (4,)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    tree = _tree(lambda s: rng.normal(size=s).astype(np.float32))
    want = float(jax.jit(lambda t: jnp.sqrt(sum(
        jnp.sum(jnp.square(x)) for x in jax.tree.leaves(t))))(tree))
    got = global_norm(jax.tree.map(torch.from_numpy, tree))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(200):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(((w - target) ** 2).sum(), [w])
        params, opt, _ = adamw_update({"w": g}, opt, params, lr=5e-2,
                                      weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)


def test_schedules():
    s = np.array([float(cosine_schedule(torch.tensor(i, dtype=torch.int32),
                                        peak_lr=1.0, warmup=10, total=100))
                  for i in (0, 5, 10, 100)])
    assert s[0] == 0 and abs(s[2] - 1.0) < 1e-6 and s[3] < 0.2
    w = wsd_schedule(torch.tensor(50, dtype=torch.int32), peak_lr=1.0,
                     warmup=10, total=100)
    assert abs(float(w) - 1.0) < 1e-6


@pytest.mark.parametrize("kind,kw", [
    ("cosine", dict(peak_lr=1.0, warmup=10, total=100)),
    ("cosine", dict(peak_lr=3e-4, warmup=7, total=50, final_frac=0.05)),
    ("wsd", dict(peak_lr=1.0, warmup=10, total=100)),
    ("wsd", dict(peak_lr=3e-4, warmup=0, total=50, decay_frac=0.3)),
])
def test_schedules_match_reference(kind, kw):
    """Every step 0 … total + 5, float32 on both sides."""
    ref, port = {"cosine": (ref_cosine, cosine_schedule),
                 "wsd": (ref_wsd, wsd_schedule)}[kind]
    steps = np.arange(kw["total"] + 6, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: ref(s, **kw))(steps))
    got = port(torch.from_numpy(steps), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4 * 2.0 ** -24 * kw["peak_lr"])
    one = [float(port(int(s), **kw)) for s in steps[::7]]
    np.testing.assert_array_equal(one, got.numpy()[::7])
