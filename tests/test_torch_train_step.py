"""One train step of the port (``repro_torch.distributed.steps
.make_train_step``) against the reference's on the CPU, for the
attention archs' smoke configs (the recurrent, MoE and encoder-decoder
ones are in ``test_torch_train_step_mixers.py``); ``make_prefill`` /
``make_decode_step`` against the reference's on qwen3-14b's; and
``make_abstract_inputs`` against the reference's ``ShapeDtypeStruct``s
for every arch's production config.

One step: B = 4, S = 32, ``grad_accum`` 2 (two microbatches), lr 1e-3,
the reference's float32 parameters from ``jax.random.key(0)`` carried
across, the moments from ``adamw_init`` carried by
``convert.opt_state_from_numpy``, the batch ``SyntheticTokens(vocab, 32,
4, seed=1).batch_at(0)``.  Tolerances: ``tests/train_parity.py`` (loss,
ce, aux 1e-6 relative; gnorm 2e-4; every parameter and moment within
1e-3 of its tree's largest |value|, each parameter within 2.1 lr).
Prefill and decode: logits within 1e-3 of the largest, the bf16 caches
within one bf16 rounding (2^-8) of the largest.  Abstract inputs: shape
and dtype of every leaf equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.configs import get_config as ref_get_config         # noqa: E402
from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES          # noqa: E402
from repro.configs.shapes import ShapeCell as RefShapeCell     # noqa: E402
from repro.distributed import steps as rsteps                  # noqa: E402
from repro.launch.mesh import make_host_mesh                   # noqa: E402
from repro_torch.configs import (get_config, get_smoke_config,  # noqa: E402
                                 list_archs)
from repro_torch.configs.shapes import SHAPES, ShapeCell       # noqa: E402
from repro_torch.distributed.steps import (                    # noqa: E402
    _accum_factor, make_abstract_inputs, make_decode_step, make_prefill)
from repro_torch.models.common import tree_paths               # noqa: E402
from repro_torch.models.convert import caches_from_numpy       # noqa: E402

from lm_parity import assert_close, ref_params, t              # noqa: E402
from train_parity import check_step, step_both                 # noqa: E402

ATTN_ARCHS = ("qwen1.5-4b", "qwen3-14b", "phi3-medium-14b", "gemma3-27b",
              "chameleon-34b")


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_train_step_matches_reference(arch):
    ref, port, before = step_both(arch)
    check_step(arch, ref, port, before)


def test_accum_factor_follows_reference_loop():
    """The largest divisor of the global batch not above grad_accum."""
    for gb, accum, want in ((4, 2, 2), (6, 4, 3), (7, 4, 1), (256, 8, 8),
                            (12, 5, 4), (1, 8, 1)):
        assert _accum_factor(None, gb, accum) == want


def test_prefill_and_decode_step_match_reference():
    arch = "qwen3-14b"
    cfg, pcfg = ref_smoke_config(arch), get_smoke_config(arch)
    rp, pp = ref_params(cfg, pcfg, 3)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 17)).astype(np.int32)
    mesh = make_host_mesh(1, 1)
    fn, in_sh, out_sh = rsteps.make_prefill(
        cfg, mesh, RefShapeCell("p", "prefill", 32, 2))
    rlog, rcache = jax.jit(fn, in_shardings=in_sh,
                           out_shardings=out_sh)(rp, tokens[:, :16])
    plog, pcache = make_prefill(pcfg, None, ShapeCell("p", "prefill", 32, 2))(
        pp, t(tokens[:, :16]))
    assert_close(plog, rlog, 1e-3, "prefill logits")
    rc, pc = dict(tree_paths(jax.tree.map(np.asarray, rcache))), \
        dict(tree_paths(pcache))
    assert set(rc) == set(pc)
    for path, a in rc.items():
        assert str(pc[path].dtype) == f"torch.{a.dtype}", path
        assert_close(pc[path].float(), a.astype(np.float32), 2.0 ** -8,
                     f"cache{path}")
    dfn, din, dout = rsteps.make_decode_step(
        cfg, mesh, RefShapeCell("d", "decode", 32, 2))
    rstep, _ = jax.jit(dfn, in_shardings=din, out_shardings=dout)(
        rp, rcache, tokens[:, 16:], jnp.int32(16))
    # the port decodes from the reference's caches
    caches = caches_from_numpy(jax.tree.map(np.asarray, rcache), pcfg, 2, 32,
                               device="cpu")
    pstep, _ = make_decode_step(pcfg, None, ShapeCell("d", "decode", 32, 2))(
        pp, caches, t(tokens[:, 16:]), 16)
    assert_close(pstep, rstep, 1e-3, "decode logits")


def _meta_leaves(tree):
    return [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for _, a in tree_paths(tree)]


def _ref_leaves(tree):
    return [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("cellname", ["train_4k", "prefill_32k",
                                      "decode_32k"])
def test_abstract_inputs_match_reference(cellname):
    """bf16 parameters, float32 moments and an int32 count (train), bf16
    decode caches (decode): every arch's production config, leaf for
    leaf in flatten order, on ``meta`` (nothing allocated)."""
    for arch in list_archs():
        cfg = get_config(arch, production=True)
        got = make_abstract_inputs(cfg, None, SHAPES[cellname])
        want = rsteps.make_abstract_inputs(
            ref_get_config(arch, production=True), None, REF_SHAPES[cellname])
        assert len(got) == len(want)
        assert _meta_leaves(got) == _ref_leaves(want), arch
        assert all(a.device.type == "meta" for _, a in tree_paths(got))
