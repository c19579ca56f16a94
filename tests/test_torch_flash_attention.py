"""Port parity of ``flash_attention`` on CPU tensors (its plain version)
against the reference's oracle ``repro.kernels.ref.flash_attention_ref``
on the same numpy inputs.  The reference's Pallas kernel is not the
oracle: it calls ``pl.load``, which the installed jax no longer has.

Tolerances:

* float32: the reference's own test of its kernel against the oracle,
  ``rtol = atol = 2e-4``.  The online softmax sums the same terms in
  another order than the oracle's one-pass softmax.
* bfloat16: both sides compute in float32 from the same bf16 inputs and
  round the result to bf16 once, so two results that differ in float32
  by a few ulps may round to neighbouring bf16 values: one bf16 step is
  at most ``2**-7`` of the value (8 bits of mantissa), and ``atol =
  1e-2`` covers the outputs near zero, where ``2**-7`` of the value is
  no larger than the float32 difference itself.
* the float64 reference of the bf16 kernel's numerics
  (``flash_attention_bf16_reference``, which rounds P to bf16): against
  the oracle, the bound derived from that rounding (P's rounding moves an
  output by at most ``u max|v|``, u = 2**-8, as the weights p / l sum to
  1; each side's output rounding by ``u |o|``; the fp32 sums by ``(S + d)
  2**-24 max|v|``).  Its own bound is held against an fp32 emulation of
  the kernel's steps, which must pass, and against the same emulation
  with one middle KV tile left out, which must fail on every long row.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax.numpy as jnp                                        # noqa: E402

from repro.kernels import ref as kref                          # noqa: E402
from repro_torch.kernels import flash_attention as tfa         # noqa: E402


def _qkv(B, H, S, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, S, d)).astype(np.float32)
            for _ in range(3)]


def _oracle(q, k, v, causal, dtype=jnp.float32):
    out = kref.flash_attention_ref(*(jnp.asarray(a).astype(dtype)
                                     for a in (q, k, v)), causal=causal)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("B,H,S,d,causal", [
    (1, 2, 128, 32, True), (2, 1, 256, 64, True), (1, 1, 128, 32, False)])
def test_flash_attention_matches_ref(B, H, S, d, causal):
    # the shapes and seeds of the reference's own kernel test
    q, k, v = _qkv(B, H, S, d, B * 10 + S)
    out = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, q_tile=64, block_k=64)
    assert out.dtype == torch.float32 and out.shape == (B, H, S, d)
    np.testing.assert_allclose(out.numpy(), _oracle(q, k, v, causal),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_tile,block_k", [(128, 64), (64, 128)])
def test_flash_attention_tiles_differ(q_tile, block_k, causal):
    """q tiles larger and smaller than kv tiles: the Pallas kernel's causal
    tile bound ``ceil((q0 + q_tile) / block_k)`` is not a multiple of one
    tile either way."""
    q, k, v = _qkv(2, 2, 256, 32, 7)
    out = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, q_tile=q_tile, block_k=block_k)
    np.testing.assert_allclose(out.numpy(), _oracle(q, k, v, causal),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("q_tile,block_k", [(64, 64), (128, 64), (64, 128)])
def test_flash_attention_plain_tile_skip_is_exact(q_tile, block_k):
    """The Pallas kernel stops a q tile's KV loop at the causal bound
    ``ceil((q0 + q_tile) / block_k)``; the plain version runs every tile.
    A tile fully masked for a row leaves the row's running softmax
    unchanged bit for bit, so the plain version over the sequence cut at
    that bound gives the q tile's rows exactly as over the whole one."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 384, 32, 5))
    S = q.shape[2]
    full = tfa.flash_attention_plain(q, k, v, causal=True, block_k=block_k)
    for q0 in range(0, S, q_tile):
        end = min(S // block_k, -(-(q0 + q_tile) // block_k)) * block_k
        cut = tfa.flash_attention_plain(
            *(t[:, :, :end].contiguous() for t in (q, k, v)), causal=True,
            block_k=block_k)
        assert torch.equal(cut[:, :, q0:q0 + q_tile],
                           full[:, :, q0:q0 + q_tile])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16(causal):
    q, k, v = _qkv(1, 2, 256, 64, 3)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = tfa.flash_attention(qb, kb, vb, causal=causal, q_tile=64,
                              block_k=128)
    assert out.dtype == torch.bfloat16
    # the oracle on the same bf16 values (exact in float32, then cast)
    want = _oracle(*(t.float().numpy() for t in (qb, kb, vb)), causal,
                   dtype=jnp.bfloat16)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-2)


@pytest.mark.parametrize("shape,q_tile,block_k", [
    ((1, 1, 96, 32), 64, 32),            # S % q_tile
    ((1, 1, 96, 32), 32, 64),            # S % block_k
])
def test_flash_attention_rejects_untiled_s(shape, q_tile, block_k):
    q = torch.zeros(shape)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, q_tile=q_tile, block_k=block_k)


def test_flash_attention_rejects_other_kv_length():
    q = torch.zeros((1, 1, 128, 32))
    kv = torch.zeros((1, 1, 64, 32))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, kv, kv, q_tile=64, block_k=64)


def test_flash_attention_rejects_other_devices():
    """Only a CPU tensor takes the plain version; a tensor elsewhere that is
    not CUDA raises instead of falling back."""
    q = torch.zeros((1, 1, 64, 32), device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, q_tile=64, block_k=64)


def _emulate_bf16_kernel(q, k, v, causal, drop=None):
    """The bf16 kernel's steps in float32 on the CPU (fp32 scores times the
    fp32 constant scale·log2(e), KV tiles of 64 with a running maximum,
    exp2, P rounded to bf16 for P·V, l from the fp32 P, ``acc · (1/l)``
    rounded to bf16); ``drop`` leaves one KV tile out."""
    B, H, S, d = q.shape
    T = tfa.KV_TILE
    qf, kf, vf = q.float(), k.float(), v.float()
    c = (torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
         * torch.tensor(np.log2(np.e), dtype=torch.float32))
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, d))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, T):
        if k0 // T == drop:
            continue
        x = (qf @ kf[:, :, k0:k0 + T].transpose(-1, -2)) * c
        cols = k0 + torch.arange(x.shape[-1])[None, :]
        keep = (cols <= rows) if causal else torch.ones_like(cols, dtype=bool)
        x = torch.where(keep, x, torch.tensor(-1e30))
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = alpha * l + p.sum(-1)
        acc = (acc * alpha[..., None]
               + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + T])
        m = m_new
    return (acc * (1.0 / l)[..., None]).to(torch.bfloat16)


def _bf16_qkv(S, d, seed):
    return [torch.from_numpy(a).to(torch.bfloat16)
            for a in _qkv(1, 2, S, d, seed)]


@pytest.mark.parametrize("S,d,causal", [(1024, 64, True), (1024, 128, False),
                                        (200, 256, True), (600, 32, False)])
def test_bf16_reference_bound_holds_for_kernel_steps(S, d, causal):
    q, k, v = _bf16_qkv(S, d, S + d)
    o, slack = tfa.flash_attention_bf16_reference(q, k, v, causal=causal)
    got = _emulate_bf16_kernel(q, k, v, causal).double()
    assert bool(((got - o).abs() <= 2.0 ** -8 * got.abs() + slack).all())
    assert bool((slack >= 0).all()) and bool(torch.isfinite(slack).all())


@pytest.mark.parametrize("d,causal", [(64, True), (128, False)])
def test_bf16_reference_bound_catches_a_dropped_tile(d, causal):
    """One middle KV tile of 64 left out of 16 is caught on every row of
    the last quarter (the rows whose softmax spreads widest)."""
    S = 1024
    q, k, v = _bf16_qkv(S, d, d)
    o, slack = tfa.flash_attention_bf16_reference(q, k, v, causal=causal)
    got = _emulate_bf16_kernel(q, k, v, causal, drop=8).double()
    bad = (got - o).abs() > 2.0 ** -8 * got.abs() + slack
    assert bool(bad[..., 3 * S // 4:, :].any(dim=-1).all())


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_reference_matches_ref(causal):
    """The float64 reference of the bf16 kernel against the oracle on the
    same bf16 values, within the bound derived from rounding P."""
    S, d = 256, 64
    qb, kb, vb = _bf16_qkv(S, d, 5)
    o, _ = tfa.flash_attention_bf16_reference(qb, kb, vb, causal=causal)
    want = _oracle(*(t.float().numpy() for t in (qb, kb, vb)), causal)
    u = 2.0 ** -8
    vmax = vb.float().abs().amax(dim=(-2, -1), keepdim=True).numpy()
    tol = u * (np.abs(o.numpy()) + np.abs(want)) \
        + (u + (S + d) * 2.0 ** -24) * vmax
    assert bool((np.abs(o.numpy() - want) <= tol).all())
