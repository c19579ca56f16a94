"""Flash attention (forward): the CUDA kernel, its wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_kernel``).  The kernel source is
``csrc/flash_attention.cu``: bfloat16 inputs run on the tensor cores
(``wgmma``, K and V staged by TMA, P rounded to bf16 for the P·V
product, as ``scaled_dot_product_attention`` rounds it), float32 inputs
on fp32 FMAs.  A CPU tensor takes the plain version, a CUDA tensor the
kernel (or an error); nothing falls back.

The function is blocked online-softmax attention over ``[B, H, S, d]``
with the same S for q and kv, ``scale = 1/sqrt(d)`` and, when causal,
the mask ``col <= row`` on global indices with masked scores set to
``-1e30``.  The result is in ``q.dtype``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import runtime

NAME = "flash_attention"
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)      # head widths the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          block_k: int = 128) -> torch.Tensor:
    """What the reference's Pallas ``_kernel`` computes, for all q rows at
    once: q cast to float32 and multiplied by ``scale``, k and v cast to
    float32, then a loop over KV tiles of ``block_k`` with a running
    ``(m, l, acc)`` online softmax (``m`` starts at ``NEG_INF``), causal
    scores ``cols <= rows`` kept and the rest set to ``NEG_INF``, and
    ``acc / max(l, 1e-30)`` cast to ``q.dtype``.

    Every KV tile is processed, including those the kernel's causal tile
    skip leaves out.  That changes nothing: a tile fully masked for a row
    has ``max(s) = NEG_INF`` below the row's ``m`` (its first tile holds
    column 0, which no row masks), so ``m_new = m``, ``alpha = exp(0) = 1``
    and ``p = exp(NEG_INF - m) = 0``, and the row's ``(m, l, acc)`` come
    out of the tile unchanged bit for bit."""
    B, H, S, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qs = q.float() * scale
    kf, vf = k.float(), v.float()
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, d), dtype=torch.float32, device=q.device)
    rows = torch.arange(S, device=q.device)[:, None]
    for k0 in range(0, S, block_k):
        s = qs @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)
        if causal:
            cols = k0 + torch.arange(s.shape[-1], device=q.device)[None, :]
            s = torch.where(cols <= rows, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ vf[:, :, k0:k0 + block_k]
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


KV_TILE = 64        # the bf16 kernel's KV tile (kTk in the CUDA source)


def flash_attention_bf16_reference(q, k, v, *, causal: bool = True):
    """The bf16 kernel's stated numerics in float64, with the slack its
    fp32 steps may add: ``(o, slack)``, both float64 ``[B, H, S, d]``, such
    that the kernel's bf16 output ``got`` on the same inputs satisfies,
    elementwise,

        |got - o| <= u |got| + slack,   u = 2**-8 (bf16 unit roundoff).

    ``o`` takes the kernel's steps exactly: scores ``t = scale log2(e)
    q.k`` (log2 domain), KV tiles of ``KV_TILE`` in order, each row's
    running maximum ``M_j`` over its kept columns of tiles ``<= j``,
    ``p = 2**(t - M_j)`` rounded to float32 and then to bf16 for the P·V
    product, the row sum ``l`` of the unrounded ``p``, both rescaled to
    the row's final maximum, and ``o = Σ bf16(p)·2**(M_j - M_T) v / l``.

    ``slack`` bounds what the kernel's float32 arithmetic adds, per row of
    ``n`` kept KV tiles (the causal tile skip's count), to first order:

    * its scores: each an fp32 sum of d exact bf16 products, within
      ``d 2**-23 Σ_i |q_i k_i|`` (one rounding per addition, truncating
      or not), times ``scale log2(e)``, rounded with its constant:
      ``e_c = scale log2(e) d 2**-23 A_c + 2**-22 |t_c|``, ``A = |q| |k|ᵀ``;
      ``E`` is the row's largest ``e_c``, and its running maxima are off
      by at most ``E``;
    * ``p_c = ex2.approx(x_c - m)``: the exponent is off by at most
      ``e_c + E + 2**-23 max|t|`` (the subtraction's rounding), and
      ex2.approx is within 2 ulp of the rounded result, so ``p_c`` is
      within a relative ``eta = 2**(that) - 1 + 2.5 2**-23`` of ``o``'s;
    * bf16(p_c) is the same on both sides unless ``[p_c (1 - eta),
      p_c (1 + eta)]`` holds a rounding boundary; then the two differ by at
      most the band's width ``hi_c - lo_c`` (``lo_c`` 0 where the band
      reaches below float32's normal range: ex2.approx.ftz flushes):
      ``F = Σ_c (hi_c - lo_c) 2**(M_j - M_T) |v_c| / l``;
    * the products bf16(p)·v are exact in fp32; ``acc`` takes at most
      ``64 + 5 n`` roundings per term (its tile's four k16 steps, then per
      later tile one rescale and four steps), ``l`` at most ``19 + n``
      (16 in the thread's partial sum, the per-tile fused multiply-add,
      two shuffles); each rescale factor ``alpha = ex2.approx(m_old -
      m_new)`` is within ``2.5 2**-23 + 2**-23 max|t|`` and applies to
      ``acc`` and ``l`` alike, so it only reweights the tiles;
    * the output ``acc · (1/l)``: two roundings.

    With ``W = Σ_c bf16(p_c) 2**(M_j - M_T) |v_c| / l`` (``|o| <= W``),
    ``rho = eta + (19 + 2 n) 2**-23 + n (2.5 2**-23 + 2**-23 max|t|)`` (the
    relative error of ``l``) and ``g = (64 + 5 n) 2**-23 + n (2.5 2**-23 +
    2**-23 max|t|)`` (that of ``acc``'s terms):

        slack = (F + g W)(1 + rho) + rho W + 2**-23 W.

    Rows are processed one (batch, head) at a time (float64 ``[S, S]``
    tensors)."""
    B, H, S, d = q.shape
    T = KV_TILE
    nt = -(-S // T)
    c = (1.0 / math.sqrt(d)) * math.log2(math.e)
    u23 = 2.0 ** -23
    ex2 = 2.5 * u23
    dev = q.device
    rows = torch.arange(S, device=dev)[:, None]
    cols = torch.arange(nt * T, device=dev)[None, :]
    keep = cols < S
    if causal:
        keep = keep & (cols <= rows)
    n = (torch.full((S, 1), nt, dtype=torch.float64, device=dev)
         if not causal else (rows // T + 1).clamp(max=nt).double())
    pad = nt * T - S
    o = torch.empty((B, H, S, d), dtype=torch.float64, device=dev)
    slack = torch.empty_like(o)
    tiny = 2.0 ** -126
    for b in range(B):
        for h in range(H):
            qd = q[b, h].double()
            kd, vd = (torch.nn.functional.pad(x[b, h].double(),
                                              (0, 0, 0, pad)) for x in (k, v))
            va = vd.abs()
            t = torch.where(keep, (qd @ kd.T) * c, -math.inf)
            run = t.view(S, nt, T).amax(dim=-1).cummax(dim=1).values
            Mj = run.repeat_interleave(T, dim=1)
            p = torch.exp2(t - Mj)
            resc = torch.exp2(Mj - run[:, -1:])
            pr = p.float().to(torch.bfloat16).double()
            w = pr * resc
            l = (p * resc).sum(dim=1, keepdim=True)
            o[b, h] = (w @ vd) / l
            # the kernel's fp32 deviations
            at = torch.where(keep, t.abs(), 0.0)
            tmax = at.amax(dim=1, keepdim=True)
            e = torch.where(keep, c * d * u23 * (qd.abs() @ kd.abs().T)
                            + 4 * 2.0 ** -24 * at, 0.0)
            E = e.amax(dim=1, keepdim=True)
            eta = torch.exp2(e + E + u23 * tmax) - 1 + ex2
            lo = (p * (1 - eta)).float().to(torch.bfloat16).double()
            lo = torch.where(p * (1 - eta) < tiny, 0.0, lo)
            hi = (p * (1 + eta)).float().to(torch.bfloat16).double()
            band = torch.where(keep, hi - lo, 0.0) * resc
            F = (band @ va) / l
            W = (w @ va) / l
            alpha = n * (ex2 + u23 * tmax)
            rho = eta.amax(dim=1, keepdim=True) + (19 + 2 * n) * u23 + alpha
            g = (64 + 5 * n) * u23 + alpha
            slack[b, h] = (F + g * W) * (1 + rho) + rho * W + u23 * W
    return o, slack


def _check(q, k, v, q_tile: int, block_k: int) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must be [B, H, S, d] with "
                         f"the same S for q and kv, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    S = q.shape[2]
    if q_tile <= 0 or block_k <= 0 or S % q_tile or S % block_k:
        raise ValueError(f"flash_attention: S={S} must divide by q_tile="
                         f"{q_tile} and block_k={block_k} (pad outside)")


def _launcher():
    f = runtime.load(NAME).flash_attention_launch
    f.restype = ctypes.c_int
    f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                  + [ctypes.c_float, ctypes.c_void_p])
    return f


def flash_attention(q, k, v, *, causal: bool = True, q_tile: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q, k, v ``[B, H, S, d]`` (the same S for q and kv) → ``[B, H, S, d]``
    in ``q.dtype``.  S must divide by ``q_tile`` and ``block_k``.  On the
    GPU: float32 or bfloat16, contiguous, d in ``HEAD_DIMS``, bf16 tensors
    16-byte aligned; the kernel tiles by its own sizes
    (``csrc/flash_attention.cu``), which changes only the order of its
    sums, and for bf16 rounds the probabilities to bf16 before the P·V
    product (the plain version keeps them in float32)."""
    _check(q, k, v, q_tile, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} is not one of "
                        f"{DTYPES}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        runtime.require(t, what, q.dtype, 4, q.device)
    B, H, S, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one of "
                         f"{HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k, v must start at "
                         "16-byte aligned addresses (the kernel's TMA loads)")
    o = torch.empty((B, H, S, d), dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return o
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      B * H, S, d, int(causal),
                      int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d),
                      runtime.stream_ptr(q))
    runtime.check_launch(NAME, err)
    runtime.count_launch(NAME)
    return o
