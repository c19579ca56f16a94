"""Flash attention (forward): the CUDA kernel, its wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_kernel``).  The kernel source is
``csrc/flash_attention.cu``.  A CPU tensor takes the plain version, a
CUDA tensor the kernel (or an error); nothing falls back.

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
    GPU: float32 or bfloat16, contiguous, d in ``HEAD_DIMS``; the kernel
    tiles by its own sizes (``csrc/flash_attention.cu``), which changes
    only the order of its sums."""
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
