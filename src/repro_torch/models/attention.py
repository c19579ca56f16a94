"""Grouped-query attention: train/prefill and cached decode paths.

* q heads are padded to ``cfg.padded_heads``; padded heads have zero
  o-proj rows, so outputs (and gradients into real weights) are
  unaffected.  Without padding the grouped einsum runs (no KV copy);
  with it, kv heads are expanded to the q heads by a static gather.
* decode caches are laid out ``[batch, kv_seq, kv_heads, head_dim]``.

The reference computes the attention logits with
``preferred_element_type=float32``: products of the (possibly bf16)
operands summed into float32 logits.  A bf16 ``torch.einsum`` returns
bf16, so the port casts both operands to float32 first (:func:`_dot_f32`;
a product of two bf16 values is exact in float32, so only the order of
the float32 sum can differ).  The softmax is cast back to the input's
dtype before the product with V, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .common import PDef, rms_norm, rope, round_to, softcap
from .config import ModelConfig
from repro_torch.distributed import ctx
from repro_torch.distributed.ctx import constrain

NEG_INF = -2.0e38


def attn_pdefs(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.padded_heads, cfg.n_kv_heads
    p = {
        "wq": PDef((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": PDef((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": PDef((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": PDef((H, hd, d), ("heads", "head_dim", "embed"),
                   init="zeros" if H != cfg.n_heads else "normal"),
    }
    if cfg.qkv_bias:
        p["bq"] = PDef((H, hd), ("heads", "head_dim"), init="zeros")
        p["bk"] = PDef((KV, hd), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = PDef((KV, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = PDef((hd,), ("head_dim",), init="zeros")
        p["k_norm"] = PDef((hd,), ("head_dim",), init="zeros")
    return p


def _grouped_ok(cfg: ModelConfig) -> bool:
    """Grouped (expansion-free) GQA path: only when heads need no padding
    and divide evenly into kv groups."""
    return (cfg.padded_heads == cfg.n_heads
            and cfg.n_heads % max(cfg.n_kv_heads, 1) == 0)


def _q_to_kv_map(cfg: ModelConfig) -> np.ndarray:
    """Padded q-head index -> kv-head index (real heads keep GQA groups)."""
    group = cfg.n_heads // cfg.n_kv_heads
    m = np.zeros(cfg.padded_heads, np.int32)
    m[: cfg.n_heads] = np.arange(cfg.n_heads) // group
    return m  # padded heads point at kv 0; their wo rows are zero


def _expand_kv(cfg: ModelConfig, t):
    """kv heads of ``t`` [B, T, KV, hd] gathered to the padded q heads (on
    a mesh, on each rank's rows with the kv heads whole)."""
    kmap = torch.as_tensor(_q_to_kv_map(cfg), dtype=torch.long,
                           device=t.device)
    return ctx.local_op(lambda tt: tt.index_select(2, kmap), t,
                        work_dims=[(2,)])


def _grouped(cfg: ModelConfig, q) -> bool:
    """The grouped path for ``q`` [B, S, H, hd]: ``_grouped_ok``, and on a
    mesh each shard of the heads holds whole kv groups (the kv heads
    divide over the ranks that split the heads); otherwise the kv heads
    are expanded to the q heads, each rank's own."""
    return _grouped_ok(cfg) and cfg.n_kv_heads % ctx.dim_extent(q, 2) == 0


def _dot_f32(eq: str, a, b):
    """``einsum`` of ``a`` and ``b`` with float32 output, as the
    reference's ``preferred_element_type=float32``."""
    return ctx.einsum(eq, a.float(), b.float())


def _einsum_promoted(eq: str, a, b):
    """``einsum`` in the promoted dtype of ``a`` and ``b``, as the
    reference's ``jnp.einsum`` of mixed dtypes (a float32 decode over a
    bf16 cache)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return ctx.einsum(eq, a.to(dt), b.to(dt))


def _scale(cfg: ModelConfig, dtype) -> float:
    return round_to(cfg.head_dim ** -0.5, dtype)


def _project_qkv(p, cfg: ModelConfig, x, positions):
    q = ctx.einsum("bsd,dhk->bshk", x, p["wq"])
    k = ctx.einsum("bsd,dhk->bshk", x, p["wk"])
    v = ctx.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _banded_local_attn(qg, k, v, scale: float, window: int, softcap_v):
    """Exact sliding-window attention over diagonal bands: each W-sized
    query block attends to its own and the previous key block only —
    score bytes drop from O(S*S) to O(S*2W).

    qg: [B,S,KV,G,hd]; k,v: [B,S,KV,hd]; requires S % window == 0.
    """
    B, S, KV, G, hd = qg.shape
    W = window
    nb = S // W
    qb = qg.reshape(B, nb, W, KV, G, hd)
    kb = k.reshape(B, nb, W, KV, hd)
    vb = v.reshape(B, nb, W, KV, hd)
    # block 0's previous block is zeros (masked out below)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    kcat = torch.cat([kprev, kb], dim=2)       # [B,nb,2W,KV,hd]
    vcat = torch.cat([vprev, vb], dim=2)
    logits = _dot_f32("bnwKGh,bnuKh->bnKGwu", qb * scale, kcat)
    logits = softcap_v(logits)
    bidx = torch.arange(nb, dtype=torch.int32, device=qg.device)[:, None, None]
    ipos = bidx * W + torch.arange(W, dtype=torch.int32,
                                   device=qg.device)[None, :, None]
    jpos = (bidx - 1) * W + torch.arange(2 * W, dtype=torch.int32,
                                         device=qg.device)[None, None, :]
    mask = (jpos >= 0) & (jpos <= ipos) & (ipos - jpos < W)
    logits = torch.where(mask[None, :, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(qg.dtype)
    out = ctx.einsum("bnKGwu,bnuKh->bnwKGh", probs, vcat)
    return out.reshape(B, S, KV, G, hd)


def attn_fwd(p, cfg: ModelConfig, x, *, local: bool,
             positions: Optional[torch.Tensor] = None,
             kv_mask: Optional[torch.Tensor] = None,
             return_cache: bool = False):
    """Full-sequence (train / prefill) attention.  x: [B, S, D]."""
    B, S, _ = x.shape
    if positions is None:
        # one row, broadcast over the batch: the same values as every
        # row's, and no [B, S] rope tables
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    q, k, v = _project_qkv(p, cfg, x, positions)
    q = constrain(q, "batch", None, "heads", None)
    scale = _scale(cfg, q.dtype)
    # banded path: exact sliding window over diagonal blocks (no S*S scores)
    banded = (local and cfg.local_window and S % cfg.local_window == 0
              and S > cfg.local_window and kv_mask is None)
    if banded:
        H, hd = q.shape[2], q.shape[3]
        sc = lambda l: softcap(l, cfg.attn_softcap)
        if _grouped(cfg, q):
            KV = cfg.n_kv_heads
            qg = q.reshape(B, S, KV, H // KV, hd)
            out = _banded_local_attn(qg, k, v, scale, cfg.local_window, sc)
        else:
            qg = q.reshape(B, S, H, 1, hd)
            out = _banded_local_attn(qg, _expand_kv(cfg, k),
                                     _expand_kv(cfg, v), scale,
                                     cfg.local_window, sc)
        out = out.reshape(B, S, H, hd)
        out = constrain(out, "batch", None, "heads", None)
        y = ctx.einsum("bshk,hkd->bsd", out, p["wo"])
        y = constrain(y, "batch", None, "act_embed")
        if return_cache:
            return y, {"k": k, "v": v}
        return y
    i = positions[:, None, :, None]
    j = positions[:, None, None, :]
    mask = j <= i
    if local and cfg.local_window:
        mask = mask & ((i - j) < cfg.local_window)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, :]
    if _grouped(cfg, q):
        # no head padding: grouped einsum, no KV expansion copy
        B, S, H, hd = q.shape
        KV = cfg.n_kv_heads
        qg = q.reshape(B, S, KV, H // KV, hd)
        logits = _dot_f32("bsKGh,btKh->bKGst", qg * scale, k)
        logits = softcap(logits, cfg.attn_softcap)
        logits = torch.where(mask[:, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = ctx.einsum("bKGst,btKh->bsKGh", probs, v).reshape(B, S, H, hd)
    else:
        ke = constrain(_expand_kv(cfg, k), "batch", None, "heads", None)
        ve = constrain(_expand_kv(cfg, v), "batch", None, "heads", None)
        logits = _dot_f32("bshk,bthk->bhst", q * scale, ke)
        logits = constrain(logits, "batch", "heads", None, None)
        logits = softcap(logits, cfg.attn_softcap)
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = ctx.einsum("bhst,bthk->bshk", probs, ve)
    out = constrain(out, "batch", None, "heads", None)
    y = ctx.einsum("bshk,hkd->bsd", out, p["wo"])
    y = constrain(y, "batch", None, "act_embed")
    if return_cache:
        return y, {"k": k, "v": v}
    return y


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    hd, KV = cfg.head_dim, cfg.n_kv_heads
    return {
        "k": torch.zeros((batch, max_len, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, KV, hd), dtype=dtype, device=device),
    }


def attn_decode(p, cfg: ModelConfig, x, cache, cache_pos, *, local: bool):
    """Single-token cached decode.  x: [B, 1, D]; cache_pos: the *true*
    sequence position (an int or a 0-d integer tensor).

    Local layers use a rolling buffer of length ``local_window``: position
    p lives at slot p % window, k/v are stored pre-rotated at absolute
    positions, and the buffer membership itself enforces the window (every
    resident entry is within the last ``window`` positions).  Global
    layers write at slot ``cache_pos`` directly; past the end of the
    buffer the slot is clamped to the last one, as the reference's
    ``dynamic_update_slice`` clamps its start.

    The new k/v are written into ``cache``'s tensors in place, which are
    returned as the new cache.
    """
    B = x.shape[0]
    pos = int(cache_pos)
    rolling = bool(local and cfg.local_window)
    L = cache["k"].shape[1]
    slot = pos % L if rolling else min(pos, L - 1)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    k, v = cache["k"], cache["v"]
    ctx.write_seq(k, k_new, slot)
    ctx.write_seq(v, v_new, slot)
    scale = _scale(cfg, q.dtype)
    # slots written so far: t <= cache_pos covers warm-up; once the rolling
    # buffer has wrapped every slot is valid and in-window by construction.
    mask = torch.arange(L, device=x.device) <= pos
    if _grouped(cfg, q):
        B_, S_, H_, hd_ = q.shape
        KV = cfg.n_kv_heads
        qg = q.reshape(B_, S_, KV, H_ // KV, hd_)
        logits = _dot_f32("bsKGh,btKh->bKGst", qg * scale, k)
        logits = softcap(logits, cfg.attn_softcap)
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = _einsum_promoted("bKGst,btKh->bsKGh", probs, v) \
            .reshape(B_, S_, H_, hd_)
    else:
        ke, ve = _expand_kv(cfg, k), _expand_kv(cfg, v)
        logits = _dot_f32("bshk,bthk->bhst", q * scale, ke)   # [B,H,1,T]
        logits = softcap(logits, cfg.attn_softcap)
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = _einsum_promoted("bhst,bthk->bshk", probs, ve)
    y = ctx.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, {"k": k, "v": v}


def cross_attn_pdefs(cfg: ModelConfig) -> dict:
    """Whisper-style cross attention (bias, no rope)."""
    d, hd, H = cfg.d_model, cfg.head_dim, cfg.padded_heads
    return {
        "wq": PDef((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": PDef((d, H, hd), ("embed", "heads", "head_dim")),
        "wv": PDef((d, H, hd), ("embed", "heads", "head_dim")),
        "wo": PDef((H, hd, d), ("heads", "head_dim", "embed"),
                   init="zeros" if H != cfg.n_heads else "normal"),
        "bq": PDef((H, hd), ("heads", "head_dim"), init="zeros"),
        "bv": PDef((H, hd), ("heads", "head_dim"), init="zeros"),
    }


def cross_attn_fwd(p, cfg: ModelConfig, x, enc_kv):
    """x: [B, S, D] queries; enc_kv: dict(k, v) precomputed [B, T, H, hd]."""
    q = ctx.einsum("bsd,dhk->bshk", x, p["wq"]) + p["bq"]
    logits = _dot_f32("bshk,bthk->bhst", q * _scale(cfg, q.dtype),
                      enc_kv["k"])
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = ctx.einsum("bhst,bthk->bshk", probs, enc_kv["v"])
    return ctx.einsum("bshk,hkd->bsd", out, p["wo"])


def encode_cross_kv(p, cfg: ModelConfig, enc_out):
    k = ctx.einsum("btd,dhk->bthk", enc_out, p["wk"])
    v = ctx.einsum("btd,dhk->bthk", enc_out, p["wv"]) + p["bv"]
    return {"k": k, "v": v}
