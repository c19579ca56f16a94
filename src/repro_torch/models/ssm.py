"""Mamba-2 (SSD — state-space duality) mixer: chunked training form and
O(1)-state decode step  [arXiv:2405.21060].

Training runs the standard chunked SSD decomposition with chunk length Q:
intra-chunk quadratic (attention-like with decay mask) + inter-chunk
state recurrence via a scan over chunks (:func:`common.affine_scan`, a
log-depth doubling scan: the reference's ``associative_scan`` in another
bracketing).  Decode keeps a ``[B, H, N, P]`` state and a rolling
depthwise-conv tail.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .common import PDef, affine_scan, rms_norm
from .config import ModelConfig
from repro_torch.distributed import ctx
from repro_torch.distributed.ctx import constrain


def ssm_pdefs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = d * cfg.ssm_expand
    H, N, G, K = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_conv
    return {
        "wz": PDef((d, di), ("embed", "mlp")),
        "wx": PDef((d, di), ("embed", "mlp")),
        "wB": PDef((d, G * N), ("embed", None)),
        "wC": PDef((d, G * N), ("embed", None)),
        "wdt": PDef((d, H), ("embed", "ssm_heads")),
        "conv_x": PDef((K, di), ("conv", "mlp"), init="normal", scale=0.5),
        "conv_B": PDef((K, G * N), ("conv", None), init="normal", scale=0.5),
        "conv_C": PDef((K, G * N), ("conv", None), init="normal", scale=0.5),
        "A_log": PDef((H,), ("ssm_heads",), init="zeros"),
        "D": PDef((H,), ("ssm_heads",), init="ones"),
        "dt_bias": PDef((H,), ("ssm_heads",), init="zeros"),
        "norm": PDef((di,), ("mlp",), init="zeros"),
        "wo": PDef((di, d), ("mlp", "embed")),
    }


def _causal_conv(x, w, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: [B,S,C], w: [K,C]; tail: [B,K-1,C]."""
    K = w.shape[0]
    pad = tail if tail is not None else x.new_zeros(
        (x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return F.silu(out), xp[:, -(K - 1):, :]


def _ssd_chunked(xh, dt, A, B_, C_, Q: int, h0=None):
    """Chunked SSD.  xh:[B,S,H,P] dt:[B,S,H] A:[H] B_,C_:[B,S,H,N].

    Returns (y:[B,S,H,P], h_last:[B,H,N,P])."""
    B, S, H, P = xh.shape
    nc = S // Q
    r = lambda t: t.reshape((B, nc, Q) + tuple(t.shape[2:]))
    xc, dtc, Bc, Cc = r(xh), r(dt), r(B_), r(C_)
    a = dtc * A                                  # [B,nc,Q,H] log-decay (<0)
    # on a mesh, along each rank's chunks (DTensor has no rule for the
    # flip of cumsum's backward in every torch version)
    cum = ctx.local_op(lambda t: torch.cumsum(t, dim=2), a, work_dims=[(2,)])
    # intra-chunk: y_i += Σ_{j≤i} exp(cum_i − cum_j)·dt_j·(C_i·B_j)·x_j
    # mask the *exponent* (not the result): exp at masked i<j positions
    # overflows and 0·inf = NaN in the gradient otherwise.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,nc,i,j,H]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=xh.device))[None, None, :, :, None]
    decay = torch.exp(torch.where(tri, diff, -torch.inf))
    scores = ctx.einsum("bcihn,bcjhn->bcijh", Cc, Bc)
    w = scores * decay * dtc[:, :, None, :, :]
    w = constrain(w, "batch", None, None, None, "ssm_heads")
    y_intra = ctx.einsum("bcijh,bcjhp->bcihp", w.to(xh.dtype), xc)
    # chunk summaries: state_c = Σ_j exp(cum_last − cum_j)·dt_j·B_j ⊗ x_j
    seg = torch.exp(cum[:, :, -1:, :] - cum) * dtc                # [B,nc,Q,H]
    states = ctx.einsum("bcjh,bcjhn,bcjhp->bchnp", seg, Bc,
                          xc.to(seg.dtype))
    chunk_decay = torch.exp(cum[:, :, -1, :])                     # [B,nc,H]
    # inter-chunk recurrence: h_c = chunk_decay_c · h_{c-1} + states_c
    dscan, sscan = affine_scan(chunk_decay[..., None, None], states, dim=1)
    if h0 is not None:
        sscan = sscan + dscan * h0[:, None]
    h_prev = torch.cat(
        [h0[:, None] if h0 is not None else torch.zeros_like(sscan[:, :1]),
         sscan[:, :-1]], dim=1)                                   # [B,nc,H,N,P]
    y_inter = ctx.einsum("bcihn,bchnp->bcihp",
                           (Cc * torch.exp(cum)[..., None]).to(xh.dtype),
                           h_prev.to(xh.dtype))
    y = (y_intra + y_inter).reshape(B, S, H, P)
    h_last = sscan[:, -1]
    return y, h_last


def ssm_fwd(p, cfg: ModelConfig, x, *, state=None, return_state: bool = False):
    """x: [B,S,D].  state: dict(h, conv) for prefill continuation."""
    B, S, D = x.shape
    di = D * cfg.ssm_expand
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    G = cfg.ssm_groups
    z = ctx.einsum("bsd,de->bse", x, p["wz"])
    xs = ctx.einsum("bsd,de->bse", x, p["wx"])
    Br = ctx.einsum("bsd,de->bse", x, p["wB"])
    Cr = ctx.einsum("bsd,de->bse", x, p["wC"])
    dt_raw = ctx.einsum("bsd,dh->bsh", x, p["wdt"])
    tails = state["conv"] if state is not None else None
    xs, tail_x = _causal_conv(xs, p["conv_x"], tails["x"] if tails else None)
    Bc, tail_B = _causal_conv(Br, p["conv_B"], tails["B"] if tails else None)
    Cc, tail_C = _causal_conv(Cr, p["conv_C"], tails["C"] if tails else None)
    # jax.nn.softplus is logaddexp(x, 0); F.softplus would turn linear
    # above 20
    u = dt_raw.float() + p["dt_bias"]
    dt = torch.logaddexp(u, torch.zeros_like(u))
    A = -torch.exp(p["A_log"].float())
    xh = constrain(xs.reshape(B, S, H, P), "batch", None, "ssm_heads", None)
    rep = H // G
    Bh = Bc.reshape(B, S, G, N).repeat_interleave(rep, dim=2).float()
    Ch = Cc.reshape(B, S, G, N).repeat_interleave(rep, dim=2).float()
    Q = min(cfg.ssm_chunk, S)
    assert S % Q == 0, (S, Q)
    h0 = state["h"] if state is not None else None
    y, h_last = _ssd_chunked(xh, dt, A, Bh, Ch, Q, h0=h0)
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = ctx.einsum("bse,ed->bsd", y, p["wo"])
    if return_state:
        return out, {"h": h_last,
                     "conv": {"x": tail_x, "B": tail_B, "C": tail_C}}
    return out


def ssm_init_state(cfg: ModelConfig, batch: int, dtype, device):
    di = cfg.d_model * cfg.ssm_expand
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    GN = cfg.ssm_groups * cfg.ssm_state
    K = cfg.ssm_conv
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    return {
        "h": z(batch, H, N, P, dt=torch.float32),
        "conv": {"x": z(batch, K - 1, di), "B": z(batch, K - 1, GN),
                 "C": z(batch, K - 1, GN)},
    }


def ssm_decode(p, cfg: ModelConfig, x, state):
    """Single-token decode.  x: [B,1,D]."""
    return ssm_fwd(p, cfg, x, state=state, return_state=True)
