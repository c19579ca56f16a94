"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

h_t = a_t · h_{t-1} + √(1 − a_t²) · (i_t ⊙ x_t),   a_t = a^(c·r_t)

with a = sigmoid(Λ) per channel, r/i input-dependent sigmoid gates, c=8.
Training runs a log-depth doubling scan over time of the affine
recurrence (:func:`common.affine_scan`; the reference's
``associative_scan`` in another bracketing); decode keeps an O(1)
``[B, rec_width]`` state.  The block is conv1d(k=4) -> RG-LRU -> gated
output, as in the paper's recurrent block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import PDef, affine_scan
from .config import ModelConfig
from repro_torch.distributed.ctx import constrain

_C = 8.0


def rglru_pdefs(cfg: ModelConfig) -> dict:
    d, r, K = cfg.d_model, cfg.rec_width, cfg.rglru_conv
    return {
        "w_in": PDef((d, r), ("embed", "rec")),
        "w_gate": PDef((d, r), ("embed", "rec")),
        "conv": PDef((K, r), ("conv", "rec"), init="normal", scale=0.5),
        "w_r": PDef((r, r), ("embed", "rec")),
        "w_i": PDef((r, r), ("embed", "rec")),
        "lam": PDef((r,), ("rec",), init="ones", scale=1.0),
        "w_out": PDef((r, d), ("rec", "embed")),
    }


def _conv_tail(x, w, tail):
    K = w.shape[0]
    pad = tail if tail is not None else x.new_zeros(
        (x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return out, xp[:, -(K - 1):, :]


def rglru_fwd(p, cfg: ModelConfig, x, *, state=None,
              return_state: bool = False):
    """x: [B,S,D].  state: dict(h:[B,r], conv:[B,K-1,r])."""
    xb = constrain(torch.einsum("bsd,dr->bsr", x, p["w_in"]),
                   "batch", None, "rec")
    gate = constrain(torch.einsum("bsd,dr->bsr", x, p["w_gate"]),
                     "batch", None, "rec")
    xc, tail = _conv_tail(xb, p["conv"],
                          state["conv"] if state is not None else None)
    r = torch.sigmoid(torch.einsum("bsr,rq->bsq", xc, p["w_r"]).float())
    i = torch.sigmoid(torch.einsum("bsr,rq->bsq", xc, p["w_i"]).float())
    # log a_t = c · r_t · log sigmoid(Λ)  (≤ 0)
    log_a = _C * r * F.logsigmoid(8.0 * p["lam"].float())
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    v = mult * i * xc.float()
    if state is not None:
        # the carried state enters through the first step: v_0 += a_0 · h
        v = torch.cat([v[:, :1] + a[:, :1] * state["h"][:, None], v[:, 1:]],
                      dim=1)
    _, h = affine_scan(a, v, dim=1)
    y = h.to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = torch.einsum("bsr,rd->bsd", y, p["w_out"])
    if return_state:
        return out, {"h": h[:, -1, :], "conv": tail}
    return out


def rglru_init_state(cfg: ModelConfig, batch: int, dtype, device):
    r, K = cfg.rec_width, cfg.rglru_conv
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, K - 1, r), dtype=dtype,
                                device=device)}


def rglru_decode(p, cfg: ModelConfig, x, state):
    return rglru_fwd(p, cfg, x, state=state, return_state=True)
