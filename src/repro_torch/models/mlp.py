"""Dense gated MLPs and token-choice MoE.

MoE uses the permute -> grouped-GEMM -> unpermute formulation (sort-based
dispatch with a static per-expert capacity) rather than GShard's
``[groups, seq, experts, capacity]`` one-hot einsum — the one-hot dispatch
tensor is O(S·E·C) and does not fit at seq_len 4096 with 64 experts.
The rank-within-expert computation is a stable sort and a running maximum
of run starts (``torch.cummax``, exact on integers).

The combine adds each token's ``top_k`` expert outputs with
``index_add``.  On the CPU it adds them in index order; on CUDA the order
of the adds to one token is not fixed, so for ``top_k > 2`` (two adds to
a zero row commute exactly) a token's output may differ from run to run
by float rounding.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .common import PDef, ACT
from .config import ModelConfig
from repro_torch.distributed import ctx
from repro_torch.distributed.ctx import constrain


def mlp_pdefs(cfg: ModelConfig, d_ff: int) -> dict:
    d = cfg.d_model
    return {
        "w_gate": PDef((d, d_ff), ("embed", "mlp")),
        "w_up": PDef((d, d_ff), ("embed", "mlp")),
        "w_down": PDef((d_ff, d), ("mlp", "embed")),
    }


def mlp_fwd(p, cfg: ModelConfig, x):
    act = ACT[cfg.mlp_act]
    h = act(ctx.einsum("bsd,df->bsf", x, p["w_gate"])) \
        * ctx.einsum("bsd,df->bsf", x, p["w_up"])
    h = constrain(h, "batch", None, "mlp")
    y = ctx.einsum("bsf,fd->bsd", h, p["w_down"])
    return constrain(y, "batch", None, "act_embed")


def moe_pdefs(cfg: ModelConfig) -> dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": PDef((d, E), ("embed", None)),
        "w_gate": PDef((E, d, f), ("experts", "embed", "expert_mlp")),
        "w_up": PDef((E, d, f), ("experts", "embed", "expert_mlp")),
        "w_down": PDef((E, f, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_pdefs(cfg, cfg.d_ff * cfg.n_shared_experts)
    return p


def _rank_in_group(keys: torch.Tensor) -> torch.Tensor:
    """Occurrence rank of each element within its (sorted) key group,
    along the last axis."""
    n = keys.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=keys.device)
    is_start = torch.ones_like(keys, dtype=torch.bool)
    is_start[..., 1:] = keys[..., 1:] != keys[..., :-1]
    run_start = torch.where(is_start, idx, 0).cummax(dim=-1).values
    return idx - run_start


def _route(probs, K: int, C: int):
    """Per batch row (a routing group): the top-``K`` gates, the one-hot
    of each token's first expert, and the sort of the (token, choice)
    pairs by expert with each pair's capacity slot (``E * C`` where it
    overflows).  probs: [B, S, E]."""
    B, S, E = probs.shape
    gate, eid = torch.topk(probs, K, dim=-1, sorted=True)     # [B, S, K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(eid[..., 0], E).float()
    a_exp = eid.reshape(B, S * K).to(torch.int32)
    a_gate = gate.reshape(B, S * K)
    order = torch.argsort(a_exp, dim=-1, stable=True)        # [B, S*K]
    s_exp = torch.gather(a_exp, 1, order)
    s_tok = order // K
    s_gate = torch.gather(a_gate, 1, order)
    rank = _rank_in_group(s_exp)
    fits = rank < C
    slot = torch.where(fits, s_exp * C + rank, E * C).long()  # drop overflow
    return onehot, slot, s_tok, s_gate, fits


def _permute(x, slot, s_tok, E: int, C: int):
    """Each row's tokens into its [E, C] expert buffer.  x: [B, S, D]."""
    B, _, D = x.shape
    rows = torch.arange(B, device=x.device)[:, None]
    gathered = x[rows, s_tok]                                # [B,S*K,D]
    # one spare row takes every overflow write and is cut off: the
    # reference's scatter with mode="drop"
    buf = x.new_zeros((B, E * C + 1, D)).index_put(
        (rows.expand_as(slot), slot), gathered)
    return buf[:, :E * C].reshape(B, E, C, D)


def _combine(x, y, slot, s_tok, s_gate, fits):
    """Each token's gated expert outputs added back into its row.
    y: [B, E*C, D]."""
    B, S, D = x.shape
    EC = y.shape[1]
    K = slot.shape[1] // S
    rows = torch.arange(B, device=x.device)[:, None]
    contrib = y[rows, torch.clamp(slot, max=EC - 1)] \
        * s_gate[..., None].to(x.dtype)
    contrib = torch.where(fits[..., None], contrib, 0.0)
    out = x.new_zeros((B * S, D)).index_add(
        0, (rows * S + s_tok).reshape(-1), contrib.reshape(B * S * K, D))
    return out.reshape(B, S, D)


def moe_fwd(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss).  x: [B, S, D].

    *Grouped* dispatch: each batch row is an independent routing group,
    so the sort and the scatters stay within the row.  On a mesh the
    routing, the permute and the combine (sorts, running maxima and
    scatters, which have no DTensor sharding rule) run on each rank's
    rows (``ctx.local_op``); the expert GEMMs run on DTensors.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = ctx.einsum("bsd,de->bse", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    # capacity per (group, expert): cf·S·K/E, floored so that single-token
    # decode groups are dropless (each expert gets ≤ 1 of a token's K).
    C = min(S * K, max(int(cfg.capacity_factor * S * K / E), 4))
    onehot, slot, s_tok, s_gate, fits = ctx.local_op(
        lambda pr: _route(pr, K, C), probs, work_dims=[(1, 2)])

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))
    ce = onehot.mean(dim=(0, 1))
    aux = E * (me * ce).sum()

    # ---- permute within each group: sorted by expert ---------------------
    buf = ctx.local_op(lambda xx, sl, st: _permute(xx, sl, st, E, C),
                       x, slot, s_tok, work_dims=[(1, 2), (1,), (1,)])
    buf = constrain(buf, "batch", "experts", None, None)

    # ---- grouped GEMMs ----------------------------------------------------
    act = ACT[cfg.mlp_act]
    h = act(ctx.einsum("becd,edf->becf", buf, p["w_gate"])) \
        * ctx.einsum("becd,edf->becf", buf, p["w_up"])
    h = constrain(h, "batch", "experts", None, None)
    y = ctx.einsum("becf,efd->becd", h, p["w_down"])
    y = constrain(y, "batch", "experts", None, None).reshape(B, E * C, D)

    # ---- unpermute + combine ---------------------------------------------
    out = ctx.local_op(_combine, x, y, slot, s_tok, s_gate, fits,
                       work_dims=[(1, 2), (1, 2), (1,), (1,), (1,), (1,)])
    out = constrain(out, "batch", None, None)
    if cfg.n_shared_experts:
        out = out + mlp_fwd(p["shared"], cfg, x)
    return out, aux
