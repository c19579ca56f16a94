"""Unified pattern-interleaved decoder stack + whisper encoder-decoder.

Layers follow ``cfg.pattern`` repeated over ``n_layers`` (e.g. gemma3 is
``(local,)*5 + (attn,)`` and recurrentgemma ``(rglru, rglru, local)``).
The parameters of whole periods are stacked on a leading layers axis
(``params["scan"]["pos{t}"]``) and the stack loops over the periods; the
remainder layers (``params["rem"]``) follow one by one.

Public entry points (functions of (params, inputs)):
  * ``pdefs(cfg)``                   — parameter declaration tree
  * ``fwd_train(params, cfg, tokens[, enc_frames])`` -> logits, aux
  * ``loss_fn``                      — CE + z-loss + MoE aux
  * ``prefill`` / ``decode_step``    — cached serving paths
  * ``init_caches``                  — decode cache trees

``prefill`` fills fresh caches; ``decode_step`` writes the new position
into the attention caches it is given, in place, and returns new
recurrent states beside them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import PDef, layer_norm, rms_norm, round_to, tree_map
from .config import ModelConfig
from . import attention as attn
from . import mlp as mlp_mod
from . import ssm as ssm_mod
from . import rglru as rglru_mod
from repro_torch.distributed.ctx import constrain
from repro_torch.kernels.runtime import resolve_device


# ---------------------------------------------------------------------------
# parameter declarations
# ---------------------------------------------------------------------------

def _norm_pdefs(cfg: ModelConfig) -> Dict[str, PDef]:
    if cfg.use_layer_norm_bias:
        return {"g": PDef((cfg.d_model,), (None,), init="ones"),
                "b": PDef((cfg.d_model,), (None,), init="zeros")}
    return {"g": PDef((cfg.d_model,), (None,), init="zeros")}


def _apply_norm(p, cfg: ModelConfig, x):
    if cfg.use_layer_norm_bias:
        return layer_norm(x, p["g"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["g"], cfg.norm_eps)


def _mixer_pdefs(cfg: ModelConfig, kind: str) -> dict:
    if kind in ("attn", "local"):
        return attn.attn_pdefs(cfg)
    if kind == "ssm":
        return ssm_mod.ssm_pdefs(cfg)
    if kind == "rglru":
        return rglru_mod.rglru_pdefs(cfg)
    raise ValueError(kind)


def _layer_pdefs(cfg: ModelConfig, kind: str) -> dict:
    p = {"ln1": _norm_pdefs(cfg), "mixer": _mixer_pdefs(cfg, kind)}
    if cfg.use_post_norm:
        p["pn1"] = _norm_pdefs(cfg)
    if cfg.n_experts:
        p["ln2"] = _norm_pdefs(cfg)
        p["mlp"] = mlp_mod.moe_pdefs(cfg)
    elif cfg.d_ff:
        p["ln2"] = _norm_pdefs(cfg)
        p["mlp"] = mlp_mod.mlp_pdefs(cfg, cfg.d_ff)
    if cfg.use_post_norm and "mlp" in p:
        p["pn2"] = _norm_pdefs(cfg)
    return p


def _stack_pdefs(tree, n: int):
    return tree_map(
        lambda pd: PDef((n,) + pd.shape, ("layers",) + pd.axes,
                        init=pd.init, scale=pd.scale), tree)


def _split_layers(cfg: ModelConfig) -> Tuple[int, int]:
    if cfg.is_encoder_decoder or cfg.force_unroll:
        return 0, cfg.n_layers        # whisper/probes: fully unrolled
    period = len(cfg.pattern)
    return cfg.n_layers // period, cfg.n_layers % period


def pdefs(cfg: ModelConfig) -> dict:
    n_periods, rem = _split_layers(cfg)
    d = cfg.d_model
    p: Dict[str, Any] = {
        "embed": PDef((cfg.padded_vocab, d), ("vocab", "embed"),
                      init="embed", scale=0.02),
        "final_norm": _norm_pdefs(cfg),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = PDef((d, cfg.padded_vocab), ("embed", "vocab"))
    if n_periods:
        p["scan"] = {
            f"pos{t}": _stack_pdefs(_layer_pdefs(cfg, kind), n_periods)
            for t, kind in enumerate(cfg.pattern)}
    base = n_periods * len(cfg.pattern)
    p["rem"] = [_layer_pdefs(cfg, cfg.layer_kinds[base + t])
                for t in range(rem)]
    if cfg.is_encoder_decoder:
        p["enc"] = {
            "layers": [
                {"ln1": _norm_pdefs(cfg), "attn": attn.attn_pdefs(cfg),
                 "ln2": _norm_pdefs(cfg),
                 "mlp": mlp_mod.mlp_pdefs(cfg, cfg.d_ff)}
                for _ in range(cfg.n_encoder_layers)],
            "final_norm": _norm_pdefs(cfg),
        }
        p["cross"] = [
            {"ln": _norm_pdefs(cfg), "attn": attn.cross_attn_pdefs(cfg)}
            for _ in range(cfg.n_layers)]
    return p


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _block_train(p, cfg: ModelConfig, kind: str, x, aux):
    h = _apply_norm(p["ln1"], cfg, x)
    if kind in ("attn", "local"):
        h = attn.attn_fwd(p["mixer"], cfg, h, local=(kind == "local"))
    elif kind == "ssm":
        h = ssm_mod.ssm_fwd(p["mixer"], cfg, h)
    elif kind == "rglru":
        h = rglru_mod.rglru_fwd(p["mixer"], cfg, h)
    if cfg.use_post_norm:
        h = _apply_norm(p["pn1"], cfg, h)
    x = x + h
    if "mlp" in p:
        h = _apply_norm(p["ln2"], cfg, x)
        if cfg.n_experts:
            h, a = mlp_mod.moe_fwd(p["mlp"], cfg, h)
            aux = aux + a
        else:
            h = mlp_mod.mlp_fwd(p["mlp"], cfg, h)
        if cfg.use_post_norm:
            h = _apply_norm(p["pn2"], cfg, h)
        x = x + h
    return x, aux


def _block_decode(p, cfg: ModelConfig, kind: str, x, cache, cache_pos):
    h = _apply_norm(p["ln1"], cfg, x)
    if kind in ("attn", "local"):
        h, cache = attn.attn_decode(p["mixer"], cfg, h, cache, cache_pos,
                                    local=(kind == "local"))
    elif kind == "ssm":
        h, cache = ssm_mod.ssm_decode(p["mixer"], cfg, h, cache)
    elif kind == "rglru":
        h, cache = rglru_mod.rglru_decode(p["mixer"], cfg, h, cache)
    if cfg.use_post_norm:
        h = _apply_norm(p["pn1"], cfg, h)
    x = x + h
    if "mlp" in p:
        h = _apply_norm(p["ln2"], cfg, x)
        if cfg.n_experts:
            h, _ = mlp_mod.moe_fwd(p["mlp"], cfg, h)
        else:
            h = mlp_mod.mlp_fwd(p["mlp"], cfg, h)
        if cfg.use_post_norm:
            h = _apply_norm(p["pn2"], cfg, h)
        x = x + h
    return x, cache


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------

def _embed(params, cfg: ModelConfig, tokens):
    x = F.embedding(tokens, params["embed"])
    if cfg.emb_scale:
        x = x * round_to(math.sqrt(cfg.d_model), x.dtype)
    return constrain(x, "batch", None, "act_embed")


def _logits(params, cfg: ModelConfig, x):
    x = _apply_norm(params["final_norm"], cfg, x)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["unembed"])
    return constrain(logits.float(), "batch", None, "vocab")


def _period(tree, c: int):
    """Period ``c``'s slice (views) of a tree stacked on a layers axis."""
    return tree_map(lambda a: a[c], tree)


def _run_stack(params, cfg: ModelConfig, x, train: bool):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_periods, rem = _split_layers(cfg)
    # recompute each period (layer) in the backward pass, as the
    # reference's jax.checkpoint; only when a backward can follow
    remat = cfg.remat and train and torch.is_grad_enabled()

    def period_fn(xx, aa, pslice):
        for t, kind in enumerate(cfg.pattern):
            xx, aa = _block_train(pslice[f"pos{t}"], cfg, kind, xx, aa)
        return xx, aa

    for c in range(n_periods):
        pslice = _period(params["scan"], c)
        if remat:
            x, aux = checkpoint(period_fn, x, aux, pslice,
                                use_reentrant=False)
        else:
            x, aux = period_fn(x, aux, pslice)
    base = n_periods * len(cfg.pattern)
    for t in range(rem):
        kind = cfg.layer_kinds[base + t]
        if remat:
            x, aux = checkpoint(_block_train, params["rem"][t], cfg, kind, x,
                                aux, use_reentrant=False)
        else:
            x, aux = _block_train(params["rem"][t], cfg, kind, x, aux)
    return x, aux


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def encode(params, cfg: ModelConfig, enc_frames):
    """Whisper encoder over precomputed frame embeddings [B, T, D]."""
    B, T = enc_frames.shape[:2]
    pos = _sinusoid(T, cfg.d_model, enc_frames.dtype, enc_frames.device)
    x = enc_frames + pos[None]
    no_rope = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    for lp in params["enc"]["layers"]:
        h = _apply_norm(lp["ln1"], cfg, x)
        h = attn.attn_fwd(lp["attn"], cfg, h, local=False, kv_mask=None,
                          positions=no_rope)         # no-rope: pos 0
        x = x + h
        h = _apply_norm(lp["ln2"], cfg, x)
        x = x + mlp_mod.mlp_fwd(lp["mlp"], cfg, h)
    return _apply_norm(params["enc"]["final_norm"], cfg, x)


def _inv_freq(d: int, device):
    return torch.exp(-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=device)
                     * (math.log(10000.0) / d))


def _sinusoid(T: int, d: int, dtype, device):
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    div = _inv_freq(d, device)[None, :]
    pe = torch.cat([torch.sin(pos * div), torch.cos(pos * div)], dim=-1)
    return pe[:, :d].to(dtype)


def _sinusoid_at(pos: int, d: int, dtype, device):
    ang = float(pos) * _inv_freq(d, device)
    pe = torch.cat([torch.sin(ang), torch.cos(ang)])[:d]
    return pe.to(dtype)[None, None, :]


def fwd_train(params, cfg: ModelConfig, tokens,
              enc_frames: Optional[torch.Tensor] = None):
    """Teacher-forced forward -> (logits [B,S,Vp], aux_loss)."""
    x = _embed(params, cfg, tokens)
    if cfg.is_encoder_decoder:
        x = x + _sinusoid(tokens.shape[1], cfg.d_model, x.dtype,
                          x.device)[None]
        enc_out = encode(params, cfg, enc_frames)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for li in range(cfg.n_layers):
            x, aux = _block_train(_get_layer(params, cfg, li), cfg,
                                  cfg.layer_kinds[li], x, aux)
            cp = params["cross"][li]
            x = x + attn.cross_attn_fwd(
                cp["attn"], cfg, _apply_norm(cp["ln"], cfg, x),
                attn.encode_cross_kv(cp["attn"], cfg, enc_out))
        return _logits(params, cfg, x), aux
    x, aux = _run_stack(params, cfg, x, train=True)
    return _logits(params, cfg, x), aux


def _get_layer(params, cfg: ModelConfig, li: int):
    n_periods, rem = _split_layers(cfg)
    period = len(cfg.pattern)
    if li < n_periods * period:
        c, t = divmod(li, period)
        return _period(params["scan"][f"pos{t}"], c)
    return params["rem"][li - n_periods * period]


def loss_fn(params, cfg: ModelConfig, tokens, targets,
            enc_frames: Optional[torch.Tensor] = None):
    logits, aux = fwd_train(params, cfg, tokens, enc_frames)
    if cfg.padded_vocab != cfg.vocab:
        iota = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(iota < cfg.vocab, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    # the reference sums an iota mask of the gold column, every other term
    # an exact zero: the gathered logit, bit for bit
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    ce = (lse - gold).mean()
    zloss = 1e-4 * lse.square().mean()
    return ce + zloss + cfg.router_aux_weight * aux, (ce, aux)


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype, device):
    if kind in ("attn", "local"):
        length = min(max_len, cfg.local_window) if (
            kind == "local" and cfg.local_window) else max_len
        return attn.init_cache(cfg, batch, length, dtype, device)
    if kind == "ssm":
        return ssm_mod.ssm_init_state(cfg, batch, dtype, device)
    if kind == "rglru":
        return rglru_mod.rglru_init_state(cfg, batch, dtype, device)
    raise ValueError(kind)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None):
    """Zero decode caches on ``device`` (the GPU when not given)."""
    device = resolve_device(device)
    n_periods, rem = _split_layers(cfg)
    caches: Dict[str, Any] = {}
    if n_periods:
        caches["scan"] = {
            f"pos{t}": tree_map(
                lambda a: torch.zeros((n_periods,) + tuple(a.shape),
                                      dtype=a.dtype, device=device),
                _layer_cache(cfg, kind, batch, max_len, dtype, "meta"))
            for t, kind in enumerate(cfg.pattern)}
    base = n_periods * len(cfg.pattern)
    caches["rem"] = [_layer_cache(cfg, cfg.layer_kinds[base + t], batch,
                                  max_len, dtype, device) for t in range(rem)]
    return caches


def _cached_stack(params, cfg: ModelConfig, caches, x, step):
    """Run ``step(p, kind, x, cache) -> (x, new cache)`` over the layers in
    order.  Returns (x, the new caches): an attention layer's cache is the
    one given, which ``step`` wrote in place; a recurrent layer's is the
    state it returned (stacked per period), so it keeps the dtype the
    reference gives it."""
    n_periods, rem = _split_layers(cfg)
    new: Dict[str, Any] = {}
    if n_periods:
        outs = {f"pos{t}": [] for t in range(len(cfg.pattern))}
        for c in range(n_periods):
            for t, kind in enumerate(cfg.pattern):
                key = f"pos{t}"
                x, nc = step(_period(params["scan"][key], c), kind, x,
                             _period(caches["scan"][key], c))
                outs[key].append(nc)
        new["scan"] = {
            key: (caches["scan"][key] if kind in ("attn", "local") else
                  tree_map(lambda *a: torch.stack(a), *outs[key]))
            for key, kind in zip(outs, cfg.pattern)}
    base = n_periods * len(cfg.pattern)
    new["rem"] = []
    for t in range(rem):
        x, nc = step(params["rem"][t], cfg.layer_kinds[base + t], x,
                     caches["rem"][t])
        new["rem"].append(nc)
    return x, new


def decode_step(params, cfg: ModelConfig, caches, tokens, cache_pos,
                enc_out: Optional[torch.Tensor] = None):
    """One decode step.  tokens: [B, 1] integer; cache_pos: the position
    (an int or a 0-d integer tensor).  Returns (logits [B, Vp], caches).
    The attention caches of ``caches`` are updated in place (the returned
    tree holds the same k/v tensors); recurrent states are new tensors.

    Local-attention caches are rolling buffers of ``local_window``;
    positions are taken modulo the buffer length for those layers.
    """
    x = _embed(params, cfg, tokens)
    if cfg.is_encoder_decoder:
        x = x + _sinusoid_at(int(cache_pos), cfg.d_model, x.dtype, x.device)
        new_rem = []
        for li in range(cfg.n_layers):
            x, nc = _block_decode(_get_layer(params, cfg, li), cfg,
                                  cfg.layer_kinds[li], x, caches["rem"][li],
                                  cache_pos)
            # cross attention after self-attn block
            cp = params["cross"][li]
            x = x + attn.cross_attn_fwd(
                cp["attn"], cfg, _apply_norm(cp["ln"], cfg, x),
                attn.encode_cross_kv(cp["attn"], cfg, enc_out))
            new_rem.append(nc)
        return _logits(params, cfg, x)[:, 0], {"rem": new_rem}
    x, new = _cached_stack(
        params, cfg, caches, x,
        lambda p, kind, xx, cache: _block_decode(p, cfg, kind, xx, cache,
                                                 cache_pos))
    return _logits(params, cfg, x)[:, 0], new


def _fill_kv(cache, kv, S: int):
    """Write a prefill's k/v [B, S, ...] at the start of ``cache``."""
    cache["k"][:, :S] = kv["k"]
    cache["v"][:, :S] = kv["v"]


def prefill(params, cfg: ModelConfig, tokens, max_len: int,
            enc_frames: Optional[torch.Tensor] = None, dtype=torch.bfloat16):
    """Full-sequence forward that also fills decode caches (on the tokens'
    device).

    Returns (logits [B,S,Vp], caches).  For recurrent blocks the state
    after the last position is stored; for attention the K/V of all
    positions are written into buffers of length ``max_len``.
    """
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    caches = init_caches(cfg, B, max_len, dtype, tokens.device)
    if cfg.is_encoder_decoder:
        # whisper: encode once, run decoder layers filling self-attn caches
        x = x + _sinusoid(S, cfg.d_model, x.dtype, x.device)[None]
        enc_out = encode(params, cfg, enc_frames)
        for li in range(cfg.n_layers):
            p = params["rem"][li]
            h = _apply_norm(p["ln1"], cfg, x)
            h, kv = attn.attn_fwd(p["mixer"], cfg, h, local=False,
                                  return_cache=True)
            _fill_kv(caches["rem"][li], kv, S)
            x = x + h
            cp = params["cross"][li]
            x = x + attn.cross_attn_fwd(
                cp["attn"], cfg, _apply_norm(cp["ln"], cfg, x),
                attn.encode_cross_kv(cp["attn"], cfg, enc_out))
            if "mlp" in p:
                h = _apply_norm(p["ln2"], cfg, x)
                x = x + mlp_mod.mlp_fwd(p["mlp"], cfg, h)
        return _logits(params, cfg, x), caches

    def apply_block_prefill(p, kind, xx, cache):
        h = _apply_norm(p["ln1"], cfg, xx)
        if kind in ("attn", "local"):
            h, kv = attn.attn_fwd(p["mixer"], cfg, h,
                                  local=(kind == "local"), return_cache=True)
            L = cache["k"].shape[1]
            if kind == "local" and cfg.local_window and S > L:
                # keep the last window, aligned to position mod window
                shift = S % L
                cache["k"].copy_(torch.roll(kv["k"][:, -L:], shift, 1))
                cache["v"].copy_(torch.roll(kv["v"][:, -L:], shift, 1))
            else:
                _fill_kv(cache, kv, S)
        elif kind == "ssm":
            h, cache = ssm_mod.ssm_fwd(p["mixer"], cfg, h, return_state=True)
        elif kind == "rglru":
            h, cache = rglru_mod.rglru_fwd(p["mixer"], cfg, h,
                                           return_state=True)
        if cfg.use_post_norm:
            h = _apply_norm(p["pn1"], cfg, h)
        xx = xx + h
        if "mlp" in p:
            h = _apply_norm(p["ln2"], cfg, xx)
            if cfg.n_experts:
                h, _ = mlp_mod.moe_fwd(p["mlp"], cfg, h)
            else:
                h = mlp_mod.mlp_fwd(p["mlp"], cfg, h)
            if cfg.use_post_norm:
                h = _apply_norm(p["pn2"], cfg, h)
            xx = xx + h
        return xx, cache

    x, caches = _cached_stack(params, cfg, caches, x, apply_block_prefill)
    return _logits(params, cfg, x), caches
