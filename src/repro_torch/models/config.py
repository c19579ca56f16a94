"""Unified model configuration for all assigned architectures.

One config describes a pattern-interleaved decoder stack (dense attention,
local attention, Mamba-2 SSD, RG-LRU), dense or MoE MLPs, plus the
whisper encoder-decoder special case.  Sharding-induced padding
(``pad_heads_multiple``, ``pad_vocab_multiple``) is explicit: padded q/kv
heads have zero output-projection rows and padded vocab rows never win
the softmax, so logical outputs are unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from .common import pad_to


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # repeating block pattern; entries: attn | local | ssm | rglru
    pattern: Tuple[str, ...] = ("attn",)
    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    local_window: int = 0
    attn_softcap: float = 0.0
    # mlp
    mlp_act: str = "silu"
    use_post_norm: bool = False
    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_groups: int = 1
    # rglru (recurrentgemma)
    rglru_width: int = 0            # recurrence width (defaults to d_model)
    rglru_conv: int = 4
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500         # precomputed frame embeddings (stub)
    use_layer_norm_bias: bool = False
    # embeddings / misc
    tie_embeddings: bool = False
    emb_scale: bool = False         # gemma-style sqrt(d) embedding scale
    norm_eps: float = 1e-6
    # sharding-induced padding (1 = no padding; 16 on the production mesh)
    pad_heads_multiple: int = 1
    pad_vocab_multiple: int = 1
    # numerics
    remat: bool = True
    # dry-run probes: unroll every layer (no scan) so cost_analysis counts
    # each layer explicitly (see launch/roofline.py methodology)
    force_unroll: bool = False

    # ---- derived ---------------------------------------------------------
    @property
    def padded_heads(self) -> int:
        return pad_to(self.n_heads, self.pad_heads_multiple)

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab, max(self.pad_vocab_multiple, 1))

    @property
    def ssm_heads(self) -> int:
        return (self.d_model * self.ssm_expand) // self.ssm_head_dim

    @property
    def rec_width(self) -> int:
        return self.rglru_width or self.d_model

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        reps = math.ceil(self.n_layers / len(self.pattern))
        return tuple((self.pattern * reps)[: self.n_layers])

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.head_dim
        n = self.padded_vocab * d                       # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        for kind in self.layer_kinds:
            if kind in ("attn", "local"):
                n += d * (self.n_heads + 2 * self.n_kv_heads) * hd
                n += self.n_heads * hd * d
            elif kind == "ssm":
                di = d * self.ssm_expand
                n += d * (2 * di + 2 * self.ssm_groups * self.ssm_state
                          + self.ssm_heads)
                n += di * d
            elif kind == "rglru":
                r = self.rec_width
                n += d * 2 * r + r * d + 3 * r
            if self.n_experts:
                n += d * self.n_experts                 # router
                n += self.n_experts * 3 * d * self.moe_d_ff
                n += self.n_shared_experts * 3 * d * self.d_ff
            elif self.d_ff:
                n += 3 * d * self.d_ff
        if self.is_encoder_decoder:
            for _ in range(self.n_encoder_layers):
                n += 4 * d * d + 3 * d * self.d_ff      # enc self-attn + mlp
                n += 4 * d * d                          # dec cross-attn
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        inactive = (self.n_experts - self.top_k) * 3 * self.d_model \
            * self.moe_d_ff * len(self.layer_kinds)
        return full - inactive
