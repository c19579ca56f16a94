"""Assigned input-shape cells and meta-tensor input specs.

  train_4k     seq 4096  × gb 256   -> train_step
  prefill_32k  seq 32768 × gb 32    -> prefill forward
  decode_32k   1 token, 32768-cache × gb 128 -> serve_step
  long_500k    1 token, 524288-cache × gb 1  -> serve_step (sub-quadratic
               state families only; full-attention archs skip)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

# families that can run 1-token decode against a 500k context with
# sub-quadratic state (SSM / RG-LRU hybrid / local:global hybrid)
LONG_OK_FAMILIES = ("ssm", "hybrid")


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    if cell.name == "long_500k":
        if cfg.name == "gemma3-27b":
            return True, "5:1 local:global — global KV seq-sharded"
        if cfg.family not in LONG_OK_FAMILIES:
            return False, "pure full-attention arch (quadratic) — skipped"
    if cell.kind == "decode" and cfg.is_encoder_decoder:
        # whisper has a decoder; decode cells lower mechanically with the
        # caveat that the real model caps decoder length at 448.
        return True, "enc-dec: decoder-side cache (mechanical beyond 448)"
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    B, S = cell.global_batch, cell.seq_len
    i32 = torch.int32
    if cell.kind == "train":
        specs = {"tokens": _spec((B, S), i32),
                 "targets": _spec((B, S), i32)}
        if cfg.is_encoder_decoder:
            specs["enc_frames"] = _spec((B, cfg.encoder_len, cfg.d_model),
                                        torch.bfloat16)
        return specs
    if cell.kind == "prefill":
        specs = {"tokens": _spec((B, S), i32)}
        if cfg.is_encoder_decoder:
            specs["enc_frames"] = _spec((B, cfg.encoder_len, cfg.d_model),
                                        torch.bfloat16)
        return specs
    # decode: one new token against a seq_len cache
    specs = {"tokens": _spec((B, 1), i32),
             "cache_pos": _spec((), i32)}
    if cfg.is_encoder_decoder:
        specs["enc_out"] = _spec((B, cfg.encoder_len, cfg.d_model),
                                 torch.bfloat16)
    return specs
