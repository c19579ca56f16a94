"""moonshot-v1-16b-a3b — MoE 64e top-6 (kimi/moonlight)
[hf:moonshotai/Moonlight-16B-A3B].  48L d_model=2048 16H (kv=16)
expert d_ff=1408 vocab=163840.  (The assignment's 48-layer config yields
~28B total params; the released Moonlight checkpoint is shallower —
we follow the assignment numbers.)"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=163840,
    pattern=("attn",), mlp_act="silu", rope_theta=5e4,
    n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=64, vocab=512, n_experts=8, top_k=2, moe_d_ff=64,
        n_shared_experts=1, capacity_factor=4.0)
