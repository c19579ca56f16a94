"""llama4-scout-17b-a16e — MoE 16e top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].  48L d_model=5120 40H (kv=8)
d_ff=8192 vocab=202048."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    pattern=("attn",), mlp_act="silu", rope_theta=5e5,
    n_experts=16, top_k=1, moe_d_ff=8192, n_shared_experts=1,
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, n_experts=4, top_k=1, moe_d_ff=128,
        n_shared_experts=1, capacity_factor=4.0)
