"""gemma3-27b — 5:1 local:global hybrid, 128k context
[hf:google/gemma-3-1b-pt].  62L d_model=5376 32H (kv=16) d_ff=21504
vocab=262144, local window 1024, qk-norm, sqrt(d) embedding scale."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="hybrid",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab=262144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    qk_norm=True, local_window=1024, rope_theta=1e6,
    mlp_act="gelu", emb_scale=True, use_post_norm=True, tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=7, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, local_window=16)
