"""phi3-medium-14b — dense, RoPE SwiGLU GQA [arXiv:2404.14219].
40L d_model=5120 40H (kv=10) d_ff=17920 vocab=100352."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab=100352,
    pattern=("attn",), rope_theta=1e4, mlp_act="silu",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512)
