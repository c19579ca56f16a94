"""qwen3-14b — dense, qk-norm GQA [hf:Qwen/Qwen3-8B].
40L d_model=5120 40H (kv=8) d_ff=17408 vocab=151936."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936,
    pattern=("attn",), qk_norm=True, rope_theta=1e6, mlp_act="silu",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512)
