"""qwen1.5-4b — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B].
40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab=151936,
    pattern=("attn",), qkv_bias=True, rope_theta=1e6, mlp_act="silu",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512)
