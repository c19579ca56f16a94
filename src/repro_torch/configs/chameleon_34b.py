"""chameleon-34b — early-fusion VLM backbone, VQ image tokens in the
vocab [arXiv:2405.09818].  48L d_model=8192 64H (kv=8) d_ff=22016
vocab=65536, qk-norm.  The VQ tokenizer frontend is a stub per the
assignment: inputs are token ids over the joint text+image vocabulary."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=65536,
    pattern=("attn",), qk_norm=True, rope_theta=1e4, mlp_act="silu",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512)
