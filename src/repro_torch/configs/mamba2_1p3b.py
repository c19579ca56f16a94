"""mamba2-1.3b — SSD (state-space duality), attention-free
[arXiv:2405.21060].  48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280,
    pattern=("ssm",),
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128, ssm_conv=4,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, vocab=512, ssm_state=16,
        ssm_head_dim=32, ssm_chunk=32)
