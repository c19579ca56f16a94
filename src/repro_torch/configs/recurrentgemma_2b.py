"""recurrentgemma-2b — RG-LRU + local attention 1:2 hybrid
[arXiv:2402.19427].  26L d_model=2560 10H (kv=1) d_ff=7680 vocab=256000,
window 2048, GeGLU."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000,
    pattern=("rglru", "rglru", "local"),
    local_window=2048, mlp_act="gelu", emb_scale=True, tie_embeddings=True,
    rglru_width=2560, rglru_conv=4,
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=512, local_window=16, rglru_width=64)
