"""whisper-tiny — encoder-decoder ASR backbone [arXiv:2212.04356].
4+4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.  The conv frontend is
a stub per the assignment: ``input_specs`` feeds precomputed frame
embeddings (B, 1500, d).  Both sides use sinusoidal positions
(simplification of whisper's learned decoder positions)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab=51865,
    pattern=("attn",), qkv_bias=True, mlp_act="gelu",
    use_layer_norm_bias=True, norm_eps=1e-5,
    is_encoder_decoder=True, n_encoder_layers=4, encoder_len=1500,
    rope_theta=1e4,
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, encoder_len=32)
