"""Whisper small — encoder-decoder audio backbone; mel+conv frontend is a
stub providing 1500 frame embeddings [arXiv:2212.04356]."""
from repro_torch.common.config import ArchConfig, register


@register("whisper-small")
def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-small",
        family="audio",
        num_layers=12,                      # decoder layers
        encoder_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        head_dim=64,
        activation="gelu",
        cross_attention=True,
        layer_pattern="attn",
        frontend="audio",
        frontend_tokens=1500,               # 30 s of audio at 50 Hz
        frontend_dim=768,
        tie_embeddings=True,
        source="arXiv:2212.04356",
    )
