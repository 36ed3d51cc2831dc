"""Qwen2 1.5B — dense GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.common.config import ArchConfig, register


@register("qwen2-1.5b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-1.5b",
        family="dense",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        head_dim=128,
        activation="silu",
        qkv_bias=True,
        rope_theta=1000000.0,
        tie_embeddings=True,
        source="arXiv:2407.10671",
    )
