"""Gemma 7B — dense GeGLU model, head_dim=256 [arXiv:2403.08295]."""
from repro_torch.common.config import ArchConfig, register


@register("gemma-7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        d_ff=24576,
        vocab_size=256000,
        head_dim=256,
        activation="geglu",
        tie_embeddings=True,
        source="arXiv:2403.08295",
    )
