"""Llama 3.2 3B — small llama3 dense GQA [hf:meta-llama/Llama-3.2-1B family]."""
from repro_torch.common.config import ArchConfig, register


@register("llama3.2-3b")
def config() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-3b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        head_dim=128,
        activation="silu",
        rope_theta=500000.0,
        tie_embeddings=True,
        source="hf:meta-llama/Llama-3.2-1B",
    )
