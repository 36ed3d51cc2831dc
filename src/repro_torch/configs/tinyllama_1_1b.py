"""TinyLlama 1.1B — llama2-architecture small dense model [arXiv:2401.02385]."""
from repro_torch.common.config import ArchConfig, register


@register("tinyllama-1.1b")
def config() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b",
        family="dense",
        num_layers=22,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        d_ff=5632,
        vocab_size=32000,
        head_dim=64,
        activation="silu",
        rope_theta=10000.0,
        source="arXiv:2401.02385",
    )
