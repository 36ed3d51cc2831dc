"""InternVL2 1B — InternViT (stub) + InternLM2-like 0.5B LM backbone
[arXiv:2404.16821]. The ViT + projector is the modality stub: input_specs
provides 256 patch embeddings per image."""
from repro_torch.common.config import ArchConfig, register


@register("internvl2-1b")
def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-1b",
        family="vlm",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        head_dim=64,
        activation="silu",
        qkv_bias=True,
        rope_theta=1000000.0,
        frontend="vision",
        frontend_tokens=256,                # ViT patch tokens after projector
        frontend_dim=896,
        tie_embeddings=True,
        source="arXiv:2404.16821",
    )
