"""Jamba v0.1 52B — hybrid Mamba+attention (1:7 interleave) with 16-expert
top-2 MoE [arXiv:2403.19887]."""
from repro_torch.common.config import ArchConfig, MoEConfig, SSMConfig, register


@register("jamba-v0.1-52b")
def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        head_dim=128,
        activation="silu",
        layer_pattern="jamba",
        attn_period=8,                      # 1 attention layer per 8 (1:7)
        moe=MoEConfig(num_experts=16, experts_per_token=2, expert_d_ff=14336,
                      layer_period=2),
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
        source="arXiv:2403.19887",
    )
