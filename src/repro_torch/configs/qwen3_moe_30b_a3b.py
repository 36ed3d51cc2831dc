"""Qwen3-30B-A3B — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.common.config import ArchConfig, MoEConfig, register


@register("qwen3-moe-30b-a3b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        d_ff=768,
        vocab_size=151936,
        head_dim=128,
        activation="silu",
        rope_theta=1000000.0,
        moe=MoEConfig(num_experts=128, experts_per_token=8, expert_d_ff=768,
                      layer_period=1),
        source="hf:Qwen/Qwen3-30B-A3B",
    )
