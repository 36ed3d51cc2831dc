"""OLMoE 1B-7B — 64-expert top-8 MoE, MoE in every layer [arXiv:2409.02060]."""
from repro_torch.common.config import ArchConfig, MoEConfig, register


@register("olmoe-1b-7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="olmoe-1b-7b",
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        head_dim=128,
        activation="silu",
        moe=MoEConfig(num_experts=64, experts_per_token=8, expert_d_ff=1024,
                      layer_period=1),
        source="arXiv:2409.02060",
    )
