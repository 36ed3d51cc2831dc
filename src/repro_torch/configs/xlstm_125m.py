"""xLSTM 125M — sLSTM + mLSTM recurrent blocks, no separate FFN (d_ff=0)
[arXiv:2405.04517]."""
from repro_torch.common.config import ArchConfig, SSMConfig, register


@register("xlstm-125m")
def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        head_dim=192,
        activation="silu",
        layer_pattern="xlstm",
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, mlstm_heads=4),
        tie_embeddings=True,
        source="arXiv:2405.04517",
    )
