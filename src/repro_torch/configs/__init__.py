"""Architecture config registry: importing this package registers all configs."""
from repro_torch.configs import (  # noqa: F401
    jamba_v01_52b,
    tinyllama_1_1b,
    whisper_small,
    gemma_7b,
    olmoe_1b_7b,
    llama3_2_3b,
    qwen2_1_5b,
    internvl2_1b,
    qwen3_moe_30b_a3b,
    xlstm_125m,
)
