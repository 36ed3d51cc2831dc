"""Configuration system: architecture configs + registry (port of
`repro/common/config.py`, copied as data; it needs neither jax nor torch).

Every assigned architecture gets a module in ``repro_torch.configs`` that
builds an :class:`ArchConfig` with the exact dimensions from its source
paper/model card and registers it under its public id (e.g.
``--arch tinyllama-1.1b``).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    # d_ff of each expert (may differ from the dense d_ff)
    expert_d_ff: int
    # apply MoE every `period` layers (1 = every layer, 2 = alternate)
    layer_period: int = 1
    # load-balancing auxiliary loss coefficient
    aux_loss_coef: float = 0.01
    # router jitter for training
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM / xLSTM cell dims."""
    state_dim: int = 16          # N (per-channel state)
    conv_width: int = 4
    expand: int = 2              # inner dim = expand * d_model
    dt_rank: int = 0             # 0 -> ceil(d_model / 16)
    # xLSTM: number of mLSTM heads
    mlstm_heads: int = 4


@dataclass(frozen=True)
class ArchConfig:
    """One schedulable AIGC service / model family instance."""
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    activation: str = "silu"     # silu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 1 << 20
    # attention variant: 0 = full; >0 = sliding window size (tokens)
    sliding_window: int = 0
    # mixture of experts (None = dense FFN)
    moe: Optional[MoEConfig] = None
    # ssm/hybrid params
    ssm: Optional[SSMConfig] = None
    # layer pattern: "attn" | "mamba" | "jamba" | "xlstm"
    layer_pattern: str = "attn"
    # hybrid (jamba): attention layer every `attn_period` layers
    attn_period: int = 8
    # encoder-decoder (whisper): number of encoder layers consumed as a stub
    encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub: none | audio | vision
    frontend: str = "none"
    # vision/audio stub shapes (frames/patches, produced by input_specs())
    frontend_tokens: int = 0
    frontend_dim: int = 0
    # citation (source paper / model card)
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so embeddings shard on 16-way axes."""
        return _round_up(self.vocab_size, 256)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def is_recurrent(self) -> bool:
        return self.layer_pattern in ("mamba", "xlstm")

    def is_subquadratic(self) -> bool:
        """True if long-context decode is supported natively or via window."""
        return self.layer_pattern in ("mamba", "xlstm", "jamba") or self.sliding_window > 0

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        vocab = min(self.vocab_size, 1024)
        if self.vocab_size % 256 and vocab % 256 == 0:
            vocab -= 24  # preserve the "vocab needs padding" property
        num_heads = min(self.num_heads, 4)
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        while num_heads % num_kv:
            num_kv -= 1
        d_model = min(self.d_model, 256)
        head_dim = min(self.resolved_head_dim, d_model // num_heads)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(4, self.moe.num_experts),
                experts_per_token=min(2, self.moe.experts_per_token),
                expert_d_ff=min(128, self.moe.expert_d_ff))
        if self.layer_pattern == "jamba":
            layers = self.attn_period
        elif self.layer_pattern == "xlstm":
            layers = 4
        elif self.moe is not None and self.moe.layer_period > 1:
            layers = self.moe.layer_period
        else:
            layers = 2
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=layers,
            encoder_layers=min(self.encoder_layers, 2),
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            moe=moe,
            vocab_size=vocab,
            frontend_tokens=min(self.frontend_tokens, 16) if self.frontend_tokens else 0,
            frontend_dim=d_model if self.frontend != "none" else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
        )

    # parameter count (embedding + per-layer), used by the latency table
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        n_attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        if self.activation == "geglu":
            n_ffn_dense = 3 * d * self.d_ff
        else:
            n_ffn_dense = 3 * d * self.d_ff  # gate/up/down (llama-style)
        total = 0
        for i in range(self.num_layers):
            if self.layer_pattern == "attn":
                is_attn = True
            elif self.layer_pattern == "jamba":
                is_attn = (i % self.attn_period) == (self.attn_period - 1)
            else:
                is_attn = False
            if is_attn:
                total += n_attn
            elif self.ssm is not None:
                inner = self.ssm.expand * d
                total += 2 * d * inner + inner * (2 * self.ssm.state_dim + 2) + inner * d
            if self.moe is not None and (i % self.moe.layer_period) == 0:
                e = self.moe.experts_per_token if active_only else self.moe.num_experts
                total += e * 3 * d * self.moe.expert_d_ff + d * self.moe.num_experts
            elif self.d_ff:
                total += n_ffn_dense
        total += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return total


# ----------------------------------------------------------------------
# registry
_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}

ASSIGNED_ARCHS: Tuple[str, ...] = (
    "jamba-v0.1-52b",
    "tinyllama-1.1b",
    "whisper-small",
    "gemma-7b",
    "olmoe-1b-7b",
    "llama3.2-3b",
    "qwen2-1.5b",
    "internvl2-1b",
    "qwen3-moe-30b-a3b",
    "xlstm-125m",
)


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def _load_all():
    # import the configs package, which registers everything
    importlib.import_module("repro_torch.configs")


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> List[str]:
    _load_all()
    return sorted(_REGISTRY)
