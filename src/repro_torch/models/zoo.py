"""Model zoo: a uniform interface over the architecture families the port
supports (port of `repro/models/zoo.py`, the decoder-only families with
dense FFNs: dense attention, Mamba, and the Jamba hybrid of Mamba and
attention layers; MoE FFNs, xLSTM, the audio encoder-decoder and the VLM
frontend raise and are ROADMAP Queue 1 item 13).

    model = build_model(cfg)
    params = model.init(generator, dtype, device=...)
    cache = model.make_cache(batch, cache_len, dtype, device=...)
    logits, cache = model.prefill(params, batch, cache)   # batch["tokens"]
    logits, cache = model.decode(params, cache, token)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.common.config import ArchConfig
from repro_torch.models import lm as LM


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    make_cache: Callable[..., Any]


def build_model(cfg: ArchConfig) -> Model:
    LM.period_spec(cfg)               # raises for what is not ported

    def init(generator, dtype=torch.float32, *, device=None):
        return LM.init_lm(cfg, generator, dtype, device=device)

    def make_cache(batch_size, cache_len, dtype=torch.bfloat16, *,
                   device=None):
        return LM.init_cache(cfg, batch_size, cache_len, dtype, device=device)

    def prefill(params, batch: Dict, cache, compute_dtype=torch.bfloat16, *,
                impl: str = "auto"):
        return LM.lm_prefill(params, cfg, batch["tokens"], cache,
                             compute_dtype, impl=impl)

    def decode(params, cache, token, compute_dtype=torch.bfloat16):
        return LM.lm_decode(params, cfg, cache, token, compute_dtype)

    return Model(cfg, init, prefill, decode, make_cache)
