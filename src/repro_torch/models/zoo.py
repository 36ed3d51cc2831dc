"""Model zoo: a uniform interface over every architecture family (port of
`repro/models/zoo.py`: the decoder-only families through `models.lm` and
the audio encoder-decoder through `models.encdec`).

    model = build_model(cfg)
    params = model.init(generator, dtype, device=...)
    loss, metrics = model.loss(params, batch)        # training
    cache = model.make_cache(batch, cache_len, dtype, device=...)
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.decode(params, cache, token)

``batch`` is a dict: tokens (+ labels for the loss, frames for audio,
image_embeds for vlm).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.common.config import ArchConfig
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    make_cache: Callable[..., Any]


def _frontend_of(cfg: ArchConfig, batch: Dict):
    if cfg.frontend == "vision":
        return batch["image_embeds"]
    if cfg.frontend == "audio":
        return batch.get("frames")
    return None


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family == "audio":
        def init(generator, dtype=torch.float32, *, device=None):
            return ED.init_encdec(cfg, generator, dtype, device=device)

        def loss(params, batch: Dict, compute_dtype=torch.float32,
                 remat: bool = False, *, impl: str = "auto"):
            del remat  # 12+12 layers: fits without activation checkpointing
            return ED.encdec_loss(params, cfg, batch["frames"],
                                  batch["tokens"], batch["labels"],
                                  compute_dtype, impl=impl)

        def make_cache(batch_size, cache_len, dtype=torch.bfloat16, *,
                       enc_len: Optional[int] = None, device=None):
            return ED.init_encdec_cache(cfg, batch_size, cache_len,
                                        enc_len or cfg.frontend_tokens,
                                        dtype, device=device)

        def prefill(params, batch: Dict, cache, compute_dtype=torch.bfloat16,
                    *, impl: str = "auto", moe_dropless: bool = True):
            del moe_dropless  # no MoE in the enc-dec family
            return ED.encdec_prefill(params, cfg, batch["frames"],
                                     batch["tokens"], cache, compute_dtype,
                                     impl=impl)

        def decode(params, cache, token, compute_dtype=torch.bfloat16, *,
                   moe_dropless: bool = True):
            del moe_dropless
            return ED.encdec_decode(params, cfg, cache, token, compute_dtype)

        return Model(cfg, init, loss, prefill, decode, make_cache)

    LM.n_periods(cfg)                 # raises for an unknown layer pattern

    # decoder-only families (dense / moe / ssm / hybrid / vlm)
    def init(generator, dtype=torch.float32, *, device=None):
        return LM.init_lm(cfg, generator, dtype, device=device)

    def loss(params, batch: Dict, compute_dtype=torch.float32,
             remat: bool = False, *, impl: str = "auto"):
        return LM.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                          frontend=_frontend_of(cfg, batch),
                          compute_dtype=compute_dtype, remat=remat, impl=impl)

    def make_cache(batch_size, cache_len, dtype=torch.bfloat16, *,
                   device=None):
        # the VLM prefill prepends the projected patch embeddings, so the
        # KV cache holds frontend_tokens more positions
        if cfg.frontend == "vision":
            cache_len = cache_len + cfg.frontend_tokens
        return LM.init_cache(cfg, batch_size, cache_len, dtype, device=device)

    def prefill(params, batch: Dict, cache, compute_dtype=torch.bfloat16, *,
                impl: str = "auto", moe_dropless: bool = True):
        return LM.lm_prefill(params, cfg, batch["tokens"], cache,
                             compute_dtype, frontend=_frontend_of(cfg, batch),
                             impl=impl, moe_dropless=moe_dropless)

    def decode(params, cache, token, compute_dtype=torch.bfloat16, *,
               moe_dropless: bool = True):
        return LM.lm_decode(params, cfg, cache, token, compute_dtype,
                            moe_dropless=moe_dropless)

    return Model(cfg, init, loss, prefill, decode, make_cache)
