"""Decoder-only LM: the dense attention, Mamba and Jamba-hybrid families
with dense FFNs (port of `repro/models/lm.py`: `layer_pattern` "attn",
"mamba" and "jamba"; MoE FFNs, xLSTM, the encoder-decoder and the modality
frontends raise and are ROADMAP Queue 1 item 13).

The layer stack is organised into *periods*, as in the reference: a period
is the smallest repeating pattern of blocks (1 layer for a homogeneous
stack, 8 for Jamba's 7 Mamba + 1 attention), the params of all periods are
stacked along a leading axis (`periods`), and the forward pass loops over
it in Python (the reference scans). Public API:

    period_spec(cfg)                 -> ((mixer, ffn), ...) per layer in period
    init_lm(cfg, generator, dtype)   -> params
    lm_logits(params, cfg, tokens)   -> ((B, S, padded_vocab), aux)
    init_cache(cfg, batch, cache_len, dtype)      -> cache
    lm_prefill(params, cfg, tokens, cache)        -> (logits_last, cache)
    lm_decode(params, cfg, cache, token)          -> (logits, cache)

A cache is {"periods": {"blk<i>_attn": {"k", "v"}, "blk<i>_mamba":
{"conv", "ssm"}}, "pos": int}, each tensor stacked by period; prefill and
decode write its tensors in place and return it with the new position. On
the card a prefill launches the flash attention kernel once per attention
layer and the selective-scan kernel once per Mamba layer.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.common.config import ArchConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import normal_init, tree_map
from repro_torch.models import blocks as B
from repro_torch.models.layers import (embed, ffn, init_embedding, init_ffn,
                                       init_rmsnorm, linear, rmsnorm)

NOT_PORTED = "ROADMAP Queue 1 item 13"


def _check_supported(cfg: ArchConfig) -> None:
    why = []
    if cfg.family == "audio" or cfg.cross_attention:
        why.append("the encoder-decoder family")
    if cfg.layer_pattern not in ("attn", "mamba", "jamba"):
        why.append(f"layer_pattern {cfg.layer_pattern!r}")
    if cfg.moe is not None:
        why.append("MoE FFNs")
    if cfg.frontend != "none":
        why.append(f"the {cfg.frontend} frontend")
    if why:
        raise ValueError(
            f"{cfg.name}: {', '.join(why)} not ported yet ({NOT_PORTED}); "
            "the port's LM covers layer_pattern 'attn', 'mamba' and 'jamba' "
            "with dense FFNs")


# ----------------------------------------------------------------------
def period_spec(cfg: ArchConfig) -> Tuple[Tuple[str, str], ...]:
    """Per-layer (mixer, ffn) pattern within one period."""
    _check_supported(cfg)
    if cfg.layer_pattern == "jamba":
        return tuple(("attn" if i == cfg.attn_period - 1 else "mamba", "dense")
                     for i in range(cfg.attn_period))
    if cfg.layer_pattern == "mamba":
        return (("mamba", "dense" if cfg.d_ff else "none"),)
    return (("attn", "dense"),)


def n_periods(cfg: ArchConfig) -> int:
    plen = len(period_spec(cfg))
    assert cfg.num_layers % plen == 0, (cfg.name, cfg.num_layers, plen)
    return cfg.num_layers // plen


def _period(tree, p: int):
    """Period p's slice of a stacked params or cache subtree (views)."""
    return tree_map(lambda x: x[p], tree)


# ----------------------------------------------------------------------
def init_lm(cfg: ArchConfig, generator: torch.Generator,
            dtype=torch.float32, *, device=None) -> Dict:
    """Random LM params with the reference's tree, shapes and stddevs,
    drawn from `generator` on `device` (`periods` leaves stacked along a
    leading axis of n_periods)."""
    dev = resolve_device(device)
    lead = (n_periods(cfg),)
    d = cfg.d_model
    periods: Dict = {}
    for i, (mixer, f) in enumerate(period_spec(cfg)):
        periods[f"norm{i}_mix"] = {"scale": torch.ones(lead + (d,),
                                                       device=dev)}
        if mixer == "attn":
            periods[f"blk{i}_attn"] = B.init_attn(generator, cfg, lead=lead,
                                                  device=dev)
        else:
            periods[f"blk{i}_mamba"] = B.init_mamba(generator, cfg, cfg.ssm,
                                                    lead=lead, device=dev)
        if f == "dense":
            periods[f"norm{i}_ffn"] = {"scale": torch.ones(lead + (d,),
                                                           device=dev)}
            periods[f"blk{i}_ffn"] = init_ffn(generator, d, cfg.d_ff,
                                              cfg.activation, lead=lead,
                                              device=dev)
    params = {
        "embed": init_embedding(generator, cfg.padded_vocab, d, device=dev),
        "final_norm": init_rmsnorm(d, device=dev),
        "periods": periods,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": normal_init(
            generator, (d, cfg.padded_vocab), stddev=1 / math.sqrt(d),
            device=dev)}
    if dtype != torch.float32:
        params = tree_map(lambda x: x.to(dtype), params)
    return params


# ----------------------------------------------------------------------
def _ffn_apply(pp, cfg: ArchConfig, i: int, f: str, x):
    if f == "none":
        return x
    h = rmsnorm(pp[f"norm{i}_ffn"], x, cfg.norm_eps)
    return x + ffn(pp[f"blk{i}_ffn"], h, cfg.activation)


def _embed_tokens(params, cfg: ArchConfig, tokens, dtype):
    x = embed(params["embed"], tokens, dtype=dtype)
    if cfg.name.startswith("gemma"):
        x = x * math.sqrt(cfg.d_model)
    return x


def _head(params, cfg: ArchConfig, x):
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["table"].to(h.dtype).T
    else:
        logits = linear(params["lm_head"], h)
    # mask padding vocab entries
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                               device=x.device), logits)
    return logits


def lm_logits(params, cfg: ArchConfig, tokens, compute_dtype=torch.float32,
              *, impl: str = "auto"):
    """Full-sequence causal logits (the training forward) and the aux loss
    (0 for dense FFNs)."""
    x = _embed_tokens(params, cfg, tokens, compute_dtype)
    for p in range(n_periods(cfg)):
        pp = _period(params["periods"], p)
        for i, (mixer, f) in enumerate(period_spec(cfg)):
            h = rmsnorm(pp[f"norm{i}_mix"], x, cfg.norm_eps)
            if mixer == "attn":
                y = B.attn_train(pp[f"blk{i}_attn"], cfg, h, causal=True,
                                 window=cfg.sliding_window, impl=impl)
            else:
                y = B.mamba_train(pp[f"blk{i}_mamba"], cfg, cfg.ssm, h,
                                  impl=impl)
            x = _ffn_apply(pp, cfg, i, f, x + y)
    return _head(params, cfg, x), torch.zeros((), device=x.device)


# ----------------------------------------------------------------------
# caches
def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, *, device=None) -> Dict:
    """cache_len: attention KV capacity. With cfg.sliding_window > 0 and
    cache_len >= window, attention caches are rolling ``window``-sized
    rings. Mamba caches hold the conv tail in `dtype` and the fp32 state."""
    dev = resolve_device(device)
    attn_len = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
                else cache_len)
    kw = dict(lead=(n_periods(cfg),), device=dev)
    per: Dict = {}
    for i, (mixer, _f) in enumerate(period_spec(cfg)):
        if mixer == "attn":
            per[f"blk{i}_attn"] = B.init_attn_cache(cfg, batch, attn_len,
                                                    dtype, **kw)
        else:
            per[f"blk{i}_mamba"] = B.init_mamba_cache(cfg, cfg.ssm, batch,
                                                      dtype, **kw)
    return {"periods": per, "pos": 0}


def _run_cached(params, cfg: ArchConfig, x, cache, pos: int, *, decode: bool,
                impl: str = "auto"):
    """Shared prefill/decode loop over periods. x: (B, S, d). Writes the
    cache's tensors in place and returns (x, cache["periods"])."""
    for p in range(n_periods(cfg)):
        pp = _period(params["periods"], p)
        pc = _period(cache["periods"], p)
        for i, (mixer, f) in enumerate(period_spec(cfg)):
            key = f"blk{i}_{mixer}"
            h = rmsnorm(pp[f"norm{i}_mix"], x, cfg.norm_eps)
            if mixer == "attn" and decode:
                y, _ = B.attn_decode(pp[key], cfg, h, pc[key], pos,
                                     window=cfg.sliding_window)
            elif mixer == "attn":
                y, _ = B.attn_prefill(pp[key], cfg, h, pc[key],
                                      window=cfg.sliding_window, impl=impl)
            elif decode:
                y, _ = B.mamba_decode(pp[key], cfg, cfg.ssm, h, pc[key])
            else:
                y, _ = B.mamba_prefill(pp[key], cfg, cfg.ssm, h, pc[key],
                                       impl=impl)
            x = _ffn_apply(pp, cfg, i, f, x + y)
    return x, cache["periods"]


def lm_prefill(params, cfg: ArchConfig, tokens, cache,
               compute_dtype=torch.bfloat16, *, impl: str = "auto"):
    """Process the prompt; returns last-position logits + filled cache.
    `impl` picks the prefill attention and scan: "auto" (the kernels on
    the card, the plain versions on the CPU) or "ref" (the plain versions
    anywhere)."""
    x = _embed_tokens(params, cfg, tokens, compute_dtype)
    x, periods = _run_cached(params, cfg, x, cache, 0, decode=False,
                             impl=impl)
    logits = _head(params, cfg, x[:, -1:])
    return logits, {"periods": periods, "pos": int(tokens.shape[1])}


def lm_decode(params, cfg: ArchConfig, cache, token,
              compute_dtype=torch.bfloat16):
    """token: (B, 1) -> (logits (B, 1, V), cache')."""
    x = _embed_tokens(params, cfg, token, compute_dtype)
    pos = int(cache["pos"])
    x, periods = _run_cached(params, cfg, x, cache, pos, decode=True)
    return _head(params, cfg, x), {"periods": periods, "pos": pos + 1}
