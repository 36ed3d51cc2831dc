"""Unified decoder-only LM covering the dense, MoE, SSM, hybrid and VLM
families (port of `repro/models/lm.py`: `layer_pattern` "attn", "jamba",
"mamba" and "xlstm", dense or MoE FFNs, the vision frontend, and the
training loss `lm_loss`).

The layer stack is organised into *periods*, as in the reference: a period
is the smallest repeating pattern of blocks (1 layer for a homogeneous
stack, 8 for Jamba's 7 Mamba + 1 attention, 4 for xLSTM's 3 mLSTM + 1
sLSTM), the params of all periods are stacked along a leading axis
(`periods`), and the forward pass loops over it in Python (the reference
scans). Public API:

    period_spec(cfg)                 -> ((mixer, ffn), ...) per layer in period
    init_lm(cfg, generator, dtype)   -> params
    lm_loss(params, cfg, tokens, labels, ...)     -> (loss, metrics)
    lm_logits(params, cfg, tokens, frontend=...)  -> ((B, S, padded_vocab), aux)
    init_cache(cfg, batch, cache_len, dtype)      -> cache
    lm_prefill(params, cfg, tokens, cache, frontend=...) -> (logits_last, cache)
    lm_decode(params, cfg, cache, token)          -> (logits, cache)

A cache is {"periods": {"blk<i>_attn": {"k", "v"}, "blk<i>_mamba":
{"conv", "ssm"}, "blk<i>_mlstm": {"C", "n", "m"}, "blk<i>_slstm": {"c",
"n", "h", "m"}}, "pos": int}, each tensor stacked by period; prefill and
decode write its tensors in place and return it with the new position. On
the card a prefill launches the flash attention kernel once per attention
layer and the selective-scan kernel once per Mamba layer; a training step
launches each layer's forward kernel once (twice with `remat`) and its
backward kernel once. `frontend`
(VLM: (B, frontend_tokens, frontend_dim) patch embeddings) is projected
and prepended to the token embeddings, so its positions count in `pos`.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ArchConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import normal_init, tree_map
from repro_torch.models import blocks as B
from repro_torch.models.layers import (embed, ffn, init_embedding, init_ffn,
                                       init_rmsnorm, linear, next_token_nll,
                                       rmsnorm)
from repro_torch.sharding.context import constrain


# ----------------------------------------------------------------------
def period_spec(cfg: ArchConfig) -> Tuple[Tuple[str, str], ...]:
    """Per-layer (mixer, ffn) pattern within one period."""
    if cfg.layer_pattern == "attn":
        if cfg.moe is not None and cfg.moe.layer_period > 1:
            lp = cfg.moe.layer_period
            return tuple(("attn", "moe" if i % lp == lp - 1 else "dense")
                         for i in range(lp))
        return (("attn", "moe" if cfg.moe is not None else "dense"),)
    if cfg.layer_pattern == "jamba":
        return tuple(("attn" if i == cfg.attn_period - 1 else "mamba",
                      "moe" if (i % 2 == 1 and cfg.moe is not None)
                      else "dense")
                     for i in range(cfg.attn_period))
    if cfg.layer_pattern == "mamba":
        return (("mamba", "dense" if cfg.d_ff else "none"),)
    if cfg.layer_pattern == "xlstm":
        return (("mlstm", "none"),) * 3 + (("slstm", "none"),)
    raise ValueError(cfg.layer_pattern)


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
    kw = dict(lead=(n_periods(cfg),), device=dev)
    d = cfg.d_model
    periods: Dict = {}
    for i, (mixer, f) in enumerate(period_spec(cfg)):
        periods[f"norm{i}_mix"] = {"scale": torch.ones(kw["lead"] + (d,),
                                                       device=dev)}
        if mixer == "attn":
            periods[f"blk{i}_attn"] = B.init_attn(generator, cfg, **kw)
        else:         # init_mamba, init_mlstm, init_slstm
            periods[f"blk{i}_{mixer}"] = getattr(B, f"init_{mixer}")(
                generator, cfg, cfg.ssm, **kw)
        if f != "none":
            periods[f"norm{i}_ffn"] = {"scale": torch.ones(kw["lead"] + (d,),
                                                           device=dev)}
        if f == "dense":
            periods[f"blk{i}_ffn"] = init_ffn(generator, d, cfg.d_ff,
                                              cfg.activation, **kw)
        elif f == "moe":
            periods[f"blk{i}_moe"] = B.init_moe(generator, cfg, cfg.moe, **kw)
    params = {
        "embed": init_embedding(generator, cfg.padded_vocab, d, device=dev),
        "final_norm": init_rmsnorm(d, device=dev),
        "periods": periods,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": normal_init(
            generator, (d, cfg.padded_vocab), stddev=1 / math.sqrt(d),
            device=dev)}
    if cfg.frontend != "none":
        # projector from the stub frontend's embeddings into d_model
        fd = cfg.frontend_dim or d
        params["frontend_proj"] = {"w": normal_init(
            generator, (fd, d), stddev=1 / math.sqrt(fd), device=dev)}
    if dtype != torch.float32:
        params = tree_map(lambda x: x.to(dtype), params)
    return params


# ----------------------------------------------------------------------
def _mixer_train(pp, cfg: ArchConfig, i: int, mixer: str, h, impl: str):
    p = pp[f"blk{i}_{mixer}"]
    if mixer == "attn":
        return B.attn_train(p, cfg, h, causal=True, window=cfg.sliding_window,
                            impl=impl)
    if mixer == "mamba":
        return B.mamba_train(p, cfg, cfg.ssm, h, impl=impl)
    if mixer == "mlstm":
        return B.mlstm_train(p, cfg, cfg.ssm, h)
    return B.slstm_train(p, cfg, cfg.ssm, h)


def _ffn_apply(pp, cfg: ArchConfig, i: int, f: str, x, aux,
               moe_dropless: bool):
    if f == "none":
        return x, aux
    h = rmsnorm(pp[f"norm{i}_ffn"], x, cfg.norm_eps)
    if f == "dense":
        return x + ffn(pp[f"blk{i}_ffn"], h, cfg.activation), aux
    y, moe_aux = B.moe_apply(pp[f"blk{i}_moe"], cfg, cfg.moe, h,
                             dropless=moe_dropless)
    return x + y, aux + moe_aux


def _embed_tokens(params, cfg: ArchConfig, tokens, frontend, dtype):
    x = embed(params["embed"], tokens, dtype=dtype)
    if cfg.name.startswith("gemma"):
        x = x * math.sqrt(cfg.d_model)
    if frontend is not None:
        fe = frontend.to(dtype) @ params["frontend_proj"]["w"].to(dtype)
        x = torch.cat([fe, x], dim=1)
    return constrain(x)


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
              *, frontend=None, impl: str = "auto",
              moe_dropless: bool = False, remat: bool = False):
    """Full-sequence causal logits (the training forward) and the summed
    MoE aux loss (0 without MoE FFNs). `moe_dropless=True` gives the
    slicing-invariant MoE forward that prefill and decode compute; the
    default keeps the reference's capacity-dropped training dispatch.
    `remat` recomputes each period's activations in the backward
    (`torch.utils.checkpoint`, the reference's `jax.checkpoint` of its
    period function): only the period boundaries are kept."""
    x = _embed_tokens(params, cfg, tokens, frontend, compute_dtype)
    spec = period_spec(cfg)

    def period_fn(pp, x, aux):
        for i, (mixer, f) in enumerate(spec):
            h = rmsnorm(pp[f"norm{i}_mix"], x, cfg.norm_eps)
            x = x + _mixer_train(pp, cfg, i, mixer, h, impl)
            x, aux = _ffn_apply(pp, cfg, i, f, x, aux, moe_dropless)
        return constrain(x), aux

    aux = torch.zeros((), device=x.device)
    for p in range(n_periods(cfg)):
        pp = _period(params["periods"], p)
        if remat:
            x, aux = checkpoint(period_fn, pp, x, aux, use_reentrant=False)
        else:
            x, aux = period_fn(pp, x, aux)
    return _head(params, cfg, x), aux


def lm_loss(params, cfg: ArchConfig, tokens, labels, frontend=None,
            compute_dtype=torch.float32, remat: bool = False, *,
            impl: str = "auto"):
    """Next-token cross entropy in fp32, labels < 0 ignored, plus the MoE
    aux loss; the logits of the `frontend`'s positions are dropped.
    Returns (loss, {"nll", "aux", "ntokens"}). On the card the attention
    and the scan run their forward and backward kernels (`impl="ref"`: the
    plain versions under plain autograd)."""
    logits, aux = lm_logits(params, cfg, tokens, compute_dtype,
                            frontend=frontend, impl=impl, remat=remat)
    if frontend is not None:
        logits = logits[:, frontend.shape[1]:]
    nll, ntok = next_token_nll(logits.to(torch.float32), labels)
    return nll + aux, {"nll": nll, "aux": aux, "ntokens": ntok}


# ----------------------------------------------------------------------
# caches
def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, *, device=None) -> Dict:
    """cache_len: attention KV capacity. With cfg.sliding_window > 0 and
    cache_len >= window, attention caches are rolling ``window``-sized
    rings. Mamba caches hold the conv tail in `dtype` and the fp32 state;
    mLSTM and sLSTM caches their fp32 states."""
    dev = resolve_device(device)
    attn_len = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
                else cache_len)
    kw = dict(lead=(n_periods(cfg),), device=dev)
    per: Dict = {}
    for i, (mixer, _f) in enumerate(period_spec(cfg)):
        key = f"blk{i}_{mixer}"
        if mixer == "attn":
            per[key] = B.init_attn_cache(cfg, batch, attn_len, dtype, **kw)
        elif mixer == "mamba":
            per[key] = B.init_mamba_cache(cfg, cfg.ssm, batch, dtype, **kw)
        elif mixer == "mlstm":
            per[key] = B.init_mlstm_cache(cfg, cfg.ssm, batch, **kw)
        else:
            per[key] = B.init_slstm_cache(cfg, cfg.ssm, batch, **kw)
    return {"periods": per, "pos": 0}


def _run_cached(params, cfg: ArchConfig, x, cache, pos: int, *, decode: bool,
                impl: str = "auto", moe_dropless: bool = True):
    """Shared prefill/decode loop over periods. x: (B, S, d). Writes the
    cache's tensors in place and returns (x, cache["periods"])."""
    aux = torch.zeros((), device=x.device)
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
            elif mixer == "mamba" and decode:
                y, _ = B.mamba_decode(pp[key], cfg, cfg.ssm, h, pc[key])
            elif mixer == "mamba":
                y, _ = B.mamba_prefill(pp[key], cfg, cfg.ssm, h, pc[key],
                                       impl=impl)
            elif mixer == "mlstm":
                y, _ = B.mlstm_prefill(pp[key], cfg, cfg.ssm, h, pc[key])
            else:
                y, _ = B.slstm_prefill(pp[key], cfg, cfg.ssm, h, pc[key])
            x, aux = _ffn_apply(pp, cfg, i, f, x + y, aux, moe_dropless)
        x = constrain(x)
    return x, cache["periods"]


def lm_prefill(params, cfg: ArchConfig, tokens, cache,
               compute_dtype=torch.bfloat16, *, frontend=None,
               impl: str = "auto", moe_dropless: bool = True):
    """Process the prompt (after the projected `frontend` embeddings, if
    given); returns last-position logits + filled cache. `impl` picks the
    prefill attention and scan: "auto" (the kernels on the card, the plain
    versions on the CPU) or "ref" (the plain versions anywhere). MoE takes
    the dropless dispatch by default, as the reference's prefill does
    (consistent with decode)."""
    x = _embed_tokens(params, cfg, tokens, frontend, compute_dtype)
    s = x.shape[1]
    x, periods = _run_cached(params, cfg, x, cache, 0, decode=False,
                             impl=impl, moe_dropless=moe_dropless)
    logits = _head(params, cfg, x[:, -1:])
    return logits, {"periods": periods, "pos": int(s)}


def lm_decode(params, cfg: ArchConfig, cache, token,
              compute_dtype=torch.bfloat16, *, moe_dropless: bool = True):
    """token: (B, 1) -> (logits (B, 1, V), cache')."""
    x = _embed_tokens(params, cfg, token, None, compute_dtype)
    pos = int(cache["pos"])
    x, periods = _run_cached(params, cfg, x, cache, pos, decode=True,
                             moe_dropless=moe_dropless)
    return _head(params, cfg, x), {"periods": periods, "pos": pos + 1}
