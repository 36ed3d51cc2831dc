"""Whisper-style encoder-decoder backbone (port of `repro/models/encdec.py`:
serving, and the training loss `encdec_loss`).

The conv/mel frontend is a stub, as in the reference: the caller provides
precomputed frame embeddings (B, T_enc, d_model). The encoder is a
bidirectional transformer, the decoder a causal one with a self-attention
KV cache and cross-attention to the encoder output. Norms are LayerNorms
with bias, FFNs plain 2-layer gelu (tanh form), positions sinusoidal (added
to the inputs; the attention blocks apply RoPE on top, as the reference's
do), the output head tied to the embedding with the padded vocab masked.
On the card every encoder layer, every decoder self-attention prefill and
every cross-attention prefill launches the flash attention kernel, and a
training step each one's backward kernel too (the cross-attention's
non-causal, decoder tokens against the encoder frames).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.common.config import ArchConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import tree_map
from repro_torch.models import attention as attn_lib
from repro_torch.models import blocks as B
from repro_torch.models.layers import (embed, ffn, init_embedding, init_ffn,
                                       init_layernorm, layernorm, linear,
                                       next_token_nll)
from repro_torch.sharding.context import constrain


def sinusoid_pos(positions, d: int, dtype=torch.float32):
    """positions: (...,) -> (..., d): sin of the first half, cos of the
    second, frequencies 10000^(-i / (d/2))."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ----------------------------------------------------------------------
def _stacked_layernorm(lead, d: int, device):
    return {"scale": torch.ones(lead + (d,), device=device),
            "bias": torch.zeros(lead + (d,), device=device)}


def init_encdec(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, *, device=None) -> Dict:
    """Random params with the reference's tree and shapes: `enc_layers`
    (ln1, attn, ln2, ffn) and `dec_layers` (ln1, self_attn, ln2,
    cross_attn, ln3, ffn) stacked along a leading layer axis."""
    dev = resolve_device(device)
    d = cfg.d_model
    enc, dec = (cfg.encoder_layers,), (cfg.num_layers,)
    enc_layers = {
        "ln1": _stacked_layernorm(enc, d, dev),
        "attn": B.init_attn(generator, cfg, lead=enc, device=dev),
        "ln2": _stacked_layernorm(enc, d, dev),
        "ffn": init_ffn(generator, d, cfg.d_ff, "gelu", lead=enc, device=dev),
    }
    dec_layers = {
        "ln1": _stacked_layernorm(dec, d, dev),
        "self_attn": B.init_attn(generator, cfg, lead=dec, device=dev),
        "ln2": _stacked_layernorm(dec, d, dev),
        "cross_attn": B.init_cross_attn(generator, cfg, lead=dec, device=dev),
        "ln3": _stacked_layernorm(dec, d, dev),
        "ffn": init_ffn(generator, d, cfg.d_ff, "gelu", lead=dec, device=dev),
    }
    params = {
        "embed": init_embedding(generator, cfg.padded_vocab, d, device=dev),
        "enc_layers": enc_layers,
        "enc_ln": init_layernorm(d, device=dev),
        "dec_layers": dec_layers,
        "dec_ln": init_layernorm(d, device=dev),
    }
    if dtype != torch.float32:
        params = tree_map(lambda x: x.to(dtype), params)
    return params


def _layer(tree, i: int):
    return tree_map(lambda x: x[i], tree)


# ----------------------------------------------------------------------
def encode(params, cfg: ArchConfig, frames, compute_dtype=torch.float32, *,
           impl: str = "auto"):
    """frames: (B, T_enc, d_model) stub embeddings -> encoder output."""
    t = frames.shape[1]
    x = frames.to(compute_dtype) + sinusoid_pos(
        torch.arange(t, device=frames.device), cfg.d_model, compute_dtype)
    for i in range(cfg.encoder_layers):
        lp = _layer(params["enc_layers"], i)
        h = layernorm(lp["ln1"], x, cfg.norm_eps)
        x = x + B.attn_train(lp["attn"], cfg, h, causal=False, impl=impl)
        h = layernorm(lp["ln2"], x, cfg.norm_eps)
        x = constrain(x + ffn(lp["ffn"], h, "gelu"))
    return layernorm(params["enc_ln"], x, cfg.norm_eps)


def _dec_embed(params, cfg: ArchConfig, tokens, pos0: int, dtype):
    x = embed(params["embed"], tokens, dtype=dtype)
    pos = torch.arange(tokens.shape[1], device=tokens.device) + pos0
    return x + sinusoid_pos(pos, cfg.d_model, dtype)


def _head(params, cfg: ArchConfig, x):
    h = layernorm(params["dec_ln"], x, cfg.norm_eps)
    logits = h @ params["embed"]["table"].to(h.dtype).T
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                               device=x.device), logits)
    return logits


def encdec_logits(params, cfg: ArchConfig, frames, tokens,
                  compute_dtype=torch.float32, *, impl: str = "auto"):
    """Teacher-forced decoder logits (the training forward)."""
    enc = encode(params, cfg, frames, compute_dtype, impl=impl)
    x = _dec_embed(params, cfg, tokens, 0, compute_dtype)
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], i)
        h = layernorm(lp["ln1"], x, cfg.norm_eps)
        x = x + B.attn_train(lp["self_attn"], cfg, h, causal=True, impl=impl)
        h = layernorm(lp["ln2"], x, cfg.norm_eps)
        kv = B.cross_attn_kv(lp["cross_attn"], cfg, enc)
        x = x + B.cross_attn_apply(lp["cross_attn"], cfg, h, kv, impl=impl)
        h = layernorm(lp["ln3"], x, cfg.norm_eps)
        x = constrain(x + ffn(lp["ffn"], h, "gelu"))
    return _head(params, cfg, x)


def encdec_loss(params, cfg: ArchConfig, frames, tokens, labels,
                compute_dtype=torch.float32, *, impl: str = "auto"):
    """Teacher-forced next-token cross entropy in fp32, labels < 0
    ignored: (loss, {"nll", "ntokens"})."""
    logits = encdec_logits(params, cfg, frames, tokens, compute_dtype,
                           impl=impl)
    nll, ntok = next_token_nll(logits.to(torch.float32), labels)
    return nll, {"nll": nll, "ntokens": ntok}


# ----------------------------------------------------------------------
# serving: prefill fills the self-KV and cross-KV caches; decode steps one
# token.
def init_encdec_cache(cfg: ArchConfig, batch: int, cache_len: int,
                      enc_len: int, dtype=torch.bfloat16, *,
                      device=None) -> Dict:
    """self: (L, B, cache_len, kv, hd) K and V; cross: (L, B, enc_len, kv,
    hd) K and V, written once by the prefill."""
    dev = resolve_device(device)
    lead = (cfg.num_layers,)
    return {"self": B.init_attn_cache(cfg, batch, cache_len, dtype,
                                      lead=lead, device=dev),
            "cross": B.init_attn_cache(cfg, batch, enc_len, dtype,
                                       lead=lead, device=dev),
            "pos": 0}


def encdec_prefill(params, cfg: ArchConfig, frames, tokens, cache,
                   compute_dtype=torch.bfloat16, *, impl: str = "auto"):
    """Encode the frames, run the decoder over the prompt and fill both
    caches (the cross K/V computed here once); returns the last-position
    logits and the cache."""
    enc = encode(params, cfg, frames, compute_dtype, impl=impl)
    x = _dec_embed(params, cfg, tokens, 0, compute_dtype)
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], i)
        h = layernorm(lp["ln1"], x, cfg.norm_eps)
        y, _ = B.attn_prefill(lp["self_attn"], cfg, h,
                              _layer(cache["self"], i), impl=impl)
        x = x + y
        h = layernorm(lp["ln2"], x, cfg.norm_eps)
        kv = B.cross_attn_kv(lp["cross_attn"], cfg, enc)
        for key in ("k", "v"):
            cache["cross"][key][i].copy_(kv[key])
        x = x + B.cross_attn_apply(lp["cross_attn"], cfg, h, kv, impl=impl)
        h = layernorm(lp["ln3"], x, cfg.norm_eps)
        x = constrain(x + ffn(lp["ffn"], h, "gelu"))
    logits = _head(params, cfg, x[:, -1:])
    return logits, {"self": cache["self"], "cross": cache["cross"],
                    "pos": int(tokens.shape[1])}


def encdec_decode(params, cfg: ArchConfig, cache, token,
                  compute_dtype=torch.bfloat16):
    """token: (B, 1) -> (logits (B, 1, V), cache'). Cross-attention reads
    every cached encoder position (plain `decode_attention`)."""
    pos = int(cache["pos"])
    x = _dec_embed(params, cfg, token, pos, compute_dtype)
    b, hd = x.shape[0], cfg.resolved_head_dim
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], i)
        cc = _layer(cache["cross"], i)
        h = layernorm(lp["ln1"], x, cfg.norm_eps)
        y, _ = B.attn_decode(lp["self_attn"], cfg, h,
                             _layer(cache["self"], i), pos)
        x = x + y
        h = layernorm(lp["ln2"], x, cfg.norm_eps)
        q = linear(lp["cross_attn"]["wq"], h).reshape(b, 1, cfg.num_heads, hd)
        o = attn_lib.decode_attention(q, cc["k"].to(h.dtype),
                                      cc["v"].to(h.dtype), cc["k"].shape[1])
        x = x + linear(lp["cross_attn"]["wo"], o.reshape(b, 1, -1))
        h = layernorm(lp["ln3"], x, cfg.norm_eps)
        x = constrain(x + ffn(lp["ffn"], h, "gelu"))
    return _head(params, cfg, x), {"self": cache["self"],
                                   "cross": cache["cross"], "pos": pos + 1}
