"""Analytic roofline model per (arch x shape x mesh) (port of
`repro/launch/roofline.py`, its formulas term by term, with the H100
constants of `launch.mesh`).

The reference derives its absolute roofline table from this model because
XLA's `cost_analysis()` counts a `lax.scan` body once, not once per trip.
The port's dry-run traces eagerly (`launch.steps.lower_case`): every layer
and every attention block is counted, so no such caveat applies to its
measured terms. The two sets are independent estimates of the same step,
and each record carries both.

All terms are PER DEVICE, in seconds, for one step of the given shape on
an NVIDIA H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM, 18 NVLink 4
links x 25 GB/s each way, 80 GB). The collective term takes NVLink's rate
for every byte, which a mesh of 32 HGX nodes does not have across nodes
(`launch.mesh`): it is a lower bound.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.common.config import ArchConfig
from repro_torch.launch.mesh import (HBM_BW, HBM_PER_DEVICE, LINK_BW,
                                     NUM_LINKS, PEAK_FLOPS_BF16)
from repro_torch.launch.shapes import ShapeSpec

BF16 = 2
F32 = 4


def _layer_kinds(cfg: ArchConfig):
    """(n_attn_layers, n_ssm_layers, n_moe_layers, n_dense_ffn_layers)."""
    n_attn = n_ssm = n_moe = n_ffn = 0
    for i in range(cfg.num_layers):
        if cfg.layer_pattern == "attn":
            is_attn = True
        elif cfg.layer_pattern == "jamba":
            is_attn = (i % cfg.attn_period) == (cfg.attn_period - 1)
        else:
            is_attn = False
        if is_attn:
            n_attn += 1
        elif cfg.ssm is not None:
            n_ssm += 1
        if cfg.moe is not None and (i % cfg.moe.layer_period) == 0:
            n_moe += 1
        elif cfg.d_ff:
            n_ffn += 1
    return n_attn, n_ssm, n_moe, n_ffn


def analytic_terms(cfg: ArchConfig, shape: ShapeSpec, n_dev: int,
                   dp_degree: int) -> Dict[str, float]:
    """Three roofline terms from first principles.

    dp_degree: how many ways the global batch is data-sharded (the weights
    are sharded over all n_dev devices, FSDP-style).
    """
    B, S = shape.global_batch, shape.seq_len
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n_attn, n_ssm, n_moe, n_ffn = _layer_kinds(cfg)
    N_act = cfg.param_count(active_only=True)
    N_tot = cfg.param_count(active_only=False)
    P_b = N_tot * BF16                     # bf16 compute copy
    B_loc = max(1, B // max(dp_degree, 1))

    # effective attention context (sliding window caps it)
    ctx = min(S, cfg.sliding_window) if cfg.sliding_window else S

    # ---- compute FLOPs (global, then /n_dev) --------------------------
    attn_dim = cfg.num_heads * hd
    if shape.kind == "train":
        flops = 6.0 * N_act * B * S
        # causal attention scores+values, fwd+bwd (x3)
        flops += 3.0 * n_attn * 4.0 * B * S * ctx * 0.5 * attn_dim
        tokens_desc = B * S
    elif shape.kind == "prefill":
        flops = 2.0 * N_act * B * S
        flops += n_attn * 4.0 * B * S * ctx * 0.5 * attn_dim
        tokens_desc = B * S
    else:  # decode: one token against a ctx-long KV
        flops = 2.0 * N_act * B
        flops += n_attn * 4.0 * B * ctx * attn_dim
        tokens_desc = B
    t_compute = flops / n_dev / PEAK_FLOPS_BF16

    # ---- HBM traffic (per device) --------------------------------------
    kv_bytes_layer = B * ctx * 2 * cfg.num_kv_heads * hd * BF16   # K+V
    if shape.kind == "train":
        # params: read fwd + read bwd + write grads (bf16) + Adam m/v rw (f32)
        param_traffic = N_tot * (3 * BF16 + 4 * F32)
        # activations under remat: write+read layer boundaries, ~3 passes
        act = cfg.num_layers * B_loc * S * d * BF16 * 6
        logits = B_loc * S * cfg.padded_vocab * F32 * 2
        bytes_dev = param_traffic / n_dev + act + logits
    elif shape.kind == "prefill":
        param_traffic = N_tot * BF16
        act = cfg.num_layers * B_loc * S * d * BF16 * 4
        kv = n_attn * kv_bytes_layer / n_dev * 2          # write + re-read
        bytes_dev = param_traffic / n_dev + act + kv
    else:
        param_traffic = N_tot * BF16                      # every weight once
        kv = n_attn * kv_bytes_layer / n_dev              # read full cache
        bytes_dev = (param_traffic / n_dev + kv
                     + B_loc * d * cfg.num_layers * BF16 * 4)
    t_memory = bytes_dev / HBM_BW

    # ---- collective traffic (per device) -------------------------------
    # FSDP: all-gather weights fwd (+bwd for train) + reduce-scatter grads.
    shard_b = P_b / n_dev
    if shape.kind == "train":
        coll = shard_b * (2 + 1) + shard_b * 2            # AG fwd+bwd, RS+AG opt
    else:
        coll = shard_b                                    # AG weights once
    # decode with sequence-sharded KV: per-token partial-softmax reduce
    if shape.kind == "decode":
        coll += n_attn * B * attn_dim * BF16 * 2
    t_coll = coll / (LINK_BW * NUM_LINKS)

    terms = {
        "a_compute_s": t_compute, "a_memory_s": t_memory,
        "a_collective_s": t_coll,
        "a_flops_dev": flops / n_dev, "a_bytes_dev": bytes_dev,
        "a_coll_bytes_dev": coll,
        "model_flops_global": (6.0 if shape.kind == "train" else 2.0)
        * N_act * tokens_desc,
        "params_total": N_tot, "params_active": N_act,
    }
    dom = max(("a_compute_s", "a_memory_s", "a_collective_s"),
              key=lambda k: terms[k])
    terms["a_bottleneck"] = dom[2:].replace("_s", "")
    # weights-fit check: bf16 copy + f32 master + 2xf32 Adam per device
    if shape.kind == "train":
        resident = N_tot * (BF16 + 3 * F32) / n_dev
    else:
        resident = N_tot * BF16 / n_dev + (
            _layer_kinds(cfg)[0] * kv_bytes_layer / n_dev)
    terms["a_resident_bytes_dev"] = resident
    terms["a_fits_hbm"] = bool(resident < HBM_PER_DEVICE * 0.9)
    return terms
