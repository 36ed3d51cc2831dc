"""Actor networks and the attention feature extractor (paper Table VII;
port of `repro/core/networks.py`).

Params are plain nested dicts of tensors in the reference's layout (a dense
weight is (in, out)), so reference checkpoints load unchanged. Hidden
layers use Mish; the attention encoder treats each column of the Eq.-6
state matrix as a token and applies one scaled-dot-product attention layer
(Eq. 9), giving a feature f_s of dim E + l.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from repro_torch.common.pytree import normal_init
from repro_torch.models.layers import mish


def init_mlp(dims: Sequence[int], *, generator, device) -> Dict:
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        layers.append({"w": normal_init(generator, (a, b),
                                        stddev=1.0 / math.sqrt(a),
                                        device=device),
                       "b": torch.zeros((b,), device=device)})
    return {"layers": layers}


def mlp_apply(p: Dict, x, activation=mish, final_activation=None):
    n = len(p["layers"])
    for i, layer in enumerate(p["layers"]):
        x = x @ layer["w"] + layer["b"]
        if i < n - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


# ----------------------------------------------------------------------
# attention feature extractor (Eq. 9)
def init_attention_encoder(n_rows: int, n_cols: int, d_attn: int = 32, *,
                           generator, device) -> Dict:
    """State matrix (n_rows, n_cols): columns are tokens of dim n_rows."""
    def w(shape, fan_in):
        return normal_init(generator, shape, stddev=1.0 / math.sqrt(fan_in),
                           device=device)
    return {"wq": w((n_rows, d_attn), n_rows),
            "wk": w((n_rows, d_attn), n_rows),
            "wv": w((n_rows, d_attn), n_rows),
            "wo": w((d_attn,), d_attn)}


def attention_encode(p: Dict, s) -> torch.Tensor:
    """s: (..., 3, E+l) -> f_s: (..., E+l)."""
    x = s.transpose(-1, -2)                                  # (..., E+l, 3)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    d = q.shape[-1]
    att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
    return (att @ v) @ p["wo"]                               # (..., E+l)


# MLP encoder (the EAT-A / EAT-DA ablations: no attention layer)
def init_mlp_encoder(n_rows: int, n_cols: int, *, generator, device) -> Dict:
    return init_mlp([n_rows * n_cols, n_cols], generator=generator,
                    device=device)


def mlp_encode(p: Dict, s) -> torch.Tensor:
    return mlp_apply(p, s.reshape(s.shape[:-2] + (-1,)))


def make_encoder(kind: str, obs_shape, d_attn: int = 32, *, generator,
                 device):
    """Returns (params, encode_fn, feature_dim)."""
    n_rows, n_cols = obs_shape
    if kind == "attention":
        return (init_attention_encoder(n_rows, n_cols, d_attn,
                                       generator=generator, device=device),
                attention_encode, n_cols)
    if kind == "mlp":
        return (init_mlp_encoder(n_rows, n_cols, generator=generator,
                                 device=device), mlp_encode, n_cols)
    raise ValueError(kind)
