"""Plain PyTorch versions of the fused denoiser kernels.

`denoiser_ref` is one eps-MLP forward given flattened weights;
`denoiser_chain_ref` is the whole K-step affine reverse chain
(x <- c_x x + c_e eps + c_n noise) with the eps-MLP inside the loop, ending
in the tanh action bound. It is the oracle of the CUDA chain kernel and the
path the kernel's wrapper takes for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import mish


def denoiser_ref(inp, w1, b1, w2, b2, w3, b3):
    h = mish(inp @ w1 + b1)
    h = mish(h @ w2 + b2)
    return torch.tanh(h @ w3 + b3)


def denoiser_chain_ref(x, noises, f_s, tembs, coef_x, coef_e, coef_n,
                       w1, b1, w2, b2, w3, b3):
    """Run the K-step reverse chain. Shapes:

        x       (..., A)      initial x_K ~ N(0, I)
        noises  (K, ..., A)   per-step posterior noise (zeros for DDIM)
        f_s     (..., F)      state feature, constant across steps
        tembs   (K, t_dim)    per-step timestep embeddings
        coef_*  (K,)          affine chain coefficients

    Returns tanh(x_0), (..., A)."""
    t_shape = x.shape[:-1] + (tembs.shape[-1],)
    for j in range(tembs.shape[0]):
        inp = torch.cat([x, tembs[j].expand(t_shape), f_s], dim=-1)
        eps = denoiser_ref(inp, w1, b1, w2, b2, w3, b3)
        x = coef_x[j] * x + coef_e[j] * eps + coef_n[j] * noises[j]
    return torch.tanh(x)
