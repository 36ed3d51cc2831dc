"""Entry points of the denoiser kernels on the params dict.

* `denoise_eps_fused`: one eps-MLP forward (drop-in for
  `core.diffusion.denoise_eps`), one `denoiser_step` launch on the card;
  given one embedding row for all (`temb`), the launch is all it does.
* `denoise_chain`: the whole K-step reverse chain, one `denoiser_chain`
  launch on the card. `impl="auto"` dispatches by the tensors' device: the
  CUDA kernel for CUDA tensors (it launches or raises; there is no
  fallback), the plain PyTorch version for CPU tensors. `impl="ref"` takes
  the plain version on any device.

The params dict is validated first: the kernels hard-code the paper's
3-layer Mish MLP (Table VII).
"""
from __future__ import annotations

import torch

from repro_torch.core.diffusion import timestep_embedding
from repro_torch.kernels.denoiser.kernel import denoiser_chain, denoiser_step
from repro_torch.kernels.denoiser.ref import denoiser_chain_ref


def _flat_weights(denoiser_params):
    """Validate the 3-layer MLP shape and flatten to (w1, b1, ..., b3)."""
    layers = denoiser_params.get("layers") \
        if hasattr(denoiser_params, "get") else None
    if layers is None:
        raise ValueError(
            "denoiser params must be the core.networks.init_mlp dict "
            "{'layers': [{'w','b'}, ...]}; got "
            f"{type(denoiser_params).__name__}")
    if len(layers) != 3:
        raise ValueError(
            f"fused denoiser kernels support exactly 3 MLP layers "
            f"(in -> hidden -> hidden -> out, paper Table VII); got "
            f"{len(layers)} layers — use repro_torch.core.diffusion."
            "denoise_eps for other depths")
    return (layers[0]["w"], layers[0]["b"], layers[1]["w"], layers[1]["b"],
            layers[2]["w"], layers[2]["b"])


def denoise_eps_fused(denoiser_params, x, i, f_s, t_dim: int = 16, *,
                      temb=None):
    """eps(x_i, i, f_s) through the one-call kernel: x (..., A), i (...,),
    f_s (..., F), with ... empty or one batch axis (a 1-D input is
    expanded and squeezed back). The kernel reads the timestep embedding
    of `i` per row; `temb` (t_dim,), the embedding of one step for every
    row (`actors.samplers.step_embedding`), replaces it, and `i` is then
    not read."""
    w = _flat_weights(denoiser_params)
    if temb is None:
        temb = timestep_embedding(i, t_dim)
    squeeze = x.ndim == 1
    if squeeze:
        x, f_s = x[None], f_s[None]
    out = denoiser_step(x, temb, f_s, *w)
    return out[0] if squeeze else out


def denoise_chain(denoiser_params, x, noises, f_s, tembs, coef_x, coef_e,
                  coef_n, *, impl: str = "auto"):
    """Whole K-step reverse chain on the params dict.

    x: (..., A); noises: (K, ..., A); f_s: (..., F); tembs: (K, t_dim);
    coef_*: (K,). Returns tanh(x_0) with x's shape. The kernel takes a 2-D
    batch (1-D inputs are expanded and squeezed back)."""
    w = _flat_weights(denoiser_params)
    if impl == "ref":
        return denoiser_chain_ref(x, noises, f_s, tembs, coef_x, coef_e,
                                  coef_n, *w)
    if impl != "auto":
        raise ValueError(f"impl must be auto|ref, got {impl!r}")
    squeeze = x.ndim == 1
    if squeeze:
        x, noises, f_s = x[None], noises[:, None], f_s[None]
    out = denoiser_chain(x, noises, f_s, tembs, coef_x, coef_e, coef_n, *w)
    return out[0] if squeeze else out
