"""PyTorch/CUDA port of the EAT scheduler (`repro`), for one NVIDIA H100.

The package mirrors `repro/` module for module (`repro_torch/core/env.py`
is the counterpart of `repro/core/env.py`, and so on). It imports torch and
numpy only. Entry points take `device=None`, which means the CUDA device and
raises when there is none; pass `device="cpu"` for the plain PyTorch path.
"""
