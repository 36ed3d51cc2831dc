"""Whole reverse-diffusion chain: `ref` (plain), `kernel` (CUDA), `ops` (entry)."""
