"""Mamba selective scan: `ref` (plain), `kernel` (CUDA), `ops` (entry)."""
