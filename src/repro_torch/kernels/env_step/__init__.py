"""Fused env decision step: `ref` (plain), `kernel` (CUDA), `ops` (entry)."""
