"""Rollout-protocol actor policies and the diffusion samplers."""
