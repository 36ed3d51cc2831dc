"""Layers shared by the actor networks."""
