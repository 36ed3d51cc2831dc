"""Serving-side fault exceptions."""
