"""Utilities of the port: mel normalization (audio)."""
