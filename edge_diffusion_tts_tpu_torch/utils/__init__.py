"""Utilities of the port: mel normalization (audio), metric logging,
divergence guards (reliability), sample plots (visualization)."""
