"""Models of the port: the diffusion decoder."""

from .decoder import EdgeDiffusionDecoder

__all__ = ["EdgeDiffusionDecoder"]
