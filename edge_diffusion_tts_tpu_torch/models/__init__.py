"""Models of the port: the diffusion decoder and the semantic encoder
(HuBERT + projection + FSQ/VQ)."""

from .decoder import EdgeDiffusionDecoder
from .encoder import SemanticEncoder, is_hubert_param
from .fsq import FSQ, FSQEncoder
from .hubert import HubertConfig, HubertEncoder
from .vq import VectorQuantizer

__all__ = [
    "EdgeDiffusionDecoder",
    "FSQ",
    "FSQEncoder",
    "HubertConfig",
    "HubertEncoder",
    "SemanticEncoder",
    "VectorQuantizer",
    "is_hubert_param",
]
