"""Models of the port: the diffusion decoder and the semantic encoder
(HuBERT + projection + FSQ/VQ)."""

from .decoder import EdgeDiffusionDecoder
from .encoder import SemanticEncoder, is_hubert_param
from .fsq import FSQ, FSQEncoder, count_code_usage, usage_metrics
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
    "count_code_usage",
    "is_hubert_param",
    "load_hubert_params_from_torch",
    "usage_metrics",
]


def __getattr__(name):
    # The JAX package's HF HuBERT loader; here it gives the port's
    # HubertEncoder state dict (weights.py imports this package).
    if name == "load_hubert_params_from_torch":
        from ..weights import hubert_state_dict_from_hf

        return hubert_state_dict_from_hf
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
