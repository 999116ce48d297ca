"""Models of the port: the diffusion decoder and the semantic encoder
(HuBERT, WavLM or w2v-BERT 2.0 + projection + FSQ/VQ)."""

from .decoder import EdgeDiffusionDecoder
from .encoder import SemanticEncoder, is_hubert_param
from .fsq import FSQ, FSQEncoder, count_code_usage, usage_metrics
from .hubert import HubertConfig, HubertEncoder, hubert_config_for
from .vq import VectorQuantizer
from .w2v_bert import W2vBertConfig, W2vBertEncoder

__all__ = [
    "EdgeDiffusionDecoder",
    "FSQ",
    "FSQEncoder",
    "HubertConfig",
    "HubertEncoder",
    "SemanticEncoder",
    "VectorQuantizer",
    "W2vBertConfig",
    "W2vBertEncoder",
    "count_code_usage",
    "hubert_config_for",
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
