"""Neural-net layers of the PyTorch port."""

from .attention import (
    CrossAttention,
    EfficientAttention,
    MultiHeadLatentAttention,
    local_attention_mask,
    q_chunked_banded_sdpa,
    q_chunked_sdpa,
    sdpa,
)
from .conv import ConvBlock, DepthwiseSeparableConv
from .embeddings import (
    LearnedPositionalEmb,
    LearnedTimeEmb,
    SinusoidalPositionalEmb,
    SinusoidalTimeEmb,
    apply_rope,
    rope_tables,
    sinusoidal_position_table,
    sinusoidal_time_embedding,
)
from .ffn import Dropout, FeedForward, dropout, swiglu
from .norms import AdaLayerNorm, RMSNorm
from .transformer import DiffusionTransformerBlock

__all__ = [
    "AdaLayerNorm",
    "ConvBlock",
    "CrossAttention",
    "DepthwiseSeparableConv",
    "DiffusionTransformerBlock",
    "Dropout",
    "EfficientAttention",
    "FeedForward",
    "LearnedPositionalEmb",
    "LearnedTimeEmb",
    "MultiHeadLatentAttention",
    "RMSNorm",
    "SinusoidalPositionalEmb",
    "SinusoidalTimeEmb",
    "apply_rope",
    "dropout",
    "local_attention_mask",
    "q_chunked_banded_sdpa",
    "q_chunked_sdpa",
    "rope_tables",
    "sdpa",
    "sinusoidal_position_table",
    "sinusoidal_time_embedding",
    "swiglu",
]
