"""Utilities of the port: mel normalization (audio), metric logging (logging),
divergence guards (reliability), timing and profiling (speed), the decoder's
``.pt2`` and TFLite exports (export; the TFLite lowering and flatbuffer in
tflite_lower and tflite_surgery), weight-only int8 (quantize),
reference-checkpoint conversion (torch_compat), sample plots (visualization)."""

from .audio import denormalize_mel, normalize_mel
from .logging import MetricWriter
from .reliability import DivergenceError, make_nan_guard, retry_transient
from .speed import TimingContext, benchmark, memory_stats, profile_trace, remat_decoder


def __getattr__(name):  # lazy: these pull matplotlib / torch.export
    if name == "visualize_generation":
        from .visualization import visualize_generation

        return visualize_generation
    if name in ("export_for_edge", "load_exported", "export_tflite", "load_tflite",
                "synthetic_representative_batches"):
        from . import export

        return getattr(export, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DivergenceError",
    "MetricWriter",
    "TimingContext",
    "benchmark",
    "denormalize_mel",
    "export_for_edge",
    "export_tflite",
    "load_tflite",
    "make_nan_guard",
    "memory_stats",
    "normalize_mel",
    "profile_trace",
    "remat_decoder",
    "retry_transient",
    "synthetic_representative_batches",
    "visualize_generation",
]
