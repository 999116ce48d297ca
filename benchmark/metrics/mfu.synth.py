"""Model FLOPs utilisation of the synthesis window: every call's products
(counts/calls.py) over the traced window times the peak of the
configuration's compute dtype, in %."""

from benchmark.counts import peaks
from benchmark.counts.calls import synth_model_flops


def read(trace):
    if not trace.window_s or not trace.kernels:
        return None
    flops = sum(synth_model_flops(trace.info, c) for c in trace.info["calls"])
    peak = peaks()["flops_per_s"][trace.info["compute"]]
    return 100.0 * flops / (trace.window_s * peak)
