"""Model FLOPs utilisation of the training window: each step's products
(counts/calls.py: frozen parts once, trained parts three times) over the
traced window times the peak of the configuration's compute dtype, in %."""

from benchmark.counts import peaks
from benchmark.counts.calls import train_step_flops


def read(trace):
    if not trace.window_s or not trace.kernels or not trace.info.get("steps"):
        return None
    flops = trace.info["steps"] * train_step_flops(trace.info)
    peak = peaks()["flops_per_s"][trace.info["compute"]]
    return 100.0 * flops / (trace.window_s * peak)
