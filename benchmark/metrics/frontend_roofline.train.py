"""The conv frontend kernels' share of their roofline in the training step:
each step's conv stack at [batch, segment] (counts/frontend.py) over their
device time, in %."""

from benchmark.counts.calls import frontend_least_s


def read(trace):
    busy = trace.device_s("frontend")
    info = trace.info
    if busy <= 0 or not info.get("steps"):
        return None
    least = info["steps"] * frontend_least_s(info["rows"], info["samples"], info["compute"])
    return 100.0 * least / busy
