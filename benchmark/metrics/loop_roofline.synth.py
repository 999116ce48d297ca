"""The fused loop kernels' share of their roofline: the least time of every
call's loop (counts/decoder.py, at the compute dtype's peak) over the device
time of the loop's kernels (kernels.json "loop"), in %."""

from benchmark.counts.calls import synth_loop_least_s


def read(trace):
    busy = trace.device_s("loop")
    if busy <= 0:
        return None
    least = sum(synth_loop_least_s(trace.info, c) for c in trace.info["calls"])
    return 100.0 * least / busy
