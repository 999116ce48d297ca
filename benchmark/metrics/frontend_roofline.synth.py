"""The conv frontend kernels' share of their roofline in audio-in calls: the
least time of every call's conv stack (counts/frontend.py; conv0 at float32,
the rest at the compute dtype) over their device time, in %."""

from benchmark.counts.calls import frontend_least_s


def read(trace):
    busy = trace.device_s("frontend")
    calls = [c for c in trace.info["calls"] if c.get("samples")]
    if busy <= 0 or not calls:
        return None
    least = sum(frontend_least_s(c["rows"], c["samples"], trace.info["compute"]) for c in calls)
    return 100.0 * least / busy
