"""w2v-BERT's relative-key attention kernel's share of its roofline in
audio-in calls: each call's least time of its launches (counts/w2v_bert.py,
a launch a layer) over the device time of ``relkey_attention16_kernel``,
found by function name, in %.  None where the kernel did not run."""

from benchmark.counts.w2v_bert import call_least_s
from benchmark.harness.trace import function_name

KERNEL = "relkey_attention16_kernel"


def read(trace):
    info = trace.info
    calls = [c for c in info["calls"] if c.get("samples")]
    if not calls or not trace.kernels or trace.window is None or not info.get("hubert"):
        return None
    lo, hi = trace.window
    busy = sum(b - a for a, b, n in trace.kernels if lo <= a <= hi and function_name(n) == KERNEL)
    if busy <= 0:
        return None
    least = sum(call_least_s(info["hubert"], info["cfg"], c["rows"], c["tokens"]) for c in calls)
    return 100.0 * least / (busy / 1e9)
