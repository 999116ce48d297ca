"""Device idle per synthesis call inside the program's ``prep:loop_inputs``
and ``prep:launch`` spans (the fused loop's inputs and its launch, on the
host): the spans' time in the window less the device's busy time inside
them, over the window's ``bench:call`` count, in ms.  None where the program
opens no such span."""

NAMES = ("prep:loop_inputs", "prep:launch")


def read(trace):
    calls = trace.calls("bench:call")
    if not calls or not trace.kernels or trace.window is None:
        return None
    lo, hi = trace.window
    spans = sorted((max(a, lo), min(b, hi)) for a, b, n in trace.host
                   if n in NAMES and a < hi and b > lo)
    if not spans:
        return None
    union = []  # a span inside another counts once
    for a, b in spans:
        if union and a <= union[-1][1]:
            union[-1] = (union[-1][0], max(b, union[-1][1]))
        else:
            union.append((a, b))
    idle = sum(b - a for a, b in union) - sum(trace.busy_in(union))
    return idle / len(calls) / 1e6
