"""Host time per synthesis call: its wall time minus the device's busy time
inside it (profiler trace), averaged over the window's calls, in ms."""


def read(trace):
    calls = trace.calls("bench:call")
    if not calls or not trace.kernels:
        return None
    busy = trace.busy_in(calls)
    return sum((b - a) - u for (a, b), u in zip(calls, busy)) / len(calls) / 1e6
