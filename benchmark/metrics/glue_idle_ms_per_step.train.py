"""Device idle per training step inside the program's ``train:step`` span but
outside every other ``train:*`` range (the step's own code between its
stages: the gradients' reset, the loss code outside the ranges): that time
in the window less the device's busy time inside it, over the window's
``train:step`` count, in ms.  None where the program opens no such span."""


def read(trace):
    if not trace.kernels or trace.window is None:
        return None
    lo, hi = trace.window
    steps = [(max(a, lo), min(b, hi)) for a, b, n in trace.host
             if n == "train:step" and a < hi and b > lo]
    if not steps:
        return None
    children = sorted((a, b) for a, b, n in trace.host
                      if n.startswith("train:") and n != "train:step")
    glue = []  # each step less the union of the ranges inside it
    for a, b in steps:
        at = a
        for c, d in children:
            if d <= at or c >= b:
                continue
            if c > at:
                glue.append((at, c))
            at = max(at, d)
        if at < b:
            glue.append((at, b))
    idle = sum(b - a for a, b in glue) - sum(trace.busy_in(glue))
    return idle / len(steps) / 1e6
