"""Device time per training step of the kernels launched inside the trained
part's ranges (``train:mel``, ``train:encoder``, ``train:decoder``,
``train:backward``, ``train:optimizer``), in ms."""

RANGES = ("train:mel", "train:encoder", "train:decoder", "train:backward", "train:optimizer")


def read(trace):
    steps = trace.info.get("steps")
    if not steps or not trace.kernels:
        return None
    s = trace.device_s_by_range(RANGES)
    return 1e3 * s / steps if s > 0 else None
