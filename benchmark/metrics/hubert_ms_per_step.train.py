"""Device time per training step of the kernels launched inside the step's
``train:hubert`` range, the frontend's kernels left out, in ms."""


def read(trace):
    steps = trace.info.get("steps")
    if not steps or not trace.kernels:
        return None
    s = trace.device_s_by_range(["train:hubert"], exclude_groups=["frontend"])
    return 1e3 * s / steps if s > 0 else None
