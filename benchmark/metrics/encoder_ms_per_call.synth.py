"""Device time per audio-in call of every kernel that is neither the
frontend's nor the loop's (kernels.json): HuBERT past its conv stack, the
projection and FSQ, and the loop's preparation, in ms."""


def read(trace):
    calls = [c for c in trace.info["calls"] if c.get("samples")]
    if not calls or not trace.kernels:
        return None
    return 1e3 * trace.device_s(exclude=("frontend", "loop")) / len(calls)
