"""Training cells: the port's diffusion data step, back to back, on batches
that live on the device.

The entry is ``Trainer(...).make_diffusion_step()`` over one train state
(``create_train_state`` with ``make_optimizer``, its schedule sized as
``train()`` sizes it for the configuration's assumed corpus), driven by one
``torch.Generator`` seeded from the run's seed.  Set-up makes ``batches``
distinct batches of synthetic wavs, timesteps and noise on the device (the
replay keys ``t`` and ``noise``, which the step takes in place of its own
draws), then runs the first ``check_steps`` steps through the window's own
call on distinct batches: they warm every shape, and they are what the
reference follows.  The host collate is left out (it is host-paced).

The window runs steps until ``seconds`` have passed (a traced run: the
traffic's ``trace_seconds``, with ``bench:step`` around each step), then
waits for the device; the rate is every step's audio over all of that time.  Afterwards,
with the program's state freed, the reference runs the same first steps from
the same weights, batches and generator seed, and the harness compares each
step's loss, step 1's clipped gradient (read from the optimizer's first
moment: mu = (1 - b1) g after one update) and the parameters' change over
the steps, leaf by leaf.
"""

from __future__ import annotations

import gc
import time

from ..harness import compare, weights
from ..harness.trace import TraceView
from ..harness.traffic import subseed
from ..reference import decoder as rdec, hubert as rhub, train as rtrain
from ..reference.precision import Ops, no_tf32


def total_updates(c: dict) -> int:
    """The schedule's length in updates, as ``train()`` sizes it: steps per
    epoch x (diffusion + progressive halvings x epochs each + consistency)."""
    halvings, cur = 0, c["diff_steps"]
    while cur > c["progressive_target_steps"]:
        cur = max(cur // 2, c["progressive_target_steps"])
        halvings += 1
    epochs = c["diffusion_epochs"] + c["progressive_epochs_per_halving"] * halvings \
        + c["consistency_epochs"]
    steps = c["assumed"]["train_steps_per_epoch"] * max(epochs, 1)
    return -(-steps // max(c["grad_accumulation"], 1))


def data(run, torch) -> dict:
    c, tr, dev = run.config, run.traffic, run.device
    h = c["hubert"]
    enc = weights.make(rhub.encoder_shapes(c, h), run.seed, dev, "encoder")
    dec = weights.make(rdec.parameter_shapes(c), run.seed, dev, "decoder")
    W = {**{f"encoder.{n}": t for n, t in enc.items()}, **{f"decoder.{n}": t for n, t in dec.items()}}
    B, N = int(c["batch_size"]), int(c["segment_len"])
    frames = N // c["hop_length"] + 1
    g = weights.generator(run.seed, "batches", dev)
    batches = []
    for _ in range(int(tr["batches"])):
        batches.append({"wav": weights.synthetic_wavs(B, N, g, dev),
                        "t": torch.randint(1, c["max_timestep"], (B,), generator=g, device=dev),
                        "noise": torch.randn(B, frames, c["n_mels"], generator=g, device=dev)})
    return {"h": h, "W": W, "enc": enc, "dec": dec, "batches": batches, "B": B, "N": N,
            "updates": total_updates(c), "gen_seed": subseed(run.seed, "steps")}


def program(run, torch, s):
    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.models import (EdgeDiffusionDecoder, HubertConfig,
                                                     SemanticEncoder)
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
    from edge_diffusion_tts_tpu_torch.training import (Trainer, create_train_state,
                                                       make_optimizer)

    c, dev = run.config, run.device
    if c["param_dtype"] != "float32":
        raise ValueError("the training driver runs float32 parameters")
    cfg = CFG.from_dict(c)
    compute = {"float32": torch.float32, "bfloat16": torch.bfloat16}[c["compute_dtype"]]
    h = HubertConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in s["h"].items()})
    with torch.device(dev):
        encoder = SemanticEncoder(cfg, h, dtype=compute)
        decoder = EdgeDiffusionDecoder(cfg, dtype=compute)
    encoder.load_state_dict(s["enc"])
    decoder.load_state_dict(s["dec"])
    trainer = Trainer(cfg, encoder, decoder,
                      DiffusionSchedule.create(cfg.diff_steps, cfg.beta_start, cfg.beta_end),
                      device=dev)
    state = create_train_state(trainer.encoder, trainer.decoder,
                               make_optimizer(cfg, trainer.encoder, trainer.decoder, s["updates"]))
    return trainer, state, trainer.make_diffusion_step()


def run(run):
    import torch

    no_tf32()  # the configurations state float32 where they do not state bf16
    cuda, tr = run.device != "cpu", run.traffic
    s = data(run, torch)
    trainer, state, step = program(run, torch, s)
    gen = torch.Generator(device=run.device).manual_seed(s["gen_seed"])
    batches, n_check = s["batches"], int(tr["check_steps"])
    params = state.optimizer.params
    got = {"losses": []}
    for k in range(n_check):
        state, metrics = step(state, batches[k % len(batches)], gen)
        got["losses"].append(float(metrics["loss"]))
        if k == 0:
            b1 = state.optimizer.b1
            got["first_grad"] = {n: m.detach().double() / (1.0 - b1)
                                 for n, m in state.optimizer.mu.items()}
    got["change"] = {n: p.detach().double() - s["W"][n].double() for n, p in params.items()}
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - run.t0

    prof = None
    if run.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()
        window_mark = record_function("bench:window")
        window_mark.__enter__()
    seconds = min(run.seconds, float(tr["trace_seconds"])) if run.trace else run.seconds
    t_start = time.perf_counter()
    deadline, n = t_start + seconds, 0
    while time.perf_counter() < deadline:
        batch = batches[(n_check + n) % len(batches)]
        if prof is not None:
            with record_function("bench:step"):
                state, _ = step(state, batch, gen)
        else:
            state, _ = step(state, batch, gen)
        n += 1
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_start
    view = None
    if prof is not None:
        window_mark.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        view = TraceView(prof, {
            "kind": "train", "compute": run.config["compute_dtype"], "cfg": run.config,
            "hubert": s["h"], "steps": n, "rows": s["B"], "samples": s["N"]})
        del prof
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = {"train_audio_s_per_s": n * s["B"] * s["N"] / run.config["sample_rate"] / window_s,
           "setup_s": setup_s}

    del trainer, state, step, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare.training_numbers(got, reference(run, s, Ops("float32")),
                                       run.__dict__.setdefault("diagnostics", {}))
    failed = sum(int(not numbers[k] <= v) for k, v in run.limits.items() if k in numbers)
    return {"e2e": e2e, "numbers": numbers, "attempted": n, "failed": failed,
            "memory_peak_bytes": peak, "trace": view}


def reference(run, s, ops: Ops, half_batch: bool = False) -> dict:
    """The reference's readings of the first steps: losses, step 1's clipped
    gradient and the change, per leaf.  ``half_batch`` plants a
    fault: each step's loss over the first half of its batch's rows."""
    import torch

    no_tf32()
    gen = torch.Generator(device=run.device).manual_seed(s["gen_seed"])
    n_check = int(run.traffic["check_steps"])
    batches = [s["batches"][k % len(s["batches"])] for k in range(n_check)]
    if half_batch:
        batches = [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]
    out = rtrain.run_steps(run.config, s["h"], s["W"], batches, gen, s["updates"], ops)
    return out


def control(run, precision: str, half_batch: bool = False, diagnostics: dict = None) -> dict:
    """The numbers of the control: the reference at ``precision`` in the
    program's place (with ``half_batch``, the fault of that name)."""
    import torch

    s = data(run, torch)
    return compare.training_numbers(reference(run, s, Ops(precision), half_batch),
                                    reference(run, s, Ops("float32")), diagnostics)
