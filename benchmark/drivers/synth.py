"""Synthesis cells: batched token -> mel or audio -> mel calls, back to back.

One caller, a closed loop: each call is issued when the previous one has
returned its mel to the host, so a call is due when it is issued.  The
entry is the port's own: ``EdgeInference(backend="fused").generate_mel`` for
tokens at float32, ``generate_from_audio`` (the frontend kernel, HuBERT,
FSQ, then the same loop) for audio, and ``ops.fused_denoise.
fused_generate_mel(..., compute_dtype=bfloat16)`` on weights packed once
for a bfloat16 configuration, since ``EdgeInference`` does not route a
compute dtype into the fused loop.  Each call's mel is copied to the host
inside the call.

A call holds ``rows`` utterances of one bucket of ``traffic.buckets``,
padded to the bucket's length: token rows with codes (no mask, as the fused
loop takes them), wavs with zeros past each row's own duration.  The rate
counts each row's own seconds, not its padding.

Set-up makes the weights and a pool of inputs per bucket on the device from
the seed and runs every bucket twice; the window then calls until
``seconds`` have passed (a traced run: the traffic's ``trace_seconds``, under
``torch.profiler``, with ``bench:call`` around each call), and on until every
call ``traffic.checked`` drew from the seed has been made.  Afterwards, with
the program's state freed, the reference recomputes those calls and the
harness compares; a checked call that is missing makes every number
infinite.  An audio call's tokens are recorded where the engine hands them
to ``generate_mel``: the reference decodes the timed path's tokens, and its
own encode judges them by ``token_margin``.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from ..harness import compare, traffic as plan_of, weights
from ..harness.trace import TraceView
from ..reference import decoder as rdec, hubert as rhub, schedule as rsched
from ..reference.precision import Ops, no_tf32


def data(run, torch) -> dict:
    """Weights and the pool of inputs, made on the device from the seed."""
    from edge_diffusion_tts_tpu_torch.config import CFG

    c, tr, dev = run.config, run.traffic, run.device
    cfg = CFG.from_dict(c)
    s = dict(cfg=cfg, audio=tr["input"] == "audio", steps=cfg.inference_steps,
             prediction="v" if cfg.use_v_prediction else "eps", B=int(tr["rows"]),
             h=c.get("hubert"))
    s["W_dec"] = weights.make(rdec.parameter_shapes(c), run.seed, dev, "decoder")
    if s["audio"]:
        s["W_enc"] = weights.make(rhub.encoder_shapes(c, s["h"]), run.seed, dev, "encoder")
    g = weights.generator(run.seed, "inputs", dev)
    codes, B, M = cfg.effective_codebook_size(), s["B"], cfg.n_mels
    s["pool"] = []
    for b in plan_of.buckets(tr):
        n, sets = b["length"], []
        if s["audio"]:  # zero past each row's own duration
            own = torch.tensor([round(x * tr["units_per_s"]) for x in b["row_s"]], device=dev)
            keep = (torch.arange(n, device=dev)[None, :] < own[:, None]).float()
        for _ in range(int(tr["pool"])):
            if s["audio"]:
                S = rhub.frames(s["h"], n)[-1]
                inp = {"wav": weights.synthetic_wavs(B, n, g, dev) * keep, "samples": n}
            else:
                S = n
                inp = {"tokens": torch.randint(0, codes, (B, S), generator=g, device=dev)}
            inp["x"] = torch.randn(B, 2 * S, M, generator=g, device=dev)
            inp["S"], inp["T"], inp["speech_s"] = S, 2 * S, sum(b["row_s"])
            sets.append(inp)
        s["pool"].append(sets)
    return s


def program(run, torch, s):
    """The port's entry for this cell, as ``call(inputs) -> mel on the host``."""
    from edge_diffusion_tts_tpu_torch.inference import EdgeInference
    from edge_diffusion_tts_tpu_torch.models import (EdgeDiffusionDecoder, HubertConfig,
                                                     SemanticEncoder)
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

    c, dev, cfg = run.config, run.device, s["cfg"]
    if c["param_dtype"] != "float32":
        raise ValueError("the synthesis driver runs float32 parameters")
    compute = {"float32": torch.float32, "bfloat16": torch.bfloat16}[c["compute_dtype"]]
    if s["audio"] and compute != torch.float32:
        raise ValueError("EdgeInference encodes and decodes audio at float32 only")
    with torch.device(dev):
        decoder = EdgeDiffusionDecoder(cfg, dtype=compute)
    decoder.load_state_dict(s["W_dec"])
    schedule = DiffusionSchedule.create(cfg.diff_steps, cfg.beta_start, cfg.beta_end)
    steps, pred = s["steps"], s["prediction"]
    if s["audio"]:
        h = HubertConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in s["h"].items()})
        with torch.device(dev):
            encoder = SemanticEncoder(cfg, h, dtype=compute)
        encoder.load_state_dict(s["W_enc"])
        engine = EdgeInference(cfg, schedule, decoder, prediction=pred, backend="fused",
                               device=dev, encoder=encoder)
        inner = engine.generate_mel

        def generate_mel(sem_idx, *a, **k):  # records the tokens the timed path made
            if s["current"] is not None:  # a checked call
                s["tokens_of"][s["current"]] = sem_idx
            return inner(sem_idx, *a, **k)

        engine.generate_mel = generate_mel
        s["tokens_of"] = {}
        return engine, lambda inp: engine.generate_from_audio(inp["wav"], steps,
                                                              x_T=inp["x"]).cpu()
    if compute == torch.float32:
        engine = EdgeInference(cfg, schedule, decoder, prediction=pred, backend="fused",
                               device=dev)
        return engine, lambda inp: engine.generate_mel(inp["tokens"], steps, x_T=inp["x"]).cpu()
    decoder = decoder.to(dev).eval()
    schedule = schedule.to(dev)
    packed = fd.pack_decoder_weights(decoder, compute)
    return (decoder, schedule, packed), lambda inp: fd.fused_generate_mel(
        cfg, schedule, decoder, inp["tokens"], inp["x"], steps, pred, weights=packed,
        compute_dtype=compute).cpu()


def pool_index(order, i: int) -> int:
    """Which of its length's pool entries call ``i`` takes: they rotate."""
    return order[:i].count(order[i])


def run(run):
    import torch

    no_tf32()  # the configurations state float32 where they do not state bf16
    cuda = run.device != "cpu"
    s = data(run, torch)
    engine, call = program(run, torch, s)
    pool = s["pool"]
    for sets in pool:  # warm every bucket the window uses: builds, plans, handles
        for inp in sets[:2]:
            s["current"] = None
            call(inp)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - run.t0

    tr = run.traffic
    order = plan_of.plan(tr, run.seed, int(tr["plan_calls"]))
    checked = plan_of.checked(tr, run.seed)
    last_checked = max(checked, default=-1)
    used = [0] * len(pool)
    kept, calls, info = {}, [], []
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
    deadline = t_start + seconds
    while len(calls) < len(order):
        due = time.perf_counter()
        if due >= deadline and len(calls) > last_checked:
            break
        i, li = len(calls), order[len(calls)]
        inp = pool[li][used[li] % len(pool[li])]
        s["current"] = i if i in checked else None
        if prof is not None:
            with record_function("bench:call"):
                mel = call(inp)
        else:
            mel = call(inp)
        calls.append((due, time.perf_counter()))
        info.append({"rows": s["B"], "tokens": inp["S"], "frames": inp["T"],
                     "samples": inp.get("samples"), "speech_s": inp["speech_s"]})
        if i in checked:
            kept[i] = (li, used[li] % len(pool[li]), mel)
        used[li] += 1
    window_s = calls[-1][1] - t_start
    view = None
    if prof is not None:
        window_mark.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        view = TraceView(prof, {
            "kind": "synth", "input": tr["input"], "compute": run.config["compute_dtype"],
            "cfg": run.config, "hubert": s["h"], "steps": s["steps"], "calls": info})
        del prof
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = {"audio_s_per_s": sum(x["speech_s"] for x in info) / window_s,
           "call_ms_p95": float(np.percentile([(b - a) * 1e3 for a, b in calls], 95)),
           "setup_s": setup_s}

    answers = {i: {"mel": mel, "tokens": s.get("tokens_of", {}).get(i), "input": pool[li][p]}
               for i, (li, p, mel) in kept.items()}
    del engine, call
    s.pop("tokens_of", None)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, failed = check(run, s, answers, len(checked))
    return {"e2e": e2e, "numbers": numbers, "attempted": len(calls), "failed": failed,
            "memory_peak_bytes": peak, "trace": view}


def reference_mel(run, s, tokens, x, ops: Ops):
    """The reference's DDIM mel of ``tokens`` from the start noise ``x``."""
    import torch

    c, W, B = run.config, s["W_dec"], x.shape[0]
    ctx = rdec.token_context(W, tokens)

    def model(xt, t, i):
        return rdec.forward(W, c, xt, torch.full((B,), t, device=xt.device),
                            torch.full((B,), i, device=xt.device), ctx, ops)

    return rsched.ddim(model, x.float(), c["diff_steps"], s["steps"], s["prediction"])


def check(run, s, answers: dict, due: int):
    """``(numbers, failed calls)`` of the checked answers against the
    reference at full precision; each number infinite unless all ``due``
    checked calls answered."""
    import torch

    no_tf32()
    full, limits = Ops("float32"), run.limits
    numbers = {"row_rms_gap": 0.0}
    if s["audio"]:
        numbers["token_margin"] = 0.0
    failed = 0
    with torch.no_grad():
        for a in answers.values():
            inp, tokens, mine = a["input"], a["tokens"], {}
            if s["audio"]:
                ref_tokens, scaled = rhub.encode(s["W_enc"], run.config, s["h"], inp["wav"], full)
                if tokens is None:  # the engine handed no tokens to generate_mel
                    tokens = ref_tokens
                fsq = rhub.FSQ(run.config["fsq_levels"], scaled.device)
                mine["token_margin"] = rhub.flip_margin(fsq, scaled, tokens)
            else:
                tokens = inp["tokens"]
            want = reference_mel(run, s, tokens, inp["x"], full)
            mine["row_rms_gap"] = compare.row_rms_gap(a["mel"], want)
            for k, v in mine.items():
                numbers[k] = max(numbers[k], v)
            failed += int(any(not v <= limits.get(k, float("inf")) for k, v in mine.items()))
    if len(answers) < due or not answers:
        numbers = {k: float("inf") for k in numbers}
        failed += due - len(answers)
    return numbers, failed


def control(run, precision: str) -> dict:
    """The numbers of the control: the reference at ``precision`` in the
    program's place, on the calls the seed checks."""
    import torch

    s = data(run, torch)
    no_tf32()
    low = Ops(precision)
    tr = run.traffic
    checked = plan_of.checked(tr, run.seed)
    order = plan_of.plan(tr, run.seed, max(checked) + 1)
    answers = {}
    with torch.no_grad():
        for i, li in checked.items():
            inp = s["pool"][li][pool_index(order, i) % len(s["pool"][li])]
            tokens = inp.get("tokens")
            if s["audio"]:
                tokens = rhub.encode(s["W_enc"], run.config, s["h"], inp["wav"], low)[0]
            answers[i] = {"mel": reference_mel(run, s, tokens, inp["x"], low),
                          "tokens": tokens if s["audio"] else None, "input": inp}
    return check(run, s, answers, len(checked))[0]
