#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's paths, on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 port_profile.py [flagship] [longform] [audio] [ddpm] [stream] [burst] [train]
                            [cli]

Profiles (``torch.profiler``, CPU + CUDA activity) a steady window of
calls of each path named (all of them by default) with the weights and
inputs of chip_smoke.py:

- flagship: ``EdgeInference(backend="fused").generate_mel``, B=1, S=250,
  4 DDIM steps (5 calls);
- long-form: ``EdgeInference(backend="eager", sampler="dpmpp")`` at
  configs/longform.json, S=2000 -> T=4000, 4 steps (3 calls);
- audio: ``EdgeInference(backend="fused", encoder=...).generate_from_audio``
  on a 5 s wav (80,000 samples) at B=1, full HuBERT-base width (5 calls);
- ddpm: ``FusedEdgeInference.sample_ddpm``, 1000 steps at B=1, S=250 (1 call);
- stream: the serving path's long-form pieces with the flagship decoder and
  the full HuBERT-base encoder: one ``LongFormScheduler`` tick, i.e.
  ``LongFormPipeline.refine_chunk_batch_seeds`` at 1 and 4 rows (50 steps,
  cfg 2.0, T=201: 50 eager decoder calls of 2 x rows; 3 calls each), and one
  ``stream_prep`` of a 6 s wav on the 8 s prep bucket (3 calls), then
  ``stream_prep_async``'s dispatch and its ``realize()`` apart (3 calls from
  an idle card): the host ms of each, the device busy ms inside each and its
  busy share;
- burst: chip_smoke.py's phase 9b (``serve_burst``: a 10 s stream ticking
  through ``run_server`` at phase 9's settings, four 6 s streams requested
  from four threads after its second increment) three times: from a cold
  pinned-memory cache, warm, and warm under the profiler on every thread
  after one dispatch on the idle server, each prep's dispatch in a
  ``record_function`` range.  Per
  dispatch: its wall ms, the ms inside the torch ops it called on its
  thread (the dispatcher and the CUDA launches, run with the GIL released)
  and the rest (Python, and taking the GIL back after each op);
- train: steady flagship data steps (configs/flagship.json: batch 4 of 2 s,
  dropout 0.2, grad_accumulation 8, depthwise pre-net) of the diffusion
  step, on the wav path (the frozen full-width HuBERT-base on the frontend
  kernel, then the mel, the encoder projection, the decoder forward and
  backward, the optimizer) and on the precomputed-features path (16 steps
  each, two optimizer updates among them, after 8 warm-up steps); beside
  them the host time of one batch's collate (4 LJSpeech-rate wavs resampled
  and cropped).  Device time is split by the step's ``record_function``
  ranges (``train:hubert``, ``train:mel``, ``train:encoder``,
  ``train:decoder``, ``train:backward`` with the autograd engine's
  functions, ``train:optimizer``): each kernel is charged to the range that
  encloses the op that launched it; the frontend's kernels (launched
  through ctypes, no op) by their names;
- cli: the command line's ``generate`` as it runs (``demo.generate_sample``:
  the checkpoint read from disk, a 5 s wav encoded on the frontend kernel,
  4 eager DDIM steps, the mel denormalized, 100 Griffin-Lim iterations, the
  wav written) from a checkpoint of the flagship decoder and the full
  HuBERT-base written to build/port_profile_cli/ (3 calls).

For each it prints the wall time per call, the device busy time (the union
of the kernels' intervals) and its share of the wall time, the kernels
launched per call and how many of them are copies (PyTorch's copy kernels:
``.contiguous()``, a reshape that copies), the device time per call of the
kernels by name and by group (the frontend kernels, the decoder-loop
kernels, the long-form band attention, cuBLAS/cuDNN products such as
HuBERT's, the rest), and the host gap (wall minus busy time).  For the
audio path it also times each stage alone with CUDA events, the frontend's
kernels apart from ``groupnorm_fold``, and those two by CUDA-graph replay.
It writes the same as JSON to build/port_profile.json and exits non-zero
without a CUDA device.

    python3 port_profile.py --band-strip N

prints the band-attention kernel's device time by CUDA-graph replay at
chip_smoke.py's phase-2 shapes in each tile it is built for (the plan
narrowed to one tile by ``BAND_ROWS``): N = 0 the kernel as it ships, and
N = 1-3 a build with -DEDT_BAND_STRIP=N into build/band_strip/ that leaves
work out (1: staging alone, 2: without O += PV, 3: without S = QK^T;
csrc/band_attention.cu), beside which the full kernel's time shows where the
time goes.  Run each N in its own process.

    python3 port_profile.py --gemm-timers

instead builds the loop library with -DEDT_GEMM_TIMERS into
build/gemm_timers/, where the step GEMM (csrc/gemm.cuh) stamps each block's
phases with clock64 (thread 0) and its start and end with %globaltimer and
takes a tile forced from the host.  It runs each GEMM of the flagship decoder
step in each tile at 500 rows and prints, per tile, its device time in a
CUDA graph (stamps on), the kernel's span, and the median cycles per phase
over blocks: issuing the staging copies, loading the epilogue's operands,
the row-norm prologue, the wait for the first K-chunk, the products (with
the waits for the later chunks), the epilogue.

    python3 port_profile.py --nccl

runs chip_smoke.py's phase 11 (``parallel/``: DP steps, ``train()`` on a
mesh, sequence-parallel long-form at T = 8000, the TP encode, a PP step,
``make_dp_generate``) with one rank per card over NCCL, on every card of
the machine (at least 2), each program against the single-device run on
cuda:0 with phase 11's bars, and writes its times to
build/port_profile_parallel.json.  It writes phase 10's corpus first (84
synthetic utterances under build/phase10).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PATHS = ("flagship", "longform", "audio", "ddpm", "stream", "burst", "train", "cli")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _is_annotation(name: str) -> bool:
    """The ``record_function`` ranges (the training step's, the stream
    prep's), which the profiler also reports on the device timeline
    (spanning their kernels and the gaps between them): not kernels."""
    return name.startswith(("train:", "prep:"))


def _device_spans(prof) -> list:
    """Sorted (start, end) µs of every device activity but the annotations."""
    return sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type is not None and "cuda" in str(e.device_type).lower()
                  and not _is_annotation(e.name))


def _busy_us(spans, lo: float = float("-inf"), hi: float = float("inf")) -> float:
    """The union of ``spans`` clipped to [lo, hi]: kernels that overlap (cuDNN
    runs a grouped conv's groups side by side) count once."""
    busy, end = 0.0, lo
    for a, b in spans:
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


def profile_calls(torch, fn, calls: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up (kernel build and load happen before the window)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, copies = [], 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if (us > 0 and evt.device_type is not None and "cuda" in str(evt.device_type).lower()
                and not _is_annotation(evt.key)):
            kernels.append({"name": evt.key[:90], "ms_per_call": us / 1e3 / calls,
                            "count_per_call": evt.count / calls})
            copies += evt.count if "copy" in evt.key.lower() else 0
    kernels.sort(key=lambda k: -k["ms_per_call"])
    busy_ms = _busy_us(_device_spans(prof)) / 1e3 / calls
    stages = stage_split(prof, calls)
    return {"wall_ms_per_call": wall_ms / calls, "stages_ms_per_call": stages,
            "kernel_ms_per_call": sum(k["ms_per_call"] for k in kernels),
            "device_ms_per_call": busy_ms, "busy_share": busy_ms / (wall_ms / calls),
            "launches_per_call": sum(k["count_per_call"] for k in kernels),
            "copies_per_call": copies / calls, "kernels": kernels}


def profile_prep_split(torch, pipe, wav, calls: int = 3) -> dict:
    """``stream_prep_async`` with its dispatch and its fetch apart: each call
    from an idle card, the dispatch and then ``realize()`` at once, each in a
    ``record_function`` range.  Per call: the host ms of each range, the
    device busy ms inside it, its busy share, and the prep's device busy ms
    in all."""
    from torch.profiler import ProfilerActivity, profile, record_function

    pipe.stream_prep_async(wav, seed=2)()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            torch.cuda.synchronize()
            with record_function("prep:dispatch"):
                realize = pipe.stream_prep_async(wav, seed=2)
            with record_function("prep:realize"):
                realize()
    spans = _device_spans(prof)
    out = {"device_ms_per_call": _busy_us(spans) / 1e3 / calls}
    for part in ("dispatch", "realize"):
        ranges = [(e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.name == f"prep:{part}" and e.device_type is not None
                  and "cpu" in str(e.device_type).lower()]
        assert len(ranges) == calls, (part, len(ranges))
        wall = sum(b - a for a, b in ranges) / 1e3 / calls
        busy = sum(_busy_us(spans, a, b) for a, b in ranges) / 1e3 / calls
        out[part] = {"wall_ms_per_call": wall, "device_ms_per_call": busy,
                     "busy_share": busy / wall}
    return out


def profile_burst(torch, cfg, dec) -> dict:
    """The ``burst`` path (module docstring): ``serve_burst``'s readings of
    each burst (``cold``, ``warm``, ``profiled``) and, keyed by its stream's
    seed (19: the idle server's, 20: the ticking stream's, 21-24: the
    burst's), each profiled dispatch's
    ``wall_ms``, ``in_ops_ms``, ``rest_ms`` and ``ops``."""
    import chip_smoke
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, record_function

    from edge_diffusion_tts_tpu_torch import serving
    from edge_diffusion_tts_tpu_torch.weights import save_checkpoint

    ckpt = os.path.join(ROOT, "build", "burst_checkpoint")
    save_checkpoint(ckpt, cfg, dec, chip_smoke.seeded_encoder(torch, cfg, chip_smoke.SEED))
    server, batcher = serving.run_server(ckpt, port=0, buckets=(128, 256), max_batch=8,
                                         longform=True, longform_streams=2, verbose=False)
    sched = server.longform_fn.scheduler
    pipe, host_port = sched.pipe, server.server_address
    dispatch = pipe.stream_prep_async

    def ranged(wav, seed=0):
        with record_function(f"burst:dispatch:{seed}"):
            return dispatch(wav, seed)

    out = {}
    try:
        for name in ("cold", "warm"):  # the second with the pinned blocks cached
            out[name] = chip_smoke.serve_burst(torch, sched, *host_port)
            out[name].pop("streams")
        pipe.stream_prep_async = ranged  # serve_burst wraps it, then drops the wrappers
        wav = chip_smoke.synthetic_wav(6.0, 9200 + chip_smoke.SEED)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            pipe.stream_prep_async(wav, seed=19)()
            out["profiled"] = chip_smoke.serve_burst(torch, sched, *host_port)
            out["profiled"].pop("streams")
    finally:
        if "stream_prep_async" in vars(pipe):
            del pipe.stream_prep_async
        server.shutdown()
        batcher.close()
    for e in prof.events():
        if e.name.startswith("burst:dispatch:") and "cpu" in str(e.device_type).lower():
            wall = e.time_range.elapsed_us() / 1e3
            in_ops = sum(c.time_range.elapsed_us() for c in e.cpu_children) / 1e3
            out[int(e.name.rsplit(":", 1)[1])] = {
                "wall_ms": wall, "in_ops_ms": in_ops, "rest_ms": wall - in_ops,
                "ops": len(e.cpu_children)}
    return out


FRONTEND_KERNELS = ("conv0_kernel", "conv_slab_kernel", "split_sum_gelu_kernel")


def stage_split(prof, calls: int) -> dict:
    """Device ms per call charged to the training step's ``record_function``
    ranges: each op that launched kernels is charged to the innermost
    ``train:*`` range (or autograd engine function: "backward") above it.
    Empty for paths with no such range."""
    stages = {}
    for e in prof.events():
        kernels = getattr(e, "kernels", None)
        if not kernels:
            continue
        stage, p = None, e
        while p is not None and stage is None:
            if p.name.startswith("train:"):
                stage = p.name[len("train:"):]
            elif p.name.startswith("autograd::engine::evaluate_function"):
                stage = "backward"
            p = p.cpu_parent
        if stage is None:
            continue
        stages[stage] = stages.get(stage, 0.0) + sum(k.duration for k in kernels) / 1e3 / calls
    if stages:
        stages["frontend kernels"] = sum(
            _device_us(evt) / 1e3 / calls for evt in prof.key_averages()
            if any(k in evt.key for k in FRONTEND_KERNELS))
    return stages


# Kernel-name substrings -> group, first match wins.
GROUPS = (
    ("conv0_kernel", "conv frontend kernels"),
    ("conv_slab_kernel", "conv frontend kernels"),
    ("split_sum_gelu_kernel", "conv frontend kernels"),
    ("band_tile_kernel", "long-form band attention"),
    ("gemm_kernel<", "decoder loop kernels"),
    ("band_attention_kernel", "decoder loop kernels"),
    ("ddim_kernel", "decoder loop kernels"),
    ("ddpm_kernel", "decoder loop kernels"),
    ("gemm", "cuBLAS/cuDNN products"),
    ("cutlass", "cuBLAS/cuDNN products"),
    ("conv", "cuBLAS/cuDNN products"),
)


def group_of(name: str) -> str:
    return next((g for key, g in GROUPS if key in name), "other (elementwise, norms, copies)")


def report(name: str, r: dict) -> None:
    groups = {}
    for k in r["kernels"]:
        g = group_of(k["name"])
        groups[g] = groups.get(g, 0.0) + k["ms_per_call"]
    r["groups_ms_per_call"] = groups
    r["host_gap_ms_per_call"] = r["wall_ms_per_call"] - r["device_ms_per_call"]
    print(f"[{name}] wall {r['wall_ms_per_call']:.4f} ms/call, device busy "
          f"{r['device_ms_per_call']:.4f} ms/call (kernel times summed "
          f"{r['kernel_ms_per_call']:.4f}), busy share {r['busy_share']:.3f}, "
          f"host gap {r['host_gap_ms_per_call']:.4f} ms/call; {r['launches_per_call']:g} "
          f"kernels per call, {r['copies_per_call']:g} of them copies")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[{name}]   group {ms:.5f} ms  {g}")
    for g, ms in sorted(r["stages_ms_per_call"].items(), key=lambda kv: -kv[1]):
        print(f"[{name}]   stage {ms:.5f} ms  {g}")
    for k in r["kernels"][:12]:
        print(f"[{name}]   {k['ms_per_call']:.5f} ms  x{k['count_per_call']:.0f}  {k['name']}")


def profile_train(torch) -> dict:
    """The ``train`` path (the module docstring): steady flagship diffusion
    data steps on the wav and the precomputed path, and one batch's collate."""
    import chip_smoke
    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.data import Collate
    from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
    from edge_diffusion_tts_tpu_torch.training import Trainer, create_train_state, make_optimizer

    with open(os.path.join(ROOT, "configs", "flagship.json")) as f:
        cfg = CFG.from_dict(json.load(f))
    torch.manual_seed(chip_smoke.SEED)
    encoder = chip_smoke.seeded_encoder(torch, cfg, chip_smoke.SEED)
    trainer = Trainer(cfg, encoder, EdgeDiffusionDecoder(cfg),
                      DiffusionSchedule.create(cfg.diff_steps), device="cuda")
    state = create_train_state(trainer.encoder, trainer.decoder,
                               make_optimizer(cfg, trainer.encoder, trainer.decoder, 1000))
    step = trainer.make_diffusion_step()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    wav22k = [chip_smoke.synthetic_wav(3.0, 9500 + i, sr=22050) for i in range(cfg.batch_size)]
    collate = Collate(cfg, seed=cfg.seed)
    batch = collate([(w, 22050) for w in wav22k])
    t0 = time.perf_counter()
    for _ in range(20):
        collate([(w, 22050) for w in wav22k])
    collate_ms = (time.perf_counter() - t0) * 1e3 / 20
    print(f"[train] collate of one batch ({cfg.batch_size} wavs of 3 s at 22,050 Hz, resample "
          f"to 16 kHz, crop to {cfg.segment_len}): {collate_ms:.4f} ms on the host")
    wav = trainer.put_batch(batch)
    pre = dict(wav, hubert_features=trainer.hubert_features(state, wav["wav"]))
    out = {"train_collate_ms_per_batch": collate_ms}
    for name, b in (("train_wav", wav), ("train_precomputed", pre)):
        for _ in range(8):  # one accumulation cycle: cuBLAS/cuDNN picks, allocator
            step(state, b, gen)
        out[name] = profile_calls(torch, lambda: step(state, b, gen), calls=16)
        report(name, out[name])
    out["train_peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] peak torch.cuda.max_memory_allocated {out['train_peak_memory_gib']:.3f} GiB")
    return out


TIMER_PHASES = ("issue", "epilogue loads", "norm", "first chunk", "products", "epilogue")


def build_gemm_timers():
    """Compile the loop library with gemm.cuh's per-block timers
    (-DEDT_GEMM_TIMERS) into build/gemm_timers/; returns the ctypes library."""
    import ctypes
    import subprocess

    from edge_diffusion_tts_tpu_torch import _build

    out = os.path.join(ROOT, "build", "gemm_timers")
    os.makedirs(out, exist_ok=True)
    lib_path = os.path.join(out, "libtimers.so")
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DEDT_GEMM_TIMERS", "-o",
                           lib_path, str(_build.CSRC / "fused_ddim.cu")],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc of the timed GEMM failed:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(lib_path)


def band_strip(torch, level: int) -> int:
    import ctypes
    import subprocess

    import chip_smoke
    from edge_diffusion_tts_tpu_torch import _build
    from edge_diffusion_tts_tpu_torch.ops import window_attention as wa

    if level:
        out = os.path.join(ROOT, "build", "band_strip")
        os.makedirs(out, exist_ok=True)
        lib_path = os.path.join(out, f"libband_strip{level}.so")
        done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-DEDT_BAND_STRIP={level}",
                               "-o", lib_path, str(_build.CSRC / "band_attention.cu")],
                              capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"nvcc of the stripped band kernel failed:\n{done.stdout}"
                               f"{done.stderr}")
        lib = ctypes.CDLL(lib_path)
        load = _build.load
        _build.load = lambda name: lib
        try:
            wa._lib.__wrapped__()  # sets the argtypes on the stripped library
        finally:
            _build.load = load
        wa._lib = lambda: lib
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = wa.BAND_ROWS
    for B, T in chip_smoke.BAND_SHAPES:
        q, k, v = chip_smoke.band_inputs(torch, B, 4, T, 40, seed=T + B)
        pick = wa.band_plan(B, 4, T, 40, 64, sms)["rows"]
        times = {}
        for rows in tiles:
            wa.BAND_ROWS = (rows,)
            times[rows] = chip_smoke.graph_ms(torch, lambda: wa.banded_attention(q, k, v, 64))
        wa.BAND_ROWS = tiles
        print(f"[band strip {level}] [{B},4,{T},40] w=64 device ms by graph replay, rows per "
              f"block: " + ", ".join(f"{r} {ms:.5f}" + (" (the plan's)" if r == pick else "")
                                     for r, ms in times.items()))
    return 0


def gemm_timers(torch) -> int:
    import ctypes

    import chip_smoke
    from edge_diffusion_tts_tpu_torch import _build
    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd

    lib = build_gemm_timers()
    load = _build.load
    _build.load = lambda name: lib
    try:
        fd._lib.__wrapped__()  # sets the hook's argtypes on the timer library
    finally:
        _build.load = load
    fd._lib = lambda: lib
    lib.edt_gemm_timers.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.edt_gemm_force_tile.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.edt_gemm_force_tile.restype = ctypes.c_int
    cfg = CFG(dropout=0.0)
    w = fd.pack_decoder_weights(chip_smoke.seeded_decoder(torch, cfg, chip_smoke.SEED).cuda())
    rows, H, M, F = 500, cfg.hidden, cfg.n_mels, cfg.hidden * cfg.ffn_mult
    rng = np.random.RandomState(chip_smoke.SEED)

    def act(n):
        return torch.from_numpy(rng.randn(rows, n).astype(np.float32)).cuda()

    x, h, ao, f = act(M), act(H), act(H), act(F)
    mods = torch.from_numpy(1.0 + 0.1 * rng.randn(4, H).astype(np.float32)).cuda()
    pos = act(H)
    shapes = [
        ("in_proj", x, w["in_w"], dict(bias=w["in_b"], pos=pos)),
        ("qkv", h, w["qkv_w"][0], dict(norm="rms", scale=mods[0], shift=mods[1])),
        ("attn proj", ao, w["proj_w"][0], dict(bias=w["proj_b"][0], residual=h)),
        ("cross q", h, w["cq_w"][0], dict(norm="rms", scale=w["n2w"][0])),
        ("cross out", ao, w["co_w"][0], dict(residual=h)),
        ("fc1", h, w["fc1_w"][0], dict(bias=w["fc1_b"][0], norm="rms", scale=mods[2],
                                       shift=mods[3], swiglu=True)),
        ("fc2", f, w["fc2_w"][0], dict(bias=w["fc2_b"][0], residual=h)),
        ("out_proj", h, w["out_w"], dict(bias=w["out_b"], norm="ln", scale=w["fn_s"],
                                         shift=w["fn_b"])),
    ]
    stamps = np.zeros((8192, 8), np.int64)
    bm_bn = (ctypes.c_int * 2)()
    for name, a, W, kw in shapes:
        n = W.shape[0] // (2 if kw.get("swiglu") else 1)
        pick = fd.decoder_gemm_tile(rows, n)
        tile = 0
        while lib.edt_gemm_force_tile(tile, bm_bn) >= 0:
            bm, bn = bm_bn[0], bm_bn[1]
            for _ in range(3):  # the last launch's stamps are read
                fd.decoder_gemm(a, W, **kw)
            torch.cuda.synchronize()
            blocks = -(-rows // bm) * -(-n // bn)
            _build.check(lib.edt_gemm_timers(stamps.ctypes.data, blocks), "gemm timers")
            t = stamps[:min(blocks, len(stamps))]
            us = 1e3 * chip_smoke.graph_ms(torch, lambda: fd.decoder_gemm(a, W, **kw))
            mark = " (the host's pick)" if (bm, bn) == pick else ""
            print(f"[gemm timers] {name} tile {bm}x{bn}{mark}, {blocks} blocks: "
                  f"{us:.3f} us in a CUDA graph, span {(t[:, 1].max() - t[:, 0].min()) / 1e3:.2f}"
                  f" us, block median {np.median(t[:, 1] - t[:, 0]) / 1e3:.2f} us; median "
                  "cycles: " + ", ".join(f"{p} {int(np.median(t[:, 2 + i]))}"
                                         for i, p in enumerate(TIMER_PHASES)))
            tile += 1
    lib.edt_gemm_force_tile(-1, bm_bn)
    return 0


def parallel_nccl(torch) -> int:
    """chip_smoke.py's phase 11 with one rank per card over NCCL."""
    import chip_smoke
    from edge_diffusion_tts_tpu_torch.config import CFG

    n = torch.cuda.device_count()
    if n < 2:
        print(f"port_profile --nccl: {n} CUDA device(s); one rank per card needs 2+",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_build()
    chip_smoke.write_ljspeech(os.path.join(ROOT, "build", "phase10", "LJSpeech-1.1"),
                              chip_smoke.TRAIN_UTTERANCES, chip_smoke.SEED)
    cfg = CFG(dropout=0.0)
    dec = chip_smoke.seeded_decoder(torch, cfg, chip_smoke.SEED).cuda()
    out = chip_smoke.phase_parallel(torch, cfg, dec, nranks=n, backend="nccl")
    out["devices"] = [torch.cuda.get_device_name(i) for i in range(n)]
    path = os.path.join(ROOT, "build", "port_profile_parallel.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_profile: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if "--nccl" in sys.argv[1:]:
        return parallel_nccl(torch)
    if "--gemm-timers" in sys.argv[1:]:
        return gemm_timers(torch)
    if "--band-strip" in sys.argv[1:]:
        return band_strip(torch, int(sys.argv[sys.argv.index("--band-strip") + 1]))
    paths = [a for a in sys.argv[1:] if not a.startswith("-")] or list(PATHS)
    unknown = set(paths) - set(PATHS)
    if unknown:
        print(f"port_profile: unknown paths {sorted(unknown)}; choose from {PATHS}",
              file=sys.stderr)
        return 2
    import chip_smoke
    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.inference import EdgeInference
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"device": torch.cuda.get_device_name(0)}

    cfg = CFG(dropout=0.0)
    dec = chip_smoke.seeded_decoder(torch, cfg, chip_smoke.SEED).cuda()
    engine = EdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps), dec,
                           backend="fused")
    rng = np.random.RandomState(1000 + chip_smoke.SEED)
    sem = torch.from_numpy(rng.randint(0, 2304, (1, 250))).cuda()
    x_T = torch.from_numpy(rng.randn(1, 500, cfg.n_mels).astype(np.float32)).cuda()
    if "flagship" in paths:
        out["flagship_fused"] = profile_calls(
            torch, lambda: engine.generate_mel(sem, num_steps=4, x_T=x_T), calls=5)
        report("flagship_fused", out["flagship_fused"])

    if "longform" in paths:
        with open(os.path.join(ROOT, "configs", "longform.json")) as f:
            lcfg = CFG.from_json(f.read())
        ldec = chip_smoke.seeded_decoder(torch, lcfg, chip_smoke.SEED).cuda()
        lengine = EdgeInference(lcfg, DiffusionSchedule.create(lcfg.diff_steps), ldec,
                                prediction="v", sampler="dpmpp")
        rng = np.random.RandomState(2000 + chip_smoke.SEED)
        lsem = torch.from_numpy(rng.randint(0, 2304, (1, 2000))).cuda()
        lx = torch.from_numpy(rng.randn(1, 4000, lcfg.n_mels).astype(np.float32)).cuda()
        out["longform_eager"] = profile_calls(
            torch, lambda: lengine.generate_mel(lsem, num_steps=4, x_T=lx), calls=3)
        report("longform_eager", out["longform_eager"])

    if "audio" in paths:
        encoder = chip_smoke.seeded_encoder(torch, cfg, chip_smoke.SEED).cuda()
        aengine = EdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps), dec,
                                backend="fused", encoder=encoder)
        rng = np.random.RandomState(3000 + chip_smoke.SEED)
        wav = torch.from_numpy((0.2 * rng.randn(1, 80000)).astype(np.float32)).cuda()
        out["audio_fused"] = profile_calls(
            torch, lambda: aengine.generate_from_audio(wav, num_steps=4), calls=5)
        report("audio_fused", out["audio_fused"])
        from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff

        w = aengine.frontend_weights
        with torch.no_grad():
            feats = ff.conv_frontend(wav, w)
            h = encoder.hubert.feature_projection(feats)
            tokens = ff.fast_encode(encoder, wav, w)
            fold = ff.groupnorm_fold(wav, w["w0"], w["gamma"], w["beta"])
            frontend = {
                "frontend kernels (the fold given)": lambda: ff.conv_frontend(wav, w, fold=fold),
                "groupnorm_fold": lambda: ff.groupnorm_fold(wav, w["w0"], w["gamma"], w["beta"]),
            }
            out["audio_frontend_graph_ms"] = {k: chip_smoke.graph_ms(torch, fn)
                                              for k, fn in frontend.items()}
            stages = {
                "frontend call (groupnorm_fold + kernels)": lambda: ff.conv_frontend(wav, w),
                **frontend,
                "HuBERT positional conv (cuDNN, groups 16)":
                    lambda: encoder.hubert.encoder.pos_conv_embed(h),
                "HuBERT to layer 9 from the conv features":
                    lambda: encoder.extract_hubert(wav, conv_feats=feats),
                "fast_encode (all of the encode)": lambda: ff.fast_encode(encoder, wav, w),
                "generate_mel (4-step fused DDIM)":
                    lambda: aengine.generate_mel(tokens, num_steps=4),
            }
            out["audio_stage_ms"] = {k: chip_smoke.timed_ms(torch, fn, iters=10)
                                     for k, fn in stages.items()}
        for k, ms in out["audio_stage_ms"].items():
            print(f"[audio_stages] {ms:.4f} ms  {k}")
        for k, ms in out["audio_frontend_graph_ms"].items():
            print(f"[audio_stages] {ms:.5f} ms device time by CUDA-graph replay  {k}")

    if "ddpm" in paths:
        from edge_diffusion_tts_tpu_torch.ops.fused_denoise import FusedEdgeInference

        dengine = FusedEdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps), dec)
        out["ddpm_1000"] = profile_calls(
            torch, lambda: dengine.sample_ddpm(sem, generator=torch.Generator(device="cuda")
                                               .manual_seed(chip_smoke.SEED)), calls=1)
        report("ddpm_1000", out["ddpm_1000"])

    if "stream" in paths:
        from edge_diffusion_tts_tpu_torch.pipeline import LongFormPipeline

        encoder = chip_smoke.seeded_encoder(torch, cfg, chip_smoke.SEED).cuda()
        pipe = LongFormPipeline(cfg, DiffusionSchedule.create(cfg.diff_steps), dec, encoder,
                                prep_buckets=[8 * cfg.sample_rate])
        T, S = pipe.chunk_frames, pipe.chunk_samples // pipe.sem_stride
        rng = np.random.RandomState(9300 + chip_smoke.SEED)
        for rows in (1, 4):
            z = rng.randn(rows, S, cfg.semantic_dim).astype(np.float32)
            known = rng.randn(rows, T, cfg.n_mels).astype(np.float32)
            have, seeds = np.ones(rows, bool), np.arange(rows)
            out[f"stream_tick_{rows}_rows"] = profile_calls(
                torch, lambda: pipe.refine_chunk_batch_seeds(
                    seeds, z, known, have, strength=0.6, steps=50, cfg_scale=2.0).cpu(), calls=3)
            report(f"stream_tick_{rows}_rows", out[f"stream_tick_{rows}_rows"])
        wav = chip_smoke.synthetic_wav(6.0, 9200 + chip_smoke.SEED)
        out["stream_prep_8s_bucket"] = profile_calls(
            torch, lambda: pipe.stream_prep(wav, seed=2), calls=3)
        report("stream_prep_8s_bucket", out["stream_prep_8s_bucket"])
        split = out["stream_prep_async_split"] = profile_prep_split(torch, pipe, wav)
        for part in ("dispatch", "realize"):
            r = split[part]
            print(f"[stream_prep_async] {part}: wall {r['wall_ms_per_call']:.4f} ms/call, "
                  f"device busy inside it {r['device_ms_per_call']:.4f} ms/call, busy share "
                  f"{r['busy_share']:.3f}")
        print(f"[stream_prep_async] the prep's device busy in all "
              f"{split['device_ms_per_call']:.4f} ms/call")

    if "burst" in paths:
        out["burst"] = profile_burst(torch, cfg, dec)
        for seed, r in out["burst"].items():
            if isinstance(seed, int):
                print(f"[burst] dispatch of stream {seed}{' (idle server)' * (seed == 19)}: "
                      f"wall {r['wall_ms']:.4f} ms, inside its {r['ops']} torch ops "
                      f"{r['in_ops_ms']:.4f} ms, the rest {r['rest_ms']:.4f} ms")

    if "train" in paths:
        out.update(profile_train(torch))

    if "cli" in paths:
        from edge_diffusion_tts_tpu_torch import demo
        from edge_diffusion_tts_tpu_torch.weights import save_checkpoint

        base = os.path.join(ROOT, "build", "port_profile_cli")
        encoder = chip_smoke.seeded_encoder(torch, cfg, chip_smoke.SEED)
        save_checkpoint(os.path.join(base, "ckpt"), cfg, dec, encoder)
        wav = chip_smoke._write_wav16(os.path.join(base, "ref_5s.wav"),
                                      chip_smoke.synthetic_wav(5.0, 12000 + chip_smoke.SEED))
        out["cli_generate"] = profile_calls(torch, lambda: demo.generate_sample(
            os.path.join(base, "ckpt"), wav_path=wav, num_steps=4,
            out_path=os.path.join(base, "generated.wav")), calls=3)
        report("cli_generate", out["cli_generate"])

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "port_profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
