#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (edge_diffusion_tts_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, each asserting:

1. the card (nvidia-smi name and power limit) and the build of every CUDA
   kernel from csrc/ (one nvcc per source, in parallel), with its time;
2. the long-form banded-attention kernel (csrc/band_attention.cu) against
   its plain version at [1,4,500,40], [1,4,4000,40] and [2,4,4000,40],
   window 64, atol 2e-5, and at T=4000 on strided views of a [B, T, 3, H, d]
   buffer with the output in [B, T, H, d] memory (the attention layer's
   call); per shape its plan (rows, threads, blocks, waves), device
   time by CUDA-graph replay, the eager CUDA-event mean, the plain version's time, band-masked
   ``scaled_dot_product_attention``'s device time (a yardstick only), the
   bound and TFLOP/s; at T=4000 the float64 witness (kernel and float32
   plain version against the plain version in float64); then the kernel
   against band-masked SDPA at T = 500 to 4000, [1,4,T,40] (the crossover);
3. the fused DDIM kernel against its plain version at the flagship shape
   (hidden 160, 4 layers, 4 heads of 40, window 64; B=1, S=250, T=500,
   4 steps), eps and v prediction (tolerances below); the kernel launches
   per decoder step (asserted: 2 + 8 * layers + 1, 35 at 4 layers); and each
   GEMM of the step alone (``decoder_gemm``) at its flagship shape, held to
   ``decoder_gemm_plain`` (atol 1e-5, rtol 1e-5) and timed in the host's
   tile, with its blocks per launch, beside ``torch.nn.functional.linear``
   at the same shape with TF32 off (a yardstick only, never called by the port),
   each as device time: calls captured in a CUDA graph and replayed between
   CUDA events, since one call from Python costs the host more than the
   kernel costs the card;
4. the main path: ``EdgeInference(backend="fused").generate_mel`` answers
   three requests; outputs finite, one fused launch per request;
5. the long-form shape (configs/longform.json, S=2000 -> T=4000) through
   ``backend="eager"``, 4 steps: one banded launch per layer per step, and
   the same output as with the banded route forced to its plain version
   (atol 1e-4), with the call's time on each route;
6. the conv-frontend kernels against their plain version at the hubert-base
   conv specs on wav [1, 80000] (5 s) and [4, 32000], atol 2e-4 rtol 1e-3
   (the JAX fused kernel's bar), and two calls bit-equal; device time by
   CUDA-graph replay of the kernels alone (``groupnorm_fold`` given), of the
   whole ``conv_frontend`` call and of ``groupnorm_fold`` alone, beside the
   plain version's; then each layer alone (``conv_frontend_layer``, the same
   bar) with its plan (tile, split-K factor, blocks, waves), device µs,
   TFLOP/s, bound, ``F.conv1d`` at the same shape and ``torch.matmul`` at
   its GEMM shape (im2col not built), TF32 off (yardsticks the port never
   calls), and, for a layer the plan keeps to one wave, the split factors
   that would give >= one block per SM and twice the plan's;
7. the audio path: ``EdgeInference(backend="fused", encoder=...)`` at full
   HuBERT-base width answers three ``generate_from_audio`` requests (5 s at
   B=1, the same at temperature 0.7, 2 s at B=2), each one frontend and one
   fused-DDIM launch; the kernel route's layer-9 features are held to the
   module route's to atol 1e-3 and its FSQ tokens agree on >= 99% (an
   exact-GroupNorm vs analytical-GroupNorm difference can flip a token that
   sits on a rounding edge);
8. DDPM: the fused DDPM kernel against its plain version over the 50-step
   schedule at the flagship shape, injected and Philox noise (tolerance
   below), with the plain version on the CPU beside the plain version on the
   card as a witness of that tolerance; then
   ``FusedEdgeInference.sample_ddpm`` over the full 1000-step schedule at
   B=1, S=250: one launch per call, finite, the same output for the same
   generator seed and another for another seed; and the 1000-step kernel
   against its plain version (Philox noise, same key), held to the same rule,
   with both printed against the plain version in float64 (weights, inputs
   and coefficients cast; the same Philox draws) as a witness of how far
   each float32 route is from the exact trajectory;
9. serving: ``serving.run_server`` from a port checkpoint (build/
   serve_checkpoint: the flagship decoder and the phase-7 encoder) on
   127.0.0.1, buckets (128, 256), ``max_batch`` 8, long-form with 2
   streams and the default prep buckets (8/16/32/64 s).  16 concurrent
   ``request_tts`` of 60-250 tokens (8 binary, 8 JSON): shapes [2 len, 80],
   finite, fewer than 16 batches; latency p50/p95, requests per second,
   mean occupancy.  Two concurrent ``request_longform`` streams of a 10 s
   and a 6 s synthetic wav (the second as audio) at the protocol defaults
   (50 steps, strength 0.6, cfg 2.0): the 10 s stream's mel equals
   ``pipe.generate`` with its seed in log-mel, within the float32 rounding
   that a tick's row count brings (cuBLAS picks its kernels by shape): the
   bar is the chunk count times this run's witness (the stream's first
   chunk refined alone vs beside another row) times the chunks' largest
   std, and at least 1e-5; the audio increments are contiguous and finite;
   time to first increment, ms per scheduler tick by rows, ticks per
   stream, Griffin-Lim ms per increment; the conv-frontend launches of this
   traffic (one per stream, from ``stream_prep``'s encode on its length
   bucket) join the ``kernels`` line.  Then the 6 s stream's prep on its
   8 s bucket against an exact-length prep (z_q 1e-4 at valid latents, zero
   past them; chunk mean and std 1e-5), the kernel route's FSQ indices
   against the module route's (>= 99% equal, as phase 7), ``conv_frontend``
   against its plain version under phase 6's bar on the very wavs the two
   streams' preps gave it ([1, 256000] with wav_len 160000 and [1, 128000]
   with 96000) and at [2, 128000] with wav_len (80000, 128000), and, in
   process, a masked batch of 8 rows at
   temperature 0 against each row alone (1e-4).  The stream prep is
   dispatched on the pipeline's side stream (``stream_prep_async``) and
   fetched at a stream's first tick: b. with the two streams done, a third
   (10 s) ticks and, after its second increment, four 6 s streams are
   requested from four threads at once; each submit's return ms and the
   handler thread's CPU ms inside it (the same for its dispatch), the
   pinned host blocks and device segments the burst made, each new
   stream's time to first increment, and the ticking stream's tick ms
   inside the window of the four preps (first submit to last fetch) and
   outside it are printed; a synchronizing CUDA call on a submitting thread
   fails the phase (``set_sync_debug_mode("warn")`` over the burst, the
   warnings read per thread); each new stream's mel is held to its offline
   ``pipe.generate`` under the row-count witness bar; these five streams'
   frontend launches count with the traffic's, equal to the encodes
   recorded from every thread.  a. on the 6 s wav (8 s bucket),
   ``stream_prep`` against ``stream_prep_async(...)()`` and the same work
   run inline on the default stream, bit for bit, with the median of 5 of
   ``stream_prep``'s ms, the dispatch's ms and the ms to fetch a finished
   prep; and one dispatch under ``torch.cuda.set_sync_debug_mode("error")``;
10. training: a synthetic corpus in the LJSpeech layout (build/phase10: 84
   utterances of 2.5-4 s at 22,050 Hz int16, so the collate resamples)
   trained through ``training.train()`` at configs/flagship.json (hidden 160,
   4 layers, the depthwise pre-net, FSQ, dropout 0.2, cfg dropout 0.1,
   batch 4 x 2 s, grad_accumulation 8, 1000 steps halved to 4) with the full
   HuBERT-base frozen on the frontend kernel, epochs cut to 2 diffusion, 1
   per halving and 1 consistency.  Asserted: every logged loss finite; the
   HuBERT bit-equal before and after; the decoder unchanged through data step
   8 (the first update runs at learning rate 0) and moved by step 16; no
   teacher in phase 1, and in the first halving the teacher bit-equal on
   every accumulation-only step and moved on every update step; one frontend
   launch per data step and per validation batch; the phase tags.  Then
   ``resume="auto"`` from the periodic checkpoint skips the phases its meta
   records as done; ``precompute_hubert_features`` (the kernel route) writes
   every utterance's features and ``train_v2`` runs a diffusion epoch on
   them (no frontend launch; the flagship without the pre-net, which the
   fused kernel does not implement); one diffusion loss and its gradients
   at flagship width, dropout 0, on the card against the CPU (loss rtol
   1e-4, every gradient cosine >= 0.99999); the first run's final model
   loaded with ``weights.load_checkpoint`` refused by the fused backend
   (pre-net) and served by the eager one, the precomputed run's served by
   ``backend="fused"`` (one launch; both finite).  Printed: ms per data step
   per phase (the mean of the steady steps' host-clock intervals) and
   utterances/s, the precomputed path apart, peak
   ``torch.cuda.max_memory_allocated``, wall times.  Its frontend launches
   and its fused launch join the ``kernels`` line;
11. parallel (``parallel/``): two ranks on cuda:0 over gloo (the one-card
   machine's choice: NCCL refuses two ranks on one device), spawned by
   ``parallel.launch.spawn`` under a 900 s deadline; each rank returns its
   results and its kernel launch counts (every count set to 0 just before
   its run, read just after) through a file the parent reads, and any rank's
   failure or the deadline fails the phase.  Full width: the flagship
   decoder, the full HuBERT-base, random weights from SEED, synthetic audio.
   a. one diffusion, one progressive (a teacher of its own seed) and one
   consistency data-parallel step at configs/flagship.json (dropout 0, one
   update per step, AdamW at a constant 1e-3), batch 4 x 2 s, 2 rows per
   rank, against the single-process step on the whole batch: loss rel 1e-5,
   every gradient tensor at cosine >= 0.99999 (two summation orders: the
   bars of the JAX comparisons on the CPU), the replicas' parameters
   bit-equal; one frontend launch per rank per step; ms per data step
   beside the single device's.  b. ``train()`` with ``mesh_shape [2, 1]`` on
   phase 10's corpus, one epoch per phase, the halvings cut to 1000 -> 500
   -> 250: rank 0 alone writes checkpoints, the parameters are bit-equal
   across the ranks after every optimizer update.  c. sequence-parallel
   long-form at T = 8000 (S = 4000; configs/longform.json with its
   positional tables raised to 8192/4096, printed), 4 DDIM steps and 1,
   eps, each rank's window Te = 4512 >= 3000 so the band kernel runs in all
   4 layers x 4 steps, against the single-device call: the max error at
   1e-4 or 2 times the one-ulp witness, whichever is larger (how far the
   single call moves when its input moves by one ulp: the first step
   divides by sqrt(alpha_bar_999) = 1.56e-5, and the seeded decoder carries
   a difference on from step to step), and at most 0.5% of the elements
   over 1e-4 (``PAR_WITNESS`` and ``PAR_SEQ_FRAC`` give the readings they
   were set from).
   d. the tensor-parallel encode of a 5 s wav on a (1, 2) mesh (6 heads
   and FFN 1536 per rank, the frontend kernel replicated) against
   ``fast_encode``: layer-9 features 1e-3, tokens >= 99% equal (phase 7's
   bars).  e. ``make_dp_generate`` in this process over [cuda:0, cuda:0],
   8 token rows of 250 at the flagship shape, unmasked (one fused launch
   per share) and masked, against the unsharded call: phase 3's rule for
   v prediction, 0.05 on all elements and 2e-4 on 99.9%.  f. one pipeline-parallel
   diffusion step, 2 stages x 2 microbatches, against the single-process
   step: a's bars and ``grad_norm`` rel 1e-5.  Printed: every check's
   error beside its bar, ms per DP step, per sequence-parallel call, per TP
   encode and per PP step with the single device's beside them, each
   labelled "two ranks on one card over gloo: no scaling claim".  Its
   launches join the ``kernels`` line;
12. the command line (``cli.main`` in this process, each subcommand's wall
   time printed; build/phase12), from phase 9's checkpoint (the flagship
   decoder, phase 7's full HuBERT-base) and phase 10's corpus; every command
   runs on the card by default (no ``--device``).  a. ``generate --wav
   <5 s> --steps 4``: a 16-bit wav of (2S - 1) hops, not silent, one
   frontend launch, the mel it vocodes equal to ``generate_from_audio``
   with the same generator seed (1e-5); ``--oracle`` (the input's length,
   no launch) and ``--post-filter`` too; ``--sampler dpmpp`` on an eps copy
   of the checkpoint exits with the JAX package's message.  b. ``export``
   (``.pt2``): loaded on the card, against the eager decoder at (1,500,250)
   and (2,200,100), 1e-5.  c. ``export --format weight-int8``: the report;
   the fused kernel on the dequantized weights against the eager decoder on
   them under phase 3's rule; the 4-step mel L1 of int8 against float32
   printed beside the JAX package's stated 1e-2 budget (random weights, no
   quality claim; asserted finite only).  d. ``bench``: its JSON line
   parsed, one fused launch per fused call.  e. ``longform <10 s>
   --stream``: a RIFF file whose size grows with every increment and whose
   header fields hold at the end, 160,000 samples, the first-audio line;
   one frontend launch.  f. ``precompute`` phase 10's corpus ``--limit 4``:
   one frontend launch per utterance, finite [frames, 768] features.  g.
   ``migrate`` of a reference-layout (v1, FSQ) ``.pt`` made of the
   checkpoint's weights: the decoder, projection and FSQ bit-equal, no
   HuBERT weights written, ``use_depthwise`` turned off, and ``generate``
   on it exits naming ``--hubert-id``.  h. ``python -m
   edge_diffusion_tts_tpu_torch.cli serve`` as a subprocess (bucket 128,
   started first, stopped at the end of the phase): one ``request_tts``
   answered.  i. ``train --config build/phase12/cfg.json --export``:
   configs/flagship.json on phase 10's corpus cut as phase 11b (one epoch
   per phase, halvings 1000 -> 500 -> 250: 80 data steps); the run's
   ``edge_model.pt2`` against its final decoder, 1e-5.  Its frontend and
   fused launches join the ``kernels`` line.

Why the DDIM tolerances are stated as they are: the DDIM grid starts at
t=999 where sqrt(alpha_bar) = 1.56e-5, and the update divides by it.  With
eps prediction every first-step x0 whose raw value leaves [-3, 3] is
clipped, so the comparison is well conditioned only if no element stays
inside; the script checks that precondition on its inputs and then holds the
kernel to 2e-4 everywhere (the summation order differs from the plain
version's).  With v prediction the reference forms eps = sqrt(1-ab)*x +
sqrt(ab)*v and then x0 = (x - sqrt(1-ab)*eps)/sqrt(ab): a one-ulp difference
in eps moves x0 by ulp(x)/1.56e-5 (about 0.03), so a handful of elements
differ by such a quantum whenever the model outputs differ in the last bit.
v is held to 2e-4 on at least 99.9% of elements and to 0.05 on all.  The
long-form phase samples with DPM-Solver++ (v), which starts at t=950 and
reads x0 = sqrt(ab)*x - sqrt(1-ab)*v, well conditioned, and is held to 1e-4.

Why the DDPM tolerance is stated as it is: the unclamped DDPM recurrence
over an untrained decoder grows to O(1e4) in 50 steps (its first step
multiplies x by 1/sqrt(alpha_999) = 100), so float32 rounding differences
between two summation orders reach ~1e-2 in absolute terms.  Where a
trajectory crosses zero the element is small and its own relative error is
large, though the error is the trajectory's, not the element's.  So every
element is held to 1e-4 of the largest |x| (plus 1e-3), and at least 99.9%
of elements to rtol 1e-4, atol 1e-3 elementwise (the JAX DDPM test's bar).
Each comparison prints the largest |x| among the elements over the
elementwise bar, and phase 8 prints how far two plain runs (card and CPU)
differ by the same measures.

The encoder's weights come from a torch.Generator seeded with SEED (no
pretrained HuBERT is in the repository): no quality claim, only parity.

Prints one ``{"kernels": [...]}`` line, the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device, without the port package beside it, or on any
failed check.  The ptxas report of the build goes to build/chip_smoke_build.log.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_PEAK_FLOPS = 67e12  # H100 SXM float32 without tensor cores (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
SEED = 7  # first-step x0 fully clipped for these weights and inputs (see above)
DEVICE = "cuda"  # the phases' device; a CPU rehearsal of the script sets "cpu"
BAND_SHAPES = ((1, 500), (1, 4000), (2, 4000))  # phase 2's (B, T) at [B, 4, T, 40], w=64
CROSSOVER_T = (500, 1000, 2000, 3000, 4000)  # phase 2's band kernel vs SDPA, [1, 4, T, 40]


def bound(flops: float, nbytes: float):
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timed_call(torch, fn):
    """``fn()``'s result and the device time of that one call in ms (CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def timed_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(torch, fn, n: int = 50, replays: int = 10) -> float:
    """Device time of one ``fn()`` in ms: ``n`` calls captured in a CUDA
    graph and replayed ``replays`` times between CUDA events, so that the
    host's cost of each call (Python, ctypes, the launch) stays out."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * n)


def band_pairs(T: int, window: int, kv_len: int) -> int:
    i = np.arange(T)
    lo = np.maximum(0, i - window)
    hi = np.minimum(min(T, kv_len) - 1, i + window)
    return int(np.maximum(0, hi - lo + 1).sum())


def seeded_decoder(torch, cfg, seed: int):
    """A decoder whose every weight comes from numpy RandomState(seed): torch's
    default-init ranges, then 0.02*N(0,1) on every parameter (so the
    zero-init out head and AdaLN projections are nontrivial)."""
    from torch import nn

    from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder

    dec = EdgeDiffusionDecoder(cfg)
    rng = np.random.RandomState(seed)

    def put(p, a):
        p.copy_(torch.from_numpy(np.asarray(a, np.float32)))

    with torch.no_grad():
        for m in dec.modules():
            if isinstance(m, nn.Linear):
                b = 1.0 / np.sqrt(m.in_features)
                put(m.weight, rng.uniform(-b, b, m.weight.shape))
                if m.bias is not None:
                    put(m.bias, rng.uniform(-b, b, m.bias.shape))
            elif isinstance(m, nn.Embedding):
                put(m.weight, rng.randn(*m.weight.shape))
        for p in dec.parameters():
            put(p, p.numpy() + 0.02 * rng.randn(*p.shape))
    return dec.eval()


def phase_build():
    from edge_diffusion_tts_tpu_torch import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke_build.log"), "w") as f:
        for name, info in built.items():
            f.write(f"=== {name} ({info['seconds']:.1f} s)\n{info['log']}\n")
    print(f"[build] {sorted(built) or 'cached'} in {seconds:.2f} s "
          f"-> {_build.build_dir()}")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line and " 0 bytes spill" not in line:
                print(f"[build] {name}: {line.strip()}")
    return seconds


def band_inputs(torch, B, H, T, d, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, H, T, d).astype(np.float32)).to(DEVICE)
            for _ in range(3)]


def phase_banded(torch):
    """The band kernel against its plain version at [1,4,500,40],
    [1,4,4000,40] and [2,4,4000,40], window 64 (atol 2e-5), and at T=4000
    on strided views of a [B, T, 3, H, d] buffer written in [B, T, H, d];
    per shape its plan, device time by graph replay, the eager CUDA-event
    mean, the plain version's time,
    band-masked SDPA's (a yardstick), the bound and TFLOP/s; at T=4000 the
    float64 witness; then the crossover against SDPA from T=500 to 4000."""
    import torch.nn.functional as F

    from edge_diffusion_tts_tpu_torch.layers.attention import local_attention_mask
    from edge_diffusion_tts_tpu_torch.ops import window_attention as wa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    H, d, w = 4, 40, 64
    results = {}
    for B, T in BAND_SHAPES:
        q, k, v = band_inputs(torch, B, H, T, d, seed=T + B)
        got = wa.banded_attention(q, k, v, w)
        torch.cuda.synchronize()
        want = wa.banded_attention_plain(q, k, v, w)
        err = (got - want).abs().max().item()
        assert err <= 2e-5, f"banded [{B},{H},{T},{d}]: max err {err} > 2e-5"
        notes = ""
        if T == BAND_SHAPES[-1][1]:
            # Views of the qkv projection's output, o in [B, T, H, d]: the
            # layer's call.
            qkv = torch.stack([q, k, v]).permute(1, 3, 0, 2, 4).contiguous()  # [B, T, 3, H, d]
            qs, ks, vs = qkv.permute(2, 0, 3, 1, 4)
            strided = wa.banded_attention(qs, ks, vs, w, out_layout="bthd")
            torch.cuda.synchronize()
            s_err = (strided - want).abs().max().item()
            assert strided.transpose(1, 2).is_contiguous() and s_err <= 2e-5, (
                f"banded strided [{B},{H},{T},{d}]: max err {s_err} > 2e-5")
            err = max(err, s_err)
            s_ms = graph_ms(torch, lambda: wa.banded_attention(qs, ks, vs, w, out_layout="bthd"))
            exact = wa.banded_attention_plain(q.double(), k.double(), v.double(), w)
            notes = (f"; strided views -> [B,T,H,d]: max_abs_err={s_err:.3g}, graph_ms="
                     f"{s_ms:.5f}; float64 witness: kernel {(got.double() - exact).abs().max():.3g}"
                     f", float32 plain {(want.double() - exact).abs().max():.3g}")
            del exact
        plan = wa.band_plan(B, H, T, d, w, sms)
        dev = graph_ms(torch, lambda: wa.banded_attention(q, k, v, w))
        ms = timed_ms(torch, lambda: wa.banded_attention(q, k, v, w))
        plain_ms = timed_ms(torch, lambda: wa.banded_attention_plain(q, k, v, w))
        mask = local_attention_mask(T, w, q.device)
        lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        flops = 4 * d * band_pairs(T, w, T) * B * H
        bound_ms, bound_by = bound(flops, 4 * B * H * T * d * 4)
        results[(B, T)] = dict(max_abs_err=err, ms=dev, eager_ms=ms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
        print(f"[banded] [{B},{H},{T},{d}] w={w}: max_abs_err={err:.3g} graph_ms={dev:.5f} "
              f"({flops / dev / 1e9:.2f} TFLOP/s, {bound_ms / dev:.1%} of the bound) "
              f"eager_ms={ms:.5f} plain_ms={plain_ms:.5f} sdpa_graph_ms={lib_ms:.5f} "
              f"bound_ms={bound_ms:.6f} ({bound_by}); plan: rows {plan['rows']}, threads "
              f"{plan['threads']}, blocks {plan['blocks']}, {plan['resident']} per SM, waves "
              f"{plan['waves']:.2f}, smem {plan['smem']} B" + notes)
    # The crossover against band-masked SDPA (ops config pallas_min_seq_len).
    for T in CROSSOVER_T:
        q, k, v = band_inputs(torch, 1, H, T, d, seed=T)
        mask = local_attention_mask(T, w, q.device)
        kern = graph_ms(torch, lambda: wa.banded_attention(q, k, v, w))
        sdpa = graph_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        print(f"[banded] crossover T={T} [1,{H},{T},{d}] w={w}: kernel {kern:.5f} ms, "
              f"band-masked SDPA {sdpa:.5f} ms (device time by graph replay), "
              f"SDPA / kernel {sdpa / kern:.2f}")
    return results


def fused_flops_bytes(B, T, S, M, H, heads, L, F, window, steps, tensors):
    dh = H // heads
    per_row = 4 * M * H + L * (2 * H * 3 * H + 6 * H * H + 4 * H * F + 2 * F * H)
    attn = L * heads * 4 * dh * (band_pairs(T, window, T) + T * S)
    flops = steps * (B * T * per_row + B * attn)
    nbytes = 4 * (sum(t.numel() for t in tensors) + B * T * M)
    return flops, nbytes


def phase_fused(torch, cfg, decoder, schedule):
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd

    dev = torch.device(DEVICE)
    B, S, steps = 1, 250, 4
    T = 2 * S
    rng = np.random.RandomState(1000 + SEED)
    sem_idx = torch.from_numpy(rng.randint(0, 2304, (B, S))).to(dev)
    x_T = torch.from_numpy(rng.randn(B, T, cfg.n_mels).astype(np.float32)).to(dev)
    ts, coef = fd.ddim_coefficients(schedule, steps)
    coef = coef.to(dev)
    loop = fd.prepare_loop_inputs(decoder, sem_idx, T, ts)
    w = fd.pack_decoder_weights(decoder)
    args = (x_T, loop["pos"], loop["mods"], loop["ckv"], coef, w)

    # Precondition of the strict eps check: every first-step x0 is clipped.
    with torch.no_grad():
        eps1 = decoder(x_T, torch.full((B,), ts[0], device=dev), sem_idx=sem_idx,
                       step_idx=torch.zeros(B, dtype=torch.long, device=dev))
        raw = (x_T - coef[0, 1] * eps1) / coef[0, 0]
    unclipped = int((raw.abs() < 3.0).sum())
    assert unclipped == 0, f"{unclipped} first-step x0 unclipped: eps check ill-conditioned"

    out = {}
    for prediction in ("eps", "v"):
        kw = dict(heads=cfg.heads, window=cfg.attn_window_size, prediction=prediction)
        got = fd.fused_ddim(*args, **kw)
        torch.cuda.synchronize()
        want = fd.fused_ddim_plain(*args, **kw)
        diff = (got - want).abs()
        err = diff.max().item()
        frac_over = (diff > 2e-4).float().mean().item()
        assert torch.isfinite(got).all(), f"fused {prediction}: non-finite output"
        if prediction == "eps":
            assert err <= 2e-4, f"fused eps: max err {err} > 2e-4"
        else:
            assert frac_over <= 1e-3 and err <= 0.05, (
                f"fused v: {frac_over:.2e} of elements over 2e-4, max err {err}")
        ms = timed_ms(torch, lambda: fd.fused_ddim(*args, **kw), iters=10)
        plain_ms = timed_ms(torch, lambda: fd.fused_ddim_plain(*args, **kw), iters=5)
        out[prediction] = dict(max_abs_err=err, frac_over_2e4=frac_over, ms=ms,
                               plain_ms=plain_ms, x0=got)
        print(f"[fused] {prediction}: max_abs_err={err:.3g} frac>2e-4={frac_over:.2e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f}")
    flops, nbytes = fused_flops_bytes(
        B, T, S, cfg.n_mels, cfg.hidden, cfg.heads, cfg.layers, cfg.hidden * cfg.ffn_mult,
        cfg.attn_window_size, len(ts),
        [x_T, loop["pos"], loop["mods"], loop["ckv"], coef, *w.values()])
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[fused] {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB per call: "
          f"bound_ms={bound_ms:.5f} ({bound_by})")

    before = fd.kernel_launches()
    fd.fused_ddim(*args, heads=cfg.heads, window=cfg.attn_window_size)
    torch.cuda.synchronize()
    per_step = (fd.kernel_launches() - before) / len(ts)
    want_per_step = 2 + 8 * cfg.layers + 1
    print(f"[fused] kernel launches per decoder step (with its update): {per_step:g}")
    assert per_step == want_per_step, f"{per_step} launches per step, not {want_per_step}"
    step_gemms(torch, cfg, B * T, loop, w)
    out.update(bound_ms=bound_ms, bound_by=bound_by, x_T=x_T, sem_idx=sem_idx)
    return out


def step_gemms(torch, cfg, rows: int, loop, w):
    """Each GEMM of the decoder step alone at ``rows`` rows, layer 0's
    weights: held to its plain version, and its device time (``graph_ms``)
    in the host's tile beside ``F.linear``'s at the same shape."""
    import torch.nn.functional as F

    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd

    H, M, FF = cfg.hidden, cfg.n_mels, cfg.hidden * cfg.ffn_mult
    rng = np.random.RandomState(5000 + SEED)

    def act(n):
        return torch.from_numpy(rng.randn(rows, n).astype(np.float32)).to(DEVICE)

    x, h, ao, f = act(M), act(H), act(H), act(FF)
    m0 = loop["mods"][0, 0]
    shapes = [
        ("in_proj (+bias +pos)", x, w["in_w"], dict(bias=w["in_b"], pos=loop["pos"])),
        ("qkv (AdaLN-RMS prologue)", h, w["qkv_w"][0], dict(norm="rms", scale=m0[0],
                                                            shift=m0[1])),
        ("attn proj (+bias +residual)", ao, w["proj_w"][0], dict(bias=w["proj_b"][0],
                                                                residual=h)),
        ("cross q (RMS x n2w prologue)", h, w["cq_w"][0], dict(norm="rms",
                                                              scale=w["n2w"][0])),
        ("cross out (+residual)", ao, w["co_w"][0], dict(residual=h)),
        ("fc1 (AdaLN-RMS prologue, SwiGLU)", h, w["fc1_w"][0], dict(
            bias=w["fc1_b"][0], norm="rms", scale=m0[2], shift=m0[3], swiglu=True)),
        ("fc2 (+bias +residual)", f, w["fc2_w"][0], dict(bias=w["fc2_b"][0], residual=h)),
        ("out_proj (LayerNorm prologue, +bias)", h, w["out_w"], dict(
            bias=w["out_b"], norm="ln", scale=w["fn_s"], shift=w["fn_b"])),
    ]
    for name, a, W, kw in shapes:
        got = fd.decoder_gemm(a, W, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, fd.decoder_gemm_plain(a, W, **kw), atol=1e-5, rtol=1e-5)
        n, K = got.shape[-1], a.shape[1]
        bm, bn = fd.decoder_gemm_tile(rows, n)
        us = 1e3 * graph_ms(torch, lambda: fd.decoder_gemm(a, W, **kw))
        lin_us = 1e3 * graph_ms(torch, lambda: F.linear(a, W))
        bound_us = 1e3 * bound(2 * rows * W.shape[0] * K, 0)[0]
        print(f"[gemm] {name}: M={rows} N={n} K={K}: {us:.3f} us, tile {bm}x{bn}, "
              f"{-(-rows // bm) * -(-n // bn)} blocks; F.linear {lin_us:.3f} us; "
              f"ops bound {bound_us:.3f} us")


def phase_main_path(torch, cfg, decoder, schedule, fused):
    from edge_diffusion_tts_tpu_torch.inference import EdgeInference
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
    from edge_diffusion_tts_tpu_torch.ops import window_attention as wa

    engine = EdgeInference(cfg, schedule, decoder, backend="fused", device=DEVICE)
    engine.generate_mel(fused["sem_idx"], num_steps=4, x_T=fused["x_T"])  # warm-up
    torch.cuda.synchronize()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    requests = [
        dict(sem_idx=fused["sem_idx"], x_T=fused["x_T"]),
        dict(sem_idx=torch.randint(0, 2304, (2, 128), device=DEVICE, generator=gen),
             generator=gen),
        dict(sem_idx=fused["sem_idx"], temperature=0.7, generator=gen),
    ]
    fd.fused_ddim.launches = wa.banded_attention.launches = 0
    times, outs = [], []
    for req in requests:
        t0 = time.perf_counter()
        mel = engine.generate_mel(num_steps=4, **req)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(mel)
    launches = fd.fused_ddim.launches
    assert launches == len(requests), f"fused launches {launches} != {len(requests)}"
    for req, mel in zip(requests, outs):
        B, S = req["sem_idx"].shape
        assert mel.shape == (B, 2 * S, cfg.n_mels), mel.shape
        assert torch.isfinite(mel).all(), "non-finite mel"
    # The first request repeats phase 3's eps inputs through the entry point.
    err = (outs[0] - fused["eps"]["x0"]).abs().max().item()
    assert err <= 1e-5, f"entry point differs from the kernel by {err}"
    print(f"[main] fused generate_mel per-call ms: "
          + ", ".join(f"{t:.3f}" for t in times) + f"; fused launches={launches}")
    return launches, times


def phase_longform(torch):
    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.inference import EdgeInference
    from edge_diffusion_tts_tpu_torch.ops import window_attention as wa
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

    with open(os.path.join(ROOT, "configs", "longform.json")) as f:
        cfg = CFG.from_json(f.read())
    decoder = seeded_decoder(torch, cfg, SEED).to(DEVICE)
    schedule = DiffusionSchedule.create(cfg.diff_steps)
    engine = EdgeInference(cfg, schedule, decoder, prediction="v", sampler="dpmpp",
                           device=DEVICE)
    rng = np.random.RandomState(2000 + SEED)
    S, steps = 2000, cfg.inference_steps
    sem_idx = torch.from_numpy(rng.randint(0, 2304, (1, S))).to(DEVICE)
    x_T = torch.from_numpy(rng.randn(1, 2 * S, cfg.n_mels).astype(np.float32)).to(DEVICE)

    engine.generate_mel(sem_idx, num_steps=steps, x_T=x_T)  # warm-up
    torch.cuda.synchronize()
    wa.banded_attention.launches = 0
    t0 = time.perf_counter()
    mel = engine.generate_mel(sem_idx, num_steps=steps, x_T=x_T)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = wa.banded_attention.launches
    assert launches == cfg.layers * steps, f"banded launches {launches}"
    assert mel.shape == (1, 2 * S, cfg.n_mels) and torch.isfinite(mel).all()

    kernel_route = wa.banded_attention

    def plain_route(q, k, v, window, seq_len=None, **layout):
        return wa.banded_attention_plain(q, k, v, window, seq_len)

    wa.banded_attention = plain_route
    try:
        t0 = time.perf_counter()
        plain = engine.generate_mel(sem_idx, num_steps=steps, x_T=x_T)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        wa.banded_attention = kernel_route
    err = (mel - plain).abs().max().item()
    assert err <= 1e-4, f"long-form: max err {err} > 1e-4"
    print(f"[longform] T={2 * S} eager dpmpp {steps} steps: {ms:.3f} ms "
          f"(banded route plain: {plain_ms:.3f} ms), banded launches={launches}, "
          f"max_abs_err={err:.3g}")
    return launches


def seeded_encoder(torch, cfg, seed: int, hubert_cfg=None):
    """A SemanticEncoder (hubert-base unless ``hubert_cfg``) whose weights come
    from a CPU torch.Generator(seed): each weight matrix N(0, g/fan_in), g = 2
    for the convs (keeps the GELU stack's scale) and 1 elsewhere; every vector
    (bias, norm affine) its default + 0.02 N(0, 1)."""
    from edge_diffusion_tts_tpu_torch.models import HubertConfig, SemanticEncoder

    enc = SemanticEncoder(cfg, hubert_cfg or HubertConfig())
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if p.dim() >= 2:
                g = 2.0 if "conv" in name else 1.0
                p.copy_(torch.randn(p.shape, generator=gen) * math.sqrt(g / p[0].numel()))
            else:
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return enc.eval()


def frontend_flops(B: int, samples: int) -> int:
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff

    frames = ff.frame_counts(samples)
    c_in = [1] + [512] * 6
    return sum(2 * B * f * 512 * k * c for f, k, c in zip(frames, ff.BASE_KERNELS, c_in))


def frontend_layers(torch, wav, w, fold):
    """Each layer alone (``conv_frontend_layer``) on the plain chain's input
    for it: held to ``conv_frontend_layer_plain`` (atol 2e-4, rtol 1e-3),
    device µs by CUDA-graph replay, TFLOP/s, its bound, and ``F.conv1d`` at
    the same shape (channels-first, TF32 off: a yardstick the port never
    calls).  Returns the per-layer rows."""
    import torch.nn.functional as F

    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff

    B, n = wav.shape
    plan = ff.frontend_plan(B, n, sms=torch.cuda.get_device_properties(0).multi_processor_count)
    x, rows = wav, []
    for p in plan:
        i = p["layer"]
        extra = fold if i == 0 else ()
        got = ff.conv_frontend_layer(x, i, w, *extra)
        torch.cuda.synchronize()
        want = ff.conv_frontend_layer_plain(x, i, w, *extra)
        err = (got - want).abs().max().item()
        excess = ((got - want).abs() - 1e-3 * want.abs()).max().item()
        assert torch.isfinite(got).all() and excess <= 2e-4, (
            f"frontend layer {i} [{B},{n}]: max err {err}, over the bar by {excess}")
        us = 1e3 * graph_ms(torch, lambda: ff.conv_frontend_layer(x, i, w, *extra))
        W = ff.layer_weight(w, i)
        C = W.shape[0]
        if i == 0:
            xc, wc, s = x[:, None, :], W[:, None, :], ff.BASE_STRIDES[0]
        else:
            xc = x.transpose(1, 2).contiguous()
            wc, s = W.reshape(C, -1, C).permute(0, 2, 1).contiguous(), ff.BASE_STRIDES[i]
        conv_us = 1e3 * graph_ms(torch, lambda: F.conv1d(xc, wc, stride=s))
        flops = 2 * B * p["M"] * p["N"] * p["K"]
        if i > 0:  # cuBLAS float32 (TF32 off) at the layer's GEMM shape, im2col not built
            a = torch.randn(B * p["M"], p["K"], device=x.device)
            b = torch.randn(p["K"], p["N"], device=x.device)
            mm_us = 1e3 * graph_ms(torch, lambda: torch.matmul(a, b))
            notes = f"; torch.matmul {mm_us:.3f} us ({flops / mm_us / 1e6:.2f} TFLOP/s)"
        else:
            notes = ""
        bound_ms, bound_by = bound(flops, 4 * (x.numel() + W.numel() + got.numel()))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        if i > 0 and p["blocks"] < sms:
            # The plan keeps one wave; beside it, the fewest splits that give
            # >= sms blocks and twice the plan's (two waves).
            tiles, chunks = p["blocks"] // p["splits"], p["N"] // ff.CHUNK
            for s2 in sorted({min(-(-sms // tiles), chunks), min(2 * p["splits"], chunks)}):
                alt_us = 1e3 * graph_ms(torch, lambda: ff.conv_frontend_layer(x, i, w, splits=s2))
                notes += f"; splits {s2} ({tiles * s2} blocks) {alt_us:.3f} us"
        rows.append(dict(layer=i, us=us, conv1d_us=conv_us, bound_us=1e3 * bound_ms,
                         blocks=p["blocks"], splits=p["splits"], max_abs_err=err))
        print(f"[frontend] [{B},{n}] conv{i}: M={p['M']} N={p['N']} K={p['K']} tile "
              f"{p['tile'][0]}x{p['tile'][1]} splits {p['splits']}, {p['blocks']} blocks "
              f"({p['blocks'] / sms:.2f} waves): {us:.3f} us, {flops / us / 1e6:.2f} TFLOP/s; "
              f"bound {1e3 * bound_ms:.3f} us ({bound_by}); F.conv1d {conv_us:.3f} us "
              f"({flops / conv_us / 1e6:.2f} TFLOP/s){notes}; max_abs_err={err:.3g}")
        x = want
    return rows


def phase_frontend(torch, encoder):
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff

    w = ff.pack_frontend_weights(encoder.hubert.feature_extractor)
    results = {}
    for B, n in ((1, 80000), (4, 32000)):
        rng = np.random.RandomState(n + B)
        wav = torch.from_numpy((0.2 * rng.randn(B, n)).astype(np.float32)).to(DEVICE)
        got = ff.conv_frontend(wav, w)
        torch.cuda.synchronize()
        want = ff.conv_frontend_plain(wav, w)
        err = (got - want).abs().max().item()
        excess = ((got - want).abs() - 1e-3 * want.abs()).max().item()
        assert torch.isfinite(got).all() and excess <= 2e-4, (
            f"frontend [{B},{n}]: max err {err}, over atol 2e-4 + rtol 1e-3 by {excess}")
        assert torch.equal(got, ff.conv_frontend(wav, w)), f"frontend [{B},{n}]: two calls differ"
        fold = ff.groupnorm_fold(wav, w["w0"], w["gamma"], w["beta"])
        kernels_ms = graph_ms(torch, lambda: ff.conv_frontend(wav, w, fold=fold))
        call_ms = graph_ms(torch, lambda: ff.conv_frontend(wav, w))
        fold_ms = graph_ms(torch, lambda: ff.groupnorm_fold(wav, w["w0"], w["gamma"], w["beta"]))
        plain_ms = timed_ms(torch, lambda: ff.conv_frontend_plain(wav, w), iters=10)
        flops = frontend_flops(B, n)
        nbytes = 4 * (wav.numel() + sum(t.numel() for t in w.values()) + got.numel())
        bound_ms, bound_by = bound(flops, nbytes)
        layers = frontend_layers(torch, wav, w, fold)
        results[(B, n)] = dict(max_abs_err=err, ms=kernels_ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, layers=layers)
        print(f"[frontend] wav [{B},{n}] -> {tuple(got.shape)}: max_abs_err={err:.3g}, two "
              f"calls bit-equal; device ms by CUDA-graph replay: kernels {kernels_ms:.5f} "
              f"(layers alone summed {sum(r['us'] for r in layers) / 1e3:.5f}), whole call "
              f"{call_ms:.5f}, groupnorm_fold {fold_ms:.5f}; plain_ms={plain_ms:.4f}; "
              f"{flops / 1e9:.3f} GFLOP, {flops / kernels_ms / 1e9:.2f} TFLOP/s; "
              f"bound_ms={bound_ms:.5f} ({bound_by})")
    return results


def phase_audio(torch, cfg, decoder, schedule, encoder):
    from edge_diffusion_tts_tpu_torch.inference import EdgeInference
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff

    engine = EdgeInference(cfg, schedule, decoder, backend="fused", device=DEVICE,
                           encoder=encoder)
    rng = np.random.RandomState(3000 + SEED)
    wav5 = torch.from_numpy((0.2 * rng.randn(1, 80000)).astype(np.float32)).to(DEVICE)
    wav2 = torch.from_numpy((0.2 * rng.randn(2, 32000)).astype(np.float32)).to(DEVICE)
    for wav in (wav5, wav2):  # warm-up of each request shape
        engine.generate_from_audio(wav, num_steps=4)
    torch.cuda.synchronize()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    requests = [dict(wav=wav5), dict(wav=wav5, temperature=0.7, generator=gen),
                dict(wav=wav2, generator=gen)]
    ff.conv_frontend.launches = fd.fused_ddim.launches = 0
    times, outs = [], []
    for req in requests:
        t0 = time.perf_counter()
        mel = engine.generate_from_audio(num_steps=4, **req)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(mel)
    launches = ff.conv_frontend.launches
    ddim_launches = fd.fused_ddim.launches
    assert launches == ddim_launches == len(requests), (
        f"frontend launches {launches}, fused_ddim launches {ddim_launches}, "
        f"{len(requests)} requests")
    for req, mel in zip(requests, outs):
        B, n = req["wav"].shape
        assert mel.shape == (B, 2 * ff.frame_counts(n)[-1], cfg.n_mels), mel.shape
        assert torch.isfinite(mel).all(), "non-finite mel"

    # The kernel route against the module route (exact GroupNorm, F.conv1d).
    w = engine.frontend_weights
    agree = []
    with torch.no_grad():
        for wav in (wav5, wav2):
            h_kernel = encoder.extract_hubert(wav, conv_feats=ff.conv_frontend(wav, w))
            h_module = encoder.extract_hubert(wav)
            feat_err = (h_kernel - h_module).abs().max().item()
            tok = (ff.fast_encode(encoder, wav, w) == encoder.encode(wav)).float().mean().item()
            agree.append((feat_err, tok))
            print(f"[audio] wav {tuple(wav.shape)}: layer-9 feature max err {feat_err:.3g}, "
                  f"tokens equal {tok:.4%}")
            assert feat_err <= 1e-3 and tok >= 0.99, (feat_err, tok)

    # Per-call split: encode (fast_encode) and generate (generate_mel) alone.
    split = []
    for req in requests:
        t0 = time.perf_counter()
        tokens = ff.fast_encode(encoder, req["wav"], w)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.generate_mel(tokens, num_steps=4, temperature=req.get("temperature", 1.0),
                            generator=req.get("generator"))
        torch.cuda.synchronize()
        split.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    print("[audio] fused generate_from_audio per-call ms: "
          + ", ".join(f"{t:.3f}" for t in times)
          + "; alone, encode + generate ms: "
          + ", ".join(f"{e:.3f} + {g:.3f}" for e, g in split)
          + f"; frontend launches={launches}, fused_ddim launches={ddim_launches}")
    return launches, agree


def report_ddpm(label: str, got, want):
    """Print and return (max |got - want|, max |want|, the fraction of elements
    over atol 1e-3 + rtol 1e-4, and the largest |want| among those elements
    over max |want|)."""
    diff = (got - want).abs()
    scale = want.abs().max().item()
    over = diff > 1e-3 + 1e-4 * want.abs()
    near = want.abs()[over].max().item() / scale if bool(over.any()) else 0.0
    err, frac = diff.max().item(), over.float().mean().item()
    print(f"[ddpm] {label}: max_abs_err={err:.3g} max|x|={scale:.4g} "
          f"max_abs_err/max|x|={err / scale:.3g} frac over rtol 1e-4 atol 1e-3={frac:.2e} "
          f"(largest |x| among them / max|x| = {near:.3g})")
    return err, scale, frac, near


def check_ddpm(label: str, got, want) -> float:
    """Hold a DDPM output to the stated rule (module docstring); return max err."""
    err, scale, frac, _ = report_ddpm(label, got, want)
    assert bool(got.isfinite().all()), f"ddpm {label}: non-finite output"
    assert err <= 1e-3 + 1e-4 * scale and frac <= 1e-3, (
        f"ddpm {label}: max err {err} at scale {scale}, {frac:.2e} of elements over "
        f"rtol 1e-4 atol 1e-3")
    return err


def phase_ddpm(torch, cfg, decoder):
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

    dev = torch.device(DEVICE)
    B, S = 1, 250
    T = 2 * S
    rng = np.random.RandomState(4000 + SEED)
    sem_idx = torch.from_numpy(rng.randint(0, 2304, (B, S))).to(dev)
    x_T = torch.from_numpy(rng.randn(B, T, cfg.n_mels).astype(np.float32)).to(dev)
    w = fd.pack_decoder_weights(decoder)
    kw = dict(heads=cfg.heads, window=cfg.attn_window_size)

    def loop_args(steps):
        ts = list(range(steps - 1, -1, -1))
        loop = fd.prepare_loop_inputs(decoder, sem_idx, T, ts,
                                      step_idx=torch.zeros(steps, dtype=torch.long))
        coef = fd.ddpm_coefficients(DiffusionSchedule.create(steps)).to(dev)
        return (x_T, loop["pos"], loop["mods"], loop["ckv"], coef, w)

    args50 = loop_args(50)
    noise = torch.from_numpy(rng.randn(B, 50, T, cfg.n_mels).astype(np.float32)).to(dev)
    key = (SEED, 0x5EED)
    for mode, extra in (("injected", dict(noise=noise)), ("philox", dict(key=key))):
        got = fd.fused_ddpm(*args50, **kw, **extra)
        torch.cuda.synchronize()
        want = fd.fused_ddpm_plain(*args50, **kw, **extra)
        check_ddpm(f"50 steps, {mode} noise, kernel vs plain", got, want)
        if mode == "injected":
            # Witness of the bar: the plain version on the CPU is another float32
            # summation order with no kernel in it.
            cpu_args = [a.cpu() for a in args50[:5]] + [{k: v.cpu() for k, v in w.items()}]
            cpu = fd.fused_ddpm_plain(*cpu_args, **kw, noise=noise.cpu())
            report_ddpm("50 steps, injected noise, plain on the card vs plain on the CPU",
                        want.cpu(), cpu)

    engine = fd.FusedEdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps), decoder,
                                   device=DEVICE)

    def sample(seed):
        return engine.sample_ddpm(sem_idx, generator=torch.Generator(device=DEVICE)
                                  .manual_seed(seed))

    first = sample(SEED)  # warm-up, and the reference for determinism
    torch.cuda.synchronize()
    fd.fused_ddpm.launches = 0
    t0 = time.perf_counter()
    again = sample(SEED)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    launches = fd.fused_ddpm.launches
    assert launches == 1, f"fused_ddpm launches {launches} for one sample_ddpm call"
    other = sample(SEED + 1)
    assert again.shape == (B, T, cfg.n_mels) and torch.isfinite(again).all()
    assert torch.equal(first, again), "sample_ddpm differs for the same seed"
    assert (first - other).abs().max().item() > 1e-3, "sample_ddpm ignores the seed"

    args = loop_args(cfg.diff_steps)
    got, ms = timed_call(torch, lambda: fd.fused_ddpm(*args, **kw, key=key))
    want, plain_ms = timed_call(torch, lambda: fd.fused_ddpm_plain(*args, **kw, key=key))
    err = check_ddpm(f"{cfg.diff_steps} steps, philox noise, kernel vs plain", got, want)
    # Witness: the plain version in float64 on the same draws, against which
    # both float32 routes' own rounding shows.
    args64 = [a.double() for a in args[:5]] + [{k: v.double() for k, v in w.items()}]
    exact, f64_ms = timed_call(torch, lambda: fd.fused_ddpm_plain(*args64, **kw, key=key))
    assert exact.dtype == torch.float64 and bool(exact.isfinite().all())
    report_ddpm(f"{cfg.diff_steps} steps, kernel vs float64 plain", got.double(), exact)
    report_ddpm(f"{cfg.diff_steps} steps, float32 plain vs float64 plain", want.double(), exact)
    print(f"[ddpm] float64 plain {cfg.diff_steps} steps: {f64_ms:.3f} ms")
    flops, nbytes = fused_flops_bytes(
        B, T, S, cfg.n_mels, cfg.hidden, cfg.heads, cfg.layers, cfg.hidden * cfg.ffn_mult,
        cfg.attn_window_size, cfg.diff_steps, list(args[:5]) + list(w.values()))
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[ddpm] sample_ddpm {cfg.diff_steps} steps B={B} S={S}: {call_ms:.3f} ms per call "
          f"(host clock), kernel ms={ms:.3f} plain_ms={plain_ms:.3f}, {flops / 1e12:.4f} TFLOP "
          f"bound_ms={bound_ms:.4f} ({bound_by}); max|x|={first.abs().max().item():.4g}; "
          f"fused_ddpm launches={launches}")
    # The kernels line reports the error at the main path's 1000-step shape.
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def synthetic_wav(seconds: float, seed: int, sr: int = 16000) -> np.ndarray:
    """A voiced-like test signal from ``seed`` at ``sr`` Hz: a gliding
    harmonic tone with a slow amplitude envelope, plus a little noise."""
    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 110 + 40 * rng.rand() + 30 * np.sin(2 * np.pi * (0.3 + 0.2 * rng.rand()) * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    tone = sum(np.sin(k * phase) / k for k in (1, 2, 3, 5))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t) ** 2
    return (0.15 * env * tone + 0.01 * rng.randn(n)).astype(np.float32)


def phase_serve(torch, cfg, decoder, encoder):
    """Phase 9: the serving path end to end through ``run_server`` (the
    module docstring's phase 9); returns the conv-frontend launches of its
    traffic and the numbers it printed."""
    import threading

    from edge_diffusion_tts_tpu_torch import serving
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
    from edge_diffusion_tts_tpu_torch.pipeline import ChunkStream, LongFormPipeline
    from edge_diffusion_tts_tpu_torch.weights import save_checkpoint

    t_phase = time.perf_counter()
    ckpt = os.path.join(ROOT, "build", "serve_checkpoint")
    save_checkpoint(ckpt, cfg, decoder, encoder)
    t0 = time.perf_counter()
    server, batcher = serving.run_server(ckpt, port=0, buckets=(128, 256), max_batch=8,
                                         longform=True, longform_streams=2, device=DEVICE,
                                         verbose=False)
    warm_s = time.perf_counter() - t0
    host, port = server.server_address
    sched = server.longform_fn.scheduler
    pipe = sched.pipe
    out = {}
    try:
        assert pipe.encode_route == "kernel", pipe.encode_route
        rng = np.random.RandomState(9000 + SEED)
        # Every count to 0 just before the traffic (the phase's main path).
        ff.conv_frontend.launches = 0

        # Token path: 16 concurrent requests of 60-250 tokens, half binary.
        lens = rng.randint(60, 251, 16)
        toks = [rng.randint(0, cfg.effective_codebook_size(), n) for n in lens]
        results, lat = {}, {}

        def ask(i):
            t = time.perf_counter()
            results[i] = serving.request_tts(toks[i], host=host, port=port, binary=i % 2 == 0)
            lat[i] = (time.perf_counter() - t) * 1e3

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(16)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        assert sorted(results) == list(range(16)), f"token answers {sorted(results)}"
        for i, n in enumerate(lens):
            assert results[i].shape == (2 * n, cfg.n_mels) and np.isfinite(results[i]).all()
        stats = batcher.stats()
        assert stats["batches_run"] < 16, stats
        p50, p95 = np.percentile(list(lat.values()), [50, 95])
        out.update(token_p50_ms=p50, token_p95_ms=p95, token_rps=16 / wall,
                   occupancy=stats["mean_batch_occupancy"])
        print(f"[serve] token path: 16 concurrent request_tts of {lens.min()}-{lens.max()} tokens "
              f"(8 binary, 8 JSON): latency p50 {p50:.3f} ms, p95 {p95:.3f} ms, "
              f"{16 / wall:.3f} requests/s, {stats['batches_run']} batches, mean occupancy "
              f"{stats['mean_batch_occupancy']}, mean batch {stats['mean_batch_ms']} ms")

        # Long-form: two concurrent streams (10 s and 6 s; one as audio) at the
        # protocol defaults (50 steps, strength 0.6, cfg 2.0).
        wavs = {1: synthetic_wav(10.0, 9100 + SEED), 2: synthetic_wav(6.0, 9200 + SEED)}
        streams, first_ms, gl_ms = {}, {}, []
        vocode = pipe.vocode

        def timed_vocode(*a, **kw):
            t = time.perf_counter()
            wav_out = vocode(*a, **kw)
            gl_ms.append((time.perf_counter() - t) * 1e3)
            return wav_out

        pipe.vocode = timed_vocode
        # The wavs the streams' preps hand the conv frontend (bucketed, with
        # wav_len), kept to hold the kernel against its plain version below.
        encoded = []
        encode = pipe.encode

        def recorded_encode(wav, wav_len=None):
            encoded.append((wav.clone(), wav_len))
            return encode(wav, wav_len)

        pipe.encode = recorded_encode

        def stream(seed, audio):
            t = time.perf_counter()
            segs = []
            for seg, off in serving.request_longform(wavs[seed], host=host, port=port, seed=seed,
                                                     audio=audio):
                if not segs:
                    first_ms[seed] = (time.perf_counter() - t) * 1e3
                segs.append((seg, off))
            streams[seed] = segs

        threads = [threading.Thread(target=stream, args=(1, False)),
                   threading.Thread(target=stream, args=(2, True))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        lf_wall = time.perf_counter() - t0
        pipe.vocode = vocode
        assert sorted(streams) == [1, 2], f"long-form streams {sorted(streams)}"
        lstats = sched.stats()
        # b. Four preps dispatched beside a ticking stream (counted with the traffic).
        burst = serve_burst(torch, sched, host, port)
        pipe.encode = encode
        launches = ff.conv_frontend.launches
        assert launches >= 7 and launches == len(encoded), (
            f"conv_frontend launches {launches} for 7 streams, {len(encoded)} encodes")
        mel = np.concatenate([s for s, _ in streams[1]], axis=1)
        audio = streams[2]
        offs = [o for _, o in audio]
        assert offs[0] == 0 and all(o2 == o1 + len(a) for (a, o1), o2 in zip(audio, offs[1:]))
        assert all(np.isfinite(a).all() for a, _ in audio)
        assert sum(len(a) for a, _ in audio) <= wavs[2].size

        # The stream over TCP against the same seed's offline generation, in
        # log-mel (where the refine computes).  A tick's bits depend on its
        # row count (cuBLAS picks its kernels by shape), so the stream, whose
        # ticks held 1 or 2 rows, differs from its solo run by rounding.  The
        # bar comes from this run's witness: the stream's first chunk refined
        # alone and beside another row, in normalized units, times its
        # chunks' largest std (log-mel per normalized unit) and its chunk
        # count (each chunk adding its own rounding), and at least 1e-5.
        offline, _ = pipe.generate(wavs[1], seed=1, vocode=False)
        assert mel.shape == offline.shape and np.isfinite(mel).all(), (mel.shape, offline.shape)
        assert (mel > 0).all() and (offline > 0).all()
        lf_err = float(np.abs(np.log(mel) - np.log(offline)).max())
        cs = ChunkStream(pipe, wavs[1], seed=1)
        seed0, z0, k0, have0 = cs.next_job()
        T, S_chunk = pipe.chunk_frames, pipe.chunk_samples // pipe.sem_stride
        z2 = np.concatenate([z0, rng.randn(1, S_chunk, cfg.semantic_dim).astype(np.float32)])
        k2 = np.concatenate([k0, rng.randn(1, T, cfg.n_mels).astype(np.float32)])
        rows = [pipe.refine_chunk_batch_seeds(np.asarray([seed0, 6])[:n], z2[:n], k2[:n],
                                              np.asarray([have0, True])[:n], strength=0.6,
                                              steps=50, cfg_scale=2.0)[0].cpu() for n in (1, 2)]
        witness = (rows[0] - rows[1]).abs().max().item()
        n_chunks = {k: pipe.num_chunks(w.size) for k, w in wavs.items()}
        lf_bar = max(1e-5, n_chunks[1] * witness * float(cs._std.max()))
        assert lf_err <= lf_bar, (
            f"TCP stream vs offline: log-mel max err {lf_err} over {lf_bar} ({n_chunks[1]} "
            f"chunks x witness {witness} x std {float(cs._std.max())})")
        print(f"[serve] row-count witness: the 10 s stream's first chunk refined alone vs beside "
              f"another row (50 steps): max diff {witness:.3g} (normalized); chunk std <= "
              f"{float(cs._std.max()):.4g}; TCP stream vs offline log-mel bar {lf_bar:.3g}")
        for seed, (mel_b, wav_b) in burst["streams"].items():  # b's new streams
            off_b, _ = pipe.generate(wav_b, seed=seed, vocode=False)
            cs_b = ChunkStream(pipe, wav_b, seed=seed)
            cs_b.next_job()
            bar_b = max(1e-5, pipe.num_chunks(wav_b.size) * witness * float(cs_b._std.max()))
            err_b = float(np.abs(np.log(mel_b) - np.log(off_b)).max())
            assert mel_b.shape == off_b.shape and err_b <= bar_b, (seed, mel_b.shape, err_b, bar_b)
            print(f"[serve] burst stream {seed} (6 s) vs offline: log-mel max err {err_b:.3g} "
                  f"(bar {bar_b:.3g})")
        n_chunks = {k: pipe.num_chunks(w.size) for k, w in wavs.items()}
        out.update(burst={k: v for k, v in burst.items() if k != "streams"})
        out.update(ttfi_ms=first_ms, tick_ms=lstats["tick_ms_by_rows"], ticks=n_chunks,
                   gl_ms=float(np.mean(gl_ms)), lf_err=lf_err, lf_bar=lf_bar, witness=witness,
                   frontend_launches=launches)
        print(f"[serve] long-form: 10 s (mel) and 6 s (audio) streams, 50 steps, cfg 2.0: time to "
              f"first increment {first_ms[1]:.3f} / {first_ms[2]:.3f} ms; ms per scheduler tick "
              f"by rows {lstats['tick_ms_by_rows']}; ticks per stream {n_chunks[1]} / "
              f"{n_chunks[2]} ({lstats['batches_run']} ticks in all, mean row occupancy "
              f"{lstats['mean_row_occupancy']}); Griffin-Lim {np.mean(gl_ms):.3f} ms per "
              f"increment ({len(gl_ms)} increments, 50 iterations); both streams {lf_wall:.3f} s; "
              f"TCP mel vs offline log-mel max err {lf_err:.3g} (|mel| <= "
              f"{np.abs(offline).max():.4g}); conv_frontend launches {launches}")

        # The 6 s stream's prep, bucketed (8 s bucket) against exact length.
        exact = LongFormPipeline(cfg, pipe.schedule, pipe.decoder, pipe.encoder, device=DEVICE)
        z, mean, std, seeds = exact.stream_prep(wavs[2], seed=2)
        zb, mean_b, std_b, seeds_b = pipe.stream_prep(wavs[2], seed=2)
        S = z.shape[1]
        z_err = float(np.abs(zb[:, :S] - z).max())
        m_err = float(max(np.abs(mean_b - mean).max(), np.abs(std_b - std).max()))
        assert z_err <= 1e-4 and m_err <= 1e-5 and np.all(zb[:, S:] == 0.0), (z_err, m_err)
        assert np.array_equal(seeds, seeds_b)
        # a. The async prep against the synchronous prep and against the same
        # work inline on the default stream, bit for bit; the medians of 5.
        with torch.inference_mode():
            inline = pipe._prep(torch.from_numpy(wavs[2][None]).to(DEVICE),
                                pipe.num_chunks(wavs[2].size), pipe.prep_buckets[0])
            inline = [t.cpu().numpy() for t in inline] + [seeds_b]
        sync_ms, dispatch_ms, fetch_ms = [], [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            sync = pipe.stream_prep(wavs[2], seed=2)
            sync_ms.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            t = time.perf_counter()
            realize = pipe.stream_prep_async(wavs[2], seed=2)
            dispatch_ms.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()  # the prep has finished
            t = time.perf_counter()
            fetched = realize()
            fetch_ms.append((time.perf_counter() - t) * 1e3)
            for a, b, c in zip(sync, fetched, inline):
                assert np.array_equal(a, b) and np.array_equal(a, c), "async prep != sync prep"
        torch.cuda.set_sync_debug_mode("error")
        try:
            realize = pipe.stream_prep_async(wavs[2], seed=2)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert all(np.array_equal(a, b) for a, b in zip(realize(), sync))
        med = {k: float(np.median(v)) for k, v in
               (("stream_prep", sync_ms), ("dispatch", dispatch_ms), ("fetch", fetch_ms))}
        out["prep_ms"] = med
        print(f"[serve] async prep of the 6 s stream (8 s bucket): stream_prep = "
              f"stream_prep_async(...)() = the work inline on the default stream, bit for bit; "
              f"medians of 5: stream_prep {med['stream_prep']:.3f} ms, dispatch "
              f"{med['dispatch']:.3f} ms, fetch of a finished prep {med['fetch']:.4f} ms; one "
              f"dispatch under set_sync_debug_mode('error') raised nothing")
        # The kernel route against the module route: FSQ indices.
        wav_b = torch.zeros((1, pipe.prep_buckets[0]), device=DEVICE)
        wav_b[0, :wavs[2].size] = torch.from_numpy(wavs[2])
        n = wavs[2].size + (-wavs[2].size) % pipe.sem_stride
        with torch.no_grad():
            feats = ff.conv_frontend(wav_b, pipe.frontend_weights, wav_len=n)
            idx_k = pipe.encoder(wav_b, wav_len=n, conv_feats=feats)[1][:, :S]
            idx_m = pipe.encoder(wav_b, wav_len=n)[1][:, :S]
        tok = (idx_k == idx_m).float().mean().item()
        assert tok >= 0.99, f"kernel and module routes: tokens equal {tok:.4%}"
        print(f"[serve] prep of the 6 s stream, 8 s bucket vs exact length: z_q max err "
              f"{z_err:.3g} ({S} valid latents), chunk mean/std max err {m_err:.3g}; FSQ "
              f"indices, kernel route vs module route: {tok:.4%} equal")

        # The GroupNorm fold with wav_len, on the card: kernel vs plain under
        # phase 6's bar, on the bucketed wavs the streams encoded and at
        # [2, 128000] with wav_len (80000, 128000).
        wav2 = torch.from_numpy((0.2 * rng.randn(2, 128000)).astype(np.float32)).to(DEVICE)
        wav2[0, 80000:] = 0.0
        cases = encoded + [(wav2, torch.tensor([80000, 128000], device=DEVICE))]
        fold_errs = []
        for wav_c, n_c in cases:
            got = ff.conv_frontend(wav_c, pipe.frontend_weights, wav_len=n_c)
            torch.cuda.synchronize()
            want = ff.conv_frontend_plain(wav_c, pipe.frontend_weights, wav_len=n_c)
            err = (got - want).abs().max().item()
            excess = ((got - want).abs() - 1e-3 * want.abs()).max().item()
            n_txt = tuple(n_c.tolist()) if torch.is_tensor(n_c) else n_c
            assert torch.isfinite(got).all() and excess <= 2e-4, (
                f"frontend with wav_len {n_txt} at {list(wav_c.shape)}: max err {err}, over "
                f"atol 2e-4 + rtol 1e-3 by {excess}")
            fold_errs.append(err)
            print(f"[serve] conv_frontend with wav_len {n_txt} at {list(wav_c.shape)} vs plain: "
                  f"max_abs_err={err:.3g}")
        out["fold_err"] = max(fold_errs)

        # The serving premise, in process: at temperature 0 a masked batch of
        # 8 rows equals each row alone.
        inf = batcher.inference
        sem_idx = np.zeros((8, 256), np.int64)
        sem_mask = np.zeros((8, 256), bool)
        for i in range(8):
            sem_idx[i, :lens[i]] = toks[i]
            sem_mask[i, :lens[i]] = True
        batched = inf.generate_mel(sem_idx, temperature=0.0, sem_mask=sem_mask)
        mask_err = max(
            (batched[i, :2 * lens[i]] - inf.generate_mel(toks[i][None], temperature=0.0)[0])
            .abs().max().item() for i in range(8))
        assert mask_err <= 1e-4, f"masked batch vs single rows: max err {mask_err}"
        out["mask_err"] = mask_err
        print(f"[serve] masked batch of 8 (padded to 256) vs each row alone, temperature 0: "
              f"max err {mask_err:.3g}")
    finally:
        server.shutdown()
        batcher.close()
    seconds = time.perf_counter() - t_phase
    print(f"[serve] phase 9: {seconds:.3f} s (run_server with its warmup {warm_s:.3f} s)")
    return out


def serve_burst(torch, sched, host: str, port: int) -> dict:
    """Phase 9b: one 10 s stream ticking through the server; after its second
    increment four 6 s streams are requested from four threads at once.
    Returns each submit's return ms and the handler thread's CPU ms inside
    it (the rest of its wall is waiting), the same two for the prep's
    dispatch, each new stream's time to first increment, the ticking
    stream's tick ms inside and outside the window of the four preps (first
    submit to last fetch), the pinned host blocks and device segments the
    burst made, and the new streams' mels with their wavs.  Fails if a submit made a
    synchronizing CUDA call (``set_sync_debug_mode("warn")`` over the
    burst, read on the submitting thread)."""
    import threading
    import warnings

    from edge_diffusion_tts_tpu_torch import serving

    pipe = sched.pipe
    wavs = {20: synthetic_wav(10.0, 9300 + SEED)}
    wavs.update({s: synthetic_wav(6.0, 9400 + SEED + s) for s in (21, 22, 23, 24)})
    ticks, submits, dispatches, fetched, syncs = [], {}, {}, {}, []
    run_batch, submit, dispatch = sched._run_batch, sched.submit, pipe.stream_prep_async
    in_submit = threading.local()

    def timed_batch(batch, group):
        t0 = time.perf_counter()
        run_batch(batch, group)
        ticks.append((t0, time.perf_counter(), len(batch),
                      any(s.chunk.total == wavs[20].size for s in batch)))

    def timed_submit(wav, *, seed=0, **kw):
        t0, c0 = time.perf_counter(), time.thread_time()
        in_submit.seed = seed
        try:
            it = submit(wav, seed=seed, **kw)
        finally:
            in_submit.seed = None
        submits[seed] = (t0, time.perf_counter(), (time.thread_time() - c0) * 1e3)
        return it

    def timed_dispatch(wav, seed=0):
        t0, c0 = time.perf_counter(), time.thread_time()
        realize = dispatch(wav, seed)
        dispatches[seed] = ((time.perf_counter() - t0) * 1e3, (time.thread_time() - c0) * 1e3)

        def timed_realize():
            result = realize()
            fetched[seed] = time.perf_counter()
            return result

        return timed_realize

    sched._run_batch, sched.submit, pipe.stream_prep_async = timed_batch, timed_submit, \
        timed_dispatch
    mels, started, first_at = {}, {}, {}
    second = threading.Event()

    def client(seed):
        started[seed] = time.perf_counter()
        segs = []
        for seg, _ in serving.request_longform(wavs[seed], host=host, port=port, seed=seed):
            if not segs:
                first_at[seed] = time.perf_counter()
            segs.append(seg)
            if seed == 20 and len(segs) == 2:
                second.set()
        mels[seed] = np.concatenate(segs, axis=1)

    host0, dev0 = torch.cuda.host_memory_stats(), torch.cuda.memory_stats()
    try:
        with warnings.catch_warnings():
            # Every synchronizing call warns; those on a submitting thread are
            # recorded, the scheduler's own (its fetches) dropped.
            warnings.filterwarnings("always", message=".*synchronizing CUDA")
            show = warnings.showwarning

            def record_sync(message, category, filename, lineno, *a, **kw):
                if "synchronizing CUDA" not in str(message):
                    show(message, category, filename, lineno, *a, **kw)
                elif getattr(in_submit, "seed", None) is not None:
                    syncs.append((in_submit.seed, f"{filename}:{lineno}"))

            warnings.showwarning = record_sync
            torch.cuda.set_sync_debug_mode("warn")
            try:
                main = threading.Thread(target=client, args=(20,))
                main.start()
                assert second.wait(timeout=300), "the ticking stream gave no second increment"
                burst = [threading.Thread(target=client, args=(s,)) for s in (21, 22, 23, 24)]
                for t in burst:
                    t.start()
                for t in [main] + burst:
                    t.join(timeout=600)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        del sched._run_batch, sched.submit, pipe.stream_prep_async
    host1, dev1 = torch.cuda.host_memory_stats(), torch.cuda.memory_stats()
    assert sorted(mels) == [20, 21, 22, 23, 24], f"burst streams {sorted(mels)}"
    assert not syncs, f"synchronizing CUDA calls inside a submit (seed, site): {syncs}"
    new = (21, 22, 23, 24)
    lo, hi = min(submits[s][0] for s in new), max(fetched[s] for s in new)
    # The ticking stream's ticks as (ms, rows), inside the window or outside it.
    split = {"inside": [], "outside": []}
    for t0, t1, rows, mine in ticks:
        if mine:
            split["inside" if t0 < hi and t1 > lo else "outside"].append(((t1 - t0) * 1e3, rows))
    out = {"submit_ms": {s: (submits[s][1] - submits[s][0]) * 1e3 for s in new},
           "submit_cpu_ms": {s: submits[s][2] for s in new},
           "dispatch_ms": {s: dispatches[s][0] for s in new},
           "dispatch_cpu_ms": {s: dispatches[s][1] for s in new},
           "pinned_blocks_made": host1["num_host_alloc"] - host0["num_host_alloc"],
           "pinned_alloc_ms": (host1["host_alloc_time.total"]
                               - host0["host_alloc_time.total"]) / 1e3,
           "device_segments_made": dev1["num_device_alloc"] - dev0["num_device_alloc"],
           "ttfi_ms": {s: (first_at[s] - started[s]) * 1e3 for s in new},
           "window_ms": (hi - lo) * 1e3, "tick_ms_rows_inside": split["inside"],
           "tick_ms_rows_outside": split["outside"],
           "ticking_stream_s": max(t1 for _, t1, _, mine in ticks if mine) - started[20],
           "streams": {s: (mels[s], wavs[s]) for s in new}}
    ms = lambda v: "[" + ", ".join(f"{x:.3f}" for x in v) + "]"  # noqa: E731
    ms_rows = lambda v: "[" + ", ".join(f"{x:.3f} ({r} rows)" for x, r in v) + "]"  # noqa: E731
    print(f"[serve] burst: a 10 s stream ticking; after its 2nd increment four 6 s streams "
          f"requested from four threads: submit returned in "
          f"{ms(out['submit_ms'].values())} ms, the handler thread on the CPU "
          f"{ms(out['submit_cpu_ms'].values())} ms of it (the prep's dispatch "
          f"{ms(out['dispatch_ms'].values())} ms, on the CPU {ms(out['dispatch_cpu_ms'].values())}"
          f" ms); no synchronizing CUDA call inside a submit; pinned host blocks made "
          f"{out['pinned_blocks_made']} in {out['pinned_alloc_ms']:.3f} ms, device segments "
          f"(cudaMalloc) {out['device_segments_made']}; time to first "
          f"increment "
          f"{ms(out['ttfi_ms'].values())} ms; the four preps' window {out['window_ms']:.3f} ms; "
          f"the ticking stream's tick ms inside it {ms_rows(split['inside'])}, outside it "
          f"{ms_rows(split['outside'])}; the ticking stream took {out['ticking_stream_s']:.3f} s")
    return out


TRAIN_UTTERANCES = 84  # phase 10's corpus: 80 train, 4 validation utterances
# Phase 10's cuts of the flagship recipe (configs/flagship.json): epochs only.
TRAIN_CUTS = dict(diffusion_epochs=2, progressive_epochs_per_halving=1, consistency_epochs=1,
                  plot_every_steps=0, ckpt_every_steps=70, log_every_steps=5,
                  val_every_steps=10, val_batches=1)


def write_ljspeech(root: str, n: int, seed: int) -> None:
    """A synthetic corpus in the LJSpeech layout: metadata.csv and wavs/*.wav,
    22,050 Hz int16 (so the collate resamples), 2.5-4 s each."""
    from scipy.io import wavfile

    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    rng = np.random.RandomState(seed)
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as f:
        for i in range(n):
            uid = f"LJ{i // 100 + 1:03d}-{i % 100 + 1:04d}"
            wav = synthetic_wav(2.5 + 1.5 * rng.rand(), 10000 + seed + i, sr=22050)
            wavfile.write(os.path.join(root, "wavs", uid + ".wav"), 22050,
                          (np.clip(wav, -1.0, 1.0) * 32767).astype(np.int16))
            f.write(f"{uid}|synthetic utterance {i}|synthetic utterance {i}\n")


class StepClock:
    """A training hook stamping the host clock after every data step; the
    mean interval over a phase's steady steps is its ms per data step."""

    def __init__(self):
        self.stamps = {}

    def __call__(self, step, state):
        self.stamps[step] = time.perf_counter()

    def mean_ms(self, first: int, last: int, epoch: int, skip=()) -> float:
        """Mean of step k's interval (stamp k - stamp k-1) over steps
        first..last, leaving out each epoch's first two steps (validation and
        checkpoints run between epochs) and the steps after those in ``skip``
        (periodic checkpoints, evaluations)."""
        ms = [(self.stamps[k] - self.stamps[k - 1]) * 1e3 for k in range(first, last + 1)
              if (k - first) % epoch >= 2 and k - 1 in self.stamps and k - 1 not in skip]
        assert ms, (first, last)
        return float(np.mean(ms))


def _flat(params) -> "object":
    import torch

    return torch.cat([p.detach().reshape(-1) for p in params])


def phase_train(torch, cuts=None, hubert_cfg=None, utterances: int = TRAIN_UTTERANCES):
    """Phase 10: training through ``train()`` on a synthetic LJSpeech-layout
    corpus at the flagship config with the full HuBERT-base (the module
    docstring's phase 10); returns its conv-frontend and fused-DDIM launches."""
    import copy
    import dataclasses
    import shutil

    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.data import (CollatePrecomputed, DataLoader,
                                                   LJSpeechPrecomputedDataset,
                                                   precompute_hubert_features)
    from edge_diffusion_tts_tpu_torch.inference import EdgeInference
    from edge_diffusion_tts_tpu_torch.models import (EdgeDiffusionDecoder, HubertConfig,
                                                     SemanticEncoder)
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
    from edge_diffusion_tts_tpu_torch.training import (Trainer, TrainState,
                                                       progressive_step_schedule, train,
                                                       train_v2)
    from edge_diffusion_tts_tpu_torch.training.state import trainable_parameters
    from edge_diffusion_tts_tpu_torch.weights import load_checkpoint

    t_phase = time.perf_counter()
    hubert_cfg = hubert_cfg or HubertConfig()
    base = os.path.join(ROOT, "build", "phase10")
    shutil.rmtree(base, ignore_errors=True)
    lj = os.path.join(base, "LJSpeech-1.1")
    t0 = time.perf_counter()
    write_ljspeech(lj, utterances, SEED)
    corpus_s = time.perf_counter() - t0
    with open(os.path.join(ROOT, "configs", "flagship.json")) as f:
        flagship = json.load(f)
    cfg = CFG.from_dict(dict(flagship, **dict(TRAIN_CUTS, **(cuts or {})),
                             out_dir=os.path.join(base, "out"), run_name="flagship",
                             ljspeech_dir=lj, data_root=base, ckpt_path=""))
    B = cfg.batch_size
    n_val = int(utterances * 0.05)
    spe = (utterances - n_val) // B
    val_batches = min(cfg.val_batches, n_val // B)
    halvings = progressive_step_schedule(cfg.diff_steps, cfg.progressive_target_steps)
    d_end = spe * cfg.diffusion_epochs
    p_end = d_end + spe * cfg.progressive_epochs_per_halving * len(halvings)
    total = p_end + spe * cfg.consistency_epochs
    print(f"[train] corpus: {utterances} utterances of 2.5-4 s at 22,050 Hz written in "
          f"{corpus_s:.2f} s; {spe} steps per epoch at batch {B}, grad_accumulation "
          f"{cfg.grad_accumulation}; hidden {cfg.hidden}, {cfg.layers} layers, "
          f"depthwise {cfg.use_depthwise}, dropout {cfg.dropout}, cfg dropout "
          f"{cfg.cfg_dropout}, segment {cfg.segment_len} samples; halvings {halvings}")

    # -- 2. train() at the flagship config ------------------------------------------
    clock, snaps, checks, tags = StepClock(), {}, [], []
    first_halving = range(d_end + 1, d_end + spe * cfg.progressive_epochs_per_halving + 1)

    def watch(step, st):
        if step in (8, 16):
            snaps[step] = _flat(st.decoder.parameters()).clone()
        if step == d_end:
            checks.append(("no teacher in phase 1", st.teacher is None))
        if step in first_halving:
            cur = _flat(st.teacher.parameters())
            accumulating = st.optimizer.mini_step != 0
            checks.append((accumulating, torch.equal(cur, snaps["teacher"])))
            snaps["teacher"] = cur.clone()

    def at_phase_end(tag, st):
        tags.append((tag, st.step))
        if tag == "init":
            snaps["init"] = _flat(st.decoder.parameters()).clone()
            snaps["hubert"] = {k: v.clone() for k, v in st.encoder.hubert.state_dict().items()}
        if tag == "diffusion":  # the first halving's teacher starts as this decoder
            snaps["teacher"] = _flat(st.decoder.parameters()).clone()
        torch.cuda.synchronize()
        snaps[f"t_{tag}"] = time.perf_counter()

    ff.conv_frontend.launches = fd.fused_ddim.launches = 0  # counts to 0 before the main path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train(cfg, hubert_cfg=hubert_cfg, hooks=[clock, watch], phase_end_hook=at_phase_end,
                  device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    frontend_launches = ff.conv_frontend.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    run_dir = os.path.join(cfg.out_dir, cfg.run_name)
    evals = (d_end // cfg.val_every_steps) * val_batches
    validations = (cfg.diffusion_epochs + len(halvings) + cfg.consistency_epochs) * val_batches
    assert state.step == total, (state.step, total)
    assert frontend_launches == total + validations + evals, (
        f"conv_frontend launches {frontend_launches}: expected one per data step ({total}) "
        f"and per validation batch ({validations} + {evals})")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [v for r in recs for k, v in r.items() if k.endswith("loss")]
    n_logged = sum(1 for r in recs for k in r if k.endswith("/loss") and "val" not in k)
    assert n_logged == total // cfg.log_every_steps, (n_logged, total)
    assert losses and all(math.isfinite(v) for v in losses), "a logged loss is not finite"
    for k, v in state.encoder.hubert.state_dict().items():
        assert torch.equal(v, snaps["hubert"][k]), f"the frozen HuBERT's {k} changed"
    assert torch.equal(snaps[8], snaps["init"]), "the decoder moved by data step 8 (lr 0)"
    assert not torch.equal(snaps[16], snaps[8]), "the decoder did not move by data step 16"
    assert checks[0] == ("no teacher in phase 1", True), checks[0]
    still = [same for acc, same in checks[1:] if acc]
    moved = [not same for acc, same in checks[1:] if not acc]
    assert still and all(still), f"the teacher moved on an accumulation-only step: {checks}"
    assert moved and all(moved), f"the teacher did not move on an update step: {checks}"
    assert [t for t, _ in tags] == (["init", "diffusion"] + [f"prog{h}" for h in halvings]
                                    + ["consistency"]), tags
    ckpt_skip = set(range(0, total + 1, cfg.ckpt_every_steps))
    ms = {
        "diffusion": clock.mean_ms(1, d_end, spe,
                                   ckpt_skip | set(range(0, d_end + 1, cfg.val_every_steps))),
        # the first halving's steps compare the teacher on the host: left out
        "progressive": clock.mean_ms(first_halving[-1] + 1, p_end, spe, ckpt_skip),
        "consistency": clock.mean_ms(p_end + 1, total, spe, ckpt_skip),
    }
    walls = {"diffusion": snaps["t_diffusion"] - snaps["t_init"],
             "progressive": snaps[f"t_prog{halvings[-1]}"] - snaps["t_diffusion"],
             "consistency": snaps["t_consistency"] - snaps[f"t_prog{halvings[-1]}"]}
    for name, v in ms.items():
        print(f"[train] wav path, {name}: {v:.3f} ms per data step (mean of steady steps), "
              f"{B / v * 1e3:.2f} utterances/s; phase wall {walls[name]:.3f} s (validation "
              "and checkpoints included)")
    print(f"[train] train(): {total} data steps in {train_s:.3f} s, peak "
          f"torch.cuda.max_memory_allocated {peak_gb:.3f} GiB; {len(losses)} logged losses, "
          f"all finite; HuBERT bit-equal; decoder unchanged through step 8 (lr 0), moved by "
          f"step 16; teacher from step {d_end + 1}, bit-equal on {len(still)} accumulation-"
          f"only steps, moved on {len(moved)} update steps; conv_frontend launches "
          f"{frontend_launches}")

    # -- 3. resume from the periodic checkpoint --------------------------------------
    with open(os.path.join(cfg.ckpt_path, "meta.json")) as f:
        meta = json.load(f)
    print(f"[train] periodic checkpoint meta: phase {meta.get('phase')}, halving "
          f"{meta.get('halving')}, step {meta.get('step')}")
    rtags = []
    ff.conv_frontend.launches = 0
    t0 = time.perf_counter()
    resumed = train(dataclasses.replace(cfg, run_name="resumed"), hubert_cfg=hubert_cfg,
                    resume="auto", device=DEVICE,
                    phase_end_hook=lambda tag, st: rtags.append(tag))
    resume_s = time.perf_counter() - t0
    frontend_launches += ff.conv_frontend.launches
    order = ["diffusion", "progressive", "consistency"]
    redo = order[order.index(meta["phase"]):]
    want_tags = ([f"prog{h}" for h in halvings[halvings.index(meta["halving"]):]]
                 if meta["phase"] == "progressive" else []) + (
        ["consistency"] if "consistency" in redo else [])
    assert rtags == want_tags, (rtags, want_tags)
    assert meta["phase"] != "diffusion", "the periodic checkpoint is still in phase 1"
    print(f"[train] resume='auto': skipped {order[:order.index(meta['phase'])]}, ran "
          f"{rtags} from step {meta['step']} to {resumed.step} in {resume_s:.3f} s")

    # -- 4. the precomputed-features path --------------------------------------------
    w = ff.pack_frontend_weights(state.encoder.hubert.feature_extractor)

    def hubert_apply(wav):
        x = torch.from_numpy(wav).to(DEVICE)
        with torch.no_grad():
            return state.encoder.extract_hubert(x, conv_feats=ff.conv_frontend(x, w))

    ff.conv_frontend.launches = 0
    t0 = time.perf_counter()
    precompute_hubert_features(lj, hubert_apply)
    torch.cuda.synchronize()
    precompute_s = time.perf_counter() - t0
    assert ff.conv_frontend.launches == utterances, ff.conv_frontend.launches
    frontend_launches += ff.conv_frontend.launches
    # The fused DDIM kernel implements no depthwise pre-net (ROADMAP B2.2): the
    # precomputed run trains the flagship without it, to be served fused below.
    pcfg = dataclasses.replace(cfg, run_name="precomputed", use_depthwise=False,
                               diffusion_epochs=1, ckpt_every_steps=0)
    loaders = [DataLoader(LJSpeechPrecomputedDataset(lj, split), B,
                          CollatePrecomputed(pcfg, deterministic=split == "val", seed=pcfg.seed),
                          shuffle=split == "train", seed=pcfg.seed, workers=pcfg.num_workers)
               for split in ("train", "val")]
    pclock = StepClock()
    ff.conv_frontend.launches = 0
    t0 = time.perf_counter()
    pstate = train_v2(pcfg, train_loader=loaders[0], val_loader=loaders[1],
                      hubert_cfg=hubert_cfg, hooks=[pclock], device=DEVICE)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    assert ff.conv_frontend.launches == 0, "the precomputed path ran the frontend"
    assert pstate.step == spe
    with open(os.path.join(pcfg.out_dir, pcfg.run_name, "metrics.jsonl")) as f:
        plosses = [v for line in f for k, v in json.loads(line).items() if k.endswith("loss")]
    assert plosses and all(math.isfinite(v) for v in plosses)
    ms["precomputed diffusion"] = pclock.mean_ms(1, spe, spe,
                                                 set(range(0, spe + 1, pcfg.val_every_steps)))
    print(f"[train] precomputed path (features by precompute_hubert_features on the kernel "
          f"route, {utterances} utterances in {precompute_s:.3f} s), diffusion without the "
          f"pre-net: {ms['precomputed diffusion']:.3f} ms per data step, "
          f"{B / ms['precomputed diffusion'] * 1e3:.2f} utterances/s; {spe} steps in "
          f"{pre_s:.3f} s")

    # -- 5. one diffusion loss and its gradients: the card against the CPU ---------------
    cfg0 = dataclasses.replace(cfg, dropout=0.0, cfg_dropout=0.0)
    enc_cpu = SemanticEncoder(cfg0, hubert_cfg)
    enc_cpu.load_state_dict({k: v.cpu() for k, v in state.encoder.state_dict().items()})
    dec_cpu = EdgeDiffusionDecoder(cfg0)
    dec_cpu.load_state_dict({k: v.cpu() for k, v in state.decoder.state_dict().items()})
    from edge_diffusion_tts_tpu_torch.data import Collate, LJSpeechDataset

    ds = LJSpeechDataset(lj, "train")
    wav = Collate(cfg0, deterministic=True)([ds[i] for i in range(B)])["wav"]
    with torch.no_grad():
        x = torch.from_numpy(wav).to(DEVICE)
        feats = state.encoder.extract_hubert(x, conv_feats=ff.conv_frontend(x, w)).cpu()
    rs = np.random.RandomState(5000 + SEED)
    batch = {"wav": wav, "hubert_features": feats, "t": rs.randint(1, cfg0.max_timestep, B),
             "noise": rs.randn(B, cfg0.segment_mel_frames, cfg0.n_mels).astype(np.float32)}
    results = {}
    for device, (enc, dec) in (("cpu", (enc_cpu, dec_cpu)),
                               (DEVICE, (copy.deepcopy(enc_cpu), copy.deepcopy(dec_cpu)))):
        trainer = Trainer(cfg0, enc, dec, DiffusionSchedule.create(cfg0.diff_steps),
                          device=device)
        st = TrainState(trainer.encoder, trainer.decoder, optimizer=None)
        st.train()
        params = trainable_parameters(trainer.encoder, trainer.decoder)
        loss, _ = trainer.make_diffusion_loss()(st, trainer.put_batch(batch), None)
        loss.backward()
        results[device] = (loss.item(), {n: (p.grad if p.grad is not None
                                             else torch.zeros_like(p)).detach().double().cpu()
                                         for n, p in params.items()})
    (l_cpu, g_cpu), (l_card, g_card) = results["cpu"], results[DEVICE]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst = (1.0, None)
    for name, a in g_cpu.items():
        b = g_card[name]
        na, nb = a.norm().item(), b.norm().item()
        if na < 1e-12 and nb < 1e-12:
            continue
        cos = (a * b).sum().item() / max(na * nb, 1e-300)
        worst = min(worst, (cos, name))
    print(f"[train] one flagship diffusion loss on the card vs the CPU (same weights, batch, "
          f"injected t/noise, dropout 0): loss {l_card:.7g} vs {l_cpu:.7g} (rel {loss_rel:.3g}); "
          f"{len(g_cpu)} gradient tensors, lowest cosine {worst[0]:.8f} ({worst[1]})")
    assert loss_rel <= 1e-4, loss_rel
    assert worst[0] >= 0.99999, worst

    # -- 6. serve the trained models ----------------------------------------------------
    schedule = DiffusionSchedule.create(cfg.diff_steps)
    tokens = torch.from_numpy(np.random.RandomState(6000 + SEED)
                              .randint(0, cfg.effective_codebook_size(), (1, 100))).to(DEVICE)
    fcfg, dec_sd, _, _ = load_checkpoint(os.path.join(run_dir, "edge_model_final"))
    dec = EdgeDiffusionDecoder(fcfg)
    dec.load_state_dict(dec_sd)
    try:
        EdgeInference(fcfg, schedule, dec, prediction="v", backend="fused", device=DEVICE)
        raise AssertionError("the fused backend took a depthwise pre-net")
    except ValueError as e:
        assert "depthwise" in str(e), e
    mel = EdgeInference(fcfg, schedule, dec, prediction="v", device=DEVICE).generate_mel(
        tokens, num_steps=4)
    assert mel.shape == (1, 200, cfg.n_mels) and torch.isfinite(mel).all()
    pcfg_f, pdec_sd, _, _ = load_checkpoint(os.path.join(pcfg.out_dir, pcfg.run_name,
                                                         "edge_model_final"))
    pdec = EdgeDiffusionDecoder(pcfg_f)
    pdec.load_state_dict(pdec_sd)
    engine = EdgeInference(pcfg_f, schedule, pdec, prediction="v", backend="fused",
                           device=DEVICE)
    fd.fused_ddim.launches = 0
    pmel = engine.generate_mel(tokens, num_steps=4)
    torch.cuda.synchronize()
    fused_launches = fd.fused_ddim.launches
    assert fused_launches == 1 and pmel.shape == mel.shape and torch.isfinite(pmel).all()
    seconds = time.perf_counter() - t_phase
    print(f"[train] served: the flagship final model (depthwise) through the eager backend "
          f"(the fused backend refuses its pre-net), the precomputed run's through "
          f"backend='fused': finite, fused_ddim launches {fused_launches}")
    print(f"[train] phase 10: {seconds:.3f} s (train() {train_s:.3f} s, resume {resume_s:.3f} "
          f"s, precomputed {precompute_s + pre_s:.3f} s); conv_frontend launches "
          f"{frontend_launches}")
    return dict(frontend_launches=frontend_launches, fused_launches=fused_launches,
                ms=ms, peak_gb=peak_gb, seconds=seconds)



# -- phase 11: parallel/ on two gloo ranks of one card -----------------------------------

PAR_STEPS = ("diffusion", "progressive", "consistency")  # phase 11a's step kinds
PAR_TIMED = 5  # data steps (and calls) timed after one warm-up, per path
PAR_SEQ = dict(S=4000, steps=4)  # phase 11c: T = 8000 mel frames, 4 DDIM steps
# Phase 11c: the first DDIM step divides by sqrt(alpha_bar_999) = 1.56e-5,
# so a rounding difference at an element whose first-step x0 stays inside
# the clip comes out ~6e4 times larger (phase 3), and the seeded decoder
# carries it on from step to step.  Its max bar is 1e-4 or PAR_WITNESS times
# how far the same single-device call moves when its input moves by one ulp
# (``par_witness``), whichever is larger: the largest reading so far is 1.32
# witnesses (four ranks on four cards, 4 steps).  At most PAR_SEQ_FRAC of the
# elements may lie over 1e-4: the readings so far are 0.103% (four ranks on
# the CPU) and 0 (two ranks on one card).  Phase 11e holds make_dp_generate
# to phase 3's rule for v prediction: 0.05 on all elements, 2e-4 on 99.9%.
PAR_WITNESS = 2
PAR_SEQ_FRAC = 5e-3


def par_witness(fn, x, want) -> float:
    """How far ``fn`` (which gave ``want`` on ``x``) moves when every
    element of ``x`` moves by about one ulp: the amplification a
    rounding-level difference meets on its way out."""
    return float((fn(x * (1 + 2.0 ** -23)) - want).abs().max())
PAR_POSITIONS = dict(max_mel_positions=8192, max_ctx_positions=4096)  # longform.json: 4096/2048
PAR_TRAIN_CUTS = dict(diffusion_epochs=1, progressive_epochs_per_halving=1,
                      consistency_epochs=1, progressive_target_steps=250, plot_every_steps=0,
                      ckpt_every_steps=40, log_every_steps=5, val_every_steps=10,
                      val_batches=1)


def par_flagship_cfg():
    """configs/flagship.json for phase 11's one-step comparisons: dropout and
    cfg dropout 0, one data step per update."""
    from edge_diffusion_tts_tpu_torch.config import CFG

    with open(os.path.join(ROOT, "configs", "flagship.json")) as f:
        flagship = json.load(f)
    return CFG.from_dict(dict(flagship, dropout=0.0, cfg_dropout=0.0, grad_accumulation=1,
                              ckpt_path=""))


def par_models(torch, cfg, hubert: dict):
    """The seeded encoder (HuBERT ``HubertConfig(**hubert)``: hubert-base on
    the card), decoder and teacher decoder (its own seed) on the host, built
    once per process: every fresh state copies them."""
    from edge_diffusion_tts_tpu_torch.models import HubertConfig

    torch.manual_seed(SEED)  # the encoder's vector defaults come from the global stream
    return (seeded_encoder(torch, cfg, SEED, HubertConfig(**hubert)),
            seeded_decoder(torch, cfg, SEED), seeded_decoder(torch, cfg, SEED + 1))


def par_trainer(torch, cfg, base, with_teacher: bool):
    """(trainer, state) on the card from copies of ``base`` (``par_models``),
    AdamW at a constant 1e-3; the teacher where the phase has one."""
    import copy

    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
    from edge_diffusion_tts_tpu_torch.training import (Trainer, constant_schedule,
                                                       create_train_state, make_optimizer)

    enc, dec = copy.deepcopy(base[0]), copy.deepcopy(base[1]).train()
    trainer = Trainer(cfg, enc, dec, DiffusionSchedule.create(cfg.diff_steps), device=DEVICE)
    state = create_train_state(trainer.encoder, trainer.decoder, make_optimizer(
        cfg, trainer.encoder, trainer.decoder, 100, learning_rate=constant_schedule(1e-3)))
    if with_teacher:
        state.with_teacher()
        state.teacher.load_state_dict(base[2].state_dict())
    return trainer, state


def par_step(trainer, kind: str, mesh=None):
    from edge_diffusion_tts_tpu_torch.parallel import (make_dp_consistency_step,
                                                       make_dp_diffusion_step,
                                                       make_dp_progressive_step)

    if kind == "diffusion":
        return make_dp_diffusion_step(trainer, mesh) if mesh else trainer.make_diffusion_step()
    if kind == "progressive":
        return (make_dp_progressive_step(trainer, mesh, 4) if mesh
                else trainer.make_progressive_step(4))
    return (make_dp_consistency_step(trainer, mesh) if mesh
            else trainer.make_consistency_step())


def par_run_step(torch, trainer, state, kind, batch, mesh=None):
    """One step: metrics, the gradients the optimizer took (host), the
    trainable parameters after it (host, flat)."""
    seen = {}
    update = state.optimizer.update

    def recording(grads):
        seen.update({n: (g if g is not None else torch.zeros_like(state.optimizer.params[n]))
                     .detach().cpu() for n, g in grads.items()})
        return update(grads)

    state.optimizer.update = recording
    step = par_step(trainer, kind, mesh)
    state, metrics = step(state, trainer.put_batch(batch), torch.Generator(
        device=DEVICE).manual_seed(SEED))
    state.optimizer.update = update
    torch.cuda.synchronize()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": seen,
            "params": _flat(state.optimizer.params.values()).cpu()}


def par_step_ms(torch, step, state, batch, put) -> float:
    """Host-clock ms per data step over PAR_TIMED steps after one warm-up."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    state, _ = step(state, put(batch), g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED):
        state, _ = step(state, put(batch), g)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / PAR_TIMED


def par_seq_inputs(torch, cfg, S: int):
    rng = np.random.RandomState(5000 + SEED)
    sem = torch.from_numpy(rng.randint(0, cfg.effective_codebook_size(), (1, S))).to(DEVICE)
    x_T = torch.from_numpy(rng.randn(1, 2 * S, cfg.n_mels).astype(np.float32)).to(DEVICE)
    return sem, x_T


def par_longform_cfg():
    from edge_diffusion_tts_tpu_torch.config import CFG

    with open(os.path.join(ROOT, "configs", "longform.json")) as f:
        return CFG.from_dict(dict(json.load(f), **PAR_POSITIONS))


def par_rank(rank: int, spec: dict) -> dict:
    """One rank of phase 11 (of n: two ranks on cuda:0 over gloo as this
    script runs it; with ``spec["card_per_rank"]`` rank r on cuda:r): a, the
    DP steps; f, the PP step; c, sequence-parallel long-form; d, the TP
    encode; b, train() on an [n, 1] mesh.  Returns each run's results and
    kernel launch counts (every count set to 0 just before its run, read just
    after).  ``spec["setup"]``, when given, runs first (a CPU rehearsal's
    stubs)."""
    import hashlib

    import torch
    import torch.distributed as dist

    global DEVICE
    if spec.get("setup") is not None:
        spec["setup"]()
    n = dist.get_world_size()
    card = rank if spec["card_per_rank"] else 0
    DEVICE = f"cuda:{card}" if spec["card_per_rank"] else spec["device"]
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
    from edge_diffusion_tts_tpu_torch.ops import window_attention as wa
    from edge_diffusion_tts_tpu_torch.parallel import (PIPE_AXIS, make_mesh,
                                                       make_seq_parallel_generate,
                                                       make_tp_encode, shard_batch,
                                                       shard_encoder_params)
    from edge_diffusion_tts_tpu_torch.parallel.pipeline_parallel import (create_pp_state,
                                                                         make_pp_trainer)
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
    from edge_diffusion_tts_tpu_torch.training import constant_schedule, train

    torch.cuda.set_device(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    cfg = par_flagship_cfg()
    base = par_models(torch, cfg, spec["hubert"])

    # a. data-parallel steps: this rank's 4 / n of the 4 rows.
    dp = make_mesh((n, 1))
    ff.conv_frontend.launches = 0
    out["dp"] = {}
    for kind in PAR_STEPS:
        trainer, state = par_trainer(torch, cfg, base, with_teacher=kind == "progressive")
        out["dp"][kind] = par_run_step(torch, trainer, state, kind,
                                       shard_batch(spec["batches"][kind], dp), dp)
    out["dp_launches"] = ff.conv_frontend.launches
    trainer, state = par_trainer(torch, cfg, base, with_teacher=False)
    out["dp_ms"] = par_step_ms(torch, par_step(trainer, "diffusion", dp), state,
                               spec["batches"]["diffusion"],
                               lambda b: trainer.put_batch(shard_batch(b, dp)))
    out["dp_timed_launches"] = ff.conv_frontend.launches - out["dp_launches"]

    # f. one pipeline-parallel diffusion step: n stages x 2 microbatches.
    pipe = make_mesh((n,), (PIPE_AXIS,))
    trainer, _ = par_trainer(torch, cfg, base, with_teacher=False)
    pp = make_pp_trainer(trainer, pipe, 2)
    state = create_pp_state(pp, 100, learning_rate=constant_schedule(1e-3))
    ff.conv_frontend.launches = 0
    res = par_run_step(torch, pp, state, "diffusion", spec["batches"]["diffusion"])
    k = len(state.decoder.layers)
    res["grads"] = {(f"decoder.layers.{rank * k + int(n.split('.')[2])}.{n.split('.', 3)[3]}"
                     if n.startswith("decoder.layers.") else n): g
                    for n, g in res["grads"].items()}
    res.pop("params")
    out["pp"] = res
    out["pp_ms"] = par_step_ms(torch, pp.make_diffusion_step(), state,
                               spec["batches"]["diffusion"], pp.put_batch)
    out["pp_launches"] = ff.conv_frontend.launches

    # c. sequence-parallel long-form: T = 8000 split n ways (two: the band kernel per shard).
    lcfg = par_longform_cfg()
    dec = seeded_decoder(torch, lcfg, SEED).to(DEVICE)
    lsched = DiffusionSchedule.create(lcfg.diff_steps).to(DEVICE)
    gen = make_seq_parallel_generate(lcfg, dec, lsched, dp, PAR_SEQ["steps"], prediction="eps")
    sem, x_T = par_seq_inputs(torch, lcfg, spec["seq_S"])
    wa.banded_attention.launches = 0
    x0 = gen(sem, x_T)
    torch.cuda.synchronize()
    out["seq"] = {"x0": x0.cpu(), "launches": wa.banded_attention.launches}
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED):
        gen(sem, x_T)
    torch.cuda.synchronize()
    out["seq"]["ms"] = (time.perf_counter() - t0) * 1e3 / PAR_TIMED
    out["seq"]["timed_launches"] = wa.banded_attention.launches - out["seq"]["launches"]
    one = make_seq_parallel_generate(lcfg, dec, lsched, dp, 1, prediction="eps")
    launched = wa.banded_attention.launches
    out["seq"]["x0_one_step"] = one(sem, x_T).cpu()
    out["seq"]["one_step_launches"] = wa.banded_attention.launches - launched
    del dec

    # d. the tensor-parallel encode of a 5 s wav: 12 / n heads and FFN 3072 / n per rank.
    enc = base[0].to(DEVICE)
    tp = make_mesh((1, n))
    params = shard_encoder_params(enc, tp)
    encode = make_tp_encode(enc, tp)
    wav = torch.from_numpy(spec["tp_wav"]).to(DEVICE)
    ff.conv_frontend.launches = 0
    tokens = encode(params, wav)
    feats = encode.features(params, wav)
    torch.cuda.synchronize()
    out["tp"] = {"tokens": tokens.cpu(), "features": feats.cpu(),
                 "launches": ff.conv_frontend.launches,
                 "q_rows": tuple(params["hubert.encoder.layers.0.attention.q_proj.weight"].shape),
                 "ffn_rows": tuple(params[
                     "hubert.encoder.layers.0.feed_forward.intermediate_dense.weight"].shape)}
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED):
        encode(params, wav)
    torch.cuda.synchronize()
    out["tp"]["ms"] = (time.perf_counter() - t0) * 1e3 / PAR_TIMED
    out["tp"]["timed_launches"] = ff.conv_frontend.launches - out["tp"]["launches"]
    del enc, params

    # b. train() with mesh_shape [n, 1] on phase 10's corpus, one epoch per phase.
    import edge_diffusion_tts_tpu_torch.training.checkpoint as ckpt

    writes, hashes = [], []
    save = ckpt.torch.save

    def counting(obj, path, *a, **kw):
        writes.append(os.path.basename(os.path.dirname(str(path))))
        return save(obj, path, *a, **kw)

    def watch(step, st):  # the parameters after every optimizer update
        if st.optimizer.mini_step == 0:
            flat = _flat(st.optimizer.params.values()).cpu().numpy()
            hashes.append((step, hashlib.sha1(flat.tobytes()).hexdigest()))

    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.models import HubertConfig

    with open(os.path.join(ROOT, "configs", "flagship.json")) as f:
        flagship = json.load(f)
    tcfg = CFG.from_dict(dict(flagship, **spec["train_cuts"], mesh_shape=[n, 1],
                              out_dir=spec["train_out"],
                              run_name="parallel", ljspeech_dir=spec["corpus"],
                              data_root=os.path.dirname(spec["corpus"]), ckpt_path=""))
    ckpt.torch.save = counting
    ff.conv_frontend.launches = 0
    t0 = time.perf_counter()
    try:
        state = train(tcfg, hubert_cfg=HubertConfig(**spec["hubert"]), hooks=[watch],
                      device=DEVICE)
    finally:
        ckpt.torch.save = save
    torch.cuda.synchronize()
    out["train"] = {"seconds": time.perf_counter() - t0, "writes": writes, "hashes": hashes,
                    "step": state.step, "launches": ff.conv_frontend.launches,
                    "run_dir": tcfg.get_run_dir()}
    return out


def _min_cosine(torch, got: dict, want: dict) -> float:
    return min(float(torch.nn.functional.cosine_similarity(
        got[n].double().reshape(1, -1), g.double().reshape(1, -1))[0])
        for n, g in want.items() if g.norm() > 0)


def phase_parallel(torch, cfg, decoder, hubert=None, train_cuts=None,
                   seq_S=PAR_SEQ["S"], setup=None, nranks: int = 2, backend: str = "gloo"):
    """Phase 11: ``parallel/`` on the card (the module docstring's phase 11);
    returns the launches of its kernels and its times.  ``nranks`` ranks
    over ``backend``: two over gloo on cuda:0 as this script runs it; with
    NCCL each rank takes its own card (``port_profile.py --nccl``), and
    ``make_dp_generate`` splits over every card.  ``hubert`` (HubertConfig
    fields), ``train_cuts``, ``seq_S`` and ``setup`` (run first on every
    rank) are a CPU rehearsal's cuts; the card runs the defaults."""
    import shutil

    from edge_diffusion_tts_tpu_torch.inference import EdgeInference
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
    from edge_diffusion_tts_tpu_torch.parallel import make_dp_generate
    from edge_diffusion_tts_tpu_torch.parallel.launch import spawn
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule, ddim_sample

    t_phase = time.perf_counter()
    n = nranks
    per_card = backend == "nccl"
    note = (f"{n} ranks on {n} cards over NCCL" if per_card
            else f"{n} ranks on one card over {backend}: no scaling claim")
    fcfg = par_flagship_cfg()
    hubert = hubert or {}
    base = par_models(torch, fcfg, hubert)
    rng = np.random.RandomState(4000 + SEED)
    wav = (0.2 * rng.randn(4, fcfg.segment_len)).astype(np.float32)
    trainer, _ = par_trainer(torch, fcfg, base, with_teacher=False)
    mel_shape = tuple(trainer._mel_normalized(torch.from_numpy(wav).to(DEVICE)).shape)
    noise = rng.randn(*mel_shape).astype(np.float32)
    batches = {
        "diffusion": dict(wav=wav, noise=noise, t=np.array([40, 300, 620, 900])),
        "progressive": dict(wav=wav, noise=noise, step_indices=np.array([0, 1, 2, 3])),
        "consistency": dict(wav=wav, noise=noise, t1=np.array([30, 300, 600, 990]),
                            t2=np.array([980, 20, 310, 620])),
    }
    out_dir = os.path.join(ROOT, "build", "phase11")
    shutil.rmtree(out_dir, ignore_errors=True)
    corpus = os.path.join(ROOT, "build", "phase10", "LJSpeech-1.1")
    assert os.path.isfile(os.path.join(corpus, "metadata.csv")), "phase 10's corpus is missing"
    spec = dict(batches=batches, tp_wav=(0.2 * rng.randn(1, 80000)).astype(np.float32),
                corpus=corpus, train_out=os.path.join(out_dir, "out"), device=DEVICE,
                card_per_rank=per_card, hubert=hubert,
                train_cuts=dict(PAR_TRAIN_CUTS, **(train_cuts or {})), seq_S=seq_S,
                setup=setup)
    print(f"[parallel] {note}; longform overrides {PAR_POSITIONS} (T = {2 * seq_S} "
          f"needs positions past longform.json's 4096/2048)")

    t0 = time.perf_counter()
    ranks = spawn(par_rank, n, args=(spec,), backend=backend, timeout=900)
    ranks_s = time.perf_counter() - t0
    r0 = ranks[0]
    per_rank = lambda f: " / ".join(f"{f(r):.3f}" for r in ranks)  # noqa: E731
    out = {"note": note, "ranks_s": ranks_s}

    # a. each DP step against the single-process step on the whole batch.
    bars = {"loss_rel": 1e-5, "cos": 0.99999}
    for kind in PAR_STEPS:
        trainer, state = par_trainer(torch, fcfg, base, with_teacher=kind == "progressive")
        one = par_run_step(torch, trainer, state, kind, batches[kind])
        got = r0["dp"][kind]
        for r in ranks:
            assert r["dp"][kind]["metrics"] == got["metrics"]
            assert torch.equal(r["dp"][kind]["params"], got["params"]), f"{kind}: replicas differ"
        loss_rel = abs(got["metrics"]["loss"] - one["metrics"]["loss"]) / abs(
            one["metrics"]["loss"])
        cos = _min_cosine(torch, got["grads"], one["grads"])
        print(f"[parallel] a. DP {kind} step: loss {got['metrics']['loss']:.6g} vs "
              f"{one['metrics']['loss']:.6g} rel {loss_rel:.3g} (bar {bars['loss_rel']}), "
              f"min gradient cosine {cos:.8f} (bar {bars['cos']}), replicas bit-equal")
        assert loss_rel <= bars["loss_rel"] and cos >= bars["cos"], (kind, loss_rel, cos)
    dp_launches = [r["dp_launches"] for r in ranks]
    assert dp_launches == [len(PAR_STEPS)] * n, dp_launches
    trainer, state = par_trainer(torch, fcfg, base, with_teacher=False)
    single_ms = par_step_ms(torch, trainer.make_diffusion_step(), state,
                            batches["diffusion"], trainer.put_batch)
    out.update(dp_ms=[r["dp_ms"] for r in ranks], single_step_ms=single_ms)
    print(f"[parallel] a. ms per data step, batch 4 x 2 s: DP {per_rank(lambda r: r['dp_ms'])} "
          f"(rank 0 .. {n - 1}, {4 // n} rows each), single device {single_ms:.3f} ({note}); "
          f"frontend launches per rank {dp_launches}")

    # f. the PP step against the single-process step.
    trainer, state = par_trainer(torch, fcfg, base, with_teacher=False)
    one = par_run_step(torch, trainer, state, "diffusion", batches["diffusion"])
    got = {}
    for r in ranks:
        assert r["pp"]["metrics"] == r0["pp"]["metrics"]
        got.update(r["pp"]["grads"])
    assert set(got) == set(one["grads"])
    loss_rel = abs(r0["pp"]["metrics"]["loss"] - one["metrics"]["loss"]) / abs(
        one["metrics"]["loss"])
    cos = _min_cosine(torch, got, one["grads"])
    norm_rel = abs(r0["pp"]["metrics"]["grad_norm"] - one["metrics"]["grad_norm"]) / one[
        "metrics"]["grad_norm"]
    out.update(pp_ms=[r["pp_ms"] for r in ranks])
    print(f"[parallel] f. PP diffusion step ({n} stages x 2 microbatches): loss rel "
          f"{loss_rel:.3g} (bar {bars['loss_rel']}), min gradient cosine {cos:.8f} (bar "
          f"{bars['cos']}), grad_norm rel {norm_rel:.3g} (bar 1e-5); ms per step "
          f"{per_rank(lambda r: r['pp_ms'])}, single device {single_ms:.3f} ({note})")
    assert loss_rel <= bars["loss_rel"] and cos >= bars["cos"] and norm_rel <= 1e-5

    # c. sequence parallel against the single-device call at T = 8000.
    lcfg = par_longform_cfg()
    ldec = seeded_decoder(torch, lcfg, SEED).to(DEVICE)
    lsched = DiffusionSchedule.create(lcfg.diff_steps).to(DEVICE)
    sem, x_T = par_seq_inputs(torch, lcfg, seq_S)

    @torch.inference_mode()
    def single_seq(x=x_T, steps=PAR_SEQ["steps"]):
        return ddim_sample(lsched, lambda x, t, si: ldec(x, t, sem_idx=sem, step_idx=si), x,
                           steps, prediction="eps")

    want = single_seq()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED):
        single_seq()
    torch.cuda.synchronize()
    seq_single_ms = (time.perf_counter() - t0) * 1e3 / PAR_TIMED
    want_one = single_seq(steps=1)
    for r in ranks:
        assert torch.equal(r["seq"]["x0"], r0["seq"]["x0"])
    te = min(2 * seq_S, 2 * seq_S // n + 2 * lcfg.layers * lcfg.attn_window_size)
    out.update(seq_ms=[r["seq"]["ms"] for r in ranks], seq_single_ms=seq_single_ms)
    checks = []
    for label, got, ref, steps in (("1 step", r0["seq"]["x0_one_step"], want_one, 1),
                                   (f"{PAR_SEQ['steps']} steps", r0["seq"]["x0"], want,
                                    PAR_SEQ["steps"])):
        witness = par_witness(lambda x: single_seq(x, steps), x_T, ref)
        bar = max(1e-4, PAR_WITNESS * witness)
        diff = (got - ref.cpu()).abs()
        err, frac = float(diff.max()), float((diff > 1e-4).float().mean())
        checks.append((err, bar, frac))
        print(f"[parallel] c. sequence-parallel T={2 * seq_S}, eps, Te={te} per rank, "
              f"{label}: max err {err:.3g} (bar {bar:.3g}: 1e-4 or {PAR_WITNESS} x the "
              f"one-ulp witness {witness:.3g}), fraction over 1e-4 {frac:.3e} (bar "
              f"{PAR_SEQ_FRAC})")
    print(f"[parallel] c. band launches per rank {[r['seq']['launches'] for r in ranks]}; ms "
          f"per call {per_rank(lambda r: r['seq']['ms'])}, single device "
          f"{seq_single_ms:.3f} ({note})")
    assert all(err <= bar and frac <= PAR_SEQ_FRAC for err, bar, frac in checks), checks
    # The eager decoder takes the band kernel from pallas_min_seq_len frames on.
    seq_launches = lcfg.layers * PAR_SEQ["steps"] * (te >= lcfg.pallas_min_seq_len)
    for r in ranks:
        assert r["seq"]["launches"] == seq_launches, r["seq"]["launches"]
        assert r["seq"]["timed_launches"] == seq_launches * PAR_TIMED
        assert r["seq"]["one_step_launches"] == seq_launches // PAR_SEQ["steps"]
    del ldec

    # d. the TP encode against fast_encode on one device.
    enc = base[0].to(DEVICE)
    w = ff.pack_frontend_weights(enc.hubert.feature_extractor)
    tp_wav = torch.from_numpy(spec["tp_wav"]).to(DEVICE)
    with torch.inference_mode():
        tokens = ff.fast_encode(enc, tp_wav, w)
        feats = enc.extract_hubert(tp_wav, conv_feats=ff.conv_frontend(tp_wav, w))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PAR_TIMED):
            ff.fast_encode(enc, tp_wav, w)
        torch.cuda.synchronize()
    tp_single_ms = (time.perf_counter() - t0) * 1e3 / PAR_TIMED
    feat_err = float((r0["tp"]["features"] - feats.cpu()).abs().max())
    tok = float((r0["tp"]["tokens"] == tokens.cpu()).float().mean())
    out.update(tp_ms=[r["tp"]["ms"] for r in ranks], tp_single_ms=tp_single_ms)
    print(f"[parallel] d. TP encode of a 5 s wav, mesh (1, {n}), q_proj rows "
          f"{r0['tp']['q_rows']}, FFN rows {r0['tp']['ffn_rows']} per rank: layer-9 feature "
          f"max err {feat_err:.3g} (bar 1e-3; features up to "
          f"{float(feats.abs().max()):.3g}), tokens equal {tok:.4%} (bar 99%); ms per encode "
          f"{per_rank(lambda r: r['tp']['ms'])}, single-device fast_encode "
          f"{tp_single_ms:.3f} ({note}); frontend launches per rank "
          f"{[r['tp']['launches'] for r in ranks]}")
    assert all(torch.equal(r["tp"]["tokens"], r0["tp"]["tokens"]) for r in ranks)
    assert feat_err <= 1e-3 and tok >= 0.99
    hc = base[0].hubert_cfg
    assert r0["tp"]["q_rows"] == (hc.hidden_size // n, hc.hidden_size)
    assert r0["tp"]["ffn_rows"] == (hc.intermediate_size // n, hc.hidden_size)
    assert all(r["tp"]["launches"] == 2 for r in ranks)  # the encode and the features
    assert all(r["tp"]["timed_launches"] == PAR_TIMED for r in ranks)
    del enc

    # b. train() on the [n, 1] mesh: rank 0 writes, the replicas agree after every update.
    t0 = r0["train"]
    assert all(r["train"]["writes"] == [] for r in ranks[1:])
    assert "checkpoint_final" in {x.removesuffix(".tmp") for x in t0["writes"]}
    assert t0["hashes"] and all(r["train"]["hashes"] == t0["hashes"] for r in ranks), \
        "replicas differ after an update"
    assert os.path.isfile(os.path.join(t0["run_dir"], "edge_model_final", "decoder.pt"))
    out.update(train_s=t0["seconds"], train_steps=t0["step"])
    print(f"[parallel] b. train() on mesh [{n}, 1]: {t0['step']} data steps, "
          f"{len(t0['hashes'])} updates, parameters bit-equal across ranks after each; rank 0 "
          f"wrote {len(t0['writes'])} checkpoint states, the others none; "
          f"{t0['seconds']:.3f} s ({note}); frontend launches per rank "
          f"{[r['train']['launches'] for r in ranks]}")

    # e. make_dp_generate in this process: 8 flagship token rows over a device list.
    engine = EdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps), decoder,
                           backend="fused", device=DEVICE)
    rows = torch.from_numpy(rng.randint(0, cfg.effective_codebook_size(), (8, 250))).to(DEVICE)
    x8 = torch.from_numpy(rng.randn(8, 500, cfg.n_mels).astype(np.float32)).to(DEVICE)
    mask = torch.ones(rows.shape, dtype=torch.bool, device=DEVICE)
    for i in range(8):
        mask[i, 250 - 20 * i:] = False
    devices = [f"cuda:{i}" for i in range(n)] if per_card else [DEVICE, DEVICE]
    unmasked, masked = make_dp_generate(engine, devices), make_dp_generate(
        engine, devices, masked=True)
    want_u = engine.generate_mel(rows, 4, x_T=x8)
    want_m = engine.generate_mel(rows, 4, x_T=x8, sem_mask=mask)
    fd.fused_ddim.launches = 0
    got_u = unmasked(rows, 4, x_T=x8)
    torch.cuda.synchronize()
    fused_launches = fd.fused_ddim.launches
    got_m = masked(rows, 4, x_T=x8, sem_mask=mask)
    torch.cuda.synchronize()
    assert fd.fused_ddim.launches == fused_launches == len(devices), fd.fused_ddim.launches
    for label, got, want in (("unmasked (fused)", got_u, want_u), ("masked", got_m, want_m)):
        diff = (got - want).abs()
        err, frac = float(diff.max()), float((diff > 2e-4).float().mean())
        print(f"[parallel] e. make_dp_generate {label}, 8 rows over {devices}, 4 steps: "
              f"max err {err:.3g} (bar 0.05), fraction over 2e-4 {frac:.3e} (bar 1e-3; "
              f"phase 3's rule for v)")
        assert err <= 0.05 and frac <= 1e-3 and torch.isfinite(got).all()

    out["seconds"] = time.perf_counter() - t_phase
    print(f"[parallel] phase 11: {out['seconds']:.3f} s (the ranks {ranks_s:.3f} s)")
    out["frontend_launches"] = sum(
        r["dp_launches"] + r["dp_timed_launches"] + r["pp_launches"] + r["tp"]["launches"]
        + r["tp"]["timed_launches"] + r["train"]["launches"] for r in ranks)
    out["banded_launches"] = sum(r["seq"]["launches"] + r["seq"]["timed_launches"]
                                 + r["seq"]["one_step_launches"] for r in ranks)
    out["fused_launches"] = fused_launches
    return out


PHASE12_TIMEOUT_S = 300  # the serve subprocess's wait for "serving on"


def _cli(argv, tag: str):
    """``cli.main(argv)`` in this process: its standard output (echoed with
    ``tag``) and its wall time in s."""
    import contextlib
    import io

    from edge_diffusion_tts_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"[cli] {tag}| {line}")
    print(f"[cli] {tag}: {secs:.3f} s wall")
    return out, secs


def _refused(argv, tag: str, words: str) -> None:
    """``cli.main(argv)`` must exit with a message holding ``words``."""
    from edge_diffusion_tts_tpu_torch import cli

    try:
        cli.main(argv)
    except SystemExit as e:
        assert words in str(e), f"{tag}: exit message {e}"
        print(f"[cli] {tag}: exits with {str(e)[:110]!r}")
        return
    raise AssertionError(f"{tag}: ran instead of exiting")


def _write_wav16(path: str, wav) -> str:
    from scipy.io import wavfile

    wavfile.write(path, 16000, (np.clip(wav, -1.0, 1.0) * 32767).astype(np.int16))
    return path


def _start_server(ckpt: str, dev_flag: list):
    """``python -m edge_diffusion_tts_tpu_torch.cli serve`` on a free port with
    one bucket; returns (process, port, queue of its output lines)."""
    import queue
    import socket
    import threading

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "edge_diffusion_tts_tpu_torch.cli", "serve", ckpt, "--port",
         str(port), "--buckets", "128"] + dev_flag,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line.rstrip())

    threading.Thread(target=pump, daemon=True).start()
    return proc, port, lines


def _await_server(proc, lines, t_start: float) -> float:
    """Wait for the server's "serving on" line; its seconds since start."""
    import queue

    deadline = t_start + PHASE12_TIMEOUT_S
    while True:
        left = deadline - time.perf_counter()
        assert left > 0, "serve: no 'serving on' line in time"
        try:
            line = lines.get(timeout=min(left, 1.0))
        except queue.Empty:
            assert proc.poll() is None, f"serve exited with {proc.returncode}"
            continue
        print(f"[cli] serve| {line}")
        if line.startswith("serving on"):
            return time.perf_counter() - t_start


def _decoder_vs_program(torch, program, decoder, shapes, seed: int) -> float:
    """Largest |program - decoder| over ``shapes`` (B, T, S) on the card."""
    rng = np.random.RandomState(seed)
    err = 0.0
    for B, T, S in shapes:
        x = torch.from_numpy(rng.randn(B, T, 80).astype(np.float32)).to(DEVICE)
        t = torch.from_numpy(rng.randint(0, 1000, B)).to(DEVICE)
        sem = torch.from_numpy(rng.randint(0, 2304, (B, S))).to(DEVICE)
        step = torch.from_numpy(rng.randint(0, 4, B)).to(DEVICE)
        with torch.no_grad():
            got = program(x, t, sem, step)
            want = decoder(x, t, sem_idx=sem, step_idx=step)
        assert got.shape == want.shape == (B, T, 80) and torch.isfinite(got).all()
        err = max(err, (got - want).abs().max().item())
    return err


def phase_cli(torch, train_cuts=None):
    """Phase 12: the command line on the card (the module docstring's phase
    12) from phase 9's checkpoint and phase 10's corpus; returns its
    conv-frontend and fused-DDIM launches and the subcommands' wall times."""
    import shutil

    from scipy.io import wavfile

    from edge_diffusion_tts_tpu_torch import bench, demo
    from edge_diffusion_tts_tpu_torch.config import hubert_num_frames
    from edge_diffusion_tts_tpu_torch.data import load_wav
    from edge_diffusion_tts_tpu_torch.inference import EdgeInference
    from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder, SemanticEncoder
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
    from edge_diffusion_tts_tpu_torch.pipeline import LongFormPipeline
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
    from edge_diffusion_tts_tpu_torch.serving import request_tts
    from edge_diffusion_tts_tpu_torch.utils.audio import denormalize_mel, normalize_mel
    from edge_diffusion_tts_tpu_torch.utils.export import load_exported
    from edge_diffusion_tts_tpu_torch.utils.quantize import load_quantized
    from edge_diffusion_tts_tpu_torch.weights import load_checkpoint

    t_phase = time.perf_counter()
    ckpt = os.path.join(ROOT, "build", "serve_checkpoint")
    lj = os.path.join(ROOT, "build", "phase10", "LJSpeech-1.1")
    base = os.path.join(ROOT, "build", "phase12")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    # The card is every command's default; a CPU rehearsal names its device.
    dev_flag = [] if DEVICE == "cuda" else ["--device", DEVICE]
    launches = {"frontend": 0, "fused": 0}
    walls = {}

    def count(**expected):
        """Add this run's launches (their counts set to 0 before it)."""
        got = {"frontend": ff.conv_frontend.launches, "fused": fd.fused_ddim.launches}
        for k, want in expected.items():
            assert got[k] == want, f"{k} launches {got[k]}, expected {want}"
        for k in launches:
            launches[k] += got[k]

    def zero():
        ff.conv_frontend.launches = fd.fused_ddim.launches = 0

    t_serve = time.perf_counter()
    proc, port, lines = _start_server(ckpt, dev_flag)  # warms while the rest runs
    try:
        cfg, dec_sd, hubert_cfg, enc_sd = load_checkpoint(ckpt, with_encoder=True)
        decoder = EdgeDiffusionDecoder(cfg)
        decoder.load_state_dict(dec_sd)
        encoder = SemanticEncoder(cfg, hubert_cfg)
        encoder.load_state_dict(enc_sd)
        schedule = DiffusionSchedule.create(cfg.diff_steps)
        prediction = "v" if cfg.use_v_prediction else "eps"
        engine = EdgeInference(cfg, schedule, decoder, prediction=prediction, device=DEVICE,
                               encoder=encoder)
        assert engine.encode_route == "kernel", engine.encode_route

        # -- a. generate ------------------------------------------------------------
        w5 = _write_wav16(os.path.join(base, "ref_5s.wav"), synthetic_wav(5.0, 12000 + SEED))
        wav5 = torch.as_tensor(load_wav(w5)[0], device=DEVICE)
        mels, vocode = [], demo.vocode_mel

        def capture(cfg_, mel_log, *a, **kw):
            mels.append(mel_log.clone())
            return vocode(cfg_, mel_log, *a, **kw)

        demo.vocode_mel = capture
        try:
            for flags in ([], ["--oracle"], ["--post-filter"]):
                out_wav = os.path.join(base, f"generated{''.join(flags)}.wav")
                zero()
                _, walls[f"generate{' '.join([''] + flags)}"] = _cli(
                    ["generate", ckpt, "--wav", w5, "--steps", "4", "--out", out_wav] + flags
                    + dev_flag, f"generate{' '.join([''] + flags)}")
                count(frontend=0 if flags == ["--oracle"] else 1)
                sr, got = wavfile.read(out_wav)
                n = wav5.shape[0] if flags == ["--oracle"] else (
                    2 * hubert_num_frames(wav5.shape[0]) - 1) * cfg.hop_length
                assert sr == cfg.sample_rate and got.dtype == np.int16 and got.shape == (n,), (
                    sr, got.dtype, got.shape)
                assert np.abs(got).max() > 0, "a silent wav"
        finally:
            demo.vocode_mel = vocode
        mel_n = engine.generate_from_audio(
            wav5, num_steps=4, generator=torch.Generator(device=DEVICE).manual_seed(0))
        _, mean, std = normalize_mel(demo._mel_frontend(cfg, DEVICE)(wav5[None]))
        gen_err = (mels[0] - denormalize_mel(mel_n, mean, std)).abs().max().item()
        print(f"[cli] generate: its mel vs generate_from_audio (seed 0): max err {gen_err:.3g} "
              f"(bar 1e-5); wav of {n} samples")
        assert gen_err <= 1e-5, gen_err
        eps_ckpt = os.path.join(base, "eps_checkpoint")
        shutil.copytree(ckpt, eps_ckpt, copy_function=os.link)
        with open(os.path.join(eps_ckpt, "cfg.json"), "w") as f:
            f.write(type(cfg).from_dict(dict(cfg.to_dict(), use_v_prediction=False)).to_json())
        _refused(["generate", eps_ckpt, "--wav", w5, "--sampler", "dpmpp", "--out",
                  os.path.join(base, "never.wav")] + dev_flag, "generate --sampler dpmpp (eps)",
                 "v-prediction")

        # -- b. export --format pt2 -------------------------------------------------
        pt2 = os.path.join(base, "edge_model.pt2")
        _, walls["export pt2"] = _cli(["export", ckpt, "--out", pt2] + dev_flag, "export pt2")
        program = load_exported(pt2, device=DEVICE)
        pt2_err = _decoder_vs_program(torch, program, engine.decoder,
                                      ((1, 500, 250), (2, 200, 100)), 12100 + SEED)
        print(f"[cli] export pt2: {os.path.getsize(pt2) / 1e6:.2f} MB; on the card vs the eager "
              f"decoder at (1,500,250), (2,200,100): max err {pt2_err:.3g} (bar 1e-5)")
        assert pt2_err <= 1e-5, pt2_err

        # -- c. export --format weight-int8 ------------------------------------------
        npz = os.path.join(base, "edge_model.int8.npz")
        out, walls["export weight-int8"] = _cli(
            ["export", ckpt, "--format", "weight-int8", "--out", npz] + dev_flag,
            "export weight-int8")
        report = json.loads(out.splitlines()[0])
        deq = EdgeDiffusionDecoder(cfg)
        deq.load_state_dict(load_quantized(npz))
        rng = np.random.RandomState(12200 + SEED)
        sem = torch.from_numpy(rng.randint(0, cfg.effective_codebook_size(), (1, 250)))
        x_T = torch.from_numpy(rng.randn(1, 500, cfg.n_mels).astype(np.float32))
        runs = {}
        zero()
        for name, dec, backend in (("int8 fused", deq, "fused"), ("int8 eager", deq, "eager"),
                                   ("f32 fused", engine.decoder, "fused")):
            runs[name] = EdgeInference(cfg, schedule, dec, prediction=prediction,
                                       backend=backend, device=DEVICE).generate_mel(
                sem, num_steps=4, x_T=x_T)
        torch.cuda.synchronize()
        count(fused=2)
        diff = (runs["int8 fused"] - runs["int8 eager"]).abs()
        err, frac = diff.max().item(), (diff > 2e-4).float().mean().item()
        # Phase 3's rule (eps: 2e-4 on all; v: 2e-4 on 99.9%, 0.05 on all).
        assert (err <= 2e-4) if prediction == "eps" else (frac <= 1e-3 and err <= 0.05), (
            err, frac)
        l1 = (runs["int8 fused"] - runs["f32 fused"]).abs().mean().item()
        assert np.isfinite(l1)
        print(f"[cli] weight-int8: report {json.dumps(report)[:200]}; fused vs eager on the "
              f"dequantized weights ({prediction}): max err {err:.3g}, {frac:.2e} of elements "
              f"over 2e-4 (phase 3's rule); 4-step mel L1 int8 vs float32 {l1:.4g} beside the "
              f"JAX package's stated budget 1e-2 (random weights, no quality claim)")

        # -- d. bench ---------------------------------------------------------------
        zero()
        out, walls["bench"] = _cli(["bench"] + dev_flag, "bench")
        line = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
        assert line["metric"] == "4step_melgen_latency_5s" and line["unit"] == "ms"
        assert line["backend"] in bench.BACKENDS and line["value"] > 0, line
        count(fused=bench.WARMUP + 2 * bench.RUNS)

        # -- e. longform --stream ---------------------------------------------------
        w10 = _write_wav16(os.path.join(base, "ref_10s.wav"), synthetic_wav(10.0, 12300 + SEED))
        lf_out = os.path.join(base, "longform.wav")
        sizes, stream = [], LongFormPipeline.generate_streaming_audio

        def watched(self, *a, **kw):
            for item in stream(self, *a, **kw):
                sizes.append(os.path.getsize(lf_out))
                yield item
            sizes.append(os.path.getsize(lf_out))

        LongFormPipeline.generate_streaming_audio = watched
        try:
            zero()
            out, walls["longform --stream"] = _cli(
                ["longform", ckpt, w10, "--stream", "--out", lf_out] + dev_flag,
                "longform --stream")
            count(frontend=1)
        finally:
            LongFormPipeline.generate_streaming_audio = stream
        with open(lf_out, "rb") as f:
            head = f.read(44)
        n_data = int(np.frombuffer(head[40:44], "<u4")[0])
        assert head[:4] == b"RIFF" and head[8:16] == b"WAVEfmt " and head[36:40] == b"data"
        assert int(np.frombuffer(head[4:8], "<u4")[0]) == 36 + n_data == sizes[-1] - 8
        assert sizes[0] == 44 and all(b > a for a, b in zip(sizes, sizes[1:])), sizes
        sr, got = wavfile.read(lf_out)
        assert sr == 16000 and got.shape == (160000,), got.shape
        first = [ln for ln in out.splitlines() if "first audio" in ln]
        assert first, "no first-audio line"
        print(f"[cli] longform --stream: {len(sizes) - 1} increments, the file {sizes} bytes "
              f"as each was asked for; {first[0].strip()}")

        # -- f. precompute ----------------------------------------------------------
        shutil.rmtree(os.path.join(lj, "hubert_features"), ignore_errors=True)
        zero()
        _, walls["precompute --limit 4"] = _cli(["precompute", lj, "--limit", "4"] + dev_flag,
                                                "precompute --limit 4")
        count(frontend=4)
        feats = sorted(os.listdir(os.path.join(lj, "hubert_features")))
        assert len(feats) == 4, feats
        for name in feats:
            a = np.load(os.path.join(lj, "hubert_features", name)).astype(np.float32)
            assert a.ndim == 2 and a.shape[1] == 768 and np.isfinite(a).all(), (name, a.shape)

        # -- g. migrate -------------------------------------------------------------
        pt = os.path.join(base, "edge_model_final.pt")
        torch.save({
            "decoder": dec_sd,
            "encoder_proj": {f"{i}.{p}": enc_sd[f"{m}.{p}"] for i, m in
                             (("0", "proj_fc1"), ("2", "proj_ln"), ("3", "proj_fc2"))
                             for p in ("weight", "bias")},
            "encoder_vq": {k[len("vq."):]: v for k, v in enc_sd.items() if k.startswith("vq.")},
            "cfg": dict(cfg.to_dict(), use_depthwise=True),
        }, pt)
        migrated = os.path.join(base, "migrated")
        _, walls["migrate"] = _cli(["migrate", pt, migrated], "migrate")
        mcfg, mdec, _, _ = load_checkpoint(migrated)
        assert set(mdec) == set(dec_sd) and all(torch.equal(mdec[k], v)
                                                for k, v in dec_sd.items())
        menc = torch.load(os.path.join(migrated, "encoder.pt"), weights_only=True)
        assert not any(k.startswith("hubert.") for k in menc), "HuBERT weights written"
        assert all(torch.equal(menc[k], enc_sd[k]) for k in menc)
        assert mcfg.use_depthwise is False
        _refused(["generate", migrated, "--wav", w5, "--out", os.path.join(base, "never.wav")]
                 + dev_flag, "generate (migrated, no HuBERT)", "--hubert-id")
        print(f"[cli] migrate: decoder bit-equal ({len(mdec)} tensors), encoder projection and "
              f"FSQ bit-equal ({len(menc)} tensors), no HuBERT weights")

        # -- h. serve (the subprocess started above) --------------------------------
        ready_s = _await_server(proc, lines, t_serve)
        toks = np.random.RandomState(12400 + SEED).randint(0, cfg.effective_codebook_size(), 100)
        t0 = time.perf_counter()
        mel = request_tts(toks, port=port)
        req_ms = (time.perf_counter() - t0) * 1e3
        assert mel.shape == (200, cfg.n_mels) and np.isfinite(mel).all(), mel.shape
        walls["serve ready"] = ready_s
        print(f"[cli] serve (subprocess, bucket 128): ready {ready_s:.3f} s after start; one "
              f"request_tts of 100 tokens answered in {req_ms:.3f} ms")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    # -- i. train --config ... --export --------------------------------------------
    with open(os.path.join(ROOT, "configs", "flagship.json")) as f:
        flagship = json.load(f)
    tcfg = dict(flagship, **dict(PAR_TRAIN_CUTS, **(train_cuts or {})),
                out_dir=os.path.join(base, "out"), run_name="cli", ljspeech_dir=lj,
                data_root=os.path.dirname(lj), ckpt_path="")
    cfg_path = os.path.join(base, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(tcfg, f)
    zero()
    _, walls["train --export"] = _cli(["train", "--config", cfg_path, "--export"] + dev_flag,
                                      "train --export")
    train_frontend = ff.conv_frontend.launches
    assert train_frontend >= 80 or train_cuts, train_frontend
    count()
    run_dir = os.path.join(base, "out", "cli")
    tcfg_, tdec_sd, _, _ = load_checkpoint(os.path.join(run_dir, "edge_model_final"))
    tdec = EdgeDiffusionDecoder(tcfg_)
    tdec.load_state_dict(tdec_sd)
    program = load_exported(os.path.join(run_dir, "edge_model.pt2"), device=DEVICE)
    train_err = _decoder_vs_program(torch, program, tdec.to(DEVICE).eval(),
                                    ((1, 500, 250), (2, 200, 100)), 12500 + SEED)
    print(f"[cli] train --export: {train_frontend} frontend launches; edge_model.pt2 vs the "
          f"final decoder: max err {train_err:.3g} (bar 1e-5)")
    assert train_err <= 1e-5, train_err
    walls["phase"] = time.perf_counter() - t_phase
    print(f"[cli] phase 12: {walls['phase']:.3f} s; walls "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
          + f"; launches {launches}")
    return dict(launches=launches, walls=walls)


def run(torch) -> None:
    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build()
    banded = phase_banded(torch)

    cfg = CFG(dropout=0.0)
    decoder = seeded_decoder(torch, cfg, SEED).to(DEVICE)
    schedule = DiffusionSchedule.create(cfg.diff_steps)
    fused = phase_fused(torch, cfg, decoder, schedule.to(DEVICE))
    fused_launches, _ = phase_main_path(torch, cfg, decoder, schedule, fused)
    banded_launches = phase_longform(torch)
    encoder = seeded_encoder(torch, cfg, SEED).to(DEVICE)
    frontend = phase_frontend(torch, encoder)
    frontend_launches, _ = phase_audio(torch, cfg, decoder, schedule, encoder)
    ddpm = phase_ddpm(torch, cfg, decoder)
    serve = phase_serve(torch, cfg, decoder, encoder)
    trained = phase_train(torch)
    par = phase_parallel(torch, cfg, decoder)
    cli_run = phase_cli(torch)

    b = banded[BAND_SHAPES[1]]  # ms: device time by CUDA-graph replay
    kernels = [
        {"name": "banded_attention", "route": "cuda",
         "source": "edge_diffusion_tts_tpu_torch/csrc/band_attention.cu",
         "replaces": "edge_diffusion_tts_tpu/ops/window_attention.py:48",
         "launches": banded_launches + par["banded_launches"],
         "max_abs_err": max(r["max_abs_err"] for r in banded.values()),
         "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
         "bound_by": b["bound_by"], "library_ms": b["library_ms"]},
        {"name": "fused_ddim", "route": "cuda",
         "source": "edge_diffusion_tts_tpu_torch/csrc/fused_ddim.cu",
         "replaces": "edge_diffusion_tts_tpu/ops/fused_denoise.py:127",
         "launches": fused_launches + trained["fused_launches"] + par["fused_launches"]
         + cli_run["launches"]["fused"],
         "max_abs_err": fused["eps"]["max_abs_err"],
         "ms": fused["eps"]["ms"], "plain_ms": fused["eps"]["plain_ms"],
         "bound_ms": fused["bound_ms"], "bound_by": fused["bound_by"],
         "library_ms": None},
        {"name": "conv_frontend", "route": "cuda",
         "source": "edge_diffusion_tts_tpu_torch/csrc/conv_frontend.cu",
         "replaces": "edge_diffusion_tts_tpu/ops/fused_frontend.py:123",
         "launches": frontend_launches + serve["frontend_launches"]
         + trained["frontend_launches"] + par["frontend_launches"]
         + cli_run["launches"]["frontend"],
         "max_abs_err": max(r["max_abs_err"] for r in frontend.values()),
         **{k: frontend[(1, 80000)][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None},
        {"name": "fused_ddpm", "route": "cuda",
         "source": "edge_diffusion_tts_tpu_torch/csrc/fused_ddim.cu",
         "replaces": "edge_diffusion_tts_tpu/ops/fused_denoise.py:234",
         **{k: ddpm[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by")},
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "edge_diffusion_tts_tpu_torch", "csrc")):
        print("chip_smoke: the port package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        run(torch)
    except Exception:  # any failed phase: report it and print no result
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
