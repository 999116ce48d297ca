#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (edge_diffusion_tts_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, each asserting:

1. the card (nvidia-smi name and power limit) and the build of every CUDA
   kernel from csrc/ (one nvcc per source, in parallel), with its time;
   then the libraries' machine code (``cuobjdump --dump-sass``,
   ``SASS_CHECKS``): every instance of the bf16 step GEMM
   (csrc/gemm_wgmma.cuh) and of the bf16 frontend's conv GEMM
   (csrc/conv_wgmma.cuh) runs warpgroup products (HGMMA) and TMA loads
   (UTMALDG), every instance of the bf16 step attention
   (csrc/attention16.cuh), of the bf16 band kernel (csrc/band16.cuh) and of
   the frontend's mma.sync tile tensor-core products (HMMA);
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
   then the bf16 kernel (csrc/band16.cuh, tensor cores, P kept to ~16
   bits) at [1,4,4000,40] on phase 2's inputs rounded to
   bf16: against the plain version on the same bf16 q, k, v (within 2e-5 +
   one bf16 ulp of each output) and against the float32 plain version on
   the float32 inputs by the witness rule (no farther, normwise, than 1.5
   times the bf16 plain version's distance + 1e-3, and the two-sided bars
   of ``witness16``), on strided views (=
   the contiguous call), two calls bit-equal; graph-replay ms beside the
   float32 kernel's and in each built tile, the plain version's ms,
   band-masked SDPA on the same bf16 q, k, v, the bound (the products on
   tensor cores: bytes bound it; the float32-FMA bound of the earlier kernel
   beside it); then the crossover against SDPA on bf16 at T = 500-4000;
3. the fused DDIM kernel against its plain version at the flagship shape
   (hidden 160, 4 layers, 4 heads of 40, window 64; B=1, S=250, T=500,
   4 steps), eps and v prediction (tolerances below), twice: the default
   decoder (no pre-net) and configs/flagship.json's (the depthwise pre-net
   on, weights and inputs from PRENET_SEED); the kernel launches per decoder
   step (asserted: 2 + 8 * layers + 1, 35 at 4 layers, and 3 more with the
   pre-net, 38); with the pre-net, its three kernels alone
   (``decoder_prenet``) held to ``decoder_prenet_plain`` (atol 1e-5) and
   timed by CUDA-graph replay beside the step; without it, each
   GEMM of the step alone (``decoder_gemm``) at its flagship shape, held to
   ``decoder_gemm_plain`` (atol 1e-5, rtol 1e-5) and timed in the host's
   tile, with its blocks per launch, beside ``torch.nn.functional.linear``
   at the same shape with TF32 off (a yardstick only, never called by the port),
   each as device time: calls captured in a CUDA graph and replayed between
   CUDA events, since one call from Python costs the host more than the
   kernel costs the card.  Then the bf16 variant (``compute_dtype=
   torch.bfloat16``) for the default decoder at B=1, the pre-net decoder at
   B=1 and the default decoder at B=8 (4,000 rows): ``fused_generate_mel``
   at bf16, its launch counted, equal to ``fused_ddim`` on the same inputs;
   eps and v held by the witness rule against the float32 plain version
   with the bf16 plain version as the witness (v also by the two-sided
   bars of ``witness16``; eps's first step clips every x0, and the bf16
   and float32 trajectories part after it); 35 / 38 launches per step;
   two calls bit-equal; its ms beside the float32 kernel's at the same
   shape (CUDA events), the bf16 plain version's, the bound (every product
   at 989 TFLOP/s, since each takes bf16 operands; the time with the
   attention at the float32 FMA rate, as this kernel runs it, beside it);
   each bf16 call's kernels by kind (``kernel_launches(kind)``, set to 0
   just before the entry point and read just after: 2L tensor-core
   attentions per step, its 2 + 6L GEMMs, one more with the pre-net, in the
   wgmma kernel or gemm16_kernel); without the pre-net each step GEMM's
   bf16 variant alone (the step's operand and output dtypes; 1e-3 normwise
   of the bf16 plain version) in the host's tile, in the mma.sync kernel's
   own (``gemm16_kernel`` and its own rule) and in the wgmma kernel's
   own, beside ``F.linear`` on the same bf16 operands and the wgmma kernel
   in every tile, at 500 and 4,000 rows, with the float32 GEMMs at 4,000
   rows; and the step's attentions alone (``step_attention``: the
   self-attention and the cross-attention at B rows of T=500, S=250), the
   tensor-core kernel beside the float32-FMA kernel the bf16 step ran
   before and band-masked ``scaled_dot_product_attention`` on the same
   bf16 q, k, v, held to ``_attention_rounded`` by the two-sided witness
   bars (0.5-1.25 of its distance from float32, within 2 of it);
4. the main path at configs/flagship.json's decoder (the pre-net on, v
   prediction): ``EdgeInference(backend="fused").generate_mel`` answers
   three requests; outputs finite, one fused launch per request; the two
   requests with a given x_T held to the eager backend on the same weights
   by phase 3's v rule (0.05 on all elements, 2e-4 on 99.9%: phase 4's
   bar);
5. the long-form shape (configs/longform.json, S=2000 -> T=4000) through
   ``backend="eager"``, 4 steps: one banded launch per layer per step, and
   the same output as with the banded route forced to its plain version
   (atol 1e-4), with the call's time on each route; then the same call
   with the decoder built at compute bf16 (its float32 weights): 16 launches
   of the bf16 band kernel and none of the float32 one, held
   by the witness rule and the two-sided bars against the float32 decoder's
   plain route with its own plain route as the witness;
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
   6b. the frontend's bf16 variant (``compute_dtype=torch.bfloat16``: conv0
   in float32, conv1-6 on tensor cores, bf16 activations; the tile rule's
   wgmma layers counted, ``ff.wgmma_launches``) at [1, 80000] and
   [256, 32000] (a training batch), without and with a per-row ``wav_len``:
   against ``conv_frontend_plain(compute_dtype=bf16)`` on the card, within
   1e-2 normwise, and against the float32 plain version by the witness rule
   (no farther than 1.5 times the bf16 plain version's distance + 1e-3:
   rounding flips in the two summation orders compound over six layers, so
   no elementwise bar holds); two calls bit-equal; device time by CUDA-graph
   replay beside the float32 kernels' at the same shape, the plain
   version's, and the bound at 989 TFLOP/s; then each layer alone (1e-3
   normwise, at most 1e-4 of the elements over 2^-7 of their value + 1e-5)
   with its µs, TFLOP/s and bound beside ``F.conv1d`` on the same bf16
   operands (a yardstick the port never calls; their sum printed: no single
   call computes the frontend), and every tile of the rule's table
   (``FRONTEND_BF16_TILES``) forced by index, the plan's marked;
7. the audio path: ``EdgeInference(backend="fused", encoder=...)`` at full
   HuBERT-base width answers three ``generate_from_audio`` requests (5 s at
   B=1, the same at temperature 0.7, 2 s at B=2), each one frontend and one
   fused-DDIM launch; the kernel route's layer-9 features are held to the
   module route's to atol 1e-3 and its FSQ tokens agree on >= 99% (an
   exact-GroupNorm vs analytical-GroupNorm difference can flip a token that
   sits on a rounding edge);
8. DDPM: the fused DDPM kernel against its plain version over the 50-step
   schedule at the flagship shape, injected and Philox noise (tolerance
   below), for the default decoder and for phase 3's pre-net decoder, with
   the plain version on the CPU beside the plain version on the card as a
   witness of that tolerance; then
   ``FusedEdgeInference.sample_ddpm`` over the full 1000-step schedule at
   B=1, S=250: one launch per call, finite, the same output for the same
   generator seed and another for another seed; and the 1000-step kernel
   against its plain version (Philox noise, same key), held to the same rule,
   with both printed against the plain version in float64 (weights, inputs
   and coefficients cast; the same Philox draws) as a witness of how far
   each float32 route is from the exact trajectory; then the bf16 variant:
   ``fused_ddpm_sample(compute_dtype=torch.bfloat16)`` over 1000 steps, one
   launch, the same output for the same generator seed, and ``fused_ddpm``
   at bf16 on the float32 check's key held by the witness rule against that
   1000-step float32 plain run with the bf16 plain version as the witness,
   two-sided (normwise: the trajectory magnifies every rounding flip), its
   ms beside
   the float32 kernel's, the bf16 plain version's, the bound; the bf16
   entry point's kernels counted by kind as phase 3's;
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
   8 s bucket against an exact-length prep: the FSQ's input projection
   1e-4 at the valid latents, the tokens >= 99% equal (phase 7's rule: the
   bucket changes the HuBERT's row count, so a token on a rounding edge may
   flip), z_q bit for bit where the tokens agree and zero past the valid
   latents, the chunks' mean and std bit for bit (computed from the
   unpadded wav, which the bucket does not touch); the kernel route's FSQ indices
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
   them (no frontend launch; the shipped config, pre-net included); one
   diffusion loss and its gradients at flagship width, dropout 0, on the
   card against the CPU (loss rtol 1e-4, every gradient cosine >=
   0.99999); both runs' final models loaded with
   ``weights.load_checkpoint`` and served by ``backend="fused"`` (one
   launch each, finite), the first run's held to the eager backend on the
   same x_T by phase 4's bar.  Printed: ms per data step
   per phase (the mean of the steady steps' host-clock intervals) and
   utterances/s, the precomputed path apart, peak
   ``torch.cuda.max_memory_allocated``, wall times.  Its frontend launches
   and its two fused launches join the ``kernels`` line;
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
   labelled "two ranks on one card over gloo: no scaling claim".  g. the
   bf16 pass (``par_rank_bf16``, ``parallel_bf16``), each part against the
   single device at compute bf16 by the witness rule, float32's single
   device as Q32 (normwise ``|Q - Q32| <= 1.5 |Q_one,bf16 - Q32| + 1e-3``),
   every check made and printed before any miss fails the phase: a's three
   DP steps and f's PP step at compute bf16 with float32 and with bf16
   parameters (loss, the whole gradient, parameters after the update,
   ``grad_norm``; each DP gradient tensor within 2^-8, normwise, of its
   oracle, each rank's rows stepped alone on the card and their float32
   mean rounded to the parameters' dtype; each PP gradient tensor's cosine
   to float32's within 0.01 of its oracle's, one device running the blocks
   per microbatch (``par_microbatched``); replicas bit-equal; the stage
   decoders at the source's dtypes; one bf16 frontend launch per rank per
   step, none of the float32 one); c at a bf16-compute decoder (the bf16
   band kernel, 16 launches per rank); d by a bf16 encoder on the kernel
   route (the bf16 frontend; tokens by the share rule, share(tok == tok32)
   >= the one device's - 0.02, features by the witness rule); b
   ``train()`` at configs/tpu_large_batch.json as shipped (compute bf16,
   parameters float32, batch 256 = 128 rows per rank, 2 s) on mesh [2, 1]
   (an override, the file untouched) on phase 14's corpus, one epoch per
   phase and the halvings cut to 1000 -> 500 -> 250 (8 data steps): the
   replicas' parameters bit-equal after every update, one bf16 frontend
   launch per rank per data step, ms per data step beside phase 14's
   single card (phase 14 runs before phase 11 for its corpus and its
   times).  Its launches join the ``kernels`` line, the bf16 ones in the
   ``conv_frontend_bf16`` and ``banded_attention_bf16`` rows;
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
13. the TFLite edge export on this machine, which has no TensorFlow (the
   export needs none: the port lowers the decoder's static program and
   writes the flatbuffer itself; nothing runs the artifact here).  A
   checkpoint of configs/flagship.json (the depthwise pre-net on; phase 9's
   decoder is the default config, without it) with ``seeded_decoder``'s
   weights goes to build/phase13.  At (1,200,100) and (1,500,250), for
   each mode "", "weight_int8", "dynamic" and "int8" (the calibrated full
   integer artifact, on ``synthetic_representative_batches``):
   ``export_tflite``; the artifact read back with the port's reader; for
   "int8", every Linear's and convolution's codes and scales equal to
   ``symmetric_per_channel`` of the decoder's weight, every other named
   int8 constant (norm weights, embedding tables) to the per-tensor rule
   (``tflite_int8.asymmetric``) on its weight, every bias int32 at its own
   scales, and the artifact smaller than weight_int8's; else every float constant named
   after a decoder weight equal to that weight (the dequantized one for
   weight_int8) or a transpose of it, bit for bit, and every weight but
   ``sem_proj`` (not in the graph) present; every int8 tensor and its
   per-channel scales equal to ``quantize_decoder_params``'s codes (for
   dynamic, where the pass also takes the sensitive weights, to the same
   rule, ``symmetric_per_channel``, on the float weight), bit for bit; a
   second export byte-equal.  ``cli.main(["export", ..., "--format",
   "tflite"])`` writes the API's bytes (float and ``--quantize int8`` at
   the default shape, dynamic with ``--t-frames 500 --s-tokens 250``).
   TensorFlow is
   never imported.  Printed per mode and shape: export s (both exports),
   bytes and the first 16 hex digits of their sha256, operators, int8
   tensors.  No kernel launches: the ``kernels``
   line is unchanged.
14. (run after phase 10, before phase 11, whose bf16 pass trains on its
   corpus) training at configs/tpu_large_batch.json (batch 256 x 2 s, compute
   bf16, parameters float32, the depthwise pre-net) on a synthetic
   LJSpeech-layout corpus (build/phase14: 560 utterances, two full batches
   per epoch), epochs cut to one per phase (2 diffusion, 16 progressive
   over 8 halvings, 2 consistency data steps) and a periodic checkpoint at
   step 12; the full HuBERT-base frozen on the frontend's bf16 variant.  a.
   ``train()``: the phase tags, every logged loss finite, the modules bf16
   and the parameters float32 at every phase end, one bf16 frontend launch
   per data step and no float32 one (the counts set to 0 just before,
   read just after: the bf16 kernel's main path), and at least as many
   launches of the wgmma conv kernel (csrc/conv_wgmma.cuh); ms per data step per
   phase (host clock, the intervals after a step of the same epoch), peak
   memory, one batch's collate on the host.  b. ``resume="auto"`` from the
   periodic checkpoint reruns the halvings its meta leaves and the
   consistency phase.  c. the same batch in float32 (``compute_dtype``
   alone changed), two diffusion epochs through ``train()``: ms per data
   step beside bf16's.  d. the device-resident diffusion step (a collated
   batch on the card, no loader) in bf16 and in float32: mean ms of 5
   after two warm-ups, peak memory.  e. one diffusion loss and its
   gradients at batch 4 on the trained weights (injected t and noise,
   HuBERT features given, dropout 0) in bf16 against float32 on the card,
   by the witness rule with the same pair on the CPU as the witness (loss
   1.5x + 1e-3; every gradient's cosine within 0.01 of the CPU's).  f. the
   final model (float32 parameters) served through float32 modules by
   ``backend="fused"``: one launch, held to the eager backend by phase 4's
   bar.  Its launches join the ``kernels`` line, the bf16 frontend's as a
   row of its own (``conv_frontend_bf16``, whose numbers are phase 6b's at
   [256, 32000]).

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

The ``kernels`` line has a row per TPU kernel and compute dtype: the float32
rows, ``conv_frontend_bf16`` (phase 6b), and ``fused_ddim_bf16`` (phase 3,
configs/flagship.json's decoder at B=1, v, whose error is the kernel's
where eps's is its clipped trajectory's; launches: the bf16 entry point's
six counted calls), ``banded_attention_bf16`` (phase 2; launches:
phase 5's bf16 call) and ``fused_ddpm_bf16`` (phase 8); then the bf16
step's own two kernels, ``step_gemm_wgmma`` (csrc/gemm_wgmma.cuh) and
``step_attention16`` (csrc/attention16.cuh): launches by kind in phases 3
and 8's bf16 entry-point calls (asserted nonzero), the numbers one decoder
step's 2 + 6L GEMMs (the wgmma kernel in its own tile) and 2L attentions
at B=8 (4,000 rows, phase 3), each beside its plain version and the one
PyTorch call per product (``F.linear``; ``scaled_dot_product_attention``)
summed the same way.

Prints one ``{"kernels": [...]}`` line, the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``.  ``--gemm16-timers`` runs instead
the per-block clock stamps of the bf16 step GEMMs (``gemm16_timers``).  Exits non-zero, printing no result,
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
BF16_PEAK_FLOPS = 989e12  # H100 SXM bf16 on tensor cores, dense (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
SEED = 7  # first-step x0 fully clipped for these weights and inputs (see above)
PRENET_SEED = 9  # the same for configs/flagship.json's decoder (the pre-net on)
DEVICE = "cuda"  # the phases' device; a CPU rehearsal of the script sets "cpu"
BAND_SHAPES = ((1, 500), (1, 4000), (2, 4000))  # phase 2's (B, T) at [B, 4, T, 40], w=64
CROSSOVER_T = (500, 1000, 2000, 3000, 4000)  # phase 2's band kernel vs SDPA, [1, 4, T, 40]


def bound(flops: float, nbytes: float, peak: float = F32_PEAK_FLOPS):
    t_ops = flops / peak * 1e3
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
            if isinstance(m, (nn.Linear, nn.Conv1d)):  # the pre-net's convolutions too
                b = 1.0 / np.sqrt(m.weight[0].numel())  # fan-in
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
    for lib, checks in SASS_CHECKS.items():
        sass_check(_build.library_path(lib), checks)
    return seconds


# library -> {kernel: the instructions every instance of it must contain}: the
# wgmma kernels' warpgroup products (HGMMA) and TMA loads (UTMALDG), the
# mma.sync kernels' tensor-core products (HMMA).
SASS_CHECKS = {
    "fused_ddim": {"gemm_wgmma_kernel": ("HGMMA", "UTMALDG"), "attention16_kernel": ("HMMA",)},
    "conv_frontend": {"conv_wgmma_kernel": ("HGMMA", "UTMALDG"),
                      "conv_slab_bf16_kernel": ("HMMA",)},
    "band_attention": {"band16_kernel": ("HMMA",)},
}


def sass_check(lib: str, checks: dict) -> None:
    """A built library's machine code (``cuobjdump --dump-sass``): every
    instance of each kernel in ``checks`` contains each of its instructions;
    fails otherwise (or where a kernel has no instance)."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    ops = sorted({op for want in checks.values() for op in want})
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = dict.fromkeys(ops, 0)
        elif name is not None:
            for op in ops:
                if f" {op}." in line or f" {op} " in line:
                    counts[name][op] += 1
    for kernel, want in checks.items():
        found = {n: c for n, c in counts.items() if kernel in n}
        assert found and all(c[op] > 0 for c in found.values() for op in want), (kernel, found)
        print(f"[build] sass: {len(found)} {kernel} instances, per instance "
              + ", ".join(f"{op} {sorted({c[op] for c in found.values()})}" for op in want))


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


def banded_bf16(torch, f32_row: dict) -> dict:
    """Phase 2's bf16 part: the band kernel on bf16 q, k, v (csrc/band16.cuh,
    tensor cores) at [1,4,4000,40], window 64, against the plain version on
    the same bf16 q, k, v (within 2e-5 + one bf16 ulp of each output) and
    against the float32 plain version on the float32 originals by the
    witness rule; on strided views of a bf16 [B, T, 3, H, d] buffer into
    [B, T, H, d]; two calls bit-equal; device time by graph replay beside
    the float32 kernel's, in each built tile, the plain version's time,
    band-masked SDPA on the same bf16 q, k, v (a yardstick), the bound
    (tensor-core products, so bytes bound it; the float32-FMA bound of
    earlier bf16 kernel beside it); then the crossover against SDPA on bf16."""
    import torch.nn.functional as F

    from edge_diffusion_tts_tpu_torch.layers.attention import local_attention_mask
    from edge_diffusion_tts_tpu_torch.ops import window_attention as wa

    bf16 = torch.bfloat16
    B, H, T, d, w = 1, 4, BAND_SHAPES[1][1], 40, 64
    q, k, v = band_inputs(torch, B, H, T, d, seed=T + B)  # phase 2's float32 inputs
    qb, kb, vb = (x.to(bf16) for x in (q, k, v))
    got = wa.banded_attention(qb, kb, vb, w)
    torch.cuda.synchronize()
    plain = wa.banded_attention_plain(qb, kb, vb, w)
    diff = (got.float() - plain.float()).abs()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(got.float().abs(), plain.float().abs())
                                            .clamp_min(2.0 ** -126))) - 7)
    over = (diff - 2e-5 - ulp).max().item()
    assert got.dtype == bf16 and over <= 0, f"bf16 band vs plain: over the bar by {over}"
    e_k, e_p, e_kp = witness16("bf16 band", got, plain, wa.banded_attention_plain(q, k, v, w),
                               strict=True)
    assert torch.equal(got, wa.banded_attention(qb, kb, vb, w)), "bf16 band: two calls"
    qkv = torch.stack([qb, kb, vb]).permute(1, 3, 0, 2, 4).contiguous()  # [B, T, 3, H, d]
    qs, ks, vs = qkv.permute(2, 0, 3, 1, 4)
    strided = wa.banded_attention(qs, ks, vs, w, out_layout="bthd")
    assert torch.equal(strided, got), "bf16 band: strided views differ from contiguous"
    err = diff.max().item()
    ms = graph_ms(torch, lambda: wa.banded_attention(qb, kb, vb, w))
    tiles = []
    rows_built = wa.BAND_ROWS
    try:
        for rows in rows_built:
            wa.BAND_ROWS = (rows,)
            t_ms = graph_ms(torch, lambda: wa.banded_attention(qb, kb, vb, w))
            tiles.append(f"rows {rows} {t_ms:.5f}")
    finally:
        wa.BAND_ROWS = rows_built
    plain_ms = timed_ms(torch, lambda: wa.banded_attention_plain(qb, kb, vb, w))
    mask = local_attention_mask(T, w, q.device)
    lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask))
    pairs = band_pairs(T, w, T) * B * H
    # S (2d a pair) and P V as two bf16 products (4d) on tensor cores; q, k,
    # v read and o written once in bf16
    bound_ms, bound_by = bound(6 * d * pairs, 4 * B * H * T * d * 2, BF16_PEAK_FLOPS)
    fma_ms = bound(4 * d * pairs, 4 * B * H * T * d * 2)[0]  # the earlier FMA kernel's bound
    plan = wa.band_plan(B, H, T, d, w, dtype=bf16)
    print(f"[banded-bf16] [{B},{H},{T},{d}] w={w}: vs bf16 plain max_abs_err={err:.3g}; witness: "
          f"kernel {e_k:.4g} from float32 plain, bf16 plain {e_p:.4g} (bar "
          f"{1.5 * e_p + 1e-3:.4g}), kernel vs bf16 plain {e_kp:.3g}; strided = contiguous; "
          f"graph_ms={ms:.5f} (float32 kernel {f32_row['ms']:.5f}; by tile: {', '.join(tiles)}) "
          f"plain_ms={plain_ms:.5f} sdpa_bf16_graph_ms={lib_ms:.5f} bound_ms={bound_ms:.6f} "
          f"({bound_by}; the float32-FMA bound {fma_ms:.6f}), {bound_ms / ms:.3f} of it; plan "
          f"rows {plan['rows']}, smem {plan['smem']} B, {plan['resident']} per SM, waves "
          f"{plan['waves']:.2f}")
    for Tc in CROSSOVER_T:
        q, k, v = (x.to(bf16) for x in band_inputs(torch, 1, H, Tc, d, seed=Tc))
        mask = local_attention_mask(Tc, w, q.device)
        kern = graph_ms(torch, lambda: wa.banded_attention(q, k, v, w))
        sdpa = graph_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        print(f"[banded-bf16] crossover T={Tc} [1,{H},{Tc},{d}] w={w}: kernel {kern:.5f} ms, "
              f"band-masked SDPA {sdpa:.5f} ms on the same bf16 q, k, v (graph replay), "
              f"SDPA / kernel {sdpa / kern:.2f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def fused_flops_bytes(B, T, S, M, H, heads, L, F, window, steps, tensors, prenet=False):
    dh = H // heads
    per_row = 4 * M * H + L * (2 * H * 3 * H + 6 * H * H + 4 * H * F + 2 * F * H)
    if prenet:  # pointwise 2H^2; depthwise 5H; GroupNorm, GELU and the adds ~11H
        per_row += 2 * H * H + 16 * H
    attn = L * heads * 4 * dh * (band_pairs(T, window, T) + T * S)
    flops = steps * (B * T * per_row + B * attn)
    nbytes = 4 * (sum(t.numel() for t in tensors) + B * T * M)
    return flops, nbytes


def fused_flops_bf16(B, T, S, M, H, heads, L, F, window, steps, tensors, prenet=False):
    """The bf16 loop's bound.  JAX's bf16 ``mm`` rounds both operands of
    every product, the attention's too, so every product counts at the
    card's bf16 rate (989 TFLOP/s); the pre-net's float32 elementwise work
    at the float32 rate; the tensors' own bytes (each read once) and the
    float32 output at HBM's rate.  The least time is the largest of the
    three.  Returns (ms, "operations" or "bytes", bf16 product FLOP, float32
    FLOP, the attention's FLOP); ``attention_fma_ms`` gives the looser time
    of this kernel's own choice, its attention in float32 FMA (67 TFLOP/s)."""
    dh = H // heads
    per_row = 4 * M * H + L * (2 * H * 3 * H + 6 * H * H + 4 * H * F + 2 * F * H)
    if prenet:
        per_row += 2 * H * H
    attn = steps * B * L * heads * 4 * dh * (band_pairs(T, window, T) + T * S)
    products = steps * B * T * per_row + attn
    f32 = steps * B * T * 16 * H if prenet else 0
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + 4 * B * T * M
    t_ops = max(products / BF16_PEAK_FLOPS, f32 / F32_PEAK_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms = max(t_ops, t_bytes)
    return ms, "bytes" if ms == t_bytes else "operations", products, f32, attn


def attention_fma_ms(products: float, f32: float, attn: float) -> float:
    """The bf16 loop's least time were its attention bound to float32 FMA
    (this kernel's choice, not the operands' type): the tensor-core products
    and the FMA work side by side."""
    return max((products - attn) / BF16_PEAK_FLOPS, (attn + f32) / F32_PEAK_FLOPS) * 1e3


# The two-sided witness on well-conditioned paths (v-prediction DDIM, DDPM,
# the long-form call, the band kernel), with bars set from the H100
# readings (PERF.md, the bf16 loops' finding): the kernel's distance from
# the float32 plain version was 0.99-1.00 of the bf16 plain version's, and
# its distance from the bf16 plain version 0.011-0.64 of the bf16 plain
# version's from float32.  A float32 step would sit near float32 and fail
# both.  P kept in float32 in the attention moves a loop too little to show
# here (a mutation check read 0.59 where the kernel reads 0.57): the step's
# attention alone is held to that in tests/test_torch_kernels_gpu.py.
WITNESS_FLOOR = 0.5  # e_k >= WITNESS_FLOOR * e_p
WITNESS_NEAR = 0.8  # e_kp <= WITNESS_NEAR * e_p


def witness16(label: str, kernel, plain16, plain32, strict: bool = False) -> tuple:
    """The witness rule on the card: the bf16 kernel's normwise distance from
    the float32 plain version within 1.5 times the bf16 plain version's +
    1e-3.  With ``strict`` (a well-conditioned path) also the two-sided
    bars above.  Returns (kernel's distance, plain bf16's, kernel vs plain
    bf16)."""
    e_k, e_p, e_kp = _rel(kernel, plain32), _rel(plain16, plain32), _rel(kernel, plain16)
    assert bool(kernel.isfinite().all()), f"{label}: non-finite output"
    assert e_k <= 1.5 * e_p + 1e-3, f"{label}: {e_k} from float32, the bf16 plain {e_p}"
    if strict:
        assert e_k >= WITNESS_FLOOR * e_p, (
            f"{label}: {e_k} from float32, under {WITNESS_FLOOR} x the bf16 plain's {e_p}")
        assert e_kp <= WITNESS_NEAR * e_p, (
            f"{label}: {e_kp} from the bf16 plain, over {WITNESS_NEAR} x its {e_p} from float32")
    return e_k, e_p, e_kp


def flagship_cfg():
    """configs/flagship.json with dropout 0: the depthwise pre-net on."""
    from edge_diffusion_tts_tpu_torch.config import CFG

    with open(os.path.join(ROOT, "configs", "flagship.json")) as f:
        return CFG.from_dict(dict(json.load(f), dropout=0.0))


def phase_fused(torch, cfg, decoder, schedule, seed: int = SEED):
    """Phase 3 for one decoder (inputs from ``seed``); the pre-net's
    kernels are timed alone when the decoder has one, the step's GEMMs
    otherwise."""
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd

    dev = torch.device(DEVICE)
    B, S, steps = 1, 250, 4
    T = 2 * S
    tag = "fused+prenet" if cfg.use_depthwise else "fused"
    rng = np.random.RandomState(1000 + seed)
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
        print(f"[{tag}] {prediction}: max_abs_err={err:.3g} frac>2e-4={frac_over:.2e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f}")
    flops, nbytes = fused_flops_bytes(
        B, T, S, cfg.n_mels, cfg.hidden, cfg.heads, cfg.layers, cfg.hidden * cfg.ffn_mult,
        cfg.attn_window_size, len(ts),
        [x_T, loop["pos"], loop["mods"], loop["ckv"], coef, *w.values()],
        prenet=cfg.use_depthwise)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[{tag}] {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB per call: "
          f"bound_ms={bound_ms:.5f} ({bound_by})")

    before = fd.kernel_launches()
    fd.fused_ddim(*args, heads=cfg.heads, window=cfg.attn_window_size)
    torch.cuda.synchronize()
    per_step = (fd.kernel_launches() - before) / len(ts)
    want_per_step = 2 + 8 * cfg.layers + 1 + (3 if cfg.use_depthwise else 0)
    print(f"[{tag}] kernel launches per decoder step (with its update): {per_step:g}")
    assert per_step == want_per_step, f"{per_step} launches per step, not {want_per_step}"
    if cfg.use_depthwise:
        out["prenet_us"] = prenet_alone(torch, cfg, B * T, loop, w, out["eps"]["ms"] / len(ts))
    else:
        step_gemms(torch, cfg, B * T, loop, w)
    out.update(bound_ms=bound_ms, bound_by=bound_by, x_T=x_T, sem_idx=sem_idx)
    return out


def phase_fused_bf16(torch, cfg, decoder, schedule, seed: int, B: int = 1) -> dict:
    """Phase 3's bf16 part for one decoder (inputs from ``seed``, B rows of
    S=250): ``fused_generate_mel(..., compute_dtype=torch.bfloat16)``, the
    entry point, counted (``fused_ddim.bf16_launches`` set to 0 just
    before, read just after) and equal to ``fused_ddim`` on the same inputs;
    eps and v held by the witness rule against the float32 plain version,
    the bf16 plain version the witness; launches per step (35, 38 with the
    pre-net); two calls bit-equal; the bf16 kernel's ms beside the float32
    kernel's at the same shape (CUDA events, 10 calls), the bf16 plain
    version's ms, the bound."""
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd

    bf16 = torch.bfloat16
    dev = torch.device(DEVICE)
    S, steps = 250, 4
    T = 2 * S
    tag = f"fused-bf16{'+prenet' if cfg.use_depthwise else ''} B={B}"
    rng = np.random.RandomState(1000 + seed)
    sem_idx = torch.from_numpy(rng.randint(0, 2304, (B, S))).to(dev)
    x_T = torch.from_numpy(rng.randn(B, T, cfg.n_mels).astype(np.float32)).to(dev)
    ts, coef = fd.ddim_coefficients(schedule, steps)
    coef = coef.to(dev)
    loop = fd.prepare_loop_inputs(decoder, sem_idx, T, ts)
    w32, w16 = fd.pack_decoder_weights(decoder), fd.pack_decoder_weights(decoder, bf16)
    a32 = (x_T, loop["pos"], loop["mods"], loop["ckv"], coef, w32)
    a16 = (x_T, loop["pos"], loop["mods"], loop["ckv"].to(bf16), coef, w16)
    kw = dict(heads=cfg.heads, window=cfg.attn_window_size)
    out = {}
    kinds = dict.fromkeys(fd.KERNEL_KINDS, 0)
    for prediction in ("eps", "v"):
        fd.fused_ddim.launches = fd.fused_ddim.bf16_launches = 0
        fd.zero_kernel_launches()
        entry = fd.fused_generate_mel(cfg, schedule, decoder, sem_idx, x_T, steps, prediction,
                                      compute_dtype=bf16)
        torch.cuda.synchronize()
        launches = fd.fused_ddim.bf16_launches
        assert (fd.fused_ddim.launches, launches) == (0, 1), "the bf16 entry point's launch"
        got_kinds = {k: fd.kernel_launches(k) for k in kinds}
        check_kinds(f"{tag} {prediction}", cfg, steps, got_kinds)
        kinds = {k: kinds[k] + n for k, n in got_kinds.items()}
        got = fd.fused_ddim(*a16, prediction=prediction, compute_dtype=bf16, **kw)
        assert torch.equal(entry, got), f"{tag} {prediction}: entry point != fused_ddim"
        assert torch.equal(got, fd.fused_ddim(*a16, prediction=prediction, compute_dtype=bf16,
                                              **kw)), f"{tag} {prediction}: two calls differ"
        plain16 = fd.fused_ddim_plain(*a16, prediction=prediction, compute_dtype=bf16, **kw)
        plain32 = fd.fused_ddim_plain(*a32, prediction=prediction, **kw)
        e_k, e_p, e_kp = witness16(f"{tag} {prediction}", got, plain16, plain32,
                                   strict=prediction == "v")
        err = (got - plain16).abs().max().item()
        ms = timed_ms(torch, lambda: fd.fused_ddim(*a16, prediction=prediction,
                                                   compute_dtype=bf16, **kw), iters=10)
        ms32 = timed_ms(torch, lambda: fd.fused_ddim(*a32, prediction=prediction, **kw),
                        iters=10)
        plain_ms = timed_ms(torch, lambda: fd.fused_ddim_plain(
            *a16, prediction=prediction, compute_dtype=bf16, **kw), iters=3, warmup=1)
        out[prediction] = dict(max_abs_err=err, ms=ms, f32_ms=ms32, plain_ms=plain_ms,
                               launches=launches)
        print(f"[{tag}] {prediction}: witness: kernel {e_k:.4g} from float32 plain, bf16 plain "
              f"{e_p:.4g} (bar {1.5 * e_p + 1e-3:.4g}), kernel vs bf16 plain {e_kp:.3g} (max abs "
              f"{err:.3g}); bf16 ms={ms:.4f} float32 ms={ms32:.4f} bf16 plain_ms={plain_ms:.4f}")
    before = fd.kernel_launches()
    fd.fused_ddim(*a16, compute_dtype=bf16, **kw)
    torch.cuda.synchronize()
    per_step = (fd.kernel_launches() - before) / len(ts)
    want_per_step = 2 + 8 * cfg.layers + 1 + (3 if cfg.use_depthwise else 0)
    assert per_step == want_per_step, f"{tag}: {per_step} launches per step"
    bound_ms, bound_by, products, f32, attn = fused_flops_bf16(
        B, T, S, cfg.n_mels, cfg.hidden, cfg.heads, cfg.layers, cfg.hidden * cfg.ffn_mult,
        cfg.attn_window_size, len(ts), [*a16[:5], *w16.values()], prenet=cfg.use_depthwise)
    print(f"[{tag}] {per_step:g} launches per step; {products / 1e9:.4f} GFLOP of bf16 "
          f"products ({attn / 1e9:.4f} of them attention) + {f32 / 1e9:.4f} GFLOP float32: "
          f"bound_ms={bound_ms:.5f} ({bound_by}); with the attention in float32 FMA as this "
          f"kernel runs it {attention_fma_ms(products, f32, attn):.5f} ms")
    # The kernels row reads v: after eps's clipped first step the bf16 and
    # float32 trajectories part, so eps's largest difference is the
    # trajectory's, not the kernel's.
    out["v"].update(bound_ms=bound_ms, bound_by=bound_by, kinds=kinds,
                    launches=out["eps"]["launches"] + out["v"]["launches"])
    if not cfg.use_depthwise:
        out["v"]["gemms"] = step_gemms16(torch, cfg, B * T, loop, w16)
        out["v"]["attention"] = step_attention16(torch, cfg, B)
        if B > 1:  # the float32 GEMMs at these rows, for the comparison
            step_gemms(torch, cfg, B * T, loop, w32)
    return out["v"]


def check_kinds(label: str, cfg, steps: int, kinds: dict) -> None:
    """Hold one bf16 loop call's kernels (``kernel_launches(kind)``, set to
    0 just before it): 2L tensor-core attentions per step, and its 2 + 6L
    GEMMs (one more with the pre-net) split between the wgmma kernel and
    gemm16_kernel by the tile rule."""
    gemms = steps * (2 + 6 * cfg.layers + (1 if cfg.use_depthwise else 0))
    assert kinds["attention16"] == steps * 2 * cfg.layers, f"{label}: {kinds}"
    assert kinds["gemm_wgmma"] + kinds["gemm16"] == gemms, f"{label}: {kinds}"
    print(f"[{label}] bf16 kernels launched: {kinds}")


def prenet_alone(torch, cfg, rows: int, loop, w, step_ms: float) -> float:
    """The pre-net's three kernels alone (``decoder_prenet``) on h [1, rows,
    H]: held to ``decoder_prenet_plain`` (atol 1e-5), and their device µs
    by CUDA-graph replay beside the whole step's (the loop's ms per step)."""
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd

    H = cfg.hidden
    rng = np.random.RandomState(6000 + SEED)
    h = torch.from_numpy(rng.randn(1, rows, H).astype(np.float32)).to(DEVICE)
    pos = loop["pos"]
    got = fd.decoder_prenet(h, pos, w)
    torch.cuda.synchronize()
    err = (got - fd.decoder_prenet_plain(h, pos, w)).abs().max().item()
    assert err <= 1e-5, f"pre-net kernels vs plain: max err {err} > 1e-5"
    us = 1e3 * graph_ms(torch, lambda: fd.decoder_prenet(h, pos, w))
    gemm_us = 1e3 * graph_ms(torch, lambda: fd.decoder_gemm(h[0], w["pc_pw"], bias=w["pc_pb"]))
    bound_us = 1e3 * bound(rows * (2 * H * H + 16 * H), 4 * (3 * rows * H + H * H + 5 * H))[0]
    print(f"[prenet] depthwise + pointwise GEMM + GroupNorm/GELU pass at [1, {rows}, {H}]: "
          f"max_abs_err={err:.3g} vs plain; {us:.3f} us by graph replay (the pointwise GEMM "
          f"alone {gemm_us:.3f} us) beside {1e3 * step_ms:.3f} us per decoder step; bound "
          f"{bound_us:.3f} us")
    return us


def step_gemm_shapes(cfg, rows: int, loop, w, low: bool, rng):
    """The decoder step's eight GEMMs at ``rows`` rows, layer 0's weights:
    (name, a, W, kwargs, how many a step runs) with random activations from
    ``rng``; at bf16 (``low``, ``w`` packed at bf16) the step's operand and
    output dtypes (bf16 attention and SwiGLU outputs in; bf16 q/k/v, cross q
    and SwiGLU output out)."""
    import torch

    H, M, FF, L = cfg.hidden, cfg.n_mels, cfg.hidden * cfg.ffn_mult, cfg.layers

    def act(n):
        return torch.from_numpy(rng.randn(rows, n).astype(np.float32)).to(DEVICE)

    x, h, ao, f = act(M), act(H), act(H), act(FF)
    if low:
        ao, f = ao.to(torch.bfloat16), f.to(torch.bfloat16)
    m0 = loop["mods"][0, 0]
    shapes = [
        ("in_proj (+bias +pos)", x, w["in_w"], dict(bias=w["in_b"], pos=loop["pos"]), 1),
        ("qkv (AdaLN-RMS prologue)", h, w["qkv_w"][0], dict(norm="rms", scale=m0[0],
                                                            shift=m0[1]), L),
        ("attn proj (+bias +residual)", ao, w["proj_w"][0], dict(bias=w["proj_b"][0],
                                                                residual=h), L),
        ("cross q (RMS x n2w prologue)", h, w["cq_w"][0], dict(norm="rms",
                                                              scale=w["n2w"][0]), L),
        ("cross out (+residual)", ao, w["co_w"][0], dict(residual=h), L),
        ("fc1 (AdaLN-RMS prologue, SwiGLU)", h, w["fc1_w"][0], dict(
            bias=w["fc1_b"][0], norm="rms", scale=m0[2], shift=m0[3], swiglu=True), L),
        ("fc2 (+bias +residual)", f, w["fc2_w"][0], dict(bias=w["fc2_b"][0], residual=h), L),
        ("out_proj (LayerNorm prologue, +bias)", h, w["out_w"], dict(
            bias=w["out_b"], norm="ln", scale=w["fn_s"], shift=w["fn_b"]), 1),
    ]
    if low:
        bf16 = torch.bfloat16
        shapes = [(name, a, W, dict(kw, compute_dtype=bf16, out_dtype=bf16 if name.startswith(
            ("qkv", "cross q", "fc1")) else torch.float32), n) for name, a, W, kw, n in shapes]
    return shapes


def step_gemms(torch, cfg, rows: int, loop, w):
    """Each float32 GEMM of the decoder step alone at ``rows`` rows: held to
    its plain version, and its device time (``graph_ms``) in the host's tile
    beside ``F.linear``'s at the same shape."""
    import torch.nn.functional as F

    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd

    rng = np.random.RandomState(5000 + SEED)
    for name, a, W, kw, _ in step_gemm_shapes(cfg, rows, loop, w, False, rng):
        got = fd.decoder_gemm(a, W, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, fd.decoder_gemm_plain(a, W, **kw), atol=1e-5, rtol=1e-5)
        n, K = got.shape[-1], a.shape[1]
        bm, bn = fd.decoder_gemm_tile(rows, n)
        us = 1e3 * graph_ms(torch, lambda: fd.decoder_gemm(a, W, **kw))
        lin_us = 1e3 * graph_ms(torch, lambda: F.linear(a, W))
        bound_us = 1e3 * bound(2 * rows * W.shape[0] * K, 0)[0]
        print(f"[gemm] {name}: M={rows} N={n} K={K}: {us:.3f} us, tile {bm}x{bn}, "
              f"{-(-rows // bm) * -(-n // bn)} blocks; F.linear (torch.float32) {lin_us:.3f} us; "
              f"ops bound {bound_us:.3f} us")


def gemm16_work(a, W, kw, out) -> tuple:
    """One bf16 step GEMM's work for its bound: (its products' FLOP, the
    bytes of its operands (a, W, the epilogue's rows, each read once) and of
    its output (written once))."""
    rows, K = a.shape
    nbytes = sum(t.numel() * t.element_size() for t in (a, W, out, *(
        kw.get(k) for k in ("bias", "pos", "residual", "scale", "shift"))) if t is not None)
    return 2 * rows * W.shape[0] * K, nbytes


def step_gemms16(torch, cfg, rows: int, loop, w16) -> dict:
    """Each bf16 GEMM of the decoder step alone at ``rows`` rows (layer 0's
    weights, the step's operand and output dtypes), held normwise (1e-3) to
    the bf16 plain version in the host's tile, in the mma.sync kernel's own
    tile (``gemm16_kernel`` and its own rule) and in the wgmma kernel's
    own tile; the device µs of each (``graph_ms``) beside ``F.linear`` on
    the same bf16 operands, the wgmma kernel in every tile that fits, and
    the bound.  Returns the step's sums (its 2 + 6L GEMMs) in ms: the host's
    pick, the mma.sync kernel, the wgmma kernel, the plain version, F.linear
    and the bound, with the largest error."""
    import torch.nn.functional as F

    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd

    tiles = fd.gemm16_tiles()
    rng = np.random.RandomState(5000 + SEED)
    tot = dict(host=0.0, mma=0.0, wgmma=0.0, plain=0.0, linear=0.0, err=0.0)
    flops = nbytes = 0
    print(f"[gemm-bf16] M={rows}: µs by graph replay, host's pick / mma.sync "
          "(gemm16_kernel, its rule) / wgmma (its rule) / F.linear on the bf16 operands; every "
          "wgmma tile, 64 rows x BNW columns x WGS warpgroups")
    for name, a, W, kw, per_step in step_gemm_shapes(cfg, rows, loop, w16, True, rng):
        pkw = {k: v for k, v in kw.items() if k != "out_dtype"}
        want = fd.decoder_gemm_plain(a, W, **pkw)
        n, K = want.shape[-1], a.shape[1]
        picks = {rule: fd.decoder_gemm16_tile(rows, n, rule, a.dtype, kw.get("swiglu", False))
                 for rule in ("host", "mma", "wgmma")}
        us = {}
        for rule, tile in picks.items():
            got = fd.decoder_gemm(a, W, tile=tile, **kw)
            torch.cuda.synchronize()
            e = _rel(got, want.to(got.dtype))
            assert e <= 1e-3, f"bf16 gemm {name} in tile {tiles[tile]}: {e} from the bf16 plain"
            tot["err"] = max(tot["err"], (got.float() - want).abs().max().item())
            us[rule] = 1e3 * graph_ms(torch, lambda: fd.decoder_gemm(a, W, tile=tile, **kw))
        sweep = []
        for tile, (bm, bn, kind, wgs) in enumerate(tiles):
            if kind != "wgmma":
                continue
            try:
                t_us = 1e3 * graph_ms(torch, lambda: fd.decoder_gemm(a, W, tile=tile, **kw))
            except RuntimeError:  # this tile's shared memory does not fit
                continue
            sweep.append(f"{bn // wgs}x{wgs}:{t_us:.3f}")
        a_lin = a.to(W.dtype)
        lin_us = 1e3 * graph_ms(torch, lambda: F.linear(a_lin, W))
        plain_us = 1e3 * graph_ms(torch, lambda: fd.decoder_gemm_plain(a, W, **pkw), n=10)
        work = gemm16_work(a, W, kw, want.to(kw["out_dtype"]))
        b_ms, b_by = bound(*work, BF16_PEAK_FLOPS)
        flops, nbytes = flops + per_step * work[0], nbytes + per_step * work[1]
        for key, v in (("host", us["host"]), ("mma", us["mma"]), ("wgmma", us["wgmma"]),
                       ("plain", plain_us), ("linear", lin_us)):
            tot[key] += per_step * v / 1e3
        print(f"[gemm-bf16] {name}: M={rows} N={n} K={K}: {us['host']:.3f} (tile "
              f"{tiles[picks['host']]}) / {us['mma']:.3f} ({tiles[picks['mma']]}) / "
              f"{us['wgmma']:.3f} ({tiles[picks['wgmma']]}) / F.linear {lin_us:.3f}; wgmma "
              f"host/F.linear {us['host'] / lin_us:.2f}x; bound {1e3 * b_ms:.3f} us ({b_by}); "
              f"wgmma BNWxWGS:us {' '.join(sweep)}")
    tot["bound"], tot["bound_by"] = bound(flops, nbytes, BF16_PEAK_FLOPS)
    print(f"[gemm-bf16] M={rows}: one step's {2 + 6 * cfg.layers} GEMMs: host's pick "
          f"{tot['host']:.5f} ms, mma.sync {tot['mma']:.5f}, wgmma {tot['wgmma']:.5f}, "
          f"F.linear {tot['linear']:.5f}, bound {tot['bound']:.5f} ({tot['bound_by']})")
    return tot


def step_attention16(torch, cfg, B: int) -> dict:
    """The bf16 step's attentions alone (``step_attention``) at B rows of
    T = 500, S = 250 (the flagship heads): the self-attention (window
    ``cfg.attn_window_size``) and the cross-attention, each the tensor-core
    kernel (csrc/attention16.cuh) / the float32-FMA kernel the step ran
    before (``fma=True``) / band-masked ``scaled_dot_product_attention`` on
    the same bf16 q, k, v (a yardstick), device µs by graph replay, and the
    bound; each held to ``_attention_rounded`` (P normalised, then
    rounded) by the witness rule's two-sided bars against the float32
    attention on the same values.  Returns one step's sums in ms (L of
    each) and the largest error against the plain version."""
    import torch.nn.functional as F

    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd

    bf16 = torch.bfloat16
    heads, d, w, T, S = cfg.heads, cfg.hidden // cfg.heads, cfg.attn_window_size, 500, 250
    g = torch.Generator().manual_seed(7000 + B)
    tot = dict(ms=0.0, fma=0.0, plain=0.0, library=0.0, err=0.0)
    flops = nbytes = 0
    i = torch.arange(T, device=DEVICE)
    for kind, tk, window in (("self", T, w), ("cross", S, None)):
        q, k, v = (torch.randn(B, heads, n, d, generator=g).to(DEVICE).to(bf16)
                   for n in (T, tk, tk))
        mask = None
        if window is not None:
            mask = (i[:, None] - torch.arange(tk, device=DEVICE)[None, :]).abs() <= window
        got = fd.step_attention(q, k, v, window, compute_dtype=bf16)
        old = fd.step_attention(q, k, v, window, compute_dtype=bf16, fma=True)
        torch.cuda.synchronize()
        q32, k32, v32 = q.float(), k.float(), v.float()
        exact = fd._attention_rounded(q32, k32, v32, torch.float32, mask)
        plain = fd._attention_rounded(q32, k32, v32, bf16, mask).to(bf16)
        e_k, e_p, e_kp = _rel(got, exact), _rel(plain, exact), _rel(got, plain)
        assert WITNESS_FLOOR * e_p <= e_k <= 1.25 * e_p and e_kp <= 2.0 * e_p, (
            f"step attention {kind} B={B}: kernel {e_k} from float32, plain {e_p}, "
            f"kernel vs plain {e_kp}")
        tot["err"] = max(tot["err"], (got.float() - plain.float()).abs().max().item())
        us = 1e3 * graph_ms(torch, lambda: fd.step_attention(q, k, v, window, compute_dtype=bf16))
        fma_us = 1e3 * graph_ms(torch, lambda: fd.step_attention(q, k, v, window,
                                                                 compute_dtype=bf16, fma=True))
        sdpa_us = 1e3 * graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))
        plain_us = 1e3 * graph_ms(torch, lambda: fd._attention_rounded(
            q32, k32, v32, bf16, mask), n=10)
        pairs = band_pairs(T, window, tk) if window is not None else T * tk
        work = (B * heads * 4 * d * pairs, 2 * (2 * q.numel() + k.numel() + v.numel()))
        b_ms, b_by = bound(*work, BF16_PEAK_FLOPS)
        flops, nbytes = flops + cfg.layers * work[0], nbytes + cfg.layers * work[1]
        for key, val in (("ms", us), ("fma", fma_us), ("plain", plain_us), ("library", sdpa_us)):
            tot[key] += cfg.layers * val / 1e3
        print(f"[attn-bf16] {kind} B={B} T={T} keys={tk} heads={heads} d={d}: tensor cores "
              f"{us:.3f} us / float32 FMA (before) {fma_us:.3f} / SDPA (masked) {sdpa_us:.3f}; "
              f"bound {1e3 * b_ms:.4f} us ({b_by}); witness: kernel {e_k:.4g} from float32, "
              f"plain {e_p:.4g}, kernel vs plain {e_kp:.4g} (FMA kernel "
              f"{_rel(old, exact):.4g})")
    tot["bound"], tot["bound_by"] = bound(flops, nbytes, BF16_PEAK_FLOPS)
    print(f"[attn-bf16] B={B}: one step's {2 * cfg.layers} attentions: tensor cores "
          f"{tot['ms']:.5f} ms, float32 FMA {tot['fma']:.5f}, SDPA {tot['library']:.5f}, bound "
          f"{tot['bound']:.5f} ({tot['bound_by']})")
    return tot


def v_rule(label: str, got, want) -> float:
    """Hold a v-prediction DDIM output to phase 3's rule (the module
    docstring): every element within 0.05, at least 99.9% within 2e-4."""
    diff = (got - want).abs()
    err, frac = diff.max().item(), (diff > 2e-4).float().mean().item()
    assert bool(got.isfinite().all()), f"{label}: non-finite output"
    assert frac <= 1e-3 and err <= 0.05, f"{label}: {frac:.2e} of elements over 2e-4, max {err}"
    return err


def phase_main_path(torch, cfg, decoder, schedule, fused):
    """Phase 4 at configs/flagship.json's decoder (``cfg`` and ``decoder``:
    the depthwise pre-net on, v prediction) with phase 3's pre-net inputs."""
    from edge_diffusion_tts_tpu_torch.inference import EdgeInference
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
    from edge_diffusion_tts_tpu_torch.ops import window_attention as wa

    assert cfg.use_depthwise and cfg.use_v_prediction
    engine = EdgeInference(cfg, schedule, decoder, prediction="v", backend="fused",
                           device=DEVICE)
    engine.generate_mel(fused["sem_idx"], num_steps=4, x_T=fused["x_T"])  # warm-up
    torch.cuda.synchronize()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    sem2 = torch.randint(0, 2304, (2, 128), device=DEVICE, generator=gen)
    requests = [
        dict(sem_idx=fused["sem_idx"], x_T=fused["x_T"]),
        dict(sem_idx=sem2, x_T=torch.randn((2, 256, cfg.n_mels), device=DEVICE, generator=gen)),
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
    # The first request repeats phase 3's pre-net v inputs through the entry point.
    err = (outs[0] - fused["v"]["x0"]).abs().max().item()
    assert err <= 1e-5, f"entry point differs from the kernel by {err}"
    # The requests with a given x_T against the eager backend (the module loop)
    # on the same weights: phase 3's v rule.
    eager = EdgeInference(cfg, schedule, decoder, prediction="v", device=DEVICE)
    eager.generate_mel(num_steps=4, **requests[0])  # warm-up
    eager_err, eager_ms = [], []
    for i in (0, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = eager.generate_mel(num_steps=4, **requests[i])
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        eager_err.append(v_rule(f"main path request {i} fused vs eager", outs[i], want))
    print(f"[main] configs/flagship.json decoder (pre-net, v): fused generate_mel per-call ms: "
          + ", ".join(f"{t:.3f}" for t in times) + f"; fused launches={launches}; eager ms "
          + ", ".join(f"{t:.3f}" for t in eager_ms) + "; fused vs eager max err "
          + ", ".join(f"{e:.3g}" for e in eager_err) + " (bar: 0.05, and 2e-4 on 99.9%)")
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

    # The same call with the decoder built at compute_dtype bf16 (its float32
    # weights): its windows go to the band kernel's bf16 instances.
    from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder

    dec16 = EdgeDiffusionDecoder(cfg, dtype=torch.bfloat16)
    dec16.load_state_dict(decoder.state_dict())
    engine16 = EdgeInference(cfg, schedule, dec16, prediction="v", sampler="dpmpp",
                             device=DEVICE)
    engine16.generate_mel(sem_idx, num_steps=steps, x_T=x_T)  # warm-up
    torch.cuda.synchronize()
    wa.banded_attention.launches = wa.banded_attention.bf16_launches = 0
    t0 = time.perf_counter()
    mel16 = engine16.generate_mel(sem_idx, num_steps=steps, x_T=x_T)
    torch.cuda.synchronize()
    ms16 = (time.perf_counter() - t0) * 1e3
    launches16 = wa.banded_attention.bf16_launches
    assert (wa.banded_attention.launches, launches16) == (0, cfg.layers * steps), (
        f"bf16 long-form: banded launches {wa.banded_attention.launches}, bf16 {launches16}")
    wa.banded_attention = plain_route
    try:
        t0 = time.perf_counter()
        plain16 = engine16.generate_mel(sem_idx, num_steps=steps, x_T=x_T)
        torch.cuda.synchronize()
        plain16_ms = (time.perf_counter() - t0) * 1e3
    finally:
        wa.banded_attention = kernel_route
    e_k, e_p, e_kp = witness16("bf16 long-form", mel16.float(), plain16.float(), plain,
                               strict=True)
    print(f"[longform-bf16] T={2 * S} eager dpmpp {steps} steps, decoder at compute bf16: "
          f"{ms16:.3f} ms (banded route plain: {plain16_ms:.3f} ms), bf16 banded launches="
          f"{launches16}; witness: {e_k:.4g} from the float32 decoder's plain route, the bf16 "
          f"plain route {e_p:.4g} (bar {1.5 * e_p + 1e-3:.4g}), kernel vs plain route {e_kp:.3g}")
    return launches, launches16


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


FRONTEND_BF16_SHAPES = ((1, 80000), (256, 32000))  # phase 6b: a 5 s request, a training batch


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def frontend_bf16(torch, encoder):
    """Phase 6b: the frontend's bf16 variant (tensor cores) against
    ``conv_frontend_plain(compute_dtype=bf16)`` on the card (the module
    docstring's phase 6b).  Returns the [256, 32000] row for the ``kernels``
    line, the main path's shape."""
    import torch.nn.functional as F

    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff

    bf16 = torch.bfloat16
    fe = encoder.hubert.feature_extractor
    w32, wb = ff.pack_frontend_weights(fe), ff.pack_frontend_weights(fe, bf16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for B, n in FRONTEND_BF16_SHAPES:
        rng = np.random.RandomState(n + B + 1)
        wav = torch.from_numpy((0.2 * rng.randn(B, n)).astype(np.float32)).to(DEVICE)
        lens = torch.from_numpy(rng.randint(n // 2, n + 1, B)).to(DEVICE)
        lens[0] = n
        errs = []
        wgmma = sum(p.get("tile_index", 0) > 0 for p in ff.frontend_plan(B, n, sms=sms, dtype=bf16))
        for wav_len in (None, lens):
            before = ff.wgmma_launches()
            got = ff.conv_frontend(wav, wb, wav_len=wav_len, compute_dtype=bf16)
            torch.cuda.synchronize()
            assert ff.wgmma_launches() - before == wgmma, "the plan's wgmma layers did not launch"
            plain = ff.conv_frontend_plain(wav, wb, wav_len, compute_dtype=bf16)
            f32 = ff.conv_frontend_plain(wav, w32, wav_len)
            e_k, e_p, e_kp = _rel(got, f32), _rel(plain, f32), _rel(got, plain)
            label = f"bf16 frontend [{B},{n}]" + (" with wav_len" if wav_len is not None else "")
            assert got.dtype == torch.float32 and torch.isfinite(got).all(), label
            assert e_k <= 1.5 * e_p + 1e-3, f"{label}: {e_k} from float32, plain bf16 {e_p}"
            assert e_kp <= 1e-2, f"{label}: {e_kp} from the bf16 plain version"
            assert torch.equal(got, ff.conv_frontend(wav, wb, wav_len=wav_len,
                                                     compute_dtype=bf16)), f"{label}: two calls"
            errs.append((got - plain).abs().max().item())
            print(f"[frontend-bf16] {label}: vs float32 plain {e_k:.4g} (bf16 plain {e_p:.4g}, "
                  f"bar {1.5 * e_p + 1e-3:.4g}), vs bf16 plain {e_kp:.4g} (bar 1e-2), max abs "
                  f"{errs[-1]:.4g}; two calls bit-equal; {wgmma} wgmma launches")
            del got, plain, f32
        fold = ff.groupnorm_fold(wav, w32["w0"], w32["gamma"], w32["beta"])
        big = B > 8
        n_cap, reps = (4, 3) if big else (50, 10)
        ms = graph_ms(torch, lambda: ff.conv_frontend(wav, wb, fold=fold, compute_dtype=bf16),
                      n=n_cap, replays=reps)
        ms32 = graph_ms(torch, lambda: ff.conv_frontend(wav, w32, fold=fold), n=n_cap,
                        replays=2 if big else reps)
        plain_ms = timed_ms(torch, lambda: ff.conv_frontend_plain(wav, wb, compute_dtype=bf16),
                            iters=2 if big else 10, warmup=1)
        flops = frontend_flops(B, n)
        nbytes = (4 * (wav.numel() + w32["w0"].numel() + B * ff.frame_counts(n)[-1] * 512)
                  + 2 * (wb["wk3"].numel() + wb["wk2"].numel()))
        bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK_FLOPS)
        print(f"[frontend-bf16] [{B},{n}]: kernels {ms:.5f} ms by CUDA-graph replay "
              f"({flops / ms / 1e9:.2f} TFLOP/s), the float32 kernels {ms32:.5f} ms; plain "
              f"{plain_ms:.4f} ms; bf16 bound {bound_ms:.5f} ms ({bound_by}), "
              f"{bound_ms / ms:.3f} of it")
        plan = ff.frontend_plan(B, n, sms=sms, dtype=bf16)
        x, conv_sum = wav, 0.0
        for p in plan:
            i = p["layer"]
            extra = fold if i == 0 else ()
            got = ff.conv_frontend_layer(x, i, wb, *extra, compute_dtype=bf16)
            want = ff.conv_frontend_layer_plain(x, i, wb, *extra, compute_dtype=bf16)
            e = _rel(got, want)
            over = ((got.float() - want.float()).abs()
                    > 2.0 ** -7 * want.float().abs() + 1e-5).float().mean().item()
            assert e <= 1e-3 and over <= 1e-4, f"bf16 layer {i} [{B},{n}]: {e}, {over}"
            reps = dict(n=4 if big else 20, replays=3)
            us = 1e3 * graph_ms(torch, lambda: ff.conv_frontend_layer(
                x, i, wb, *extra, compute_dtype=bf16), **reps)
            W = ff.layer_weight(wb, i)
            if i == 0:
                xc, wc, s = x[:, None, :], W[:, None, :].float(), ff.BASE_STRIDES[0]
            else:
                xc = x.transpose(1, 2).contiguous()
                wc, s = W.reshape(512, -1, 512).permute(0, 2, 1).contiguous(), ff.BASE_STRIDES[i]
            conv_us = 1e3 * graph_ms(torch, lambda: F.conv1d(xc, wc, stride=s), **reps)
            conv_sum += conv_us
            fl = 2 * B * p["M"] * p["N"] * p["K"]
            b_ms, b_by = bound(fl, x.element_size() * x.numel() + W.element_size() * W.numel()
                               + got.element_size() * got.numel(), BF16_PEAK_FLOPS)
            notes = ""
            if i > 0:  # every tile of the rule's table forced, the plan's marked
                for t, spec in enumerate(ff.FRONTEND_BF16_TILES):
                    alt = ff.conv_frontend_layer(x, i, wb, compute_dtype=bf16, tile=t)
                    t_us = 1e3 * graph_ms(torch, lambda: ff.conv_frontend_layer(
                        x, i, wb, compute_dtype=bf16, tile=t), **reps)
                    notes += (f"; tile {t} ({spec['kernel']} {spec['rows']}x{spec['cols']}"
                              f"{', the plan' if t == p['tile_index'] else ''}) {t_us:.3f} us, "
                              f"{fl / t_us / 1e6:.2f} TFLOP/s, vs plain {_rel(alt, want):.3g}")
                    del alt
            print(f"[frontend-bf16] [{B},{n}] conv{i}: M={p['M']} K={p['K']} tile "
                  f"{p['tile']} splits {p['splits']}, {p['blocks']} blocks: {us:.3f} us, "
                  f"{fl / us / 1e6:.2f} TFLOP/s; bound {1e3 * b_ms:.3f} us ({b_by}), "
                  f"{1e3 * b_ms / us:.3f} of it; F.conv1d ({xc.dtype}) {conv_us:.3f} us "
                  f"({fl / conv_us / 1e6:.2f} TFLOP/s); vs plain {e:.3g}{notes}")
            x = want
            del got, xc, wc
        print(f"[frontend-bf16] [{B},{n}]: F.conv1d per layer summed {conv_sum / 1e3:.5f} ms "
              "(seven calls: no single call computes the frontend)")
        rows[(B, n)] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, f32_ms=ms32)
        del wav, fold, x
        torch.cuda.empty_cache()
    return rows[FRONTEND_BF16_SHAPES[1]]


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


def phase_ddpm(torch, cfg, decoder, pre_decoder):
    """Phase 8; the 50-step checks run on ``decoder`` and on ``pre_decoder``
    (configs/flagship.json's, with the depthwise pre-net), the 1000-step
    run on ``decoder``."""
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

    def loop_args(steps, dec=decoder, weights=w):
        ts = list(range(steps - 1, -1, -1))
        loop = fd.prepare_loop_inputs(dec, sem_idx, T, ts,
                                      step_idx=torch.zeros(steps, dtype=torch.long))
        coef = fd.ddpm_coefficients(DiffusionSchedule.create(steps)).to(dev)
        return (x_T, loop["pos"], loop["mods"], loop["ckv"], coef, weights)

    noise = torch.from_numpy(rng.randn(B, 50, T, cfg.n_mels).astype(np.float32)).to(dev)
    key = (SEED, 0x5EED)
    for label, dec in (("", decoder), (", pre-net", pre_decoder)):
        args50 = loop_args(50, dec, fd.pack_decoder_weights(dec))
        for mode, extra in (("injected", dict(noise=noise)), ("philox", dict(key=key))):
            got = fd.fused_ddpm(*args50, **kw, **extra)
            torch.cuda.synchronize()
            want = fd.fused_ddpm_plain(*args50, **kw, **extra)
            check_ddpm(f"50 steps{label}, {mode} noise, kernel vs plain", got, want)
            if mode == "injected":
                # Witness of the bar: the plain version on the CPU is another
                # float32 summation order with no kernel in it.
                cpu_args = [a.cpu() for a in args50[:5]] + [
                    {k: v.cpu() for k, v in args50[5].items()}]
                cpu = fd.fused_ddpm_plain(*cpu_args, **kw, noise=noise.cpu())
                report_ddpm(f"50 steps{label}, injected noise, plain on the card vs plain on "
                            "the CPU", want.cpu(), cpu)

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

    # The full schedule with the pre-net: timed, finite (its kernel is held to
    # its plain version over 50 steps above).
    pre_args = loop_args(cfg.diff_steps, pre_decoder, fd.pack_decoder_weights(pre_decoder))
    pre_out, pre_ms = timed_call(torch, lambda: fd.fused_ddpm(*pre_args, **kw, key=key))
    assert bool(pre_out.isfinite().all()), "1000-step DDPM with the pre-net: non-finite"
    pre_bound = bound(*fused_flops_bytes(
        B, T, S, cfg.n_mels, cfg.hidden, cfg.heads, cfg.layers, cfg.hidden * cfg.ffn_mult,
        cfg.attn_window_size, cfg.diff_steps, list(pre_args[:5]) + list(pre_args[5].values()),
        prenet=True))
    print(f"[ddpm] {cfg.diff_steps} steps with the pre-net, philox noise: kernel ms="
          f"{pre_ms:.3f}, bound_ms={pre_bound[0]:.4f} ({pre_bound[1]})")
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
    # The bf16 variant over the full schedule: the entry point (its launch
    # counted, deterministic per seed), then the loop on the key of the
    # float32 check above, held by the witness rule to that float32 plain
    # run with the bf16 plain version as the witness.
    bf16 = torch.bfloat16
    sched = DiffusionSchedule.create(cfg.diff_steps).to(dev)
    fd.fused_ddpm.launches = fd.fused_ddpm.bf16_launches = 0
    fd.zero_kernel_launches()
    t0 = time.perf_counter()
    entry16 = fd.fused_ddpm_sample(cfg, sched, decoder, sem_idx, x_T, compute_dtype=bf16,
                                   generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    torch.cuda.synchronize()
    call16_ms = (time.perf_counter() - t0) * 1e3
    launches16 = fd.fused_ddpm.bf16_launches
    assert (fd.fused_ddpm.launches, launches16) == (0, 1), "the bf16 DDPM entry point's launch"
    kinds16 = {k: fd.kernel_launches(k) for k in fd.KERNEL_KINDS}
    check_kinds("ddpm-bf16 entry point", cfg, cfg.diff_steps, kinds16)
    assert torch.equal(entry16, fd.fused_ddpm_sample(
        cfg, sched, decoder, sem_idx, x_T, compute_dtype=bf16,
        generator=torch.Generator(device=DEVICE).manual_seed(SEED))), "bf16 DDPM per seed"
    ts = list(range(cfg.diff_steps - 1, -1, -1))
    loop16 = fd.prepare_loop_inputs(decoder, sem_idx, T, ts,
                                    step_idx=torch.zeros(len(ts), dtype=torch.long),
                                    mods_dtype=bf16)
    w16 = fd.pack_decoder_weights(decoder, bf16)
    args16 = (x_T, loop16["pos"], loop16["mods"], loop16["ckv"].to(bf16), args[4], w16)
    got16, ms16 = timed_call(torch, lambda: fd.fused_ddpm(*args16, **kw, key=key,
                                                         compute_dtype=bf16))
    plain16, plain16_ms = timed_call(torch, lambda: fd.fused_ddpm_plain(
        *args16, **kw, key=key, compute_dtype=bf16))
    e_k, e_p, e_kp = witness16(f"bf16 DDPM {cfg.diff_steps} steps", got16, plain16, want,
                               strict=True)
    err16 = (got16 - plain16).abs().max().item()
    bound16, bound16_by, products, f32, attn = fused_flops_bf16(
        B, T, S, cfg.n_mels, cfg.hidden, cfg.heads, cfg.layers, cfg.hidden * cfg.ffn_mult,
        cfg.attn_window_size, cfg.diff_steps, [*args16[:5], *w16.values()])
    print(f"[ddpm-bf16] {cfg.diff_steps} steps, philox noise: witness: kernel {e_k:.4g} from the "
          f"float32 plain, bf16 plain {e_p:.4g} (bar {1.5 * e_p + 1e-3:.4g}), kernel vs bf16 "
          f"plain {e_kp:.4g} (max abs {err16:.4g}); kernel ms={ms16:.3f} (float32 {ms:.3f}), "
          f"bf16 plain_ms={plain16_ms:.3f}; fused_ddpm_sample(compute_dtype=bf16) {call16_ms:.3f} "
          f"ms per call (host clock), bf16 launches={launches16}; {products / 1e12:.4f} TFLOP "
          f"of bf16 products ({attn / 1e12:.4f} attention): bound_ms={bound16:.4f} "
          f"({bound16_by}); with the attention in float32 FMA as this kernel runs it "
          f"{attention_fma_ms(products, f32, attn):.4f} ms")
    # The kernels line reports the error at the main path's 1000-step shape.
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bf16=dict(launches=launches16, max_abs_err=err16, ms=ms16, plain_ms=plain16_ms,
                          bound_ms=bound16, bound_by=bound16_by, kinds=kinds16))


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
        # The bucket changes the HuBERT's row count, so its float32 features
        # may move by rounding (cuBLAS picks kernels by shape) and a token at
        # an FSQ rounding edge may flip.  So the quantizer's input (the
        # projection, recorded by a hook on each prep's quantizer) is held
        # at 1e-4 over the valid latents, the tokens by phase 7's >= 99%,
        # z_q bit for bit wherever the tokens agree and zero past the valid
        # latents.  The chunks' mean and std come from the mel frontend on
        # the unpadded wav, which the bucket never touches: bit for bit.
        exact = LongFormPipeline(cfg, pipe.schedule, pipe.decoder, pipe.encoder, device=DEVICE)
        quantized = []
        hook = pipe.encoder.vq.register_forward_hook(
            lambda mod, inp, res: quantized.append((inp[0].float().cpu(), res[1].cpu())))
        try:
            z, mean, std, seeds = exact.stream_prep(wavs[2], seed=2)
            zb, mean_b, std_b, seeds_b = pipe.stream_prep(wavs[2], seed=2)
        finally:
            hook.remove()
        assert len(quantized) == 2, f"{len(quantized)} quantizer calls in two preps"
        (proj, idx), (proj_b, idx_b) = quantized
        S = z.shape[1]
        assert proj.shape[1] == idx.shape[1] == S and proj_b.shape[1] >= S
        p_err = (proj_b[:, :S] - proj).abs().max().item()
        same = (idx_b[:, :S] == idx).numpy()
        z_same = np.array_equal(zb[:, :S][same], z[same])
        assert p_err <= 1e-4 and same.mean() >= 0.99 and z_same and np.all(zb[:, S:] == 0.0), (
            p_err, same.mean(), z_same)
        assert np.array_equal(mean_b, mean) and np.array_equal(std_b, std)
        assert np.array_equal(seeds, seeds_b)
        print(f"[serve] bucketed prep (8 s bucket) vs exact length, 6 s stream: projection max "
              f"err {p_err:.3g} (bar 1e-4) over {S} latents; tokens equal {same.mean():.4f} "
              f"({int((~same).sum())} flipped; bar >= 0.99); z_q equal bit for bit where they "
              f"agree, zero past them; chunk mean and std bit-equal")
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
        print(f"[serve] prep of the 6 s stream, 8 s bucket, {S} valid latents: FSQ indices, "
              f"kernel route vs module route: {tok:.4%} equal")

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
    pcfg = dataclasses.replace(cfg, run_name="precomputed", diffusion_epochs=1,
                               ckpt_every_steps=0)
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
          f"route, {utterances} utterances in {precompute_s:.3f} s), diffusion: "
          f"{ms['precomputed diffusion']:.3f} ms per data step, "
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
    # Both final models carry the depthwise pre-net (configs/flagship.json):
    # each is served through backend="fused", one launch per request, the
    # flagship's held to the eager backend by phase 4's bar on the same x_T.
    x_T = torch.from_numpy(np.random.RandomState(6100 + SEED).randn(1, 200, cfg.n_mels)
                           .astype(np.float32)).to(DEVICE)
    eager_err, fused_launches = None, 0
    for name, rdir in (("flagship", run_dir), ("precomputed",
                                               os.path.join(pcfg.out_dir, pcfg.run_name))):
        fcfg, dec_sd, _, _ = load_checkpoint(os.path.join(rdir, "edge_model_final"))
        assert fcfg.use_depthwise, f"the {name} final model has no pre-net"
        dec = EdgeDiffusionDecoder(fcfg)
        dec.load_state_dict(dec_sd)
        engine = EdgeInference(fcfg, schedule, dec, prediction="v", backend="fused",
                               device=DEVICE)
        fd.fused_ddim.launches = 0
        mel = engine.generate_mel(tokens, num_steps=4, x_T=x_T)
        torch.cuda.synchronize()
        assert fd.fused_ddim.launches == 1, fd.fused_ddim.launches
        fused_launches += fd.fused_ddim.launches
        assert mel.shape == (1, 200, cfg.n_mels) and torch.isfinite(mel).all()
        if name == "flagship":
            eager = EdgeInference(fcfg, schedule, dec, prediction="v", device=DEVICE)
            eager_err = v_rule("the flagship final model, fused vs eager", mel,
                               eager.generate_mel(tokens, num_steps=4, x_T=x_T))
    seconds = time.perf_counter() - t_phase
    print(f"[train] served through backend='fused' (the depthwise pre-net on): the flagship "
          f"final model (vs the eager backend, max err {eager_err:.3g}; bar 0.05 "
          f"and 2e-4 on 99.9%) and the precomputed run's: finite, one fused_ddim launch each, "
          f"{fused_launches} in all")
    print(f"[train] phase 10: {seconds:.3f} s (train() {train_s:.3f} s, resume {resume_s:.3f} "
          f"s, precomputed {precompute_s + pre_s:.3f} s); conv_frontend launches "
          f"{frontend_launches}")
    return dict(frontend_launches=frontend_launches, fused_launches=fused_launches,
                ms=ms, peak_gb=peak_gb, seconds=seconds)




# -- phase 14: configs/tpu_large_batch.json in bf16 ---------------------------------------

LARGE_UTTERANCES = 560  # phase 14's corpus: 532 train (two batches of 256), 28 validation
# Phase 14's cuts of configs/tpu_large_batch.json: epochs only (and no plots).
LARGE_CUTS = dict(diffusion_epochs=1, progressive_epochs_per_halving=1, consistency_epochs=1,
                  plot_every_steps=0, ckpt_every_steps=12, log_every_steps=1)
LARGE_TIMED = 5  # device-resident data steps timed per dtype, after two warm-up steps


def _steady_ms(clock: StepClock, first: int, last: int, spe: int, skip=()) -> float:
    """Mean host-clock interval of the data steps first..last whose previous
    step ran in the same epoch (with two steps per epoch: every second one),
    leaving out the steps after those in ``skip`` (periodic checkpoints)."""
    ms = [(clock.stamps[k] - clock.stamps[k - 1]) * 1e3 for k in range(first, last + 1)
          if (k - 1) % spe and k - 1 in clock.stamps and k - 1 not in skip]
    assert ms, (first, last)
    return float(np.mean(ms))


def _witness_step(torch, cfg, hubert_cfg, enc_sd, dec_sd, batch) -> dict:
    """One diffusion loss and its gradients at float32 and bf16, on the CPU
    and on the card: ``{(device, dtype): (loss, {name: gradient})}``."""
    from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder, SemanticEncoder
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
    from edge_diffusion_tts_tpu_torch.training import Trainer, TrainState
    from edge_diffusion_tts_tpu_torch.training.state import trainable_parameters

    out = {}
    for device in ("cpu", DEVICE):
        for dtype in (torch.float32, torch.bfloat16):
            enc = SemanticEncoder(cfg, hubert_cfg, dtype=dtype)
            enc.load_state_dict(enc_sd)
            dec = EdgeDiffusionDecoder(cfg, dtype=dtype)
            dec.load_state_dict(dec_sd)
            trainer = Trainer(cfg, enc, dec, DiffusionSchedule.create(cfg.diff_steps),
                              device=device)
            st = TrainState(trainer.encoder, trainer.decoder, optimizer=None)
            st.train()
            loss, _ = trainer.make_diffusion_loss()(st, trainer.put_batch(batch), None)
            loss.backward()
            out[(device, dtype)] = (loss.item(), {
                n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().double().cpu()
                for n, p in trainable_parameters(trainer.encoder, trainer.decoder).items()})
    return out


def phase_large_batch(torch, cuts=None, hubert_cfg=None, utterances: int = LARGE_UTTERANCES):
    """Phase 14: ``train()`` at configs/tpu_large_batch.json (batch 256,
    compute bf16) with the full HuBERT-base frozen on the frontend's bf16
    variant (the module docstring's phase 14); returns its launches."""
    import dataclasses
    import shutil

    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.data import Collate, LJSpeechDataset
    from edge_diffusion_tts_tpu_torch.inference import EdgeInference
    from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder, HubertConfig
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
    from edge_diffusion_tts_tpu_torch.training import (Trainer, create_train_state, init_models,
                                                       make_optimizer,
                                                       progressive_step_schedule, train)
    from edge_diffusion_tts_tpu_torch.weights import load_checkpoint

    t_phase = time.perf_counter()
    hubert_cfg = hubert_cfg or HubertConfig()
    base = os.path.join(ROOT, "build", "phase14")
    shutil.rmtree(base, ignore_errors=True)
    lj = os.path.join(base, "LJSpeech-1.1")
    t0 = time.perf_counter()
    write_ljspeech(lj, utterances, SEED + 14)
    corpus_s = time.perf_counter() - t0
    with open(os.path.join(ROOT, "configs", "tpu_large_batch.json")) as f:
        large = json.load(f)
    cfg = CFG.from_dict(dict(large, **dict(LARGE_CUTS, **(cuts or {})),
                             out_dir=os.path.join(base, "out"), run_name="bf16",
                             ljspeech_dir=lj, data_root=base, ckpt_path=""))
    assert cfg.compute_dtype == "bfloat16" and cfg.param_dtype == "float32"
    B = cfg.batch_size
    spe = (utterances - int(utterances * 0.05)) // B
    assert spe >= 2, f"{spe} steps per epoch: the corpus needs two full batches"
    halvings = progressive_step_schedule(cfg.diff_steps, cfg.progressive_target_steps)
    d_end = spe * cfg.diffusion_epochs
    p_end = d_end + spe * cfg.progressive_epochs_per_halving * len(halvings)
    total = p_end + spe * cfg.consistency_epochs
    ds = LJSpeechDataset(lj, "train")
    collate = Collate(cfg, deterministic=True)
    t0 = time.perf_counter()
    host_batch = collate([ds[i] for i in range(B)])
    collate_ms = (time.perf_counter() - t0) * 1e3
    print(f"[large] corpus: {utterances} utterances of 2.5-4 s at 22,050 Hz in {corpus_s:.2f} s; "
          f"configs/tpu_large_batch.json: batch {B} x {cfg.segment_len} samples, compute "
          f"{cfg.compute_dtype}, params {cfg.param_dtype}, {spe} steps per epoch, halvings "
          f"{halvings}, {total} data steps; one batch's collate on the host {collate_ms:.3f} ms")

    # -- a. train() in bf16, all three phases ---------------------------------------------
    clock, tags, dtypes_seen = StepClock(), [], {}

    def at_phase_end(tag, st):
        tags.append((tag, st.step))
        dtypes_seen[tag] = ({q.dtype for q in st.decoder.parameters()}, st.decoder.dtype,
                            st.encoder.dtype)

    ff.conv_frontend.launches = ff.conv_frontend.bf16_launches = 0  # counts to 0: the main path
    fd.fused_ddim.launches = 0
    wgmma0 = ff.wgmma_launches() if DEVICE == "cuda" else 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train(cfg, hubert_cfg=hubert_cfg, hooks=[clock], phase_end_hook=at_phase_end,
                  device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    bf16_launches, f32_launches = ff.conv_frontend.bf16_launches, ff.conv_frontend.launches
    wgmma = ff.wgmma_launches() - wgmma0 if DEVICE == "cuda" else 0
    assert DEVICE != "cuda" or wgmma >= bf16_launches, (
        f"{wgmma} wgmma conv launches for {bf16_launches} bf16 frontend calls")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    run_dir = os.path.join(cfg.out_dir, cfg.run_name)
    assert state.step == total, (state.step, total)
    assert f32_launches == 0, f"the bf16 trainer launched the float32 frontend {f32_launches}x"
    assert bf16_launches == total, f"bf16 frontend launches {bf16_launches}, data steps {total}"
    assert [t for t, _ in tags] == (["init", "diffusion"] + [f"prog{h}" for h in halvings]
                                    + ["consistency"]), tags
    assert all(v == ({torch.float32}, torch.bfloat16, torch.bfloat16)
               for v in dtypes_seen.values()), dtypes_seen
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [v for r in recs for k, v in r.items() if k.endswith("loss")]
    assert losses and all(math.isfinite(v) for v in losses), "a logged loss is not finite"
    skip = set(range(0, total + 1, cfg.ckpt_every_steps))
    ms = {"diffusion": _steady_ms(clock, 1, d_end, spe, skip),
          "progressive": _steady_ms(clock, d_end + 1, p_end, spe, skip),
          "consistency": _steady_ms(clock, p_end + 1, total, spe, skip)}
    for name, v in ms.items():
        print(f"[large] bf16 train(), {name}: {v:.3f} ms per data step (host clock, the steps "
              f"after a step of the same epoch), {B / v * 1e3:.1f} utterances/s")
    print(f"[large] bf16 train(): {total} data steps in {train_s:.3f} s, {len(losses)} logged "
          f"losses, all finite; bf16 frontend launches {bf16_launches} (one per data step; "
          f"{wgmma} wgmma conv layers in them), float32 frontend 0; parameters float32, modules bf16; peak "
          f"torch.cuda.max_memory_allocated {peak_gb:.3f} GiB")

    # -- b. resume from the periodic checkpoint -----------------------------------------------
    with open(os.path.join(cfg.ckpt_path, "meta.json")) as f:
        meta = json.load(f)
    rtags = []
    ff.conv_frontend.bf16_launches = 0
    t0 = time.perf_counter()
    resumed = train(dataclasses.replace(cfg, run_name="resumed"), hubert_cfg=hubert_cfg,
                    resume="auto", device=DEVICE, phase_end_hook=lambda tag, st: rtags.append(tag))
    resume_s = time.perf_counter() - t0
    bf16_launches += ff.conv_frontend.bf16_launches
    assert meta["phase"] == "progressive", meta
    want_tags = [f"prog{h}" for h in halvings[halvings.index(meta["halving"]):]] + ["consistency"]
    assert rtags == want_tags, (rtags, want_tags)
    print(f"[large] resume='auto' from step {meta['step']} (halving {meta['halving']}): ran "
          f"{rtags} to step {resumed.step} in {resume_s:.3f} s")
    del resumed

    # -- c. the same batch in float32 through train(), compute_dtype alone changed -----------
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32", run_name="f32", diffusion_epochs=2,
                                ckpt_every_steps=0)
    clock32 = StepClock()
    torch.cuda.reset_peak_memory_stats()
    ff.conv_frontend.launches = 0
    t0 = time.perf_counter()
    train(cfg32, hubert_cfg=hubert_cfg, hooks=[clock32], phases=["diffusion"], device=DEVICE)
    torch.cuda.synchronize()
    f32_s = time.perf_counter() - t0
    f32_launches = ff.conv_frontend.launches
    assert f32_launches == 2 * spe, f32_launches
    peak32_gb = torch.cuda.max_memory_allocated() / 2**30
    ms["float32 diffusion"] = _steady_ms(clock32, 1, 2 * spe, spe)
    print(f"[large] float32 train(), diffusion: {ms['float32 diffusion']:.3f} ms per data step "
          f"({B / ms['float32 diffusion'] * 1e3:.1f} utterances/s) against bf16's "
          f"{ms['diffusion']:.3f}; {2 * spe} steps in {f32_s:.3f} s; peak {peak32_gb:.3f} GiB")

    # -- d. the device-resident step: the batch on the card, no collate ----------------------
    wav = torch.from_numpy(np.asarray(host_batch["wav"])).to(DEVICE)
    resident = {}
    for name, c in (("bfloat16", cfg), ("float32", cfg32)):
        torch.manual_seed(SEED)
        enc, dec = init_models(c, hubert_cfg)
        trainer = Trainer(c, enc, dec, DiffusionSchedule.create(c.diff_steps), device=DEVICE)
        st = create_train_state(trainer.encoder, trainer.decoder,
                                make_optimizer(c, trainer.encoder, trainer.decoder, 100))
        step = trainer.make_diffusion_step()
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        for _ in range(2):
            st, _ = step(st, {"wav": wav}, gen)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LARGE_TIMED):
            st, metrics = step(st, {"wav": wav}, gen)
        torch.cuda.synchronize()
        resident[name] = ((time.perf_counter() - t0) * 1e3 / LARGE_TIMED,
                          torch.cuda.max_memory_allocated() / 2**30)
        assert math.isfinite(float(metrics["loss"]))
        del enc, dec, trainer, st, step
        torch.cuda.empty_cache()
    ms["resident bf16"], ms["resident float32"] = resident["bfloat16"][0], resident["float32"][0]
    print(f"[large] device-resident diffusion step at batch {B} (mean of {LARGE_TIMED} after two "
          f"warm-ups, host clock around synchronize): bf16 {resident['bfloat16'][0]:.3f} ms "
          f"(peak {resident['bfloat16'][1]:.3f} GiB), float32 {resident['float32'][0]:.3f} ms "
          f"(peak {resident['float32'][1]:.3f} GiB)")

    # -- e. one bf16 step against float32, on the card and on the CPU (the witness) ----------
    W = min(4, B)
    cfg0 = dataclasses.replace(cfg, dropout=0.0, cfg_dropout=0.0, batch_size=W)
    enc_sd = {k: v.cpu() for k, v in state.encoder.state_dict().items()}
    dec_sd = {k: v.cpu() for k, v in state.decoder.state_dict().items()}
    w32 = ff.pack_frontend_weights(state.encoder.hubert.feature_extractor)
    x = wav[:W]
    with torch.no_grad():
        enc32 = init_models(cfg32, hubert_cfg)[0]
        enc32.load_state_dict(enc_sd)
        enc32 = enc32.to(DEVICE).eval()
        ff.conv_frontend.launches = 0
        feats = enc32.extract_hubert(x, conv_feats=ff.conv_frontend(x, w32)).cpu()
        f32_launches += ff.conv_frontend.launches
        del enc32
    rs = np.random.RandomState(14000 + SEED)
    batch = {"wav": x.cpu().numpy(), "hubert_features": feats,
             "t": rs.randint(1, cfg0.max_timestep, W),
             "noise": rs.randn(W, cfg0.segment_mel_frames, cfg0.n_mels).astype(np.float32)}
    res = _witness_step(torch, cfg0, hubert_cfg, enc_sd, dec_sd, batch)
    f32, bf = torch.float32, torch.bfloat16
    (l32c, g32c), (lbc, gbc) = res[("cpu", f32)], res[("cpu", bf)]
    (l32g, g32g), (lbg, gbg) = res[(DEVICE, f32)], res[(DEVICE, bf)]
    e_card, e_cpu = abs(lbg - l32g) / abs(l32g), abs(lbc - l32c) / abs(l32c)
    assert e_card <= 1.5 * e_cpu + 1e-3, (e_card, e_cpu)

    def cos(a, b):
        return (a * b).sum().item() / max(a.norm().item() * b.norm().item(), 1e-300)

    worst = (1.0, None)
    for name in g32g:
        if g32g[name].norm() < 1e-12 or gbc[name].norm() < 1e-12:
            continue
        c_card, c_cpu = cos(gbg[name], g32g[name]), cos(gbc[name], g32c[name])
        assert c_card >= c_cpu - 0.01, (name, c_card, c_cpu)
        worst = min(worst, (c_card, name))
    print(f"[large] one diffusion loss at batch {W} (the trained weights, injected t and noise, "
          f"HuBERT features given, dropout 0): bf16 vs float32 on the card rel {e_card:.4g}, "
          f"on the CPU (the witness) {e_cpu:.4g}, bar {1.5 * e_cpu + 1e-3:.4g}; lowest gradient "
          f"cosine bf16 vs float32 on the card {worst[0]:.6f} ({worst[1]}), every one within "
          "0.01 of the CPU's")

    # -- f. serve the final model through backend="fused" -------------------------------------
    fcfg, dec_sd_final, _, _ = load_checkpoint(os.path.join(run_dir, "edge_model_final"))
    dec = EdgeDiffusionDecoder(fcfg)  # float32 modules, as the JAX package serves
    dec.load_state_dict(dec_sd_final)
    schedule = DiffusionSchedule.create(fcfg.diff_steps)
    engine = EdgeInference(fcfg, schedule, dec, prediction="v", backend="fused", device=DEVICE)
    tokens = torch.from_numpy(np.random.RandomState(14100 + SEED)
                              .randint(0, fcfg.effective_codebook_size(), (1, 100))).to(DEVICE)
    x_T = torch.from_numpy(np.random.RandomState(14200 + SEED).randn(1, 200, fcfg.n_mels)
                           .astype(np.float32)).to(DEVICE)
    fd.fused_ddim.launches = 0
    mel = engine.generate_mel(tokens, num_steps=4, x_T=x_T)
    torch.cuda.synchronize()
    fused_launches = fd.fused_ddim.launches
    assert fused_launches == 1 and mel.shape == (1, 200, fcfg.n_mels)
    eager = EdgeInference(fcfg, schedule, dec, prediction="v", device=DEVICE)
    err = v_rule("the large-batch final model, fused vs eager", mel,
                 eager.generate_mel(tokens, num_steps=4, x_T=x_T))
    seconds = time.perf_counter() - t_phase
    print(f"[large] the final model (float32 parameters) served through backend='fused': one "
          f"launch, finite, vs the eager backend max err {err:.3g} (bar 0.05, and 2e-4 on "
          f"99.9%); phase 14: {seconds:.3f} s")
    return dict(bf16_launches=bf16_launches, frontend_launches=f32_launches,
                fused_launches=fused_launches, ms=ms, peak_gb=peak_gb, seconds=seconds)

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


PAR_BF16 = ("float32", "bfloat16")  # phase 11's bf16 pass: compute bf16, these parameter dtypes
# Phase 11b's bf16 run: configs/tpu_large_batch.json as phase 14 cuts it, the
# halvings cut to 1000 -> 500 -> 250: 4 epochs of 2 data steps on phase 14's corpus.
PAR_LARGE_CUTS = dict(LARGE_CUTS, progressive_target_steps=250)


def par_models16(torch, cfg, base, param_dtype: str):
    """``base`` (``par_models``) rebuilt at compute bf16, every parameter
    stored at ``param_dtype`` (``training.init_models``'s dtypes), the same
    weights rounded where stored in bf16."""
    from edge_diffusion_tts_tpu_torch.layers.dtypes import cast_parameters
    from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder, SemanticEncoder

    bf16, pdt = torch.bfloat16, getattr(torch, param_dtype)
    enc = cast_parameters(SemanticEncoder(cfg, base[0].hubert_cfg, dtype=bf16), pdt)
    enc.load_state_dict(base[0].state_dict())
    out = [enc.eval()]
    for d in base[1:]:
        dec = cast_parameters(EdgeDiffusionDecoder(cfg, dtype=bf16), pdt)
        dec.load_state_dict(d.state_dict())
        out.append(dec.eval())
    return tuple(out)


def par_dtypes(module) -> tuple:
    """(compute dtype, parameter dtypes) of a module, as strings."""
    return str(module.dtype), sorted({str(p.dtype) for p in module.parameters()})


def par_rank_bf16(rank: int, spec: dict, base, dp, pipe, tp) -> dict:
    """Phase 11's bf16 pass on one rank: a, the DP steps, and f, the PP
    step, at compute bf16 with float32 and with bf16 parameters; c,
    sequence-parallel long-form at a bf16-compute decoder; d, the TP encode
    of a bf16 encoder; b, ``train()`` at configs/tpu_large_batch.json on an
    [n, 1] mesh.  Every launch count set to 0 just before its run, read just
    after."""
    import dataclasses
    import hashlib

    import torch

    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder, HubertConfig
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
    from edge_diffusion_tts_tpu_torch.ops import window_attention as wa
    from edge_diffusion_tts_tpu_torch.parallel import (make_seq_parallel_generate,
                                                       make_tp_encode, shard_batch,
                                                       shard_encoder_params)
    from edge_diffusion_tts_tpu_torch.parallel.pipeline_parallel import (create_pp_state,
                                                                         make_pp_trainer)
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
    from edge_diffusion_tts_tpu_torch.training import constant_schedule, train

    n = dp.axis("data").size
    out = {"dp": {}, "pp": {}, "dp_ms": {}, "pp_ms": {}}
    cfg = par_flagship_cfg()

    # a and f: compute bf16, parameters float32 (tpu_large_batch.json's pair), then bf16.
    ff.conv_frontend.launches = ff.conv_frontend.bf16_launches = 0
    timed = 0
    for pdt in PAR_BF16:
        cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16", param_dtype=pdt)
        base16 = par_models16(torch, cfg16, base, pdt)
        for kind in PAR_STEPS:
            trainer, state = par_trainer(torch, cfg16, base16, with_teacher=kind == "progressive")
            out["dp"][(pdt, kind)] = par_run_step(torch, trainer, state, kind,
                                                  shard_batch(spec["batches"][kind], dp), dp)
        trainer, state = par_trainer(torch, cfg16, base16, with_teacher=False)
        launched = ff.conv_frontend.bf16_launches
        out["dp_ms"][pdt] = par_step_ms(torch, par_step(trainer, "diffusion", dp), state,
                                        spec["batches"]["diffusion"],
                                        lambda b, t=trainer: t.put_batch(shard_batch(b, dp)))
        timed += ff.conv_frontend.bf16_launches - launched
        trainer, _ = par_trainer(torch, cfg16, base16, with_teacher=False)
        pp = make_pp_trainer(trainer, pipe, 2)
        state = create_pp_state(pp, 100, learning_rate=constant_schedule(1e-3))
        res = par_run_step(torch, pp, state, "diffusion", spec["batches"]["diffusion"])
        k = len(state.decoder.layers)
        res["grads"] = {(f"decoder.layers.{rank * k + int(m.split('.')[2])}."
                         f"{m.split('.', 3)[3]}" if m.startswith("decoder.layers.") else m): g
                        for m, g in res["grads"].items()}
        res.pop("params")
        res["dtypes"] = {"source": par_dtypes(trainer.decoder), "stage": par_dtypes(state.decoder)}
        out["pp"][pdt] = res
        launched = ff.conv_frontend.bf16_launches
        out["pp_ms"][pdt] = par_step_ms(torch, pp.make_diffusion_step(), state,
                                        spec["batches"]["diffusion"], pp.put_batch)
        timed += ff.conv_frontend.bf16_launches - launched
        del base16, trainer, state, pp
    out["steps_launches"] = ff.conv_frontend.bf16_launches - timed
    out["steps_timed_launches"] = timed
    out["steps_f32_launches"] = ff.conv_frontend.launches

    # c. sequence-parallel long-form at a bf16-compute decoder: the bf16 band kernel per shard.
    lcfg = par_longform_cfg()
    dec = EdgeDiffusionDecoder(lcfg, dtype=torch.bfloat16)
    dec.load_state_dict(seeded_decoder(torch, lcfg, SEED).state_dict())
    dec = dec.to(DEVICE).eval()
    lsched = DiffusionSchedule.create(lcfg.diff_steps).to(DEVICE)
    gen = make_seq_parallel_generate(lcfg, dec, lsched, dp, PAR_SEQ["steps"], prediction="eps")
    sem, x_T = par_seq_inputs(torch, lcfg, spec["seq_S"])
    wa.banded_attention.launches = wa.banded_attention.bf16_launches = 0
    x0 = gen(sem, x_T)
    torch.cuda.synchronize()
    out["seq"] = {"x0": x0.cpu(), "launches": wa.banded_attention.bf16_launches,
                  "f32_launches": wa.banded_attention.launches}
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED):
        gen(sem, x_T)
    torch.cuda.synchronize()
    out["seq"]["ms"] = (time.perf_counter() - t0) * 1e3 / PAR_TIMED
    out["seq"]["timed_launches"] = wa.banded_attention.bf16_launches - out["seq"]["launches"]
    del dec

    # d. the TP encode of the 5 s wav by a bf16 encoder (float32 parameters).
    enc = par_models16(torch, cfg, base[:1], "float32")[0].to(DEVICE)
    params = shard_encoder_params(enc, tp)
    encode = make_tp_encode(enc, tp)
    wav = torch.from_numpy(spec["tp_wav"]).to(DEVICE)
    ff.conv_frontend.launches = ff.conv_frontend.bf16_launches = 0
    tokens = encode(params, wav)
    feats = encode.features(params, wav)
    torch.cuda.synchronize()
    out["tp"] = {"tokens": tokens.cpu(), "features": feats.float().cpu(),
                 "launches": ff.conv_frontend.bf16_launches,
                 "f32_launches": ff.conv_frontend.launches, "local": par_dtypes(encode.local)}
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED):
        encode(params, wav)
    torch.cuda.synchronize()
    out["tp"]["ms"] = (time.perf_counter() - t0) * 1e3 / PAR_TIMED
    out["tp"]["timed_launches"] = ff.conv_frontend.bf16_launches - out["tp"]["launches"]
    del enc, params, encode

    # b. train() at configs/tpu_large_batch.json (compute bf16, parameters float32,
    # batch 256) on an [n, 1] mesh, on phase 14's corpus.
    hashes, clock = [], StepClock()

    def watch(step, st):  # the parameters after every optimizer update
        if st.optimizer.mini_step == 0:
            flat = _flat(st.optimizer.params.values()).float().cpu().numpy()
            hashes.append((step, hashlib.sha1(flat.tobytes()).hexdigest()))

    with open(os.path.join(ROOT, "configs", "tpu_large_batch.json")) as f:
        large = json.load(f)
    tcfg = CFG.from_dict(dict(large, **spec["large_cuts"], mesh_shape=[n, 1],
                              out_dir=spec["train_out"], run_name="large",
                              ljspeech_dir=spec["large_corpus"],
                              data_root=os.path.dirname(spec["large_corpus"]), ckpt_path=""))
    dtypes = []
    ff.conv_frontend.launches = ff.conv_frontend.bf16_launches = 0
    t0 = time.perf_counter()
    state = train(tcfg, hubert_cfg=HubertConfig(**spec["hubert"]), hooks=[watch, clock],
                  device=DEVICE, phase_end_hook=lambda tag, st: dtypes.append(
                      (tag, par_dtypes(st.decoder), par_dtypes(st.encoder))))
    torch.cuda.synchronize()
    out["train"] = {"seconds": time.perf_counter() - t0, "hashes": hashes, "step": state.step,
                    "launches": ff.conv_frontend.bf16_launches,
                    "f32_launches": ff.conv_frontend.launches, "dtypes": dtypes,
                    "stamps": clock.stamps, "batch": tcfg.batch_size,
                    "run_dir": tcfg.get_run_dir()}
    return out


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
    del state
    out["bf16"] = par_rank_bf16(rank, dict(spec, train_out=spec["train_out16"]), base, dp, pipe,
                                tp)
    return out


def _min_cosine(torch, got: dict, want: dict) -> float:
    return min(float(torch.nn.functional.cosine_similarity(
        got[n].double().reshape(1, -1), g.double().reshape(1, -1))[0])
        for n, g in want.items() if g.norm() > 0)


def phase_parallel(torch, cfg, decoder, hubert=None, train_cuts=None,
                   seq_S=PAR_SEQ["S"], setup=None, nranks: int = 2, backend: str = "gloo",
                   large=None, large_cuts=None):
    """Phase 11: ``parallel/`` on the card (the module docstring's phase 11);
    returns the launches of its kernels and its times.  ``nranks`` ranks
    over ``backend``: two over gloo on cuda:0 as this script runs it; with
    NCCL each rank takes its own card (``port_profile.py --nccl``), and
    ``make_dp_generate`` splits over every card.  ``large`` is phase 14's
    result (its ms per data step is printed beside 11b's bf16 run, which
    trains on phase 14's corpus).  ``hubert`` (HubertConfig fields),
    ``train_cuts``, ``large_cuts``, ``seq_S`` and ``setup`` (run first on
    every rank) are a CPU rehearsal's cuts; the card runs the defaults."""
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
    large_corpus = os.path.join(ROOT, "build", "phase14", "LJSpeech-1.1")
    assert os.path.isfile(os.path.join(large_corpus, "metadata.csv")), \
        "phase 14's corpus is missing"
    spec = dict(batches=batches, tp_wav=(0.2 * rng.randn(1, 80000)).astype(np.float32),
                corpus=corpus, train_out=os.path.join(out_dir, "out"), device=DEVICE,
                card_per_rank=per_card, hubert=hubert,
                train_cuts=dict(PAR_TRAIN_CUTS, **(train_cuts or {})), seq_S=seq_S,
                setup=setup, large_corpus=large_corpus,
                large_cuts=dict(PAR_LARGE_CUTS, **(large_cuts or {})),
                train_out16=os.path.join(out_dir, "large"))
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
    one_by_kind = {}
    for kind in PAR_STEPS:
        trainer, state = par_trainer(torch, fcfg, base, with_teacher=kind == "progressive")
        one = one_by_kind[kind] = par_run_step(torch, trainer, state, kind, batches[kind])
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

    want = seq_want = single_seq()
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

    singles = {"dp": {kind: one_by_kind[kind] for kind in PAR_STEPS}, "ms": single_ms,
               "seq": seq_want, "seq_ms": seq_single_ms, "tp_features": feats.cpu(),
               "tp_tokens": tokens.cpu(), "tp_ms": tp_single_ms}
    out.update(parallel_bf16(torch, ranks, base, batches, spec, singles, large, note))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[parallel] phase 11: {out['seconds']:.3f} s (the ranks {ranks_s:.3f} s)")
    out["frontend_launches"] = sum(
        r["dp_launches"] + r["dp_timed_launches"] + r["pp_launches"] + r["tp"]["launches"]
        + r["tp"]["timed_launches"] + r["train"]["launches"] for r in ranks)
    out["banded_launches"] = sum(r["seq"]["launches"] + r["seq"]["timed_launches"]
                                 + r["seq"]["one_step_launches"] for r in ranks)
    out["fused_launches"] = fused_launches
    return out


def par_witness16(failures: list, label: str, q, q_ref, q32) -> str:
    """The witness rule: ``q`` (bf16, parallel) no farther from ``q32``
    (float32, one device), normwise, than 1.5 times ``q_ref`` (bf16, one
    device) + 1e-3; a miss is added to ``failures``.  Returns the reading
    for the printout."""
    import torch

    def rel(a):
        a, b = torch.as_tensor(a).double(), torch.as_tensor(q32).double()
        return float((a - b).norm() / max(float(b.norm()), 1e-30))

    e, e_ref = rel(q), rel(q_ref)
    bar = 1.5 * e_ref + 1e-3
    if not e <= bar:
        failures.append(f"{label}: {e:.4g} from float32, one device's bf16 {e_ref:.4g}, "
                        f"bar {bar:.4g}")
    return f"{e:.4g} (one device {e_ref:.4g}, bar {bar:.4g})"


def _cos(a, b) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(a @ b / max(float(a.norm() * b.norm()), 1e-300))


def par_cosines16(failures: list, label: str, got: dict, ref: dict, g32: dict) -> str:
    """Every gradient tensor's cosine to float32's no lower than the
    reference's - 0.01 (misses added to ``failures``); returns the lowest,
    for the printout."""
    if set(got) != set(g32):
        failures.append(f"{label}: gradient names differ {sorted(set(got) ^ set(g32))[:4]}")
        return "names differ"
    worst = (2.0, 2.0, None)
    for n, w in g32.items():
        if w.norm() == 0 or ref[n].norm() == 0:
            continue
        c, c_ref = _cos(got[n], w), _cos(ref[n], w)
        if not c >= c_ref - 0.01:
            failures.append(f"{label} {n}: cosine {c:.6f}, the reference's {c_ref:.6f}")
        worst = min(worst, (c, c_ref, n))
    if worst[2] is None:
        failures.append(f"{label}: no nonzero gradient")
    return f"lowest gradient cosine to float32 {worst[0]:.6f} ({worst[2]}; reference {worst[1]:.6f})"


def _flat_grads(grads: dict):
    import torch

    return torch.cat([grads[n].double().reshape(-1) for n in sorted(grads)])


def par_microbatched(trainer, n_mb: int):
    """``trainer`` (one device) with its decoder's blocks run per microbatch
    of ``n_mb``, as ``PPTrainer._decode`` runs them over the stages: the
    pipeline step's gradients accumulate the same per-microbatch products,
    so this is the PP step's one-device oracle (its context and
    conditioning gradients add in another order)."""
    import types

    import torch

    def decode(self, decoder, x_t, t, generator=None, sem_mask=None, mel_mask=None, **cond):
        h0, context, t_cond = decoder.prelude(x_t, t, **cond)
        outs = []
        for h, c, tc in zip(h0.chunk(n_mb), context.chunk(n_mb), t_cond.chunk(n_mb)):
            for block in decoder.layers:
                h = block(h, c, cond=tc, generator=generator)
            outs.append(h)
        return decoder.postlude(torch.cat(outs))

    trainer._decode = types.MethodType(decode, trainer)
    return trainer


def parallel_bf16(torch, ranks, base, batches, spec, singles, large, note) -> dict:
    """Phase 11's bf16 pass (``par_rank_bf16`` on every rank), held against
    the single device at compute bf16 by the witness rule, float32's single
    device as Q32, and each step's gradients against its one-device oracle
    (the module docstring's phase 11g); every check is made and printed,
    then any miss fails the phase.  Returns its launches and times."""
    import dataclasses

    from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule, ddim_sample
    from edge_diffusion_tts_tpu_torch.training import progressive_step_schedule

    n, bf16 = len(ranks), torch.bfloat16
    rb = [r["bf16"] for r in ranks]
    r0 = rb[0]
    per_rank = lambda f: " / ".join(f"{f(r):.3f}" for r in rb)  # noqa: E731
    fcfg = par_flagship_cfg()
    out = {"bf16_dp_ms": {}, "bf16_pp_ms": {}, "bf16_single_ms": {}}
    failures = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    # a and f at compute bf16, float32 then bf16 parameters.
    for pdt in PAR_BF16:
        cfg16 = dataclasses.replace(fcfg, compute_dtype="bfloat16", param_dtype=pdt)
        base16 = par_models16(torch, cfg16, base, pdt)
        one16 = {}
        for kind in PAR_STEPS:
            trainer, state = par_trainer(torch, cfg16, base16, with_teacher=kind == "progressive")
            one16[kind] = par_run_step(torch, trainer, state, kind, batches[kind])
            # the DP step's oracle: each rank's rows stepped alone on one device, their
            # gradients' float32 mean rounded to the parameters' dtype
            rows = batches[kind]["wav"].shape[0] // n
            shards = []
            for r in range(n):
                trainer, state = par_trainer(torch, cfg16, base16,
                                             with_teacher=kind == "progressive")
                shards.append(par_run_step(torch, trainer, state, kind, {
                    k: v[r * rows:(r + 1) * rows] for k, v in batches[kind].items()})["grads"])
            got, q32 = r0["dp"][(pdt, kind)], singles["dp"][kind]
            oracle = {m: (sum(sh[m].float() for sh in shards) / n).to(got["grads"][m].dtype)
                      for m in got["grads"]}
            same = sum(torch.equal(got["grads"][m], g) for m, g in oracle.items())
            worst = max(float((got["grads"][m].double() - g.double()).norm()
                              / max(float(g.double().norm()), 1e-30)) for m, g in oracle.items())
            label = f"a. DP {kind} step, compute bf16, parameters {pdt}"
            # Each tensor is held to the oracle, the whole gradient to the one-device step:
            # a split batch rounds each rank's partial gradient to bf16, so one small
            # tensor's cosine to float32 can fall 0.03 below the one-device step's (it is
            # printed below, not held).
            check(worst <= 2.0 ** -8, f"{label}: a gradient {worst:.3g} from its oracle")
            for r in rb:
                check(r["dp"][(pdt, kind)]["metrics"] == got["metrics"]
                      and torch.equal(r["dp"][(pdt, kind)]["params"], got["params"]),
                      f"{label}: replicas differ")
            check(got["params"].dtype == getattr(torch, pdt), f"{label}: parameter dtype")
            loss = par_witness16(failures, f"{label} loss", got["metrics"]["loss"],
                                 one16[kind]["metrics"]["loss"], q32["metrics"]["loss"])
            params = par_witness16(failures, f"{label} parameters", got["params"],
                                   one16[kind]["params"], q32["params"])
            whole = par_witness16(failures, f"{label} gradient", _flat_grads(got["grads"]),
                                  _flat_grads(one16[kind]["grads"]), _flat_grads(q32["grads"]))
            print(f"[parallel] {label}: gradients against the oracle (each rank's rows alone, "
                  f"the mean rounded to {pdt}): {same} of {len(oracle)} tensors bit-equal, the "
                  f"farthest {worst:.3g} (bar 2^-8); against the one-device bf16 step on the "
                  f"whole batch, float32's as Q32: loss {got['metrics']['loss']:.6g} (one "
                  f"device {one16[kind]['metrics']['loss']:.6g}, float32 "
                  f"{q32['metrics']['loss']:.6g}) rel {loss}, the whole gradient rel {whole}, "
                  f"the parameters after the update rel {params}; "
                  f"{par_cosines16([], label, got['grads'], one16[kind]['grads'], q32['grads'])}"
                  "; replicas bit-equal")
        trainer, state = par_trainer(torch, cfg16, base16, with_teacher=False)
        single = out["bf16_single_ms"][pdt] = par_step_ms(
            torch, trainer.make_diffusion_step(), state, batches["diffusion"], trainer.put_batch)
        out["bf16_dp_ms"][pdt] = [r["dp_ms"][pdt] for r in rb]
        out["bf16_pp_ms"][pdt] = [r["pp_ms"][pdt] for r in rb]
        print(f"[parallel] a. ms per data step, batch 4 x 2 s, compute bf16, parameters {pdt}: "
              f"DP {per_rank(lambda r: r['dp_ms'][pdt])}, single device {single:.3f}; float32 DP "
              f"{' / '.join(f'{r['dp_ms']:.3f}' for r in ranks)}, single device "
              f"{singles['ms']:.3f} ({note})")
        res = [r["pp"][pdt] for r in rb]
        pp_grads = {}
        label = f"f. PP diffusion step ({n} stages x 2 microbatches), parameters {pdt}"
        for r in res:
            check(r["metrics"] == res[0]["metrics"], f"{label}: stages' metrics differ")
            check(r["dtypes"]["stage"] == r["dtypes"]["source"] == (
                "torch.bfloat16", [f"torch.{pdt}"]), f"{label}: dtypes {r['dtypes']}")
            pp_grads.update(r["grads"])
        trainer, state = par_trainer(torch, cfg16, base16, with_teacher=False)
        mb = par_run_step(torch, par_microbatched(trainer, 2), state, "diffusion",
                          batches["diffusion"])
        q32 = singles["dp"]["diffusion"]
        oracle = par_cosines16(failures, f"{label} vs its oracle", pp_grads, mb["grads"],
                               q32["grads"])
        loss = par_witness16(failures, f"{label} loss", res[0]["metrics"]["loss"],
                             one16["diffusion"]["metrics"]["loss"], q32["metrics"]["loss"])
        norm = par_witness16(failures, f"{label} grad_norm", res[0]["metrics"]["grad_norm"],
                             one16["diffusion"]["metrics"]["grad_norm"],
                             q32["metrics"]["grad_norm"])
        whole = par_witness16(failures, f"{label} gradient", _flat_grads(pp_grads),
                              _flat_grads(one16["diffusion"]["grads"]), _flat_grads(q32["grads"]))
        print(f"[parallel] {label}: stage decoders {res[0]['dtypes']['stage']}; against its "
              f"oracle (one device, the blocks per microbatch) {oracle}; against the "
              f"one-device step: loss rel {loss}, grad_norm {norm}, the whole gradient rel "
              f"{whole}; "
              f"{par_cosines16([], label, pp_grads, one16['diffusion']['grads'], q32['grads'])}"
              f"; ms per step {per_rank(lambda r: r['pp_ms'][pdt])}, single device bf16 "
              f"{single:.3f} ({note})")
        del base16, trainer, state
    per_pdt = len(PAR_STEPS) + 1  # the DP steps and the PP step: one bf16 frontend call each
    for r in rb:
        check(r["steps_launches"] == len(PAR_BF16) * per_pdt
              and r["steps_timed_launches"] == len(PAR_BF16) * 2 * (PAR_TIMED + 1)
              and r["steps_f32_launches"] == 0,
              f"a/f: frontend launches {r['steps_launches']}, timed "
              f"{r['steps_timed_launches']}, float32 {r['steps_f32_launches']}")

    # c. sequence parallel at a bf16-compute decoder against its single-device call.
    lcfg = par_longform_cfg()
    ldec = EdgeDiffusionDecoder(lcfg, dtype=bf16)
    ldec.load_state_dict(seeded_decoder(torch, lcfg, SEED).state_dict())
    ldec = ldec.to(DEVICE).eval()
    lsched = DiffusionSchedule.create(lcfg.diff_steps).to(DEVICE)
    sem, x_T = par_seq_inputs(torch, lcfg, spec["seq_S"])

    @torch.inference_mode()
    def single_seq():
        return ddim_sample(lsched, lambda x, t, si: ldec(x, t, sem_idx=sem, step_idx=si), x_T,
                           PAR_SEQ["steps"], prediction="eps")

    want = single_seq().cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED):
        single_seq()
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3 / PAR_TIMED
    got = r0["seq"]["x0"]
    check(all(torch.equal(r["seq"]["x0"], got) for r in rb) and bool(torch.isfinite(got).all()),
          "c. the ranks' x0 differ or are not finite")
    reading = par_witness16(failures, "c. sequence-parallel bf16", got, want,
                            singles["seq"].cpu())
    te = min(2 * spec["seq_S"], 2 * spec["seq_S"] // n + 2 * lcfg.layers * lcfg.attn_window_size)
    launches = lcfg.layers * PAR_SEQ["steps"] * (te >= lcfg.pallas_min_seq_len)
    for r in rb:
        check(r["seq"]["launches"] == launches and r["seq"]["f32_launches"] == 0
              and r["seq"]["timed_launches"] == launches * PAR_TIMED,
              f"c. band launches {r['seq']['launches']} (bf16), {r['seq']['f32_launches']} "
              f"(float32), timed {r['seq']['timed_launches']}")
    out.update(bf16_seq_ms=[r["seq"]["ms"] for r in rb], bf16_seq_single_ms=seq_ms)
    print(f"[parallel] c. sequence-parallel T={2 * spec['seq_S']}, eps, {PAR_SEQ['steps']} steps, "
          f"a bf16-compute decoder: rel to the float32 single call {reading}; max err against "
          f"the bf16 single call {float((got - want).abs().max()):.4g}; bf16 band launches per "
          f"rank {[r['seq']['launches'] for r in rb]}; ms per call {per_rank(lambda r: r['seq']['ms'])}, "
          f"single device bf16 {seq_ms:.3f}, float32 {singles['seq_ms']:.3f} ({note})")
    del ldec

    # d. the TP encode of a bf16 encoder against the single-device bf16 encode (kernel route).
    enc = par_models16(torch, fcfg, base[:1], "float32")[0].to(DEVICE)
    w16 = ff.pack_frontend_weights(enc.hubert.feature_extractor, bf16)
    tp_wav = torch.from_numpy(spec["tp_wav"]).to(DEVICE)
    with torch.inference_mode():
        conv = ff.conv_frontend(tp_wav, w16, compute_dtype=bf16)
        feats = enc.extract_hubert(tp_wav, conv_feats=conv).float().cpu()
        tokens = ff.fast_encode(enc, tp_wav, w16, compute_dtype=bf16).cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PAR_TIMED):
            ff.fast_encode(enc, tp_wav, w16, compute_dtype=bf16)
        torch.cuda.synchronize()
    tp_ms = (time.perf_counter() - t0) * 1e3 / PAR_TIMED
    tok32 = singles["tp_tokens"]
    share = float((r0["tp"]["tokens"] == tok32).double().mean())
    share_one = float((tokens == tok32).double().mean())
    same = float((r0["tp"]["tokens"] == tokens).double().mean())
    reading = par_witness16(failures, "d. TP encode bf16 features", r0["tp"]["features"], feats,
                            singles["tp_features"])
    print(f"[parallel] d. TP encode of a 5 s wav by a bf16 encoder (float32 parameters), mesh "
          f"(1, {n}): layer-9 features rel to float32 {reading}; tokens equal to the bf16 single "
          f"device's {same:.4%}, to float32's {share:.4%} (one device {share_one:.4%}, bar "
          f"{share_one - 0.02:.4%}); ms per encode {per_rank(lambda r: r['tp']['ms'])}, single "
          f"device bf16 fast_encode {tp_ms:.3f}, float32 {singles['tp_ms']:.3f} ({note})")
    check(share >= share_one - 0.02, f"d. token share {share} against one device's {share_one}")
    for r in rb:
        check(torch.equal(r["tp"]["tokens"], r0["tp"]["tokens"])
              and r["tp"]["local"][0] == "torch.bfloat16" and r["tp"]["launches"] == 2
              and r["tp"]["f32_launches"] == 0 and r["tp"]["timed_launches"] == PAR_TIMED,
              f"d. the ranks' tokens, dtypes {r['tp']['local']} or launches "
              f"{r['tp']['launches']}/{r['tp']['f32_launches']}/{r['tp']['timed_launches']}")
    out.update(bf16_tp_ms=[r["tp"]["ms"] for r in rb], bf16_tp_single_ms=tp_ms)
    del enc

    # b. train() at configs/tpu_large_batch.json on the [n, 1] mesh.
    t = r0["train"]
    with open(os.path.join(ROOT, "configs", "tpu_large_batch.json")) as f:
        lcfg = dict(json.load(f), **spec["large_cuts"])
    halvings = progressive_step_schedule(lcfg["diff_steps"], lcfg["progressive_target_steps"])
    epochs = lcfg["diffusion_epochs"] + lcfg["progressive_epochs_per_halving"] * len(
        halvings) + lcfg["consistency_epochs"]
    spe = t["step"] // epochs
    check(bool(t["hashes"]) and all(r["train"]["hashes"] == t["hashes"] for r in rb),
          "b. bf16 replicas differ after an update")
    check(all(r["train"]["step"] == spe * epochs for r in rb),
          f"b. data steps {[r['train']['step'] for r in rb]}")
    check(all(r["train"]["launches"] == t["step"] and r["train"]["f32_launches"] == 0
              for r in rb),
          f"b. frontend launches {[(r['train']['launches'], r['train']['f32_launches']) for r in rb]}")
    want_dt = (("torch.bfloat16", ["torch.float32"]),) * 2
    check(bool(t["dtypes"]) and all(d[1:] == want_dt for d in t["dtypes"]),
          f"b. dtypes {t['dtypes']}")
    with open(os.path.join(t["run_dir"], "metrics.jsonl")) as f:
        losses = [v for line in f for k, v in json.loads(line).items() if k.endswith("loss")]
    check(bool(losses) and all(math.isfinite(v) for v in losses), "b. a logged loss is not finite")
    check(os.path.isfile(os.path.join(t["run_dir"], "edge_model_final", "decoder.pt")),
          "b. no final model")
    clocks = []
    for r in rb:
        c = StepClock()
        c.stamps = r["train"]["stamps"]
        clocks.append(_steady_ms(c, 1, t["step"], spe))
    out.update(bf16_train_ms=clocks, bf16_train_s=t["seconds"])
    beside = ("" if large is None else
              f"; phase 14's single card at batch {t['batch']}: diffusion "
              f"{large['ms']['diffusion']:.3f}, progressive {large['ms']['progressive']:.3f}, "
              f"consistency {large['ms']['consistency']:.3f}")
    print(f"[parallel] b. train() at configs/tpu_large_batch.json (compute bf16, parameters "
          f"float32, batch {t['batch']}, {t['batch'] // n} rows per rank) on mesh [{n}, 1], "
          f"phase 14's corpus, halvings {halvings}: {t['step']} data steps, {len(t['hashes'])} "
          f"updates, the replicas' parameters bit-equal after each (final sha1 "
          f"{t['hashes'][-1][1][:12]}); {len(losses)} logged losses, all finite; ms per data "
          f"step {' / '.join(f'{m:.3f}' for m in clocks)} (steady steps, host clock){beside}; "
          f"{t['seconds']:.3f} s; bf16 frontend launches per rank "
          f"{[r['train']['launches'] for r in rb]} ({note})")

    out["bf16_frontend_launches"] = sum(
        r["steps_launches"] + r["steps_timed_launches"] + r["tp"]["launches"]
        + r["tp"]["timed_launches"] + r["train"]["launches"] for r in rb)
    out["bf16_banded_launches"] = sum(r["seq"]["launches"] + r["seq"]["timed_launches"]
                                      for r in rb)
    assert not failures, "phase 11's bf16 pass:\n" + "\n".join(failures)
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


TFLITE_SHAPES = ((1, 200, 100), (1, 500, 250))  # phase 13's (B, T, S)


def _weight_views(w: np.ndarray) -> list:
    """The layouts a weight can take in the artifact: as is, transposed (a
    Linear in FULLY_CONNECTED), a 1-D conv's filter as CONV_2D or
    DEPTHWISE_CONV_2D hold it."""
    views = [w]
    if w.ndim == 2:
        views.append(w.T)
    if w.ndim == 3:
        views += [w.transpose(0, 2, 1), w.reshape(w.shape[0], -1).T]
    return [np.ascontiguousarray(v).tobytes() for v in views]


def _check_tflite(blob: bytes, sd: dict, qflat: dict, mode: str) -> dict:
    """Phase 13's checks of one artifact against the decoder's state dict
    ``sd`` (its weights as exported) and ``quantize_decoder_params``'s
    ``qflat``; returns the artifact's counts."""
    from edge_diffusion_tts_tpu_torch.utils import tflite_surgery as ts

    if mode == "int8":
        return _check_tflite_int8(blob, sd)
    model = ts.read_model(blob)
    sg = model.subgraphs[0]
    floats = int8 = 0
    seen = set()
    for t in sg.tensors:
        value = ts.constant(model, t)
        if value is None:
            continue
        if t.type == ts.FLOAT32 and t.name in sd:
            assert value.tobytes() in _weight_views(sd[t.name]), f"{mode}: {t.name} differs"
            floats += 1
            seen.add(t.name)
        elif t.type == ts.INT8:
            name = t.name[:-len("_int8")] if mode == "weight_int8" else t.name
            qp = t.quantization
            if f"q8:{name}" in qflat:
                q, sc = qflat[f"q8:{name}"], qflat[f"sc:{name}"]
            else:  # dynamic: a sensitive weight, to the converter's rule
                assert mode == "dynamic", (mode, t.name)
                q, sc = ts.symmetric_per_channel(sd[name].reshape(sd[name].shape[0], -1))
            assert value.tobytes() == np.ascontiguousarray(q).tobytes(), f"{mode}: {name} codes"
            assert qp.scale.tobytes() == np.asarray(sc, np.float32).tobytes(), (
                f"{mode}: {name} scales")
            assert np.all(qp.zero_point == 0), name
            int8 += 1
            seen.add(name)
    missing = {k for k in sd if not k.startswith("sem_proj.")} - seen
    assert not missing, f"{mode}: weights not in the artifact: {sorted(missing)}"
    return dict(bytes=len(blob), ops=len(sg.operators), int8=int8, float_weights=floats)


def _int8_views(q: np.ndarray, axis: int) -> np.ndarray:
    """A full-integer artifact's per-channel codes as [out, in * K] in the
    decoder weight's layout: FULLY_CONNECTED's [out, in] as is, CONV_2D's
    [out, K, 1, in], DEPTHWISE_CONV_2D's [1, K, 1, C] (channel axis 3)."""
    if axis == 3:
        return np.ascontiguousarray(q[0, :, 0, :].T)
    if q.ndim == 4:
        return q[:, :, 0, :].transpose(0, 2, 1).reshape(q.shape[0], -1)
    return q


def _check_tflite_int8(blob: bytes, sd: dict) -> dict:
    """The full-integer artifact read back: each weight's codes and scales
    as the export's rules give them from the decoder's state dict."""
    from edge_diffusion_tts_tpu_torch.utils import tflite_int8 as ti
    from edge_diffusion_tts_tpu_torch.utils import tflite_surgery as ts

    model = ts.read_model(blob)
    sg = model.subgraphs[0]
    linears = tensors = biases = int8 = 0
    seen = set()
    for t in sg.tensors:
        int8 += t.type == ts.INT8
        value = ts.constant(model, t)
        if value is None or t.name not in sd:
            continue
        w, qp = sd[t.name], t.quantization
        if t.type == ts.INT8 and qp.scale.size > 1:  # a Linear's or a convolution's weight
            q, scale = ts.symmetric_per_channel(w.reshape(w.shape[0], -1))
            assert np.array_equal(_int8_views(value, qp.quantized_dimension), q), (
                f"int8: {t.name} codes")
            assert qp.scale.tobytes() == scale.tobytes(), f"int8: {t.name} scales"
            linears += 1
        elif t.type == ts.INT8:  # a norm weight or a table, per tensor
            scale, zp = ti.asymmetric(float(w.min()), float(w.max()))
            assert (qp.scale.tobytes(), int(qp.zero_point[0])) == (
                np.float32(scale).tobytes(), zp), f"int8: {t.name} parameters"
            assert np.array_equal(value, ti.quantize_values(w, scale, zp).reshape(value.shape)), (
                f"int8: {t.name} codes")
            tensors += 1
        else:  # a bias, int32 at s_in * s_w
            assert t.type == ts.INT32, f"int8: {t.name} left {t.type}"
            want = np.round(w.astype(np.float64) / qp.scale.astype(np.float64))
            assert np.array_equal(value, want.astype(np.int32)), f"int8: {t.name} codes"
            biases += 1
        seen.add(t.name)
    missing = {k for k in sd if not k.startswith("sem_proj.")} - seen
    assert not missing, f"int8: weights not in the artifact: {sorted(missing)}"
    return dict(bytes=len(blob), ops=len(sg.operators), int8=int8, float_weights=0,
                linears=linears, per_tensor=tensors, biases=biases)


def phase_tflite(torch) -> dict:
    """Phase 13: the TFLite export (the module docstring's phase 13); returns
    its numbers per shape and mode."""
    import hashlib
    import shutil

    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.utils.export import export_tflite
    from edge_diffusion_tts_tpu_torch.utils.quantize import (
        dequantize_decoder_params, quantize_decoder_params,
    )
    from edge_diffusion_tts_tpu_torch.weights import save_checkpoint

    t_phase = time.perf_counter()
    base = os.path.join(ROOT, "build", "phase13")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    with open(os.path.join(ROOT, "configs", "flagship.json")) as f:
        cfg = CFG.from_json(f.read())
    assert cfg.use_depthwise
    decoder = seeded_decoder(torch, cfg, SEED)
    ckpt = os.path.join(base, "checkpoint")
    save_checkpoint(ckpt, cfg, decoder)
    qflat = quantize_decoder_params(decoder)
    sds = {"": decoder.state_dict(), "dynamic": decoder.state_dict(),
           "int8": decoder.state_dict(), "weight_int8": dequantize_decoder_params(qflat)}
    sds = {m: {k: v.detach().cpu().numpy() for k, v in sd.items()} for m, sd in sds.items()}
    dev_flag = [] if DEVICE == "cuda" else ["--device", DEVICE]
    out = {}
    for shape in TFLITE_SHAPES:
        for mode in ("", "weight_int8", "dynamic", "int8"):
            blobs, secs = [], []
            for k in range(2):
                tag = f"{'x'.join(map(str, shape))}_{mode or 'float'}{k}"
                path = os.path.join(base, f"{tag}.tflite")
                t0 = time.perf_counter()
                export_tflite(cfg, decoder, path, *shape, quantize=mode)
                secs.append(time.perf_counter() - t0)
                with open(path, "rb") as f:
                    blobs.append(f.read())
            assert blobs[0] == blobs[1], f"{shape} {mode!r}: two exports differ"
            r = _check_tflite(blobs[0], sds[mode], qflat, mode or "float")
            r.update(export_s=secs, path=path)
            out[(shape, mode)] = r
            what = (f"{r['linears']} Linear/conv weights = symmetric_per_channel, "
                    f"{r['per_tensor']} per-tensor constants and {r['biases']} int32 biases "
                    "as the rules give them" if mode == "int8" else
                    f"{r['float_weights']} float weights = the decoder's bit for bit")
            print(f"[tflite] {shape} {mode or 'float'}: export {secs[0]:.3f} s, again "
                  f"{secs[1]:.3f} s (byte-equal); {r['bytes']} bytes, sha256 "
                  f"{hashlib.sha256(blobs[0]).hexdigest()[:16]}, {r['ops']} operators, "
                  f"{r['int8']} int8 tensors, {what}")
        assert out[(shape, "int8")]["bytes"] < out[(shape, "weight_int8")]["bytes"], (
            f"{shape}: the full-integer artifact is not smaller than weight_int8's")
    for argv, key in ((["--format", "tflite"], ((1, 200, 100), "")),
                      (["--format", "tflite", "--quantize", "int8"], ((1, 200, 100), "int8")),
                      (["--format", "tflite", "--t-frames", "500", "--s-tokens", "250",
                        "--quantize", "dynamic"], ((1, 500, 250), "dynamic"))):
        path = os.path.join(base, "cli.tflite")
        _, wall = _cli(["export", ckpt, "--out", path] + argv + dev_flag,
                       f"export {' '.join(argv)}")
        with open(path, "rb") as f, open(out[key]["path"], "rb") as g:
            assert f.read() == g.read(), f"cli {argv}: other bytes than export_tflite"
        print(f"[tflite] cli export {' '.join(argv)}: {wall:.3f} s, the API's bytes")
    assert "tensorflow" not in sys.modules, "the export imported TensorFlow"
    print(f"[tflite] phase 13: {time.perf_counter() - t_phase:.3f} s; TensorFlow not "
          "imported")
    return out


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
    banded16 = banded_bf16(torch, banded[BAND_SHAPES[1]])

    cfg = CFG(dropout=0.0)
    decoder = seeded_decoder(torch, cfg, SEED).to(DEVICE)
    schedule = DiffusionSchedule.create(cfg.diff_steps)
    phase_fused(torch, cfg, decoder, schedule.to(DEVICE))
    pcfg = flagship_cfg()
    pre_decoder = seeded_decoder(torch, pcfg, PRENET_SEED).to(DEVICE)
    fused = phase_fused(torch, pcfg, pre_decoder, schedule.to(DEVICE), seed=PRENET_SEED)
    fused16 = {(c.use_depthwise, B): phase_fused_bf16(torch, c, d, schedule.to(DEVICE), seed, B)
               for c, d, seed, B in ((cfg, decoder, SEED, 1),
                                     (pcfg, pre_decoder, PRENET_SEED, 1),
                                     (cfg, decoder, SEED, 8))}
    fused_launches, _ = phase_main_path(torch, pcfg, pre_decoder, schedule, fused)
    banded_launches, banded16_launches = phase_longform(torch)
    encoder = seeded_encoder(torch, cfg, SEED).to(DEVICE)
    frontend = phase_frontend(torch, encoder)
    frontend16 = frontend_bf16(torch, encoder)
    frontend_launches, _ = phase_audio(torch, cfg, decoder, schedule, encoder)
    ddpm = phase_ddpm(torch, cfg, decoder, pre_decoder)
    serve = phase_serve(torch, cfg, decoder, encoder)
    trained = phase_train(torch)
    large = phase_large_batch(torch)  # before phase 11, whose bf16 train() takes its corpus
    par = phase_parallel(torch, cfg, decoder, large=large)
    cli_run = phase_cli(torch)
    phase_tflite(torch)

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
         + cli_run["launches"]["fused"] + large["fused_launches"],
         "max_abs_err": fused["eps"]["max_abs_err"],
         "ms": fused["eps"]["ms"], "plain_ms": fused["eps"]["plain_ms"],
         "bound_ms": fused["bound_ms"], "bound_by": fused["bound_by"],
         "library_ms": None},
        {"name": "conv_frontend", "route": "cuda",
         "source": "edge_diffusion_tts_tpu_torch/csrc/conv_frontend.cu",
         "replaces": "edge_diffusion_tts_tpu/ops/fused_frontend.py:123",
         "launches": frontend_launches + serve["frontend_launches"]
         + trained["frontend_launches"] + par["frontend_launches"]
         + cli_run["launches"]["frontend"] + large["frontend_launches"],
         "max_abs_err": max(r["max_abs_err"] for r in frontend.values()),
         **{k: frontend[(1, 80000)][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None},
        # the same TPU kernel at compute_dtype bf16: phase 14's trainer (batch 256) and phase
        # 11's bf16 pass run it; its numbers are at phase 14's shape, [256, 32000] (phase 6b)
        {"name": "conv_frontend_bf16", "route": "cuda",
         "source": "edge_diffusion_tts_tpu_torch/csrc/conv_frontend.cu",
         "replaces": "edge_diffusion_tts_tpu/ops/fused_frontend.py:123",
         "launches": large["bf16_launches"] + par["bf16_frontend_launches"],
         **{k: frontend16[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None},
        {"name": "fused_ddpm", "route": "cuda",
         "source": "edge_diffusion_tts_tpu_torch/csrc/fused_ddim.cu",
         "replaces": "edge_diffusion_tts_tpu/ops/fused_denoise.py:234",
         **{k: ddpm[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by")},
         "library_ms": None},
        # the three TPU kernels at compute_dtype bf16 (phases 2, 3, 5 and 8); the DDIM
        # numbers are configs/flagship.json's decoder at B=1, v
        {"name": "fused_ddim_bf16", "route": "cuda",
         "source": "edge_diffusion_tts_tpu_torch/csrc/fused_ddim.cu",
         "replaces": "edge_diffusion_tts_tpu/ops/fused_denoise.py:127",
         "launches": sum(r["launches"] for r in fused16.values()),
         **{k: fused16[(True, 1)][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by")},
         "library_ms": None},
        {"name": "banded_attention_bf16", "route": "cuda",
         "source": "edge_diffusion_tts_tpu_torch/csrc/band16.cuh",
         "replaces": "edge_diffusion_tts_tpu/ops/window_attention.py:48",
         "launches": banded16_launches + par["bf16_banded_launches"],
         **{k: banded16[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}},
        {"name": "fused_ddpm_bf16", "route": "cuda",
         "source": "edge_diffusion_tts_tpu_torch/csrc/fused_ddim.cu",
         "replaces": "edge_diffusion_tts_tpu/ops/fused_denoise.py:234",
         **{k: ddpm["bf16"][k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by")},
         "library_ms": None},
    ]
    # The bf16 step's two kernels of their own (phases 3 and 8: launches by
    # the bf16 entry points, counted by kind); the numbers are one decoder
    # step's GEMMs (2 + 6L) and attentions (2L) at B=8, 4,000 rows (phase 3).
    gemms, attn = fused16[(False, 8)]["gemms"], fused16[(False, 8)]["attention"]

    def kind_launches(kind):
        return sum(r["kinds"][kind] for r in fused16.values()) + ddpm["bf16"]["kinds"][kind]

    kernels += [
        {"name": "step_gemm_wgmma", "route": "cuda",
         "source": "edge_diffusion_tts_tpu_torch/csrc/gemm_wgmma.cuh",
         "replaces": "edge_diffusion_tts_tpu/ops/fused_denoise.py:127",
         "launches": kind_launches("gemm_wgmma"), "max_abs_err": gemms["err"],
         "ms": gemms["wgmma"], "plain_ms": gemms["plain"], "bound_ms": gemms["bound"],
         "bound_by": gemms["bound_by"], "library_ms": gemms["linear"]},
        {"name": "step_attention16", "route": "cuda",
         "source": "edge_diffusion_tts_tpu_torch/csrc/attention16.cuh",
         "replaces": "edge_diffusion_tts_tpu/ops/fused_denoise.py:127",
         "launches": kind_launches("attention16"), "max_abs_err": attn["err"],
         "ms": attn["ms"], "plain_ms": attn["plain"], "bound_ms": attn["bound"],
         "bound_by": attn["bound_by"], "library_ms": attn["library"]},
    ]
    for k in kernels[-2:]:
        assert k["launches"] > 0, f"{k['name']}: no launch on the bf16 main paths"
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


GEMM16_TIMER_PHASES = ("issue", "epilogue loads", "prologue", "first stage", "products",
                       "epilogue")


def gemm16_timers(torch) -> None:
    """``python3 chip_smoke.py --gemm16-timers``: the bf16 step GEMMs of phase
    3 at 500 and 4,000 rows in the wgmma kernel's own tile (gemm16_kernel has
    no stamps), from the loop library built with gemm.cuh's per-block clock stamps
    (-DEDT_GEMM_TIMERS, into build/gemm16_timers/): per launch its
    CUDA-graph µs, the span and median of its blocks' wall times (ns
    stamps), and the median cycles of each phase of a block's thread 0
    (gemm_wgmma_kernel: the TMA issue, the epilogue's loads, the float32
    prologue, the wait for the first stage, the products, the epilogue)."""
    import ctypes

    from edge_diffusion_tts_tpu_torch import _build
    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

    out = os.path.join(ROOT, "build", "gemm16_timers")
    os.makedirs(out, exist_ok=True)
    lib_path = os.path.join(out, "libtimers.so")
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DEDT_GEMM_TIMERS", "-o",
                           lib_path, str(_build.CSRC / "fused_ddim.cu")],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc of the timed GEMM failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(lib_path)
    load = _build.load
    _build.load = lambda name: lib
    try:
        fd._lib.__wrapped__()  # sets the hooks' argtypes on the timer library
    finally:
        _build.load = load
    fd._lib = lambda: lib
    lib.edt_gemm_timers.argtypes = [ctypes.c_void_p, ctypes.c_int]
    tiles = fd.gemm16_tiles()
    cfg = CFG(dropout=0.0)
    decoder = seeded_decoder(torch, cfg, SEED).to(DEVICE)
    ts, _ = fd.ddim_coefficients(DiffusionSchedule.create(cfg.diff_steps), 4)
    sem_idx = torch.zeros(1, 250, dtype=torch.long, device=DEVICE)
    loop = fd.prepare_loop_inputs(decoder, sem_idx, 500, ts)
    w16 = fd.pack_decoder_weights(decoder, torch.bfloat16)
    stamps = np.zeros((8192, 8), np.int64)
    for rows in (500, 4000):
        rng = np.random.RandomState(5000 + SEED)
        for name, a, W, kw, _ in step_gemm_shapes(cfg, rows, loop, w16, True, rng):
            n = W.shape[0] // (2 if kw.get("swiglu") else 1)
            sw = kw.get("swiglu", False)
            tile = fd.decoder_gemm16_tile(rows, n, "wgmma", a.dtype, sw)
            host = tile == fd.decoder_gemm16_tile(rows, n, "host", a.dtype, sw)
            bm, bn = tiles[tile][:2]
            for _ in range(3):  # the last launch's stamps are read
                fd.decoder_gemm(a, W, tile=tile, **kw)
            torch.cuda.synchronize()
            blocks = -(-rows // bm) * -(-n // bn)
            _build.check(lib.edt_gemm_timers(stamps.ctypes.data, blocks), "gemm timers")
            t = stamps[:min(blocks, len(stamps))]
            us = 1e3 * graph_ms(torch, lambda: fd.decoder_gemm(a, W, tile=tile, **kw))
            cycles = ", ".join(f"{p} {int(np.median(t[:, 2 + i]))}"
                               for i, p in enumerate(GEMM16_TIMER_PHASES))
            print(f"[gemm16 timers] {name} M={rows} tile {tiles[tile]}"
                  f"{' (the host pick)' if host else ''}, {blocks} blocks: {us:.3f} us in a CUDA "
                  f"graph, span {(t[:, 1].max() - t[:, 0].min()) / 1e3:.2f} us, block median "
                  f"{np.median(t[:, 1] - t[:, 0]) / 1e3:.2f} us; median cycles: {cycles}")


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
        if "--gemm16-timers" in sys.argv[1:]:
            with torch.no_grad():
                gemm16_timers(torch)
        else:
            run(torch)
    except Exception:  # any failed phase: report it and print no result
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
