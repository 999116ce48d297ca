"""Command-line entry point of the port (counterpart of
``edge_diffusion_tts_tpu/cli.py``): ``edge-tts-torch`` or
``python -m edge_diffusion_tts_tpu_torch.cli``.

Subcommands, flags, defaults and choices are the JAX CLI's, so a command line
written for it parses here:

  train       the three-phase ``training.train`` (``--recipe v2``:
              ``train_v2``); ``--export`` writes ``edge_model.pt2``
  bench       4-step mel generation latency on the card (``bench.py``)
  precompute  HuBERT layer features of an LJSpeech corpus, from a seeded
              random HuBERT-base on the conv-frontend kernel
  generate    one sample from a port checkpoint (``demo.generate_sample``)
  longform    chunked long-audio generation (``pipeline.LongFormPipeline``)
  export      the decoder as a ``.pt2`` (``utils/export.py``) or a
              weight-only int8 ``.npz`` (``utils/quantize.py``)
  serve       the micro-batched TCP server (``serving.run_server``)
  migrate     a reference ``.pt`` -> a port checkpoint (``utils/torch_compat``)

Where the port differs:

- ``--device`` takes ``cuda`` (``gpu`` is the same), ``cuda:N`` or ``cpu``,
  and refuses ``tpu``.  Every subcommand that runs a model has it (train,
  bench, precompute, generate, longform, export, serve).  Its default is the
  card, and a machine without one exits with the "no CUDA device" message:
  nothing falls back to the CPU.  It is passed to the entry points'
  ``device=``; ``cfg.device`` is not read.  ``bench`` times the card and
  refuses ``cpu``; ``export`` traces a CPU copy of the decoder whatever the
  device.
- ``export --format`` adds ``pt2``, the default; ``stablehlo`` and
  ``tflite`` exit naming ``pt2`` in their place, and ``--quantize`` (the
  TFLite converter's) exits naming ``--format weight-int8``.
- ``serve --compile-cache`` exits: the port compiles no XLA programs (its
  CUDA kernels are built once, into ``build/kernels/``).
- ``train --mesh``/``--pipeline`` run one process per rank: start the CLI
  under ``torchrun``, which the process group is initialized from
  (``parallel.init_multihost``).
- ``migrate`` reads the reference file with ``torch.load(weights_only=True)``
  and ``--hubert-id`` from a local directory or the local Hugging Face cache
  only.  Without it the checkpoint holds no HuBERT weights, and
  ``generate``, ``longform`` and ``serve --longform`` refuse it.
- ``generate``, ``longform`` and ``serve`` exit with the message of a
  ``ValueError`` (a refused sampler, a checkpoint without HuBERT).
- Random draws come from ``torch.Generator``s: the same ``--seed`` gives
  other samples than the JAX CLI's.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

MODEL_COMMANDS = ("train", "bench", "precompute", "generate", "longform", "export", "serve")


def _device(value: str) -> str:
    v = value.lower()
    if v == "gpu":
        return "cuda"
    if v in ("cuda", "cpu") or re.fullmatch(r"cuda:\d+", v):
        return v
    raise argparse.ArgumentTypeError(
        f"{value!r}: the port runs on 'cuda' (or 'gpu', 'cuda:N') or 'cpu'; 'tpu' is the "
        "JAX package's (edge-tts-tpu)")


def _add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", type=_device, default=None,
                        help="cuda (= gpu), cuda:N or cpu; default: the CUDA card")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="edge-tts-torch",
        description="Edge Diffusion TTS, PyTorch/CUDA port",
    )
    sub = p.add_subparsers(dest="command", required=False)

    t = sub.add_parser("train", help="3-phase training (reference train.py)")
    t.add_argument("--config", type=str, default=None, help="JSON config path")
    t.add_argument("--resume", type=str, default=None, help="checkpoint path")
    t.add_argument("--export", action="store_true",
                   help="export the final decoder as edge_model.pt2")
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--epochs", type=int, default=None, help="diffusion epochs")
    t.add_argument(
        "--phases", type=str, default="diffusion,progressive,consistency"
    )
    t.add_argument("--recipe", choices=["v1", "v2"], default="v1")
    _add_device(t)
    t.add_argument(
        "--pipeline", type=int, default=None,
        help="stage the decoder backbone over N pipeline stages, one process per "
             "stage under torchrun (overrides cfg.pipeline_stages)",
    )
    t.add_argument(
        "--mesh", type=str, default=None,
        help="data-parallel mesh shape, e.g. '8' or '8,1' (data, model), one process "
             "per rank under torchrun; overrides cfg.mesh_shape",
    )

    b = sub.add_parser("bench", help="latency benchmark on the card (bench.py)")
    _add_device(b)

    pre = sub.add_parser("precompute", help="precompute HuBERT features")
    pre.add_argument("root", type=str, help="LJSpeech root directory")
    pre.add_argument("--limit", type=int, default=None)
    _add_device(pre)

    g = sub.add_parser("generate", help="few-step sample generation (demo)")
    g.add_argument("checkpoint", type=str, help="port checkpoint directory")
    g.add_argument("--wav", type=str, default=None, help="reference wav path")
    g.add_argument("--steps", type=int, default=4)
    g.add_argument("--out", type=str, default="generated.wav")
    g.add_argument("--oracle", action="store_true",
                   help="wav->mel->GriffinLim round trip (vocoder error only)")
    g.add_argument("--post-filter", action="store_true")
    g.add_argument("--sampler", choices=["ddim", "dpmpp"], default="ddim",
                   help="dpmpp = 4-step DPM-Solver++ order 2 (v2 serving "
                        "sampler; requires a v-prediction model)")
    _add_device(g)

    lf = sub.add_parser("longform", help="chunked long-audio generation")
    lf.add_argument("checkpoint", type=str)
    lf.add_argument("wav", type=str, help="input waveform to re-synthesize")
    lf.add_argument("--steps", type=int, default=50)
    lf.add_argument("--strength", type=float, default=0.6)
    lf.add_argument("--cfg-scale", type=float, default=2.0)
    lf.add_argument("--out", type=str, default="longform.wav")
    lf.add_argument(
        "--stream", action="store_true",
        help="stream waveform increments (generate_streaming_audio): the "
             "output file grows as chunks finalize; prints per-increment "
             "latency incl. time-to-first-audio",
    )
    _add_device(lf)

    ex = sub.add_parser(
        "export", help="export the decoder for edge deployment"
    )
    ex.add_argument("checkpoint", type=str, help="port checkpoint directory")
    ex.add_argument("--format", choices=["pt2", "weight-int8", "stablehlo", "tflite"],
                    default="pt2",
                    help="pt2 = torch.export program; stablehlo and tflite are the JAX "
                         "package's (refused)")
    ex.add_argument("--out", type=str, default=None)
    ex.add_argument("--t-frames", type=int, default=200,
                    help="static mel length (tflite only)")
    ex.add_argument("--s-tokens", type=int, default=100,
                    help="static context length (tflite only)")
    ex.add_argument("--quantize", choices=["dynamic", "int8"], default="",
                    help="TFLite post-training quantization (refused); the selective "
                         "weight-only artifact is --format weight-int8")
    _add_device(ex)

    sv = sub.add_parser(
        "serve",
        help="micro-batched TCP serving (line-JSON protocol, serving.py)",
    )
    sv.add_argument("checkpoint", type=str, help="port checkpoint directory")
    sv.add_argument("--host", type=str, default="127.0.0.1")
    sv.add_argument("--port", type=int, default=7455)
    sv.add_argument("--steps", type=int, default=None,
                    help="denoise steps (default cfg.inference_steps)")
    sv.add_argument("--buckets", type=str, default="128,256,512,1024",
                    help="token-length buckets (one warmed shape each)")
    sv.add_argument("--max-batch", type=int, default=8)
    sv.add_argument("--max-wait-ms", type=float, default=5.0)
    sv.add_argument("--max-queue-delay-ms", type=float, default=None,
                    help="SLO bound: shed (reject) submits whose predicted "
                         "queueing delay exceeds this; bounds the p99 tail "
                         "at saturation")
    sv.add_argument("--sampler", choices=["ddim", "dpmpp"], default="ddim")
    sv.add_argument("--mesh", type=int, default=0,
                    help="shard each batch over the first N CUDA devices "
                         "(max-batch must be divisible by N)")
    sv.add_argument("--seed", type=int, default=0,
                    help="base seed; sampling noise comes from a fresh "
                         "generator per batch")
    sv.add_argument("--compile-cache", type=str, default=None,
                    help="the JAX package's XLA compilation cache (refused: "
                         "the port compiles no XLA programs)")
    sv.add_argument("--longform", action="store_true",
                    help="also serve streaming long-form requests "
                         "({'longform': ...} protocol lines): wav in, "
                         "finalized mel/waveform increments streamed out")
    sv.add_argument("--longform-streams", type=int, default=4,
                    help="max concurrent long-form streams batched into one "
                         "refine per chunk tick (with --longform)")
    sv.add_argument("--chunk-seconds", type=float, default=2.0,
                    help="long-form chunk length (with --longform)")
    sv.add_argument("--overlap-seconds", type=float, default=0.5,
                    help="long-form chunk overlap (with --longform)")
    sv.add_argument("--longform-prep-buckets", type=str, default="8,16,32,64",
                    help="comma-separated SECONDS the long-form stream prep "
                         "pads to (exact via the masked HuBERT forward). "
                         "Empty string disables bucketing")
    _add_device(sv)

    mg = sub.add_parser(
        "migrate", help="convert a PyTorch-reference .pt checkpoint"
    )
    mg.add_argument("pt_path", type=str, help="edge_model_final.pt / best_model.pt")
    mg.add_argument("out_dir", type=str, help="output checkpoint directory")
    mg.add_argument("--hubert-id", type=str, default=None,
                    help="HF model id or local directory of the pretrained HuBERT "
                         "(read from local files only)")

    return p


def _refuse_unported(args) -> None:
    if args.command == "export":
        if args.format in ("stablehlo", "tflite"):
            raise SystemExit(f"export --format {args.format} is the JAX package's; the port "
                             "exports a torch.export program: --format pt2")
        if args.quantize:
            raise SystemExit("export --quantize is the TFLite converter's and has no "
                             "counterpart here; the selective weight-only int8 artifact is "
                             "--format weight-int8")
    if args.command == "serve" and args.compile_cache:
        raise SystemExit("serve --compile-cache has no counterpart: the port compiles no XLA "
                         "programs, and its CUDA kernels are built once into build/kernels/")


def _load_models(checkpoint: str):
    """``(cfg, decoder, encoder, hubert_cfg)`` from a port checkpoint with its
    encoder."""
    from .models import EdgeDiffusionDecoder, SemanticEncoder
    from .weights import load_checkpoint

    cfg, dec_state, hubert_cfg, enc_state = load_checkpoint(checkpoint, with_encoder=True)
    decoder = EdgeDiffusionDecoder(cfg)
    decoder.load_state_dict(dec_state)
    encoder = SemanticEncoder(cfg, hubert_cfg)
    encoder.load_state_dict(enc_state)
    return cfg, decoder, encoder, hubert_cfg


def _train(args, device) -> None:
    from .config import CFG
    from .training import train, train_v2

    cfg = CFG()
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = CFG.from_dict(json.load(f))
    if getattr(args, "batch_size", None):
        cfg.batch_size = args.batch_size
    if getattr(args, "epochs", None):
        cfg.diffusion_epochs = args.epochs
    if getattr(args, "mesh", None):
        shape = [int(s) for s in args.mesh.split(",")]
        if len(shape) == 1:
            shape.append(1)
        cfg.mesh_shape = shape
    if getattr(args, "pipeline", None):
        cfg.pipeline_stages = args.pipeline
    if (cfg.mesh_shape and max(cfg.mesh_shape) > 1) or cfg.pipeline_stages > 1:
        from .parallel import init_multihost

        # Ranks on the CPU talk over gloo; on cards, NCCL when each owns one.
        init_multihost(backend="gloo" if device.type == "cpu" else None)
    # getattr defaults: a bare command line (command None) trains with a
    # namespace that has none of the train subparser's attributes.
    resume = getattr(args, "resume", None)
    export = getattr(args, "export", False)
    if getattr(args, "recipe", "v1") == "v2":
        train_v2(cfg, resume=resume, export=export, device=device)
    else:
        phases = [s for s in getattr(
            args, "phases", "diffusion,progressive,consistency").split(",") if s]
        train(cfg, resume=resume, export=export, phases=phases, device=device)


def _generate(args, device) -> None:
    from .demo import generate_sample

    generate_sample(args.checkpoint, wav_path=args.wav, num_steps=args.steps, out_path=args.out,
                    oracle=args.oracle, post_filter=args.post_filter, sampler=args.sampler,
                    device=device)


def _longform(args, device) -> None:
    import numpy as np

    from .data import load_wav, resample_np
    from .pipeline import LongFormPipeline
    from .schedule import DiffusionSchedule

    cfg, decoder, encoder, hubert_cfg = _load_models(args.checkpoint)
    wav, sr = load_wav(args.wav)
    if sr != cfg.sample_rate:
        wav = resample_np(wav, sr, cfg.sample_rate)
    pipe = LongFormPipeline(cfg, DiffusionSchedule.create(cfg.diff_steps), decoder, encoder,
                            sem_stride=hubert_cfg.total_stride, device=device)
    if args.stream:
        # Append each increment's PCM bytes and patch the two RIFF size
        # fields in place: O(increment) work, a playable file at every moment.
        import struct
        import time

        sr = cfg.sample_rate
        n_bytes, first = 0, True
        t0 = time.time()
        with open(args.out, "wb+") as f:
            f.write(b"RIFF" + struct.pack("<I", 36) + b"WAVE" + b"fmt "
                    + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
                    + b"data" + struct.pack("<I", 0))
            f.flush()
            for inc, offset in pipe.generate_streaming_audio(
                    wav, steps=args.steps, strength=args.strength, cfg_scale=args.cfg_scale):
                pcm = (np.clip(inc, -1, 1) * 32767).astype("<i2").tobytes()
                f.seek(0, 2)
                f.write(pcm)
                n_bytes += len(pcm)
                f.seek(4)
                f.write(struct.pack("<I", 36 + n_bytes))
                f.seek(40)
                f.write(struct.pack("<I", n_bytes))
                f.flush()
                tag = "first audio" if first else "increment"
                first = False
                print(f"  {tag}: +{inc.shape[0] / sr:.2f}s audio at "
                      f"t={time.time() - t0:.2f}s (offset {offset / sr:.2f}s)", flush=True)
    else:
        from scipy.io import wavfile

        _, out = pipe.generate(wav, steps=args.steps, strength=args.strength,
                               cfg_scale=args.cfg_scale)
        wavfile.write(args.out, cfg.sample_rate, (np.clip(out, -1, 1) * 32767).astype(np.int16))
    print(f"wrote {args.out}")


def _serve(args, device) -> None:
    import threading

    from .serving import run_server

    server, batcher = run_server(
        args.checkpoint, host=args.host, port=args.port, steps=args.steps,
        buckets=tuple(int(b) for b in args.buckets.split(",")), max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_queue_delay_ms=args.max_queue_delay_ms,
        sampler=args.sampler, mesh=args.mesh, seed=args.seed, longform=args.longform,
        longform_streams=args.longform_streams, chunk_seconds=args.chunk_seconds,
        overlap_seconds=args.overlap_seconds,
        longform_prep_buckets=tuple(
            float(s) for s in args.longform_prep_buckets.split(",") if s),
        device=device,
    )
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()
        batcher.close()


def _export(args) -> None:
    from .models import EdgeDiffusionDecoder
    from .weights import load_checkpoint

    cfg, dec_state, _, _ = load_checkpoint(args.checkpoint)
    decoder = EdgeDiffusionDecoder(cfg)
    decoder.load_state_dict(dec_state)
    if args.format == "weight-int8":
        from .utils.quantize import save_quantized

        final, report = save_quantized(args.out or "edge_model.int8.npz", decoder)
        print(json.dumps(report))
        print(f"Exported weight-int8 decoder -> {final}")
    else:
        from .utils.export import export_for_edge

        export_for_edge(cfg, decoder, args.out or "edge_model.pt2")


def _migrate(args) -> None:
    from .config import CFG
    from .models import EdgeDiffusionDecoder, HubertConfig, SemanticEncoder
    from .utils.torch_compat import convert_reference_checkpoint, load_reference_checkpoint
    from .weights import hubert_state_dict_from_hf, save_checkpoint

    ckpt = load_reference_checkpoint(args.pt_path)
    cfg = CFG.from_dict(ckpt["cfg"]) if ckpt.get("cfg") else CFG()
    hubert_cfg = HubertConfig()
    hubert_state = None
    if args.hubert_id:
        from transformers import HubertModel

        hm = HubertModel.from_pretrained(args.hubert_id, local_files_only=True)
        hubert_state = hubert_state_dict_from_hf(hm.state_dict(), hubert_cfg)
    dec_sd, enc_sd, cfg_dict = convert_reference_checkpoint(
        ckpt, num_layers=cfg.layers, hubert_state=hubert_state)
    if cfg_dict:
        # The converter turns off the reference's unconsumed use_depthwise.
        cfg = CFG.from_dict(cfg_dict)
    decoder = EdgeDiffusionDecoder(cfg)
    decoder.load_state_dict(dec_sd)
    encoder = SemanticEncoder(cfg, hubert_cfg)
    missing, unexpected = encoder.load_state_dict(enc_sd, strict=False)
    if unexpected or any(not k.startswith("hubert.") for k in missing):
        raise ValueError(f"reference encoder does not fit: missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]}")
    save_checkpoint(args.out_dir, cfg, decoder, encoder, hubert=hubert_state is not None)
    if hubert_state is None:
        print("NOTE: no --hubert-id given; the checkpoint holds no HuBERT weights, and "
              "generate/longform/serve --longform refuse it until it is migrated with one.")
    print(f"migrated {args.pt_path} -> {args.out_dir}")


def _precompute(args, device) -> None:
    import torch

    from .config import CFG
    from .data import precompute_hubert_features
    from .models import HubertConfig, HubertEncoder
    from .ops import fused_frontend

    cfg = CFG()
    torch.manual_seed(0)
    hubert = HubertEncoder(HubertConfig()).to(device).eval()
    weights = fused_frontend.pack_frontend_weights(hubert.feature_extractor)

    def apply(wav):
        x = torch.from_numpy(wav).to(device)
        with torch.no_grad():
            return hubert.extract_layer(
                x, cfg.hubert_layer, conv_feats=fused_frontend.conv_frontend(x, weights))

    print("WARNING: random-init HuBERT; pass converted weights for real use", file=sys.stderr)
    precompute_hubert_features(args.root, apply, limit=args.limit)


def main(argv=None):
    args = build_parser().parse_args(argv)
    command = args.command or "train"
    _refuse_unported(args)
    device = None
    if command in MODEL_COMMANDS:
        from .config import resolve_device

        try:
            device = resolve_device(getattr(args, "device", None))
        except RuntimeError as e:
            raise SystemExit(str(e)) from None

    if command == "train":
        _train(args, device)
    elif command == "bench":
        from .bench import main as bench_main

        try:
            bench_main(device)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    elif command == "precompute":
        _precompute(args, device)
    elif command == "export":
        _export(args)
    elif command == "migrate":
        _migrate(args)
    else:
        run = {"generate": _generate, "longform": _longform, "serve": _serve}[command]
        try:
            run(args, device)
        except ValueError as e:
            raise SystemExit(str(e)) from None


if __name__ == "__main__":
    main()
