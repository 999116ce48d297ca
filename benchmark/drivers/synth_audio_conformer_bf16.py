"""Audio-in synthesis at a bfloat16 configuration whose encoder is w2v-BERT
2.0 to ``hubert_layer``: wavs -> filterbank -> Conformer layers -> tokens ->
mel, calls back to back.

The window, the pool of inputs, the checked calls and the decoder's
reference are ``synth.py``'s (its ``run`` runs here over this module's
``data``, ``program`` and ``check``), as in ``synth_audio_bf16.py``.  What
differs: the weights are the ones ``reference/w2v_bert.py`` reads (each
layer's distance table a matrix to ``weights.make``, N(0, 1 / 64): the
position term then moves a logit an eighth as much as q . k does, and
dropping it still reads four times the program's ``attn_rms_gap``); the
entry is ``EdgeInference(backend="fused").generate_from_audio`` at the
configuration's compute dtype with the encoder built at it; the
reference's own encode (``reference/w2v_bert.py``) judges the timed path's
tokens.

Each checked call gives ``row_rms_gap`` and ``token_margin`` (as the WavLM
cell does), ``attn_rms_gap``: the worst layer's RMS gap of the attention
output (after ``linear_out``) of the call's first row, recorded from the
timed path by a forward hook, against the reference's, and
``fbank_rms_gap``: the RMS gap of the first row's normalized, stacked
filterbank features (the feature projection's input on the timed path)
against the reference's.
"""

from __future__ import annotations

import types

import torch

from ..harness import compare, traffic as plan_of, weights
from ..reference import decoder as rdec, hubert as rhub, w2v_bert as rw
from ..reference.precision import Ops, no_tf32
from . import synth
from .synth_audio_bf16 import attn_rms_gap


def hubert_config(h: dict):
    """The port's encoder architecture of the configuration's ``hubert`` block."""
    from edge_diffusion_tts_tpu_torch.models import W2vBertConfig

    return W2vBertConfig(**h)


def data(run, torch) -> dict:
    """Weights and the pool of inputs, made on the device from the seed:
    ``synth.data``'s, with the encoder's weights of ``reference/w2v_bert.py``."""
    from edge_diffusion_tts_tpu_torch.config import CFG

    c, tr, dev = run.config, run.traffic, run.device
    if tr["input"] != "audio":
        raise ValueError("synth_audio_conformer_bf16 drives audio-in traffic")
    hubert_config(c["hubert"])  # a port without the architecture stops here
    cfg = CFG.from_dict(c)
    s = dict(cfg=cfg, audio=True, steps=cfg.inference_steps,
             prediction="v" if cfg.use_v_prediction else "eps", B=int(tr["rows"]), h=c["hubert"])
    s["W_dec"] = weights.make(rdec.parameter_shapes(c), run.seed, dev, "decoder")
    s["W_enc"] = weights.make(rw.encoder_shapes(c, s["h"]), run.seed, dev, "encoder")
    g = weights.generator(run.seed, "inputs", dev)
    B, M = s["B"], cfg.n_mels
    s["pool"] = []
    for b in plan_of.buckets(tr):
        n, sets = b["length"], []
        own = torch.tensor([round(x * tr["units_per_s"]) for x in b["row_s"]], device=dev)
        keep = (torch.arange(n, device=dev)[None, :] < own[:, None]).float()
        for _ in range(int(tr["pool"])):
            S = rw.positions(n)
            inp = {"wav": weights.synthetic_wavs(B, n, g, dev) * keep, "samples": n}
            inp["x"] = torch.randn(B, 2 * S, M, generator=g, device=dev)
            inp["S"], inp["T"], inp["speech_s"] = S, 2 * S, sum(b["row_s"])
            sets.append(inp)
        s["pool"].append(sets)
    return s


def program(run, torch, s):
    """``EdgeInference(backend="fused").generate_from_audio`` at the
    configuration's compute dtype, as ``call(inputs) -> mel on the host``;
    the tokens it hands ``generate_mel``, the first row's attention outputs
    and its filterbank features are recorded for checked calls."""
    from edge_diffusion_tts_tpu_torch.config import torch_dtype
    from edge_diffusion_tts_tpu_torch.inference import EdgeInference
    from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder, SemanticEncoder
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

    c, dev, cfg = run.config, run.device, s["cfg"]
    if c["param_dtype"] != "float32":
        raise ValueError("the synthesis driver runs float32 parameters")
    compute = torch_dtype(c["compute_dtype"])
    with torch.device(dev):
        decoder = EdgeDiffusionDecoder(cfg, dtype=compute)
        encoder = SemanticEncoder(cfg, hubert_config(s["h"]), dtype=compute)
    decoder.load_state_dict(s["W_dec"])
    missing, unexpected = encoder.load_state_dict(s["W_enc"], strict=False)
    if unexpected or missing:
        raise ValueError(f"encoder weights do not fit: missing {missing[:4]}, "
                         f"unexpected {unexpected[:4]}")
    schedule = DiffusionSchedule.create(cfg.diff_steps, cfg.beta_start, cfg.beta_end)
    engine = EdgeInference(cfg, schedule, decoder, prediction=s["prediction"], backend="fused",
                           device=dev, encoder=encoder)
    inner = engine.generate_mel

    def generate_mel(sem_idx, *a, **k):  # records the tokens the timed path made
        if s["current"] is not None:  # a checked call
            s["tokens_of"][s["current"]] = sem_idx
        return inner(sem_idx, *a, **k)

    engine.generate_mel = generate_mel
    s["tokens_of"], s["attn_of"], s["feats_of"] = {}, {}, {}

    def keep_attention(module, args, out):  # the first row's, of checked calls
        if s["current"] is not None:
            s["attn_of"].setdefault(s["current"], []).append(out[:1].clone())

    def keep_features(module, args):  # the feature projection's input: the filterbank's
        if s["current"] is not None:
            s["feats_of"][s["current"]] = args[0][:1].clone()

    hub = encoder.hubert
    for layer in hub.encoder.layers[:rw.layers_run(c, s["h"])]:
        layer.self_attn.register_forward_hook(keep_attention)
    hub.feature_projection.register_forward_pre_hook(keep_features)
    steps = s["steps"]
    return engine, lambda inp: engine.generate_from_audio(inp["wav"], steps, x_T=inp["x"]).cpu()


def reference_first_row(run, s, inp: dict, ops: Ops):
    """The reference's filterbank features and attention outputs of every
    layer run, at ``ops``, for ``inp``'s first wav."""
    feats, attn = rw.features(inp["wav"][:1], s["h"], ops), []
    rw.layer(s["W_enc"], s["h"], None, ops, rw.layers_run(run.config, s["h"]), attn, feats=feats)
    return feats, attn


def encode_numbers(run, s, inp: dict, tokens, ops: Ops):
    """The reference's own encode at ``ops`` of ``inp``'s wavs, and how far
    the given ``tokens`` (None: the reference's) lie from it:
    ``(tokens, {"token_margin": ...})``."""
    ref_tokens, scaled = rw.encode(s["W_enc"], run.config, s["h"], inp["wav"], ops)
    tokens = ref_tokens if tokens is None else tokens
    fsq = rhub.FSQ(run.config["fsq_levels"], scaled.device)
    return tokens, {"token_margin": rhub.flip_margin(fsq, scaled, tokens.to(scaled.device))}


def check(run, s, answers: dict, due: int):
    """``(numbers, failed calls)`` of the checked answers against the
    reference at full precision; each number infinite unless all ``due``
    checked calls answered."""
    no_tf32()
    full, limits = Ops("float32"), run.limits
    numbers = {"row_rms_gap": 0.0, "token_margin": 0.0, "attn_rms_gap": 0.0,
               "fbank_rms_gap": 0.0}
    failed = 0
    with torch.no_grad():
        for i, a in answers.items():
            tokens, mine = encode_numbers(run, s, a["input"], a["tokens"], full)
            feats, attn = reference_first_row(run, s, a["input"], full)
            mine["attn_rms_gap"] = attn_rms_gap(s["attn_of"].get(i), attn)
            got = s["feats_of"].get(i)
            mine["fbank_rms_gap"] = (float("inf") if got is None
                                     else compare.row_rms_gap(got, feats))
            want = synth.reference_mel(run, s, tokens, a["input"]["x"], full)
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
    program's place (its own filterbank and encode, then its decode of
    those tokens), on the calls the seed checks."""
    s = data(run, torch)
    no_tf32()
    low = Ops(precision)
    tr = run.traffic
    checked = plan_of.checked(tr, run.seed)
    order = plan_of.plan(tr, run.seed, max(checked) + 1)
    answers, s["attn_of"], s["feats_of"] = {}, {}, {}
    with torch.no_grad():
        for i, li in checked.items():
            inp = s["pool"][li][synth.pool_index(order, i) % len(s["pool"][li])]
            tokens = encode_numbers(run, s, inp, None, low)[0]
            s["feats_of"][i], s["attn_of"][i] = reference_first_row(run, s, inp, low)
            answers[i] = {"mel": synth.reference_mel(run, s, tokens, inp["x"], low),
                          "tokens": tokens, "input": inp}
    return check(run, s, answers, len(checked))[0]


# synth.py's window over this module's data, program and check.
run = types.FunctionType(synth.run.__code__,
                         dict(vars(synth), data=data, program=program, check=check), "run")
