"""The port's profiler spans (``utils.speed.span``) on the CPU: where the
synthesis call and the training step open them, that they enter no
``record_function`` while no profiler runs, that their names carry a prefix
the benchmark's trace reader keeps off the device's timeline, and the three
per-layer readers that turn them into device idle, on hand-built traces.
"""

from __future__ import annotations

import ast
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import edge_diffusion_tts_tpu_torch
from benchmark.harness.manifest import Manifest
from benchmark.harness.trace import ANNOTATIONS, TraceView
from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder, HubertConfig, SemanticEncoder
from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
from edge_diffusion_tts_tpu_torch.training import Trainer, create_train_state, make_optimizer
from edge_diffusion_tts_tpu_torch.utils import speed

TINY = dict(hidden=32, layers=1, heads=2, attn_window_size=8, dropout=0.0, batch_size=2,
            segment_secs=0.1)
# hubert-base's conv kernels and strides at a small width: the frontend-kernel
# route, which runs its plain version on the CPU
BASE_STACK = HubertConfig(conv_dim=(128,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                          conv_stride=(5, 2, 2, 2, 2, 2, 2), hidden_size=32, num_layers=2,
                          num_heads=2, intermediate_size=64, num_conv_pos_embeddings=16,
                          num_conv_pos_embedding_groups=4)
SYNTH_SPANS = ("prep:encode", "prep:loop_inputs", "prep:launch")
TRAIN_RANGES = {"train:mel", "train:hubert", "train:encoder", "train:decoder",
                "train:backward", "train:optimizer"}


def _engine(hubert_cfg=None):
    cfg = CFG(**TINY)
    torch.manual_seed(0)
    decoder = EdgeDiffusionDecoder(cfg).eval()
    encoder = None if hubert_cfg is None else SemanticEncoder(cfg, hubert_cfg).eval()
    return EdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps), decoder,
                         prediction="v", backend="fused", device="cpu", encoder=encoder)


def _wav(B=2, n=3200):
    return torch.from_numpy(np.random.RandomState(0).randn(B, n).astype(np.float32) * 0.1)


def _trainer_step():
    cfg = CFG(**TINY)
    torch.manual_seed(0)
    enc, dec = SemanticEncoder(cfg, HubertConfig.tiny()), EdgeDiffusionDecoder(cfg)
    trainer = Trainer(cfg, enc, dec, DiffusionSchedule.create(cfg.diff_steps), device="cpu")
    state = create_train_state(trainer.encoder, trainer.decoder,
                               make_optimizer(cfg, trainer.encoder, trainer.decoder, 10))
    batch = trainer.put_batch({"wav": _wav(cfg.batch_size, cfg.segment_len).numpy()})
    step = trainer.make_diffusion_step()
    return lambda: step(state, batch, torch.Generator().manual_seed(1))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench:call"):
            fn()
    return prof.events()


def _named(events, names):
    return sorted((e for e in events if e.name in names), key=lambda e: e.time_range.start)


def _ancestors(e):
    out, p = [], e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


# -- (a) where synthesis opens its spans ----------------------------------------------


@pytest.mark.parametrize("calls", [1, 2])
def test_generate_mel_opens_loop_inputs_then_launch_per_call(calls):
    engine = _engine()
    tokens = np.random.RandomState(1).randint(0, 100, (2, 6))
    events = _profiled(lambda: [engine.generate_mel(tokens, 2) for _ in range(calls)])
    spans = _named(events, SYNTH_SPANS)
    assert [e.name for e in spans] == ["prep:loop_inputs", "prep:launch"] * calls
    for e in spans:
        assert _ancestors(e)[-1] == "bench:call"
    for first, then in zip(spans, spans[1:]):  # siblings, one after the other
        assert first.time_range.end <= then.time_range.start


@pytest.mark.parametrize("hubert_cfg", [HubertConfig.tiny(), BASE_STACK],
                         ids=["modules_route", "kernel_route"])
def test_generate_from_audio_opens_encode_first(hubert_cfg):
    engine = _engine(hubert_cfg)
    assert engine.encode_route == ("kernel" if hubert_cfg is BASE_STACK else "modules")
    events = _profiled(lambda: engine.generate_from_audio(_wav(), 2))
    spans = _named(events, SYNTH_SPANS)
    assert [e.name for e in spans] == list(SYNTH_SPANS)
    assert spans[0].time_range.end <= spans[1].time_range.start  # closed before the loop's
    assert all(_ancestors(e)[-1] == "bench:call" for e in spans)


def test_fused_generate_mel_bf16_opens_both_spans():
    engine = _engine()
    dec, cfg = engine.decoder, engine.cfg
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 100, (2, 6)))
    x = torch.randn(2, 12, cfg.n_mels, generator=torch.Generator().manual_seed(2))
    events = _profiled(lambda: fd.fused_generate_mel(cfg, engine.schedule, dec, tokens, x, 2, "v",
                                                     compute_dtype=torch.bfloat16))
    assert [e.name for e in _named(events, SYNTH_SPANS)] == ["prep:loop_inputs", "prep:launch"]


# -- (b) no profiler, no record_function ------------------------------------------------


def test_no_profiler_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    synth, step = _engine(HubertConfig.tiny()), _trainer_step()
    # the class itself, whatever name a module bound it to
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__", refuse)
    assert not torch.autograd._profiler_enabled()
    assert speed.span("prep:a") is speed.span("train:b")  # one shared no-op
    synth.generate_from_audio(_wav(), 2)
    _, metrics = step()
    assert np.isfinite(float(metrics["loss"]))


# -- (c) the trainer's step range -------------------------------------------------------


def test_train_step_encloses_every_trainer_range():
    events = _profiled(_trainer_step())
    ranges = [e for e in events if e.name.startswith("train:")]
    steps = [e for e in ranges if e.name == "train:step"]
    assert len(steps) == 1 and _ancestors(steps[0]) == ["bench:call"]
    inner = [e for e in ranges if e is not steps[0]]
    assert {e.name for e in inner} == TRAIN_RANGES
    step = steps[0].time_range
    for e in inner:
        assert "train:step" in _ancestors(e), e.name
        assert step.start <= e.time_range.start and e.time_range.end <= step.end


# -- (d) the names --------------------------------------------------------------------


def test_every_span_name_carries_a_trace_prefix():
    """Every ``span`` the port opens names a string constant whose prefix the
    trace reader keeps off the device's timeline (and is not the harness's
    own ``bench:``); nothing but ``span`` opens a ``record_function``."""
    root = Path(edge_diffusion_tts_tpu_torch.__file__).parent
    names = []
    for path in sorted(root.rglob("*.py")):
        source = path.read_text()
        if path.name != "speed.py":
            assert "record_function" not in source, path
        for node in ast.walk(ast.parse(source)):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span":
                arg = node.args[0]
                assert isinstance(arg, ast.Constant) and isinstance(arg.value, str), \
                    f"{path}:{node.lineno}"
                names.append(arg.value)
    assert set(SYNTH_SPANS) | TRAIN_RANGES | {"train:step", "train:allreduce"} == set(names)
    for name in names:
        assert name.startswith(ANNOTATIONS) and not name.startswith("bench:"), name


# -- (e) the readers on hand-built traces ----------------------------------------------


def _event(name, start_us, end_us, device="CPU"):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start_us, end=end_us),
                           device_type=f"DeviceType.{device}", kernels=[], cpu_parent=None)


def _view(host, device, info=None):
    events = [_event(n, a, b) for n, a, b in host] + [_event(n, a, b, "CUDA") for n, a, b in device]
    return TraceView(SimpleNamespace(events=lambda: events), info or {})


# Two calls of 800 us.  Call 1: encode 190 us over 100 busy, loop inputs 80
# over 30, launch 50 over 10; call 2: encode 90 over 30, loop inputs 100 over
# none, launch 10 over 5.  The profiler's copy of a range on the device's
# timeline ("prep:launch" on the CUDA side) is no device work.
SYNTH_HOST = [("bench:window", 0, 2000), ("bench:call", 100, 900), ("bench:call", 1000, 1800),
              ("prep:encode", 110, 300), ("prep:loop_inputs", 320, 400),
              ("prep:launch", 400, 450), ("aten::mm", 330, 340),
              ("prep:encode", 1010, 1100), ("prep:loop_inputs", 1100, 1200),
              ("prep:launch", 1200, 1210)]
SYNTH_DEVICE = [("gemm", 150, 250), ("gemm", 350, 380), ("loop", 440, 880),
                ("prep:launch", 400, 450), ("gemm", 1020, 1050), ("loop", 1205, 1790)]
# Two steps: glue 10 + 10 + 20 + 40 us over 3 + 10 + 30 busy; then 100 + 100
# over 10, around a backward with a range nested in it.
TRAIN_HOST = [("bench:window", 0, 3000), ("bench:step", 0, 1000), ("train:step", 10, 990),
              ("train:mel", 20, 100), ("train:hubert", 100, 300), ("train:encoder", 300, 350),
              ("train:decoder", 360, 600), ("train:backward", 620, 800),
              ("train:optimizer", 800, 950), ("bench:step", 1000, 1500),
              ("train:step", 1000, 1500), ("train:backward", 1100, 1400),
              ("train:decoder", 1150, 1200)]
TRAIN_DEVICE = [("k", 15, 18), ("k", 590, 610), ("k", 700, 750), ("k", 960, 995),
                ("train:step", 10, 990), ("k", 1050, 1060), ("k", 1200, 1300)]


@pytest.mark.parametrize("metric,host,device,want", [
    ("prep_idle_ms_per_call.synth", SYNTH_HOST, SYNTH_DEVICE, (50 + 40 + 100 + 5) / 2 / 1e3),
    ("encode_idle_ms_per_call.synth", SYNTH_HOST, SYNTH_DEVICE, (90 + 60) / 2 / 1e3),
    ("glue_idle_ms_per_step.train", TRAIN_HOST, TRAIN_DEVICE, (80 - 43 + 200 - 10) / 2 / 1e3),
])
def test_reader_gives_the_idle_inside_its_spans(metric, host, device, want):
    view = _view(host, device)
    assert Manifest().reader(metric)(view) == pytest.approx(want, rel=1e-12, abs=0)
    ours = {n for n, _, _ in host if n.startswith(("prep:", "train:step"))}
    parent = _view([h for h in host if h[0] not in ours], device)
    assert Manifest().reader(metric)(parent) is None  # the spans absent, as on the parent


def test_prep_and_encode_idle_are_part_of_the_host_time_per_call():
    view, m = _view(SYNTH_HOST, SYNTH_DEVICE), Manifest()
    host = m.reader("host_ms_per_call.synth")(view)
    assert host == pytest.approx((800 - 570 + 800 - 615) / 2 / 1e3, rel=1e-12, abs=0)
    spans = (m.reader("prep_idle_ms_per_call.synth")(view)
             + m.reader("encode_idle_ms_per_call.synth")(view))
    assert 0 < spans < host
    breakdown = view.breakdown()
    assert not any(name.startswith(ANNOTATIONS) for name, _ in breakdown["device_ops"])
    assert {name for name, _ in breakdown["idle_gaps"]} & {"prep:loop_inputs", "prep:launch"}
