"""The port's command line (cli.py) and demo (demo.py) on the CPU.

- ``build_parser()`` has every subcommand, flag, default and choice of the
  JAX CLI's, apart from the divergences its docstring lists (``--device``
  on every model command, ``export --format pt2`` as the default).
- ``main([... "--device", "cpu"])`` runs generate (also ``--oracle`` and
  ``--post-filter``), export (both formats), precompute ``--limit 2`` and
  longform ``--stream`` on a small checkpoint (the orbax recipe of
  tests/test_torch_orbax_bridge.py) and synthetic wavs; ``migrate`` is in
  tests/test_torch_migrate.py.
- Without a card every model command exits with the "no CUDA device"
  message; the refused flags exit naming the port's counterpart.
- ``generate_sample``'s mel (the one it vocodes) equals the JAX demo's on the
  same weights with JAX's start noise injected (1e-4; both sample with
  DPM-Solver++, well conditioned); ``vocode_mel``, ``oracle_roundtrip`` (the
  start phase injected, 8 Griffin-Lim iterations) and the post-filter's
  spectral gate equal JAX's, at 2e-5 of the signal's peak as the
  Griffin-Lim parity test holds it.  There both sides take the port's
  filterbank pseudo-inverse: JAX's float32 one differs from the port's
  float64 one by ~6e-7 (tests/test_torch_audio_ops.py), which the inverse
  mel scale of a loud mel and Griffin-Lim's phase renormalization carry to
  ~1e-3 of the waveform's peak.
"""

import argparse
import json
import os
import shutil
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from edge_diffusion_tts_tpu import cli as jcli
from edge_diffusion_tts_tpu import demo as jdemo
from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.ops.mel import MelFrontend as JMel
from edge_diffusion_tts_tpu_torch import cli, demo
from edge_diffusion_tts_tpu_torch import inference as pinference
from edge_diffusion_tts_tpu_torch.config import CFG, hubert_num_frames
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder
from edge_diffusion_tts_tpu_torch.utils.export import load_exported
from edge_diffusion_tts_tpu_torch.weights import load_checkpoint
from test_torch_orbax_bridge import port_checkpoint_from_jax, write_jax_final_model

MODEL_COMMANDS = ("train", "bench", "precompute", "generate", "longform", "export", "serve")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the small calls here are launch-bound, and the
    other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sine_wav(path, seconds, sr=16000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    w = 0.3 * np.sin(2 * np.pi * (120 + 60 * t) * t) + 0.02 * rng.randn(t.size)
    wavfile.write(path, sr, (w * 32767).astype(np.int16))
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    jdir, pdir = str(tmp / "jax_final"), str(tmp / "port_final")
    write_jax_final_model(jdir)
    port_checkpoint_from_jax(jdir, pdir)
    eps = str(tmp / "port_eps")
    shutil.copytree(pdir, eps)
    cfg, _, _, _ = load_checkpoint(pdir)
    cfg.use_v_prediction = False
    with open(os.path.join(eps, "cfg.json"), "w") as f:
        f.write(cfg.to_json())
    return dict(tmp=tmp, jax=jdir, port=pdir, eps=eps,
                wav=_sine_wav(str(tmp / "ref.wav"), 1.0),
                long=_sine_wav(str(tmp / "long.wav"), 3.0, seed=1))


# ---- the parser -----------------------------------------------------------------------


def _subcommands(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _options(parser):
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_has_every_jax_flag_default_and_choice():
    jsubs, psubs = _subcommands(jcli.build_parser()), _subcommands(cli.build_parser())
    assert set(psubs) == set(jsubs)
    for name, jsub in jsubs.items():
        jopts, popts = _options(jsub), _options(psubs[name])
        extra = set(popts) - set(jopts)
        assert extra == ({"device"} if name in MODEL_COMMANDS and name != "train" else set())
        for dest, ja in jopts.items():
            pa = popts[dest]
            assert pa.option_strings == ja.option_strings, (name, dest)
            assert type(pa) is type(ja) and pa.nargs == ja.nargs, (name, dest)
            assert pa.required == ja.required, (name, dest)
            if (name, dest) == ("export", "format"):  # divergence: pt2 added, the default
                assert set(ja.choices) < set(pa.choices) and pa.default == "pt2"
                continue
            assert pa.default == ja.default and pa.choices == ja.choices, (name, dest)
            if dest != "device":  # divergence: the port's --device checks its value
                assert pa.type == ja.type, (name, dest)
    # A JAX command line parses here.
    args = cli.build_parser().parse_args(
        ["train", "--config", "c.json", "--mesh", "8,1", "--phases", "diffusion", "--recipe",
         "v2", "--device", "gpu"])
    assert args.device == "cuda" and args.mesh == "8,1" and args.recipe == "v2"


def test_model_commands_need_a_card_unless_told_cpu(ckpts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"train": [], "bench": [], "precompute": [str(ckpts["tmp"])],
            "generate": [ckpts["port"]], "longform": [ckpts["port"], ckpts["wav"]],
            "export": [ckpts["port"]], "serve": [ckpts["port"]]}
    for command in MODEL_COMMANDS:
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main([command] + argv[command])
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main([])  # a bare command line trains


@pytest.mark.parametrize("argv,match", [
    (["export", "ck", "--format", "stablehlo"], "--format pt2"),
    (["export", "ck", "--quantize", "int8"], "--format weight-int8"),
    (["serve", "ck", "--compile-cache", "/tmp/x"], "no counterpart"),
    (["bench", "--device", "cpu"], "refused"),
])
def test_refused_flags_exit(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)


def test_device_tpu_exits(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["generate", "ck", "--device", "tpu"])
    assert e.value.code == 2 and "'tpu'" in capsys.readouterr().err


def test_dpmpp_on_an_eps_checkpoint_exits(ckpts, tmp_path):
    with pytest.raises(SystemExit, match="v-prediction"):
        cli.main(["generate", ckpts["eps"], "--wav", ckpts["wav"], "--sampler", "dpmpp",
                  "--device", "cpu", "--out", str(tmp_path / "x.wav")])


# ---- the subcommands on the CPU -----------------------------------------------------


def test_generate_oracle_and_post_filter(ckpts, tmp_path):
    sr, ref = wavfile.read(ckpts["wav"])
    for flags in ([], ["--oracle"], ["--post-filter"]):
        out = str(tmp_path / f"gen{len(flags)}{''.join(flags)}.wav")
        cli.main(["generate", ckpts["port"], "--wav", ckpts["wav"], "--steps", "2",
                  "--device", "cpu", "--out", out] + flags)
        osr, wav = wavfile.read(out)
        assert osr == sr and wav.dtype == np.int16 and np.abs(wav).max() > 0
        if flags == ["--oracle"]:
            assert wav.shape == ref.shape
        else:  # S tokens -> 2S mel frames -> (2S - 1) hops of Griffin-Lim
            assert wav.shape[0] == (2 * hubert_num_frames(ref.shape[0]) - 1) * 160


def test_export_both_formats(ckpts, tmp_path, capsys):
    pt2 = str(tmp_path / "dec.pt2")
    cli.main(["export", ckpts["port"], "--out", pt2, "--device", "cpu"])
    cfg, dec_state, _, _ = load_checkpoint(ckpts["port"])
    dec = EdgeDiffusionDecoder(cfg)
    dec.load_state_dict(dec_state)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 40, 80).astype(np.float32))
    t, s, st = torch.tensor([3, 900]), torch.from_numpy(rng.randint(0, 64, (2, 20))), \
        torch.tensor([0, 3])
    with torch.no_grad():
        np.testing.assert_allclose(load_exported(pt2, device="cpu")(x, t, s, st).numpy(),
                                   dec.eval()(x, t, sem_idx=s, step_idx=st).numpy(), atol=1e-6)
    capsys.readouterr()
    cli.main(["export", ckpts["port"], "--format", "weight-int8", "--out",
              str(tmp_path / "dec.int8"), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[0])
    assert report["ratio"] > 1 and report["kept_f32"]
    assert lines[1].endswith(str(tmp_path / "dec.int8.npz"))


def test_precompute_limit(ckpts, tmp_path, capsys):
    root = tmp_path / "LJSpeech-1.1"
    os.makedirs(root / "wavs")
    with open(root / "metadata.csv", "w") as f:
        for i in range(3):
            _sine_wav(str(root / "wavs" / f"LJ{i:03d}.wav"), 0.4 + 0.1 * i, sr=22050, seed=i)
            f.write(f"LJ{i:03d}|t|t\n")
    cli.main(["precompute", str(root), "--limit", "2", "--device", "cpu"])
    assert "random-init HuBERT" in capsys.readouterr().err
    feats = sorted(os.listdir(root / "hubert_features"))
    assert feats == ["LJ000.npy", "LJ001.npy"]
    for name, secs in zip(feats, (0.4, 0.5)):
        a = np.load(root / "hubert_features" / name)
        assert a.shape == ((int(secs * 16000) - 400) // 320 + 1, 768)
        assert np.isfinite(a).all()


def test_longform_stream_writes_a_growing_riff(ckpts, tmp_path, capsys):
    out = str(tmp_path / "lf.wav")
    cli.main(["longform", ckpts["port"], ckpts["long"], "--stream", "--steps", "2",
              "--device", "cpu", "--out", out])
    printed = capsys.readouterr().out
    assert "first audio" in printed and "increment" in printed.split("first audio")[1]
    with open(out, "rb") as f:
        raw = f.read()
    assert raw[:4] == b"RIFF" and raw[8:16] == b"WAVEfmt "
    n_data = struct.unpack("<I", raw[40:44])[0]
    assert struct.unpack("<I", raw[4:8])[0] == 36 + n_data == len(raw) - 8
    sr, wav = wavfile.read(out)
    assert sr == 16000 and wav.shape == (n_data // 2,) and wav.shape[0] == 3 * 16000


# ---- the demo against the JAX package's -----------------------------------------------


def test_generate_sample_mel_equals_jax(ckpts, tmp_path, monkeypatch):
    mels = {}

    def capture(name):
        def vocode(cfg, mel_log, *a, **kw):
            mels[name] = np.asarray(mel_log)
            return np.zeros((1, 160), np.float32)
        return vocode

    monkeypatch.setattr(jdemo, "vocode_mel", capture("jax"))
    monkeypatch.setattr(demo, "vocode_mel", capture("port"))
    jdemo.generate_sample(ckpts["jax"], wav_path=ckpts["wav"], num_steps=4,
                          out_path=str(tmp_path / "j.wav"), seed=5, sampler="dpmpp")
    x_T = np.array(jax.random.normal(jax.random.PRNGKey(5), mels["jax"].shape))
    monkeypatch.setattr(pinference, "start_noise", lambda *a, **kw: torch.from_numpy(x_T))
    demo.generate_sample(ckpts["port"], wav_path=ckpts["wav"], num_steps=4,
                         out_path=str(tmp_path / "p.wav"), seed=5, sampler="dpmpp",
                         device="cpu")
    assert mels["port"].shape == mels["jax"].shape
    np.testing.assert_allclose(mels["port"], mels["jax"], atol=1e-4, rtol=0)


def _chirp(n, sr=16000):
    t = np.arange(n) / sr
    return (0.4 * np.sin(2 * np.pi * (200 + 900 * t) * t)).astype(np.float32)


def test_vocode_oracle_and_post_filter_equal_jax(monkeypatch):
    cfg, jcfg = CFG(), JCFG()
    pinv = jnp.asarray(demo._mel_frontend(cfg, "cpu").fbank_pinv.numpy())
    monkeypatch.setattr(jdemo, "inverse_mel_scale", lambda mel_power, fbank, eps=0.0: jnp.clip(
        jnp.einsum("btm,mf->btf", mel_power, pinv), eps))
    wav = _chirp(4000)
    key = jax.random.PRNGKey(3)
    fe = JMel(sample_rate=16000, n_fft=1024, hop_length=160, win_length=1024, n_mels=80,
              f_min=0.0, f_max=8000.0)
    mel_log = np.asarray(fe(jnp.asarray(wav)[None]))
    angle = np.array(jax.random.uniform(key, mel_log.shape[:2] + (513,), minval=0.0,
                                        maxval=2 * jnp.pi))
    want = np.asarray(jdemo.vocode_mel(jcfg, jnp.asarray(mel_log), key, n_iter=8))
    got = demo.vocode_mel(cfg, torch.from_numpy(mel_log), n_iter=8,
                          angle=torch.from_numpy(angle))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)

    want = np.asarray(jdemo.oracle_roundtrip(jcfg, wav, key, n_iter=8))
    got = demo.oracle_roundtrip(cfg, wav, n_iter=8, angle=torch.from_numpy(angle),
                                device="cpu")
    assert got.shape == want.shape == wav.shape
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)

    noisy = wav + 0.05 * np.random.RandomState(0).randn(wav.size).astype(np.float32)
    want = np.asarray(jdemo.denoise_post_filter(noisy, 16000))
    got = demo.denoise_post_filter(noisy, 16000)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)
