"""The port's ``train()`` driver on a synthetic LJSpeech-layout corpus, on the CPU.

One three-phase run at the JAX training tests' tiny shapes (with a resume
after it) serves most checks: finite losses in every phase, periodic,
phase-end, best and final artifacts, the distillation learning rate, phase
skipping on ``resume="auto"``, and the final model served by
``EdgeInference``.  Checkpoints round-trip with the teacher's arity fitted;
the chained step equals single steps; a mesh or pipeline stages without a
process group raise; ``export=True`` writes the final decoder as a ``.pt2``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder, HubertConfig, SemanticEncoder
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
from edge_diffusion_tts_tpu_torch.training import (
    Trainer,
    create_train_state,
    make_optimizer,
    progressive_step_schedule,
    restore_checkpoint,
    save_checkpoint,
    train,
)
from edge_diffusion_tts_tpu_torch.weights import load_checkpoint

N_UTT = 40  # 2 validation utterances at val_frac 0.05


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny steps are launch-bound: one intra-op thread is faster, and
    does not contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(root):
    os.makedirs(os.path.join(root, "wavs"))
    rng = np.random.RandomState(0)
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        for i in range(N_UTT):
            n = int(22050 * (0.09 + 0.06 * rng.rand()))
            t = np.arange(n) / 22050
            w = 0.3 * np.sin(2 * np.pi * (100 + 7 * i) * t) + 0.02 * rng.randn(n)
            wavfile.write(os.path.join(root, "wavs", f"LJ{i:03d}.wav"), 22050,
                          (w * 32767).astype(np.int16))
            f.write(f"LJ{i:03d}|t|t\n")
    return root


def tiny_cfg(tmp, **kw):
    d = dict(hidden=32, layers=1, heads=2, segment_secs=0.1, batch_size=2, grad_accumulation=2,
             diff_steps=16, max_timestep=14, diffusion_epochs=1, progressive_epochs_per_halving=1,
             consistency_epochs=1, dropout=0.1, cfg_dropout=0.1, lr_consistency=3e-4,
             plot_every_steps=0, log_every_steps=1, val_every_steps=4, val_batches=1,
             ckpt_every_steps=5, num_workers=1, out_dir=str(tmp / "out"), run_name="run",
             ljspeech_dir=str(tmp / "LJSpeech-1.1"), data_root=str(tmp))
    d.update(kw)
    return CFG(**d)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    _corpus(str(tmp / "LJSpeech-1.1"))
    cfg = tiny_cfg(tmp)
    tags = []
    state = train(cfg, hubert_cfg=HubertConfig.tiny(), device="cpu",
                  phase_end_hook=lambda tag, st: tags.append((tag, st.step)))
    return dict(tmp=tmp, cfg=cfg, state=state, tags=tags,
                run_dir=os.path.join(cfg.out_dir, cfg.run_name))


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_three_phases_finite(run):
    cfg, state = run["cfg"], run["state"]
    spe = (N_UTT - 2) // cfg.batch_size  # 19 steps per epoch
    halvings = progressive_step_schedule(cfg.diff_steps, cfg.progressive_target_steps)
    assert halvings == [8, 4]
    assert state.step == spe * (1 + len(halvings) + 1)
    assert [t for t, _ in run["tags"]] == ["init", "diffusion", "prog8", "prog4", "consistency"]
    recs = _records(run["run_dir"])
    losses = {p: [r[f"{p}loss"] for r in recs if f"{p}loss" in r]
              for p in ("train/", "prog8/", "prog4/", "consistency/")}
    for prefix, vals in losses.items():
        assert len(vals) == spe and np.isfinite(vals).all(), prefix
    assert any("eval/val_eps_mse" in r for r in recs)
    assert any("diffusion/val_cos" in r for r in recs)
    # The distillation phases run at the constant lr_consistency.
    assert state.optimizer.lr(0) == state.optimizer.lr(10**6) == float(np.float32(3e-4))
    for name in ("checkpoint_phase1", "checkpoint_phase2", "checkpoint_final", "best_diffusion",
                 "best_model", "edge_model_final"):
        assert os.path.isdir(os.path.join(run["run_dir"], name)), name


def test_best_checkpoint_from_mid_epoch_eval(run):
    with open(os.path.join(run["run_dir"], "best_diffusion", "meta.json")) as f:
        meta = json.load(f)
    assert meta["step"] % run["cfg"].val_every_steps == 0 and np.isfinite(meta["val_eps_mse"])
    assert meta["frozen_external"] == "frozen_hubert"
    d, _, _ = restore_checkpoint(os.path.join(run["run_dir"], "best_diffusion"))
    assert any(k.startswith("hubert.") for k in d["encoder"])  # put back from the sibling


def test_resume_auto_skips_completed_phases(run, capsys):
    cfg = run["cfg"]
    with open(os.path.join(cfg.ckpt_path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["phase"] == "consistency" and meta["step"] == 75
    capsys.readouterr()
    cfg = dataclasses.replace(cfg, run_name="resumed")  # the first run's artifacts stay
    state = train(cfg, hubert_cfg=HubertConfig.tiny(), device="cpu", resume="auto")
    out = capsys.readouterr().out
    assert "(phase consistency)" in out
    assert "Phase 1: diffusion - already complete" in out
    assert "Phase 2: progressive - already complete" in out
    assert state.step == 75 + 19


def test_final_model_serves(run):
    cfg, dec_sd, hubert_cfg, enc_sd = load_checkpoint(
        os.path.join(run["run_dir"], "edge_model_final"), with_encoder=True)
    dec = EdgeDiffusionDecoder(cfg)
    dec.load_state_dict(dec_sd)
    enc = SemanticEncoder(cfg, hubert_cfg)
    enc.load_state_dict(enc_sd)
    for k, v in run["state"].decoder.state_dict().items():
        assert torch.equal(dec_sd[k], v)
    engine = EdgeInference(cfg, DiffusionSchedule.create(cfg.diff_steps), dec, prediction="v",
                           device="cpu", encoder=enc)
    mel = engine.generate_mel(np.zeros((1, 6), np.int64), num_steps=2)
    assert mel.shape == (1, 12, 80) and torch.isfinite(mel).all()
    assert torch.isfinite(engine.generate_from_audio(np.zeros(1600, np.float32),
                                                     num_steps=1)).all()


def _fresh(cfg, seed=0):
    torch.manual_seed(seed)
    trainer = Trainer(cfg, SemanticEncoder(cfg, HubertConfig.tiny()), EdgeDiffusionDecoder(cfg),
                      DiffusionSchedule.create(cfg.diff_steps), device="cpu")
    state = create_train_state(trainer.encoder, trainer.decoder,
                               make_optimizer(cfg, trainer.encoder, trainer.decoder, 20))
    return trainer, state


def test_checkpoint_round_trip_and_teacher_arity(tmp_path):
    cfg = tiny_cfg(tmp_path, use_fsq=False)
    trainer, state = _fresh(cfg)
    g = torch.Generator().manual_seed(1)
    wav = torch.randn(2, cfg.segment_len) * 0.1
    step = trainer.make_diffusion_step()
    for _ in range(3):
        state, _ = step(state, {"wav": wav}, g)
    state.with_teacher()
    with torch.no_grad():
        next(state.teacher.parameters()).add_(1.0)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state, cfg, {"phase": "progressive", "halving": 8},
                    hubert_cfg=HubertConfig.tiny())
    _, other = _fresh(cfg, seed=5)
    assert other.teacher is None
    other, cfg2, meta = restore_checkpoint(path, other)
    assert meta == {"phase": "progressive", "halving": 8} and cfg2.to_dict() == cfg.to_dict()
    want, got = state.state_dict(), other.state_dict()
    assert got["step"] == 3 and got["optimizer"]["mini_step"] == 1
    for part in ("encoder", "decoder", "teacher"):
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), f"{part}.{k}"
    for k, v in want["optimizer"]["mu"].items():
        assert torch.equal(got["optimizer"]["mu"][k], v)
    assert "vq.ema_w" in got["encoder"] and "vq.update_count" in got["encoder"]
    # A checkpoint without a teacher drops the one the state has.
    state.teacher = None
    save_checkpoint(path, state, cfg, {})
    assert os.path.isdir(path) and not os.path.exists(path + ".stale")
    restore_checkpoint(path, other)
    assert other.teacher is None
    # A teacher that does not fit this decoder is refused.
    wide = tiny_cfg(tmp_path, use_fsq=False, hidden=48)
    state.teacher = EdgeDiffusionDecoder(wide)
    save_checkpoint(path, state, cfg, {})
    with pytest.raises(ValueError, match="teacher does not fit"):
        restore_checkpoint(path, other)


def test_chained_step_equals_single_steps(tmp_path):
    cfg = tiny_cfg(tmp_path)
    corpus = {"wav": torch.randn(10, cfg.segment_len) * 0.1}
    idx = torch.tensor([[0, 3], [1, 9], [8, 6]])
    trainer_a, a = _fresh(cfg)
    trainer_b, b = _fresh(cfg)
    chained = trainer_a.make_chained_step(kind="diffusion")
    a, stacked = chained(a, corpus, idx, torch.Generator().manual_seed(3))
    single = trainer_b.make_diffusion_step()
    g = torch.Generator().manual_seed(3)
    losses = []
    for row in idx:
        b, m = single(b, {"wav": corpus["wav"][row]}, g)
        losses.append(m["loss"])
    assert stacked["loss"].shape == (3,) and "grad_norm" in stacked
    np.testing.assert_allclose(stacked["loss"].numpy(), torch.stack(losses).numpy(), atol=1e-6)
    for (name, p), q in zip(a.optimizer.params.items(), b.optimizer.params.values()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-6,
                                   err_msg=name)
    assert a.step == b.step == 3


@pytest.mark.parametrize("kw,match", [(dict(mesh_shape=[2, 1]), "process group"),
                                      (dict(pipeline_stages=2), "process group")])
def test_unported_options_raise(tmp_path, kw, match):
    """A mesh or pipeline stages need a process group."""
    cfg = tiny_cfg(tmp_path, **kw)
    with pytest.raises(RuntimeError, match=match):
        train(cfg, train_loader=[], device="cpu")


def test_missing_corpus_raises_from_train(tmp_path):
    cfg = tiny_cfg(tmp_path, ljspeech_dir=str(tmp_path / "absent"), data_root=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="LJSpeech not found"):
        train(cfg, hubert_cfg=HubertConfig.tiny(), device="cpu")


def test_validation_fns_and_sample_plot(tmp_path):
    """The DPM-Solver++ and raw-DDIM validations and the target-MSE
    evaluation give finite scores without moving the state; the plot hook
    writes its PNG (matplotlib is imported only when it is called)."""
    pytest.importorskip("matplotlib")
    from edge_diffusion_tts_tpu_torch.training.train import make_visualization_hook

    cfg = tiny_cfg(tmp_path, plot_every_steps=2, dropout=0.1)
    trainer, state = _fresh(cfg)
    batch = {"wav": np.random.RandomState(0).randn(2, cfg.segment_len).astype(np.float32) * 0.1}
    before = {k: v.clone() for k, v in state.decoder.state_dict().items()}
    g = torch.Generator().manual_seed(0)
    for fn in (trainer.make_validate_fn(num_steps=2),
               trainer.make_validate_fn(num_steps=2, conditioning="tokens"),
               trainer.make_validate_ddim_fn(num_steps=2), trainer.make_eval_eps_fn()):
        scores = fn(state, trainer.put_batch(batch), g)
        assert scores and all(torch.isfinite(v) for v in scores.values())
    assert state.decoder.training  # validation restores training mode
    for k, v in state.decoder.state_dict().items():
        assert torch.equal(v, before[k])
    hook = make_visualization_hook(cfg, trainer, batch, str(tmp_path))
    hook(3, state)
    hook(4, state)
    assert os.listdir(tmp_path / "samples") == ["gen_step_4.png"]


class _CorpusLoader:
    """An in-memory fixed-segment corpus (``.wavs``), the chained driver's
    input."""

    def __init__(self, wavs, batch):
        self.wavs, self.batch = wavs, batch

    def __len__(self):
        return len(self.wavs) // self.batch

    def __iter__(self):
        for i in range(len(self)):
            yield {"wav": self.wavs[i * self.batch:(i + 1) * self.batch]}


def test_train_with_chained_steps(tmp_path):
    """steps_per_dispatch=3 drives every phase through the chained step over
    the corpus on the device: the same number of data steps, finite
    losses, a periodic checkpoint on its cadence crossing."""
    cfg = tiny_cfg(tmp_path, steps_per_dispatch=3, ckpt_every_steps=4, log_every_steps=1)
    wavs = (np.random.RandomState(0).randn(10, cfg.segment_len) * 0.1).astype(np.float32)
    state = train(cfg, train_loader=_CorpusLoader(wavs, cfg.batch_size),
                  val_loader=_CorpusLoader(wavs[:2], cfg.batch_size),
                  hubert_cfg=HubertConfig.tiny(), device="cpu")
    assert state.step == 5 * (1 + 2 + 1)
    recs = _records(os.path.join(cfg.out_dir, cfg.run_name))
    losses = [v for r in recs for k, v in r.items() if k.endswith("/loss")]
    assert len(losses) == state.step and np.isfinite(losses).all()
    with open(os.path.join(cfg.ckpt_path, "meta.json")) as f:
        assert json.load(f)["step"] % 4 == 0
    with pytest.raises(ValueError, match="wavs"):
        train(cfg, train_loader=[{"wav": wavs[:2]}], hubert_cfg=HubertConfig.tiny(),
              device="cpu")


def test_train_export_writes_pt2(tmp_path):
    """export=True: the run directory holds edge_model.pt2 (utils/export.py),
    which loads and computes what the final decoder computes (1e-6: the same
    ops on the same CPU)."""
    from edge_diffusion_tts_tpu_torch.utils.export import load_exported

    cfg = tiny_cfg(tmp_path, dropout=0.0)
    wavs = (np.random.RandomState(1).randn(6, cfg.segment_len) * 0.1).astype(np.float32)
    state = train(cfg, train_loader=_CorpusLoader(wavs, cfg.batch_size),
                  hubert_cfg=HubertConfig.tiny(), phases=["diffusion"], device="cpu",
                  export=True)
    path = os.path.join(cfg.out_dir, cfg.run_name, "edge_model.pt2")
    assert os.path.getsize(path) > 0
    program = load_exported(path, device="cpu")
    rng = np.random.RandomState(2)
    for B, T, S in ((1, 20, 10), (2, 37, 19)):
        x = torch.from_numpy(rng.randn(B, T, cfg.n_mels).astype(np.float32))
        t = torch.from_numpy(rng.randint(0, cfg.diff_steps, B))
        sem = torch.from_numpy(rng.randint(0, cfg.effective_codebook_size(), (B, S)))
        step = torch.from_numpy(rng.randint(0, 4, B))
        with torch.no_grad():
            want = state.decoder.eval()(x, t, sem_idx=sem, step_idx=step)
            got = program(x, t, sem, step)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
