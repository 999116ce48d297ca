"""Three-phase training driver: diffusion -> progressive -> consistency
(counterpart of ``edge_diffusion_tts_tpu/training/train.py``).

One device (the card unless ``device="cpu"``), eager steps from
training/steps.py driven by a plain epoch loop, the mel frontend on the
device inside the step, checkpoints of the full train state
(training/checkpoint.py), metrics to JSONL (+ TensorBoard where installed).

Phases:
  1. the diffusion objective for ``diffusion_epochs`` (v-prediction by
     default, eps with ``use_v_prediction=False``);
  2. progressive distillation halving ``diff_steps`` down to
     ``progressive_target_steps``, the EMA teacher re-initialized at every
     halving, at a constant ``lr_consistency`` with Adam's moments kept;
  3. consistency training for ``consistency_epochs``.

Resume (``resume="auto"``) picks the newest complete periodic checkpoint
and skips the phases (and halvings) its meta records as done.

Parallel runs (``parallel/``), one process per rank under an initialized
process group (``torchrun`` + ``parallel.init_multihost()``):

- ``cfg.mesh_shape`` with a product > 1: every phase step runs data-parallel
  over the mesh's data axis (``parallel/data_parallel.py``).  Every rank
  walks the same global batch order and takes its rows of each batch.
- ``cfg.pipeline_stages`` > 1: the decoder's blocks are staged over a pipe
  axis (``parallel/pipeline_parallel.py``); checkpoints carry the packed
  layout and the final model is written canonical.

Both take the modules at ``cfg.compute_dtype`` and ``cfg.param_dtype`` as a
single-device run does: the stage decoders, the checkpoints (packed or not)
and the final model keep them.  Rank 0 alone writes checkpoints, metrics and
plots; a barrier follows every write, and resume loads on every rank.
``export=True`` writes the final decoder as ``edge_model.pt2``
(``utils/export.py``) beside ``edge_model_final``, where the JAX package
writes ``edge_model.stablehlo``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import CFG, resolve_device, torch_dtype
from ..layers.dtypes import cast_parameters
from ..models import EdgeDiffusionDecoder, HubertConfig, SemanticEncoder, hubert_config_for
from ..schedule import DiffusionSchedule, ddim_sample
from ..utils.logging import MetricWriter
from ..utils.reliability import make_nan_guard
from ..weights import save_checkpoint as save_weights
from .checkpoint import (
    frozen_hubert_host,
    resolve_checkpoint_dir,
    restore_checkpoint,
    save_checkpoint,
    save_final_model,
)
from .state import TrainState, constant_schedule, create_train_state, make_optimizer
from .steps import Trainer


def progressive_step_schedule(diff_steps: int, target: int = 4) -> List[int]:
    """Halving schedule diff_steps -> ... -> target."""
    steps, cur = [], diff_steps
    while cur > target:
        cur = max(cur // 2, target)
        steps.append(cur)
    return steps


def init_models(cfg: CFG, hubert_cfg: Optional[HubertConfig] = None,
                hubert_state: Optional[dict] = None):
    """``(encoder, decoder)`` initialized from torch's global generator (which
    ``CFG.setup_environment`` seeds).  ``hubert_state`` (a ``HubertEncoder``
    state dict, e.g. ``weights.hubert_state_dict_from_hf``) replaces the
    random frozen HuBERT, whose architecture is ``hubert_cfg`` or else the one
    ``cfg.hubert_id`` names.  The modules compute at ``cfg.compute_dtype``;
    every parameter, the frozen HuBERT's included, is then stored at
    ``cfg.param_dtype``, as the JAX package casts its parameter tree after
    init (the VQ's statistics are buffers and stay float32)."""
    compute, param = torch_dtype(cfg.compute_dtype), torch_dtype(cfg.param_dtype)
    encoder = SemanticEncoder(cfg, hubert_cfg or hubert_config_for(cfg.hubert_id), dtype=compute)
    decoder = EdgeDiffusionDecoder(cfg, dtype=compute)
    if hubert_state is not None:
        encoder.hubert.load_state_dict(hubert_state)
    encoder = cast_parameters(encoder, param)
    encoder.hubert.pack_frontend()  # the frontend kernel's copy of the cast weights
    return encoder, cast_parameters(decoder, param)


def _need_ranks(n: int, what: str) -> None:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{what} runs one process per rank: initialize a process group of {n} ranks "
            "first (torchrun + parallel.init_multihost(), or parallel.launch.spawn)")
    if dist.get_world_size() != n:
        raise ValueError(f"{what} needs {n} ranks, the process group has "
                         f"{dist.get_world_size()}")


def _parallel_layout(cfg: CFG):
    """``(data-parallel mesh or None, pipe mesh or None, microbatches)`` from
    ``cfg.mesh_shape`` and ``cfg.pipeline_stages``, with the JAX package's
    ``train()`` checks."""
    from ..parallel import make_mesh
    from ..parallel.pipeline_parallel import PIPE_AXIS

    dp = pipe = None
    n_mb = 0
    if cfg.mesh_shape and int(np.prod(cfg.mesh_shape)) > 1:
        n_mesh = int(np.prod(cfg.mesh_shape))
        if cfg.pipeline_stages > 1:
            raise ValueError("pipeline_stages and mesh_shape are mutually exclusive in "
                             "train(); compose DP x PP through PPTrainer(data_axis=...)")
        _need_ranks(n_mesh, f"mesh_shape={cfg.mesh_shape}")
        if cfg.batch_size % cfg.mesh_shape[0]:
            raise ValueError(f"batch_size={cfg.batch_size} must divide over the data axis "
                             f"({cfg.mesh_shape[0]} shards)")
        dp = make_mesh(cfg.mesh_shape, tuple(cfg.mesh_axis_names))
    if cfg.pipeline_stages > 1:
        n_stages = cfg.pipeline_stages
        _need_ranks(n_stages, f"pipeline_stages={n_stages}")
        if cfg.layers % n_stages:
            raise ValueError(f"layers={cfg.layers} must divide by pipeline_stages={n_stages}")
        n_mb = cfg.pipeline_microbatches or n_stages
        if cfg.batch_size % n_mb:
            raise ValueError(f"batch_size={cfg.batch_size} must divide by "
                             f"pipeline_microbatches={n_mb}")
        pipe = make_mesh((n_stages,), (PIPE_AXIS,))
    if (dp is not None or pipe is not None) and max(int(cfg.steps_per_dispatch), 1) > 1:
        raise ValueError("steps_per_dispatch > 1 is a single-device fast path; combine it "
                         "with a mesh or pipeline through the Trainer factories directly")
    return dp, pipe, n_mb


def _run_epoch(step_fn: Callable, state: TrainState, loader, generator,
               writer: Optional[MetricWriter], log_every: int,
               hooks: Optional[List[Callable]] = None, prefix: str = "",
               nan_guard: Optional[Callable] = None, put_batch: Optional[Callable] = None):
    """One epoch of a step over a loader; returns ``(state, last_metrics)``.
    Metrics are read (a device sync) only every ``log_every`` steps."""
    metrics = {}
    step = state.step
    for batch in loader:
        state, metrics = step_fn(state, put_batch(batch), generator)
        step += 1
        if step % log_every == 0:
            if writer is not None:
                writer.write(step, metrics, prefix=prefix)
            if nan_guard is not None and "loss" in metrics:
                nan_guard(step, float(metrics["loss"]))
        for hook in hooks or []:
            hook(step, state)
    return state, metrics


def make_visualization_hook(cfg: CFG, trainer: Trainer, val_batch, run_dir: str,
                            write: bool = True, rows: int = 1) -> Callable:
    """Every ``plot_every_steps``: the ground-truth mel of the first
    validation row against 4-, 8- and 16-step DDIM generations, as a PNG
    (utils/visualization.py).  The generations run on the first ``rows``
    rows (a pipeline's microbatch count).  With ``write`` False they run (a
    pipeline stage's share of them) and nothing is drawn."""
    from ..utils.visualization import visualize_generation

    batch1 = trainer.put_batch({k: np.asarray(v)[:rows] for k, v in val_batch.items()})
    prediction = "v" if cfg.use_v_prediction else "eps"

    def hook(step: int, state: TrainState):
        if cfg.plot_every_steps <= 0 or step % cfg.plot_every_steps:
            return
        with trainer._evaluating(state):
            mel_n = trainer._mel_normalized(batch1["wav"])
            _, sem_idx, _, _, _ = trainer._encode(state, batch1, None, train=False)

            def gen(num_steps: int):
                g = torch.Generator(device=trainer.device).manual_seed(step)
                x_T = torch.randn(mel_n.shape, device=mel_n.device, generator=g)

                def model_fn(x, t, si):
                    return trainer._decode(state.decoder, x, t, sem_idx=sem_idx, step_idx=si)

                return ddim_sample(trainer.schedule, model_fn, x_T, num_steps,
                                   prediction=prediction)[0]

            if write:
                visualize_generation(gen, mel_n[0], step, run_dir)
            else:
                for n in (4, 8, 16):  # visualize_generation's steps, in its order
                    gen(n)

    hook.every = cfg.plot_every_steps
    return hook


def _ljspeech_loaders(cfg: CFG, device):
    from ..data import Collate, DataLoader, LJSpeechDataset
    from ..data.dataset import resolve_ljspeech_dir

    lj_dir = resolve_ljspeech_dir(cfg.ljspeech_dir, cfg.data_root)
    common = dict(pin_memory=cfg.pin_memory, workers=cfg.num_workers, device=device)
    train_loader = DataLoader(LJSpeechDataset(lj_dir, "train"), cfg.batch_size,
                              Collate(cfg, seed=cfg.seed), seed=cfg.seed, **common)
    val_loader = DataLoader(LJSpeechDataset(lj_dir, "val"), cfg.batch_size,
                            Collate(cfg, deterministic=True), shuffle=False, **common)
    return train_loader, val_loader


def train(
    cfg: CFG,
    train_loader=None,
    val_loader=None,
    resume: Optional[str] = None,
    hubert_state: Optional[dict] = None,
    hubert_cfg: Optional[HubertConfig] = None,
    phases: Optional[List[str]] = None,
    hooks: Optional[List[Callable]] = None,
    phase_end_hook: Optional[Callable] = None,
    export: bool = False,
    device=None,
) -> TrainState:
    """Full training run; returns the final ``TrainState``.

    ``phases`` subsets {"diffusion", "progressive", "consistency"} (default:
    all three).  The loaders may be any iterables of {"wav": [B,
    segment_len]} (plus "hubert_features" for the precomputed path); without
    them, LJSpeech loaders are built from ``cfg`` (the corpus must be on
    disk).  ``hooks`` run ``hook(step, state)`` after every data step;
    ``phase_end_hook(tag, state)`` once per finished stage: "init" (fresh runs
    only), "diffusion", "prog{N}" per halving, "consistency".  Runs on the
    card unless ``device`` names another device, and raises without one.

    ``cfg.mesh_shape`` (product > 1) and ``cfg.pipeline_stages`` (> 1) need
    a process group of that many ranks, each rank calling ``train`` with the
    same arguments (see the module docstring); hooks run on every rank.
    """
    dp, pipe, n_mb = _parallel_layout(cfg)
    from ..parallel.data_parallel import (
        make_dp_consistency_step,
        make_dp_diffusion_step,
        make_dp_progressive_step,
    )

    parallel = dp is not None or pipe is not None
    primary = not parallel or dist.get_rank() == 0
    if parallel:
        # One run directory for every rank: rank 0's (run_name has a clock).
        names = [cfg.run_name]
        dist.broadcast_object_list(names, src=0)
        cfg.run_name = names[0]

    def say(*args):
        if primary:
            print(*args)

    def barrier():
        if parallel:
            dist.barrier()

    device = resolve_device(device)
    generator = cfg.setup_environment(device)
    if primary:
        cfg.print_config(device)
    run_dir = cfg.get_run_dir()
    writer = MetricWriter(run_dir) if primary else None
    phases = phases or ["diffusion", "progressive", "consistency"]

    if train_loader is None:
        train_loader, val_loader = _ljspeech_loaders(cfg, device)
    if not hasattr(train_loader, "__len__"):
        train_loader = list(train_loader)
    if val_loader is not None and not hasattr(val_loader, "__len__"):
        val_loader = list(val_loader)

    hubert_cfg = hubert_cfg or hubert_config_for(cfg.hubert_id)
    encoder, decoder = init_models(cfg, hubert_cfg, hubert_state)
    schedule = DiffusionSchedule.create(cfg.diff_steps, cfg.beta_start, cfg.beta_end)
    steps_per_epoch = max(len(train_loader), 1)
    total_steps = steps_per_epoch * max(
        cfg.diffusion_epochs
        + cfg.progressive_epochs_per_halving
        * len(progressive_step_schedule(cfg.diff_steps, cfg.progressive_target_steps))
        + cfg.consistency_epochs, 1)
    # The schedule advances once per optimizer update: size it in updates.
    total_updates = -(-total_steps // max(cfg.grad_accumulation, 1))
    trainer = Trainer(cfg, encoder, decoder, schedule, device=device)
    if pipe is not None:
        from ..parallel.pipeline_parallel import create_pp_state, make_pp_trainer

        trainer = make_pp_trainer(trainer, pipe, n_mb)
        state = create_pp_state(trainer, total_updates)
        say(f"Pipeline-parallel: {cfg.pipeline_stages} stages, {n_mb} microbatches")
    else:
        state = create_train_state(trainer.encoder, trainer.decoder,
                                   make_optimizer(cfg, trainer.encoder, trainer.decoder,
                                                  total_updates))
    put_batch = trainer.put_batch
    if dp is not None:
        from ..models.encoder import is_hubert_param
        from ..parallel import replicate, shard_batch

        replicate(state.decoder, dp)
        replicate([t for n, t in list(state.encoder.named_parameters())
                   + list(state.encoder.named_buffers()) if not is_hubert_param(n)], dp)
        # Training steps take this rank's rows; validation runs whole on every rank.
        put_batch = lambda b: trainer.put_batch(shard_batch(b, dp))  # noqa: E731
        say(f"Data-parallel mesh: {dp.shape}")

    def _save(path: str, st: TrainState, meta: dict, dedup: bool = True) -> None:
        """Every rank builds the state (a pipeline stage's is collective),
        rank 0 writes it, and the ranks wait for the write."""
        save_checkpoint(path, st, cfg, meta, frozen_host=_frozen_host(st),
                        hubert_cfg=hubert_cfg, dedup_frozen=dedup, write=primary)
        barrier()

    def _enter_distillation():
        """A constant ``lr_consistency`` from the first halving on; the
        moments and counts carry over."""
        state.optimizer.set_learning_rate(constant_schedule(cfg.lr_consistency))

    chain = max(int(cfg.steps_per_dispatch), 1)
    corpus = None
    if chain > 1:
        wavs = getattr(train_loader, "wavs", None)
        if wavs is None:
            raise ValueError("steps_per_dispatch > 1 needs an in-memory fixed-segment corpus "
                             "loader exposing .wavs; streaming/random-crop loaders run one "
                             "step per call")
        corpus = {"wav": torch.as_tensor(np.asarray(wavs, np.float32), device=device)}
        say(f"Chained steps: {chain} per call, corpus {tuple(corpus['wav'].shape)} "
              f"on {device}")

    if resume == "auto":
        resume = resolve_checkpoint_dir(cfg.ckpt_path)
    resume_meta = {}
    if resume:
        state, _, resume_meta = restore_checkpoint(resume, state)
        say(f"Resumed from {resume} at step {state.step}"
              + (f" (phase {resume_meta['phase']})" if resume_meta.get("phase") else ""))

    order = ["diffusion", "progressive", "consistency"]

    def _phase_done(name: str) -> bool:
        comp = resume_meta.get("phase_complete")
        if comp in order and order.index(name) <= order.index(comp):
            return True
        inprog = resume_meta.get("phase")
        return inprog in order and order.index(name) < order.index(inprog)

    resume_halving = (resume_meta.get("halving")
                      if resume_meta.get("phase") == "progressive" else None)
    progress = {"phase": "diffusion", "halving": None}

    frozen_cache: List = []

    def _frozen_host(st: TrainState):
        """The frozen HuBERT on the host, fetched once (it never changes)."""
        if not frozen_cache:
            frozen_cache.append(frozen_hubert_host(st))
        return frozen_cache[0]

    validate_fns = {
        "features": trainer.make_validate_fn(num_steps=cfg.inference_steps),
        "tokens": trainer.make_validate_fn(num_steps=cfg.inference_steps,
                                           conditioning="tokens"),
    }
    nan_guard = make_nan_guard(patience=3)
    best_val_cos = -float("inf")

    if hooks is None and val_loader is not None and cfg.plot_every_steps > 0:
        first_val = next(iter(val_loader), None)
        hooks = [] if first_val is None else [
            make_visualization_hook(cfg, trainer, first_val, run_dir, write=primary,
                                    rows=max(n_mb, 1))]

    if cfg.ckpt_every_steps > 0:
        def _periodic_ckpt(step: int, st: TrainState):
            if step % cfg.ckpt_every_steps == 0:
                _save(cfg.ckpt_path, st, {"step": step, **progress})

        _periodic_ckpt.every = cfg.ckpt_every_steps
        hooks = (hooks or []) + [_periodic_ckpt]

    # Mid-epoch evaluation, diffusion phase only: the target MSE on up to
    # val_batches validation batches every val_every_steps, best_diffusion
    # on it.
    diffusion_hooks = hooks
    if cfg.val_every_steps > 0 and cfg.val_batches > 0 and val_loader is not None:
        eval_eps = trainer.make_eval_eps_fn()
        eval_batches = []
        for i, b in enumerate(val_loader):
            if i >= cfg.val_batches:
                break
            eval_batches.append(trainer.put_batch(b))
        best_eval = [float("inf")]

        def _mid_epoch_eval(step: int, st: TrainState):
            if step % cfg.val_every_steps or not eval_batches:
                return
            vals = [float(eval_eps(st, b, torch.Generator(device=device).manual_seed(step + i))
                          ["val_eps_mse"]) for i, b in enumerate(eval_batches)]
            mean = float(np.mean(vals))
            if writer is not None:
                writer.write(step, {"val_eps_mse": mean}, prefix="eval/")
            if mean < best_eval[0]:
                best_eval[0] = mean
                _save(os.path.join(run_dir, "best_diffusion"), st,
                      {"val_eps_mse": mean, "step": step})

        _mid_epoch_eval.every = cfg.val_every_steps
        diffusion_hooks = (hooks or []) + [_mid_epoch_eval]

    def _maybe_validate(st: TrainState, tag: str):
        nonlocal best_val_cos
        if val_loader is None:
            return
        validate = validate_fns["features" if tag == "diffusion" else "tokens"]
        vals = []
        for i, batch in enumerate(val_loader):
            if i >= cfg.val_batches:
                break
            vals.append(validate(st, trainer.put_batch(batch), generator))
        if not vals:
            return
        agg = {k: float(np.mean([float(v[k]) for v in vals])) for k in vals[0]}
        if writer is not None:
            writer.write(st.step, agg, prefix=f"{tag}/")
        if agg.get("val_cos", -1e9) > best_val_cos + cfg.best_min_delta:
            best_val_cos = agg["val_cos"]
            _save(os.path.join(run_dir, "best_model"), st,
                  {"val_cos": best_val_cos, "phase": tag})

    def _run_phase_chained(step_fn, st, epochs, prefix, tag, phase_hooks):
        """A phase in calls of ``chain`` steps: shuffled passes over the
        corpus, hooks on cadence crossings, validation on epoch crossings."""
        B = cfg.batch_size
        n_rows = int(corpus["wav"].shape[0])
        spe = max(n_rows // B, 1)
        total = spe * epochs
        rs = np.random.RandomState(cfg.seed + 1013)
        idx_buf: List[np.ndarray] = []
        step = start = st.step
        metrics = {}
        t0 = time.time()
        while step - start < total:
            k = min(chain, total - (step - start))
            while len(idx_buf) < k:
                idx_buf.extend(rs.permutation(n_rows)[: spe * B].reshape(spe, B))
            idx = torch.as_tensor(np.stack(idx_buf[:k]).astype(np.int64), device=device)
            del idx_buf[:k]
            prev = step
            st, stacked = step_fn(st, corpus, idx, generator)
            step += k
            host = {kk: vv.detach().cpu().numpy() for kk, vv in stacked.items()}
            for j in range(k):
                s_j = prev + j + 1
                if s_j % cfg.log_every_steps == 0:
                    row = writer.write(s_j, {kk: vv[j] for kk, vv in host.items()},
                                       prefix=prefix)
                    if f"{prefix}loss" in row:
                        nan_guard(s_j, row[f"{prefix}loss"])
            metrics = {kk: float(vv[-1]) for kk, vv in host.items()}
            for hook in phase_hooks or []:
                every = int(getattr(hook, "every", 0) or 0)
                if every > 0:
                    if step // every > prev // every:
                        hook(step - step % every, st)
                else:
                    hook(step, st)
            every = max(int(cfg.validate_every_epochs), 1) * spe
            if step // every > prev // every:
                done = step - start
                say(f"  [{tag}] epoch {done // spe}/{epochs} step {step} "
                      f"loss={metrics.get('loss', float('nan')):.4f} "
                      f"({done * B / max(time.time() - t0, 1e-9):.0f} utt/s)")
                _maybe_validate(st, tag)
        return st, metrics

    def _phase_end(tag: str, st: TrainState):
        if phase_end_hook is not None:
            phase_end_hook(tag, st)

    if not resume:
        _phase_end("init", state)

    # ---- Phase 1: diffusion ---------------------------------------------------
    if "diffusion" in phases and _phase_done("diffusion"):
        say("Phase 1: diffusion - already complete in checkpoint, skipping")
    elif "diffusion" in phases:
        progress["phase"] = "diffusion"
        say(f"Phase 1: diffusion ({cfg.diffusion_epochs} epochs)")
        if chain > 1:
            state, metrics = _run_phase_chained(
                trainer.make_chained_step(kind="diffusion"), state, cfg.diffusion_epochs,
                "train/", "diffusion", diffusion_hooks)
        else:
            step_fn = (make_dp_diffusion_step(trainer, dp) if dp is not None
                       else trainer.make_diffusion_step())
            for epoch in range(cfg.diffusion_epochs):
                t0 = time.time()
                state, metrics = _run_epoch(
                    step_fn, state, train_loader, generator, writer, cfg.log_every_steps,
                    diffusion_hooks, prefix="train/", nan_guard=nan_guard,
                    put_batch=put_batch)
                say(f"  epoch {epoch + 1}/{cfg.diffusion_epochs} "
                      f"loss={float(metrics.get('loss', float('nan'))):.4f} "
                      f"({time.time() - t0:.1f}s)")
                _maybe_validate(state, "diffusion")
        _save(os.path.join(run_dir, "checkpoint_phase1"), state,
              {"phase_complete": "diffusion"}, dedup=False)
        _phase_end("diffusion", state)

    # ---- Phase 2: progressive distillation -------------------------------------
    if "progressive" in phases and _phase_done("progressive"):
        say("Phase 2: progressive - already complete in checkpoint, skipping")
    elif "progressive" in phases:
        progress["phase"] = "progressive"
        halvings = progressive_step_schedule(cfg.diff_steps, cfg.progressive_target_steps)
        if resume_halving in halvings:
            skipped = halvings[: halvings.index(resume_halving)]
            halvings = halvings[halvings.index(resume_halving):]
            if skipped:
                say(f"  resume: skipping completed halvings {skipped}")
        say(f"Phase 2: progressive distillation {cfg.diff_steps} -> {halvings}")
        _enter_distillation()
        for target_steps in halvings:
            progress["halving"] = target_steps
            state = state.with_teacher()  # re-init at each halving
            if chain > 1:
                state, metrics = _run_phase_chained(
                    trainer.make_chained_step(kind="progressive", num_steps=target_steps,
                                              exact=cfg.progressive_exact),
                    state, cfg.progressive_epochs_per_halving, f"prog{target_steps}/",
                    f"prog{target_steps}", hooks)
            else:
                step_fn = (make_dp_progressive_step(trainer, dp, target_steps,
                                                    exact=cfg.progressive_exact)
                           if dp is not None else
                           trainer.make_progressive_step(target_steps,
                                                         exact=cfg.progressive_exact))
                for _ in range(cfg.progressive_epochs_per_halving):
                    state, metrics = _run_epoch(
                        step_fn, state, train_loader, generator, writer,
                        cfg.log_every_steps, hooks, prefix=f"prog{target_steps}/",
                        nan_guard=nan_guard, put_batch=put_batch)
            say(f"  target={target_steps} "
                  f"loss={float(metrics.get('loss', float('nan'))):.4f}")
            _maybe_validate(state, f"prog{target_steps}")
            _phase_end(f"prog{target_steps}", state)
        _save(os.path.join(run_dir, "checkpoint_phase2"), state,
              {"phase_complete": "progressive"}, dedup=False)

    # ---- Phase 3: consistency -----------------------------------------------------
    if "consistency" in phases and _phase_done("consistency"):
        say("Phase 3: consistency - already complete in checkpoint, skipping")
    elif "consistency" in phases:
        progress["phase"] = "consistency"
        progress["halving"] = None
        say(f"Phase 3: consistency ({cfg.consistency_epochs} epochs)")
        _enter_distillation()
        if cfg.consistency_exact and state.teacher is None:
            state = state.with_teacher()
        if chain > 1:
            state, metrics = _run_phase_chained(
                trainer.make_chained_step(kind="consistency", exact=cfg.consistency_exact,
                                          consistency_weight=cfg.consistency_weight),
                state, cfg.consistency_epochs, "consistency/", "consistency", hooks)
        else:
            step_fn = (make_dp_consistency_step(trainer, dp, exact=cfg.consistency_exact,
                                                consistency_weight=cfg.consistency_weight)
                       if dp is not None else
                       trainer.make_consistency_step(exact=cfg.consistency_exact,
                                                     consistency_weight=cfg.consistency_weight))
            for epoch in range(cfg.consistency_epochs):
                state, metrics = _run_epoch(
                    step_fn, state, train_loader, generator, writer, cfg.log_every_steps,
                    hooks, prefix="consistency/", nan_guard=nan_guard, put_batch=put_batch)
                say(f"  epoch {epoch + 1}/{cfg.consistency_epochs} "
                      f"loss={float(metrics.get('loss', float('nan'))):.4f}")
                _maybe_validate(state, "consistency")
        _phase_end("consistency", state)

    final = os.path.join(run_dir, "edge_model_final")
    if pipe is not None:
        from ..parallel.pipeline_parallel import canonical_decoder

        decoder = canonical_decoder(state)  # collective: every stage's blocks
        if primary:
            save_weights(final, cfg, decoder, state.encoder)
    else:
        decoder = state.decoder
        if primary:
            save_final_model(final, state, cfg)
    if export and primary:
        from ..utils.export import export_for_edge

        export_for_edge(cfg, decoder, os.path.join(run_dir, "edge_model.pt2"))
    _save(os.path.join(run_dir, "checkpoint_final"), state,
          {"phase_complete": "consistency"}, dedup=False)
    if writer is not None:
        writer.close()
    return state


def train_v2(cfg: CFG, **kw) -> TrainState:
    """The single-phase v2 recipe: v-prediction + FSQ + CFG dropout + cosine
    LR, validated by 4-step DPM-Solver++ cosine with best-checkpoint tracking."""
    cfg.use_v_prediction = True
    cfg.use_fsq = True
    return train(cfg, phases=["diffusion"], **kw)
