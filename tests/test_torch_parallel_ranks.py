"""Rank programs of the port's parallel tests (no JAX import: spawned ranks
import this module, and nothing else of the test suite).

Each function runs on one rank of a gloo process group on the CPU
(``parallel.launch.spawn``), builds its models from state dicts the test
hands it, runs every case of its group, and returns plain tensors and
numbers for the test process to hold against the single-process programs
and the JAX package's.  This module holds no tests of its own.
"""

import os

import numpy as np
import torch

from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder, HubertConfig, SemanticEncoder
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
from edge_diffusion_tts_tpu_torch.training import (
    Trainer,
    constant_schedule,
    create_train_state,
    make_optimizer,
)

LR = 1e-3  # a constant rate: a warmup's first update is 0


def tiny_cfg(**kw) -> CFG:
    d = dict(hidden=32, layers=1, heads=2, segment_secs=0.1, batch_size=4, grad_accumulation=1,
             diff_steps=50, max_timestep=48, dropout=0.0, cfg_dropout=0.0)
    d.update(kw)
    return CFG(**d)


def build_state(cfg: CFG, weights: dict, with_teacher: bool = False):
    """``(trainer, state)`` on the CPU from ``weights`` ({"encoder",
    "decoder", "teacher"} state dicts), the optimizer at a constant rate."""
    enc, dec = SemanticEncoder(cfg, HubertConfig.tiny()), EdgeDiffusionDecoder(cfg)
    enc.load_state_dict(weights["encoder"])
    dec.load_state_dict(weights["decoder"])
    trainer = Trainer(cfg, enc, dec, DiffusionSchedule.create(cfg.diff_steps), device="cpu")
    state = create_train_state(trainer.encoder, trainer.decoder, make_optimizer(
        cfg, trainer.encoder, trainer.decoder, 100, learning_rate=constant_schedule(LR)))
    if with_teacher:
        state.with_teacher()
        state.teacher.load_state_dict(weights["teacher"])
    return trainer, state


def record_grads(state) -> dict:
    """The gradients ``state.optimizer.update`` is handed, kept in the
    returned dict (the update still runs)."""
    seen = {}
    update = state.optimizer.update

    def recording(grads):
        # A name the loss never reached takes zeros, as the optimizer reads it.
        seen.update({n: (g.detach().clone() if g is not None
                         else torch.zeros_like(state.optimizer.params[n]))
                     for n, g in grads.items()})
        return update(grads)

    state.optimizer.update = recording
    return seen


def make_step(trainer, kind: str, num_steps: int = 4, dp_mesh=None):
    """The phase step of ``kind``, data-parallel over ``dp_mesh`` when given."""
    from edge_diffusion_tts_tpu_torch.parallel import (
        make_dp_consistency_step,
        make_dp_diffusion_step,
        make_dp_progressive_step,
    )

    if kind.startswith("diffusion"):
        return (make_dp_diffusion_step(trainer, dp_mesh) if dp_mesh
                else trainer.make_diffusion_step())
    if kind in ("progressive", "pd_two_step"):
        exact = kind == "pd_two_step"
        return (make_dp_progressive_step(trainer, dp_mesh, num_steps, exact=exact) if dp_mesh
                else trainer.make_progressive_step(num_steps, exact=exact))
    exact = kind == "consistency_exact"  # the grid is the default 40 in both packages
    return (make_dp_consistency_step(trainer, dp_mesh, exact=exact) if dp_mesh
            else trainer.make_consistency_step(exact=exact))


def run_step(cfg: CFG, weights: dict, kind: str, batch: dict, dp_mesh=None) -> dict:
    """One step of ``kind`` on ``batch`` (this rank's rows under a mesh):
    loss, metrics, the gradients the optimizer took, the trainable
    parameters after the update and the VQ buffers."""
    trainer, state = build_state(cfg, weights, with_teacher=kind in (
        "progressive", "pd_two_step", "consistency_exact"))
    grads = record_grads(state)
    step = make_step(trainer, kind, dp_mesh=dp_mesh)
    state, metrics = step(state, trainer.put_batch(batch), torch.Generator().manual_seed(0))
    vq = {k: v.clone() for k, v in state.encoder.vq.state_dict().items()}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "params": {n: p.detach().clone() for n, p in state.optimizer.params.items()},
            "vq": vq}


# -- data parallel ------------------------------------------------------------------


def dp_rank(rank: int, cases: dict, vq_cases: dict) -> dict:
    """Every DP step case on this rank's rows, the sharded VQ cases, the pod
    mesh and ``host_local_batch``."""
    from edge_diffusion_tts_tpu_torch.models.vq import VectorQuantizer
    from edge_diffusion_tts_tpu_torch.parallel import (
        host_local_batch,
        make_mesh,
        make_pod_mesh,
        shard_batch,
    )

    mesh = make_mesh((2, 1))
    out = {"steps": {}}
    for name, case in cases.items():
        cfg = tiny_cfg(**case["cfg"])
        out["steps"][name] = run_step(cfg, case["weights"], case["kind"],
                                      shard_batch(case["batch"], mesh), dp_mesh=mesh)
    # The same rows through host_local_batch (each rank loads only its own).
    case = cases["diffusion"]
    rows = case["batch"]["wav"].shape[0] // 2
    local = {k: v[rank * rows:(rank + 1) * rows] for k, v in case["batch"].items()}
    fed = host_local_batch(local, mesh)
    out["host_local"] = run_step(tiny_cfg(**case["cfg"]), case["weights"], "diffusion",
                                 {k: v.numpy() for k, v in fed.items()}, dp_mesh=mesh)
    out["pod_mesh"] = make_pod_mesh((2, 1), ("data", "model")).shape
    # The quantizer's EMA statistics summed over the data axis.
    for name, vc in vq_cases.items():
        vq = VectorQuantizer(vc["dim"], vc["K"], reset_unused_every=vc["reset"])
        vq.load_state_dict(vc["state"])
        z = shard_batch({"z": vc["z"]}, mesh)["z"]
        vq.group = mesh.axis("data")
        vq(torch.as_tensor(z), train=True, generator=torch.Generator().manual_seed(rank))
        vq.group = None
        out[name] = {k: v.clone() for k, v in vq.state_dict().items()}
    return out


# -- sequence and tensor parallel ----------------------------------------------------


def seq_rank(rank: int, cfg_kw: dict, dec_state: dict, sem_idx, x_T, steps: int) -> dict:
    """Sequence-parallel DDIM over every rank, eps and v; then a length
    that does not divide."""
    from edge_diffusion_tts_tpu_torch.parallel import make_mesh, make_seq_parallel_generate

    cfg = CFG(**cfg_kw)
    dec = EdgeDiffusionDecoder(cfg)
    dec.load_state_dict(dec_state)
    dec.eval()
    schedule = DiffusionSchedule.create(cfg.diff_steps)
    mesh = make_mesh()
    sem, x = torch.as_tensor(sem_idx), torch.as_tensor(x_T)
    out = {}
    for pred in ("eps", "v"):
        fn = make_seq_parallel_generate(cfg, dec, schedule, mesh, steps, prediction=pred)
        out[pred] = fn(sem, x).clone()
    try:
        make_seq_parallel_generate(cfg, dec, schedule, mesh, 2)(sem, x[:, :-1])
        out["remainder"] = None
    except ValueError as e:
        out["remainder"] = str(e)
    return out


def tp_rank(rank: int, enc_cfg: dict, enc_state: dict, wav) -> dict:
    """The tensor-parallel encode over a (data 1, model 2) mesh."""
    from edge_diffusion_tts_tpu_torch.parallel import make_mesh, make_tp_encode, \
        shard_encoder_params

    cfg = CFG(**enc_cfg)
    enc = SemanticEncoder(cfg, HubertConfig.tiny())
    enc.load_state_dict(enc_state)
    enc.eval()
    mesh = make_mesh((1, 2))
    params = shard_encoder_params(enc, mesh)
    encode = make_tp_encode(enc, mesh)
    wav = torch.as_tensor(wav)
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    return {"tokens": encode(params, wav).clone(),
            "features": encode.features(params, wav).clone(), "shapes": shapes}


# -- pipeline parallel ----------------------------------------------------------------


def pp_backbone_rank(rank: int, cfg_kw: dict, dec_state: dict, inputs: dict,
                     cases: list) -> dict:
    """The pipelined backbone over every rank for each (microbatches,
    masked) case: the output, and the gradients of the inputs and of this
    stage's blocks (under their whole-decoder names) for the loss
    ``sum(h * w)``."""
    from edge_diffusion_tts_tpu_torch.parallel import make_mesh
    from edge_diffusion_tts_tpu_torch.parallel.pipeline_parallel import (
        PIPE_AXIS,
        make_pp_backbone,
        make_stage_decoder,
    )

    cfg = CFG(**cfg_kw)
    full = EdgeDiffusionDecoder(cfg)
    full.load_state_dict(dec_state)
    mesh = make_mesh((torch.distributed.get_world_size(),), (PIPE_AXIS,))
    ax = mesh.axis(PIPE_AXIS)
    dec = make_stage_decoder(full, ax.index, ax.size).eval()
    k = len(dec.layers)
    out = {}
    for n_mb, masked in cases:
        bb = make_pp_backbone(cfg, mesh, n_mb)
        h0, ctx, cond = (torch.as_tensor(inputs[n]).clone().requires_grad_()
                         for n in ("h0", "ctx", "cond"))
        masks = {}
        if masked:
            masks = dict(mel_mask=torch.as_tensor(inputs["mel_mask"]),
                         ctx_mask=torch.as_tensor(inputs["ctx_mask"]))
        for p in dec.parameters():
            p.grad = None
        h = bb(dec, h0, ctx, cond, **masks)
        loss = (h * torch.as_tensor(inputs["w"])).sum()
        g_h = torch.autograd.grad(loss, h)[0]
        g_in = bb.backward(bb.calls.pop(), g_h)
        blocks = {f"layers.{ax.index * k + int(n.split('.')[1])}.{n.split('.', 2)[2]}":
                  p.grad.clone() for n, p in dec.named_parameters()
                  if n.startswith("layers.") and p.grad is not None}
        out[(n_mb, masked)] = {"h": h.detach().clone(), "inputs": [g.clone() for g in g_in],
                               "blocks": blocks}
    return out


def pp_step_rank(rank: int, cases: dict) -> dict:
    """One pipeline-parallel step per case (2 stages): loss, metrics, the
    optimizer's gradients (blocks under their whole-decoder names), and the
    state after the update, packed."""
    from edge_diffusion_tts_tpu_torch.parallel import make_mesh
    from edge_diffusion_tts_tpu_torch.parallel.pipeline_parallel import (
        PIPE_AXIS,
        create_pp_state,
        make_pp_trainer,
    )

    out = {}
    for name, case in cases.items():
        cfg = tiny_cfg(**case["cfg"])
        trainer, _ = build_state(cfg, case["weights"])
        mesh = make_mesh((2,), (PIPE_AXIS,))
        pp = make_pp_trainer(trainer, mesh, case["microbatches"])
        state = create_pp_state(pp, 100, learning_rate=constant_schedule(LR))
        if case["kind"] in ("progressive", "pd_two_step", "consistency_exact"):
            state.with_teacher()
            state.teacher.load_state_dict(state.decoder.stage_slice(case["weights"]["teacher"]))
        grads = record_grads(state)
        step = make_step(pp, case["kind"])
        state, metrics = step(state, pp.put_batch(case["batch"]),
                              torch.Generator().manual_seed(0))
        k = len(state.decoder.layers)

        def whole(n):
            parts = n.split(".")
            if parts[0] == "decoder" and parts[1] == "layers":
                parts[2] = str(mesh.axis(PIPE_AXIS).index * k + int(parts[2]))
            return ".".join(parts)

        packed = state.state_dict()
        # A fresh stage state loads the packed layout back to the same tensors.
        again = create_pp_state(pp, 100, learning_rate=constant_schedule(LR))
        again.load_state_dict(packed)
        reloaded = all(torch.equal(a, b) for a, b in zip(
            list(state.decoder.state_dict().values())
            + list(state.optimizer.state_dict()["mu"].values()),
            list(again.decoder.state_dict().values())
            + list(again.optimizer.state_dict()["mu"].values())))
        out[name] = {"metrics": {kk: float(v) for kk, v in metrics.items()},
                     "grads": {whole(n): g for n, g in grads.items()},
                     "state": packed, "reloaded": reloaded}
    return out


# -- train() --------------------------------------------------------------------------


def train_rank(rank: int, cfg_kw: dict, train_batches: list, val_batches: list) -> dict:
    """``train()`` under the process group on in-memory loaders (every rank
    the same global batches), then again with ``resume="auto"``; counts the
    checkpoint states this rank wrote."""
    import edge_diffusion_tts_tpu_torch.training.checkpoint as ckpt
    from edge_diffusion_tts_tpu_torch.training import train

    torch.set_num_threads(1)
    writes = []
    save = ckpt.torch.save

    def counting(obj, path, *a, **kw):
        writes.append(os.path.basename(os.path.dirname(str(path))))
        return save(obj, path, *a, **kw)

    ckpt.torch.save = counting
    try:
        cfg = CFG(**cfg_kw)
        tags = []
        state = train(cfg, train_batches, val_batches, hubert_cfg=HubertConfig.tiny(),
                      device="cpu", phase_end_hook=lambda tag, st: tags.append((tag, st.step)))
        first = {n: p.detach().clone() for n, p in state.optimizer.params.items()}
        first_writes = list(writes)
        resumed = train(CFG(**cfg_kw), train_batches, val_batches,
                        hubert_cfg=HubertConfig.tiny(), device="cpu", resume="auto")
        return {"params": first, "writes": first_writes, "tags": tags, "step": state.step,
                "resumed_step": resumed.step, "run_dir": cfg.get_run_dir(),
                "resumed_params": {n: p.detach().clone()
                                   for n, p in resumed.optimizer.params.items()}}
    finally:
        ckpt.torch.save = save


def adam_direction(grads: dict, clip: float) -> dict:
    """AdamW's first bias-corrected update direction g / (|g| + eps) of the
    clipped gradients, in float64 (the witness of the parameter bars)."""
    g = {n: t.double().numpy() for n, t in grads.items()}
    norm = np.sqrt(sum(float((x * x).sum()) for x in g.values()))
    c = 1.0 if norm < clip else clip / norm
    return {n: (x * c) / (np.abs(x * c) + 1e-8) for n, x in g.items()}


def pp2_rank(rank: int, backbone: dict, steps: dict) -> dict:
    """Two stages: the backbone cases, then the step cases."""
    return {"backbone": pp_backbone_rank(rank, **backbone), "steps": pp_step_rank(rank, steps)}


def pp4_rank(rank: int, backbone: dict, dppp: dict) -> dict:
    """Four ranks: the 4-stage backbone cases, then one DP x PP diffusion
    step on a (data 2, pipe 2) mesh."""
    from edge_diffusion_tts_tpu_torch.parallel import make_mesh, make_pp_diffusion_step, \
        shard_batch
    from edge_diffusion_tts_tpu_torch.parallel.pipeline_parallel import (
        PIPE_AXIS,
        create_pp_state,
        make_pp_trainer,
    )

    out = {"backbone": pp_backbone_rank(rank, **backbone)}
    cfg = tiny_cfg(**dppp["cfg"])
    trainer, _ = build_state(cfg, dppp["weights"])
    mesh = make_mesh((2, 2), ("data", PIPE_AXIS))
    pp = make_pp_trainer(trainer, mesh, 1, data_axis="data")
    state = create_pp_state(pp, 100, learning_rate=constant_schedule(LR))
    grads = record_grads(state)
    step = make_pp_diffusion_step(pp, mesh, 1, data_axis="data")
    state, metrics = step(state, pp.put_batch(shard_batch(dppp["batch"], mesh)),
                          torch.Generator().manual_seed(0))
    k = len(state.decoder.layers)
    stage = mesh.axis(PIPE_AXIS).index
    out["dppp"] = {"metrics": {kk: float(v) for kk, v in metrics.items()},
                   "grads": {(f"decoder.layers.{stage * k + int(n.split('.')[2])}."
                              f"{n.split('.', 3)[3]}" if n.startswith("decoder.layers.")
                              else n): g for n, g in grads.items()}}
    return out
