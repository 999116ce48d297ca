"""Data-parallel training steps and data-parallel generation (counterpart of
``edge_diffusion_tts_tpu/parallel/data_parallel.py``).

Training: one process per rank, the model and optimizer replicated, the
batch split over the ``data`` axis.  A step takes this rank's rows
(``mesh.shard_batch`` of the global batch, or ``multihost.host_local_batch``):

1. the phase's loss on the local rows, drawing from a generator of the rank's
   own, seeded from the caller's generator seed, the data-step count and
   the rank's index on the axis (JAX folds the axis index into the step key);
2. the local backward;
3. ONE all-reduce of a flat float32 bucket holding every gradient and every
   metric, divided by the axis size: the big batch's mean gradient and the
   mean of the metrics, as JAX's ``pmean``; each mean goes back to its
   gradient's dtype before the optimizer sees it;
4. ``grad_norm`` of the reduced gradients, the optimizer update and the
   teacher's EMA, the same on every rank, so the replicas stay bit-equal.

With bf16 parameters (``param_dtype="bfloat16"``) the gradients are bf16.
JAX's ``pmean`` reduces them in bf16; here they are summed in the float32
bucket and rounded to bf16 once, after the divide.  Over 2 ranks the two
agree bit for bit: the float32 sum of two bf16 values rounds to bf16 as
their exact sum does, and halving is exact.  Over more ranks this rounds
once where a bf16 ring rounds after every add.  Float32 gradients take the
same bucket as before, bit for bit.

The VQ's EMA statistics are not averaged: the quantizer sums its raw batch
statistics over the axis (``models/vq.py``, ``group``), so its update equals
the big-batch one and its dead-code reset installs the same real rows on
every rank.

Generation (``make_dp_generate``) runs in one process over a list of
devices, as JAX's single controller does: a decoder replica per device, the
rows split in order, each share generated on its device, the rows gathered
back (``DeviceShares``, which ``LongFormPipeline(mesh=)`` shares).  The
start noise is drawn for the whole batch first, so the result equals the
unsharded call's.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..inference import EdgeInference
from ..ops.fused_denoise import start_noise
from ..pipeline import fold_seed
from ..training.state import TrainState, ema_update
from ..training.steps import Trainer
from ..utils.speed import span
from .mesh import DATA_AXIS, Axis, Mesh


@contextlib.contextmanager
def vq_group(encoder, axis: Optional[Axis]):
    """The encoder's VQ sums its statistics over ``axis`` inside the block
    (FSQ encoders carry no statistics: nothing to do)."""
    vq = getattr(encoder, "vq", None)
    if vq is None or not hasattr(vq, "group") or axis is None:
        yield
        return
    prev, vq.group = vq.group, axis
    try:
        yield
    finally:
        vq.group = prev


def rank_generator(generator: torch.Generator, step: int, index: int) -> torch.Generator:
    """The generator a rank draws a data step from: seeded from
    ``generator``'s seed, the step count and the rank's axis index."""
    seed = fold_seed(generator.initial_seed(), step, index)
    return torch.Generator(device=generator.device).manual_seed(seed)


def _make_dp_step(trainer: Trainer, mesh: Mesh, loss_fn: Callable, axis: str,
                  ema: Optional[float]) -> Callable:
    """``step(state, local_batch, generator) -> (state, metrics)`` around a
    phase loss; ``ema`` EMA-updates the teacher after every optimizer
    update (when the state has one)."""
    ax = mesh.axis(axis)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], generator):
        params = state.optimizer.params
        for p in params.values():
            p.grad = None
        state.train()
        g = rank_generator(generator, state.step, ax.index)
        with vq_group(state.encoder, ax):
            loss, metrics = loss_fn(state, batch, g)
        with span("train:backward"):
            trainer._backward(loss)
        with span("train:allreduce"):
            names = list(params)
            grads = [params[n].grad if params[n].grad is not None
                     else torch.zeros_like(params[n]) for n in names]
            keys = sorted(metrics)
            vals = [metrics[k].detach().float().reshape(1) for k in keys]
            bucket = torch.cat([t.reshape(-1).float() for t in grads] + vals)
            ax.all_reduce(bucket).div_(ax.size)
            reduced = torch.split(bucket[: bucket.numel() - len(vals)],
                                  [t.numel() for t in grads])
            # Each mean back at its gradient's dtype (a bf16 parameter's
            # gradient is bf16): one rounding of the float32 mean.
            grads = [r.view_as(g).to(g.dtype) for r, g in zip(reduced, grads)]
            metrics = {k: bucket[bucket.numel() - len(vals) + i] for i, k in enumerate(keys)}
        with span("train:optimizer"):
            grads = dict(zip(names, grads))
            applied = state.optimizer.update(grads)
            metrics["grad_norm"] = state.optimizer.step_norm(grads)
            if ema is not None and state.teacher is not None:
                ema_update(state.teacher, state.decoder, trainer._teacher_decay(applied, ema))
        for p in params.values():
            p.grad = None
        state.step += 1
        return state, metrics

    return step


def make_dp_diffusion_step(trainer: Trainer, mesh: Mesh, vq_weight: Optional[float] = None,
                           axis: str = DATA_AXIS) -> Callable:
    """Data-parallel phase-1 step: ``(state, local_batch, generator) ->
    (state, metrics)``.  Its update equals one big-batch step's, up to the
    float32 rounding of the split sums."""
    return _make_dp_step(trainer, mesh, trainer.make_diffusion_loss(vq_weight), axis, None)


def make_dp_progressive_step(trainer: Trainer, mesh: Mesh, num_steps: int,
                             vq_weight: float = 0.05, ema_decay: float = 0.999,
                             exact: bool = False, axis: str = DATA_AXIS) -> Callable:
    """Data-parallel phase-2 step (``exact``: the two-step-teacher
    objective), the teacher EMA'd after every update."""
    loss_fn = (trainer.make_pd_two_step_loss(num_steps, vq_weight) if exact
               else trainer.make_progressive_loss(num_steps, vq_weight))
    return _make_dp_step(trainer, mesh, loss_fn, axis, ema_decay)


def make_dp_consistency_step(trainer: Trainer, mesh: Mesh, vq_weight: float = 0.05,
                             exact: bool = False, ema_decay: float = 0.999,
                             consistency_weight: float = 1.0,
                             axis: str = DATA_AXIS) -> Callable:
    """Data-parallel phase-3 step (``exact``: the adjacent-step EMA-teacher
    objective, the teacher EMA'd after every update)."""
    if exact:
        loss_fn = trainer.make_consistency_exact_loss(
            vq_weight, consistency_weight=consistency_weight)
        return _make_dp_step(trainer, mesh, loss_fn, axis, ema_decay)
    loss_fn = trainer.make_consistency_loss(vq_weight, consistency_weight=consistency_weight)
    return _make_dp_step(trainer, mesh, loss_fn, axis, None)


def indexed_device(d) -> torch.device:
    """``d`` as a ``torch.device``; a CUDA device without an index is the
    current one (so ``"cuda"`` and ``"cuda:0"`` name one device)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceShares:
    """Rows split in order over a list of devices (one may repeat), in one
    process: a replica of ``original`` on each listed device
    (``replicate(original, device)``; the home device keeps ``original``),
    one equal share of the rows per listed device, each share run on its
    device, the results concatenated on ``home`` in order."""

    def __init__(self, devices: Sequence, home, original: Any,
                 replicate: Callable[[Any, torch.device], Any]):
        self.devices = [indexed_device(d) for d in devices]
        if not self.devices:
            raise ValueError("rows split over no device")
        self.home = indexed_device(home)
        self.replicas: Dict[torch.device, Any] = {self.home: original}
        for d in self.devices:
            if d not in self.replicas:
                self.replicas[d] = replicate(original, d)

    def __len__(self) -> int:
        return len(self.devices)

    def run(self, fn: Callable, *rows: Optional[torch.Tensor]) -> torch.Tensor:
        """``fn(replica, *share)`` on every device's share of ``rows``
        (tensors with one leading row dim, or None) -> the shares' results
        concatenated on the home device.  The row count must divide by the
        number of devices."""
        B = next(r for r in rows if r is not None).shape[0]
        n = len(self.devices)
        if B % n:
            raise ValueError(f"batch {B} does not divide over {n} devices")
        k = B // n
        outs = []
        for i, d in enumerate(self.devices):
            share = [None if r is None else r[i * k:(i + 1) * k].to(d) for r in rows]
            outs.append(fn(self.replicas[d], *share).to(self.home))
        return torch.cat(outs)


def make_dp_generate(engine: EdgeInference, devices: Sequence, masked: bool = False) -> Callable:
    """Shard ``engine.generate_mel`` over ``devices`` by rows.

    Returns ``generate(sem_idx, num_steps=None, temperature=1.0,
    generator=None, sem_mask=None, x_T=None) -> mel`` on ``engine``'s
    device.  ``sem_mask`` is required with ``masked`` (the serving batches'
    module loop) and refused without it (the engine's backend: the fused
    DDIM kernel for ``backend="fused"``, the depthwise pre-net included).  The row count must divide by the
    number of devices.  A device listed twice runs two shares on one device:
    that exercises the split and the gather where only one device exists.
    """
    shares = DeviceShares(devices, engine.device, engine, lambda e, d: EdgeInference(
        e.cfg, e.schedule, copy.deepcopy(e.decoder), prediction=e.prediction,
        backend=e.backend, sampler=e.sampler, solver_order=e.solver_order, device=d))
    home = shares.home

    def generate(sem_idx, num_steps: Optional[int] = None, temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None, sem_mask=None, x_T=None):
        if masked and sem_mask is None:
            raise ValueError("a masked data-parallel generate needs sem_mask")
        if not masked and sem_mask is not None:
            raise ValueError("this data-parallel generate is unmasked: build it with "
                             "masked=True for sem_mask")
        sem_idx = torch.as_tensor(sem_idx, device=home).long()
        if x_T is None:
            x_T = start_noise(sem_idx, engine.cfg.n_mels, temperature, generator)
        x_T = torch.as_tensor(x_T, dtype=torch.float32, device=home)
        if sem_mask is not None:
            sem_mask = torch.as_tensor(sem_mask, device=home).bool()
        return shares.run(lambda e, s, x, m: e.generate_mel(s, num_steps, x_T=x, sem_mask=m),
                          sem_idx, x_T, sem_mask)

    generate.devices = shares.devices
    return generate
