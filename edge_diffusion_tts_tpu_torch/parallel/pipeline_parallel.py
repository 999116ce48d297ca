"""Pipeline parallelism: the decoder's blocks staged over a ``pipe`` axis
(counterpart of ``edge_diffusion_tts_tpu/parallel/pipeline_parallel.py``).

GPipe over the decoder's ``cfg.layers`` blocks, one process per stage.
Stage ``s`` of ``S`` holds the contiguous blocks ``[s*L/S, (s+1)*L/S)``
(``StageDecoder``: the whole prelude and postlude, its blocks only); the
embeddings prelude, the frozen encoder, the loss and the optimizer run
replicated on every stage.  The batch splits into ``M`` microbatches; stage
``s`` takes microbatch ``m`` from stage ``s-1`` (stage 0 from the prelude),
runs its blocks and hands the activation on, so the schedule fills and
drains over ``M + S - 1`` ticks.  The last stage's outputs are broadcast to
every stage, and every stage forms the same loss from them.

Autograd does not cross processes, so the backward is scheduled here
(``PPTrainer._backward``), in the same order on every rank:

1. the loss's gradient with respect to each pipelined output (every rank
   computes the same);
2. per pipelined call, last first: the last stage backpropagates each
   microbatch through its blocks and sends the input's gradient to stage
   ``s-1``, and so on down; the block parameters collect their gradients;
3. the gradients of each call's inputs (the prelude's activation, which only
   stage 0 feeds, and the context and conditioning that every stage reads)
   are SUMMED over the pipe axis in one all-reduce;
4. one backward from the loss and those inputs through the replicated part.

So the replicated parameters end with the single-device gradient: the
prelude's (and the encoder's) through step 3's sum, the postlude's computed
once per rank from identical inputs and never summed.  The clip's global
norm sums the blocks' squares over the stages.  With dropout 0 one pipeline
step equals the single-device step to float32 rounding.

Checkpoints of a pipeline run carry the packed layout (``pp_pack_params``:
``{"pp_stack": {name: [L, ...]}, "pp_rest": {...}}``), and resume from it
or from the canonical one; the final model is written canonical.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import CFG
from ..layers.dtypes import cast_parameters
from ..models.decoder import EdgeDiffusionDecoder
from ..pipeline import fold_seed
from ..training.state import TrainState, global_norm, make_optimizer
from ..training.steps import Trainer
from .mesh import Axis, Mesh

PIPE_AXIS = "pipe"
_LAYERS = "layers."


# ---------------------------------------------------------------------------
# params <-> stacked-stage layout
# ---------------------------------------------------------------------------


def _layer_index(name: str) -> Tuple[int, str]:
    i, sub = name[len(_LAYERS):].split(".", 1)
    return int(i), sub


def stack_layer_params(dec_sd: Mapping) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A decoder state dict -> (``{sub-name: [L, ...]}``, the rest): the
    stack's leading axis is the layer index, so a stage's blocks are a
    contiguous slice of it."""
    blocks: Dict[str, Dict[int, torch.Tensor]] = {}
    rest = {}
    for name, t in dec_sd.items():
        if name.startswith(_LAYERS):
            i, sub = _layer_index(name)
            blocks.setdefault(sub, {})[i] = t
        else:
            rest[name] = t
    stack = {sub: torch.stack([per[i] for i in sorted(per)]) for sub, per in blocks.items()}
    return stack, rest


def unstack_layer_params(stack: Mapping, rest: Mapping) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_layer_params`."""
    out = dict(rest)
    for sub, t in stack.items():
        for i in range(t.shape[0]):
            out[f"{_LAYERS}{i}.{sub}"] = t[i]
    return out


def pp_pack_decoder(dec_sd: Mapping) -> dict:
    stack, rest = stack_layer_params(dec_sd)
    return {"pp_stack": stack, "pp_rest": rest}


def pp_unpack_decoder(packed: Mapping) -> Dict[str, torch.Tensor]:
    return unstack_layer_params(packed["pp_stack"], packed["pp_rest"])


def is_pp_packed(tree) -> bool:
    return isinstance(tree, Mapping) and "pp_stack" in tree


def pp_pack_params(params: Mapping) -> dict:
    """``{"encoder": sd, "decoder": sd}`` -> the same with the decoder packed."""
    out = dict(params)
    out["decoder"] = pp_pack_decoder(params["decoder"])
    return out


def pp_unpack_params(params: Mapping) -> dict:
    out = dict(params)
    out["decoder"] = pp_unpack_decoder(params["decoder"])
    return out


# ---------------------------------------------------------------------------
# a stage's decoder
# ---------------------------------------------------------------------------


class StageDecoder(EdgeDiffusionDecoder):
    """The decoder of pipeline stage ``stage`` of ``n_stages``: the prelude,
    the postlude and blocks ``[stage*k, (stage+1)*k)``, ``k = layers /
    n_stages``, renumbered from 0, computing at ``dtype``.  Its forward
    runs through a ``PPTrainer``, never alone."""

    def __init__(self, cfg: CFG, stage: int, n_stages: int, dtype: torch.dtype = torch.float32):
        if cfg.layers % n_stages:
            raise ValueError(f"layers={cfg.layers} not divisible by {n_stages} pipeline stages")
        super().__init__(cfg, dtype=dtype)
        k = cfg.layers // n_stages
        self.layers = nn.ModuleList(list(self.layers)[stage * k:(stage + 1) * k])
        self.pp_stage, self.pp_stages = stage, n_stages

    def forward(self, *args, **kwargs):
        raise RuntimeError("a pipeline stage's decoder holds only its blocks: it runs "
                           "through PPTrainer / make_pp_backbone")

    def stage_slice(self, canonical: Mapping) -> Dict[str, torch.Tensor]:
        """This stage's state dict out of a whole decoder's."""
        k, first = len(self.layers), self.pp_stage * len(self.layers)
        out = {}
        for name, t in canonical.items():
            if name.startswith(_LAYERS):
                i, sub = _layer_index(name)
                if first <= i < first + k:
                    out[f"{_LAYERS}{i - first}.{sub}"] = t
            else:
                out[name] = t
        return out


def make_stage_decoder(decoder: EdgeDiffusionDecoder, stage: int,
                       n_stages: int) -> StageDecoder:
    """Stage ``stage``'s decoder, its weights from ``decoder``'s: the same
    compute dtype, each parameter stored at its source's dtype."""
    dec = _like(StageDecoder(decoder.cfg, stage, n_stages, dtype=decoder.dtype), decoder)
    dec.load_state_dict(dec.stage_slice(decoder.state_dict()))
    device = next(decoder.parameters()).device
    return dec.to(device).train(decoder.training)


def _like(dec: EdgeDiffusionDecoder, source: EdgeDiffusionDecoder) -> EdgeDiffusionDecoder:
    """``dec`` with its parameters stored at ``source``'s parameter dtype
    (a model's ``param_dtype``: one dtype for every parameter)."""
    return cast_parameters(dec, next(source.parameters()).dtype)


def _gather_blocks(local: Mapping, ax: Axis, device) -> Dict[str, torch.Tensor]:
    """Every stage's ``layers.{j}.*`` tensors -> the whole stack's
    ``layers.{i}.*`` (CPU), each at its own dtype, in one float32
    all-gather over the pipe axis (bf16 and float32 values cross exactly)."""
    names = sorted(local)
    k = 1 + max((_layer_index(n)[0] for n in names), default=-1)
    flat = torch.cat([local[n].detach().reshape(-1).float() for n in names]).to(device)
    parts = ax.all_gather(flat[None], 0).cpu()
    out = {}
    for s in range(ax.size):
        chunks = torch.split(parts[s], [local[n].numel() for n in names])
        for n, c in zip(names, chunks):
            j, sub = _layer_index(n)
            out[f"{_LAYERS}{s * k + j}.{sub}"] = c.view(local[n].shape).to(local[n].dtype)
    return out


def _canonical(local_sd: Mapping, ax: Axis, device, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A stage's (prefixed) state dict -> the whole decoder's."""
    blocks = {n[len(prefix):]: t for n, t in local_sd.items()
              if n.startswith(prefix + _LAYERS)}
    rest = {n: t for n, t in local_sd.items() if not n.startswith(prefix + _LAYERS)}
    gathered = _gather_blocks(blocks, ax, device)
    return {**rest, **{prefix + n: t for n, t in gathered.items()}}


# ---------------------------------------------------------------------------
# the pipelined backbone
# ---------------------------------------------------------------------------


@dataclass
class _Call:
    """One pipelined forward kept for its backward."""

    inputs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # h0, context, t_cond
    leaf: torch.Tensor  # the broadcast output, a leaf the loss was built on
    saved: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]


class PPBackbone:
    """Pipelined ``EdgeDiffusionDecoder.backbone`` over ``mesh``'s ``axis``:
    ``backbone(stage_dec, h0, context, t_cond, generator=None,
    mel_mask=None, ctx_mask=None) -> h``, the activations full-batch [B, T,
    H] on every stage.  Under autograd the call is recorded and ``h`` is a
    leaf; ``backward(call, grad)`` runs its stages' backward.  With
    ``data_axis`` (a ``(data, pipe)`` mesh) each data row runs the same
    schedule on its batch shard, with dropout streams of its own."""

    def __init__(self, cfg: CFG, mesh: Mesh, num_microbatches: int, axis: str = PIPE_AXIS,
                 data_axis: Optional[str] = None):
        self.cfg = cfg
        self.ax = mesh.axis(axis)
        if cfg.layers % self.ax.size:
            raise ValueError(f"layers={cfg.layers} not divisible by pipe axis size "
                             f"{self.ax.size}")
        self.n_mb = int(num_microbatches)
        self.data_index = mesh.axis(data_axis).index if data_axis else 0
        self.calls: List[_Call] = []

    def _split(self, a: Optional[torch.Tensor]) -> list:
        return [None] * self.n_mb if a is None else list(a.detach().chunk(self.n_mb))

    def __call__(self, dec: StageDecoder, h0: torch.Tensor, context: torch.Tensor,
                 t_cond: torch.Tensor, generator: Optional[torch.Generator] = None,
                 mel_mask: Optional[torch.Tensor] = None,
                 ctx_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        ax, M = self.ax, self.n_mb
        s, S = ax.index, ax.size
        B = h0.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        record = torch.is_grad_enabled() and any(p.requires_grad for p in dec.parameters())
        g = None
        if dec.training and self.cfg.dropout > 0:
            if generator is None:
                raise ValueError("training-mode dropout draws from an explicit torch.Generator")
            # One draw on every stage (their generators agree), then a stream
            # per (stage, data shard): the stages' draws never desync them.
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=generator.device))
            g = torch.Generator(device=h0.device).manual_seed(
                fold_seed(seed, s, self.data_index))
        h_mb, c_mb, t_mb = self._split(h0), self._split(context), self._split(t_cond)
        mm_mb, cm_mb = self._split(mel_mask), self._split(ctx_mask)
        saved, outs = [], []
        for m in range(M):  # microbatch m reaches stage s at tick m + s
            h_in = h_mb[m] if s == 0 else ax.recv(h_mb[m], s - 1)
            c_in, t_in = c_mb[m], t_mb[m]
            if record:
                h_in, c_in, t_in = (a.detach().requires_grad_() for a in (h_in, c_in, t_in))
            with torch.set_grad_enabled(record):
                y = h_in
                for block in dec.layers:
                    y = block(y, c_in, cond=t_in, mel_mask=mm_mb[m], ctx_mask=cm_mb[m],
                              generator=g)
            if s < S - 1:
                ax.send(y, s + 1)
            else:
                outs.append(y.detach())
            if record:
                saved.append((h_in, c_in, t_in, y))
        h = torch.cat(outs) if s == S - 1 else torch.empty_like(h0.detach())
        ax.broadcast(h, src=S - 1)
        if not record:
            return h
        h.requires_grad_()
        self.calls.append(_Call((h0, context, t_cond), h, saved))
        return h

    def backward(self, call: _Call, grad: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Backpropagate ``grad`` (the loss's gradient at the call's output,
        the same on every stage) through every stage's blocks; returns the
        gradients of the call's (h0, context, t_cond), summed over stages."""
        ax, M = self.ax, self.n_mb
        s, S = ax.index, ax.size
        g_out = list(grad.chunk(M))
        g_h, g_c, g_t = [], [], []
        for m in range(M):
            h_in, c_in, t_in, y = call.saved[m]
            g_y = g_out[m] if s == S - 1 else ax.recv(y, s + 1)
            torch.autograd.backward(y, g_y)
            g_in = h_in.grad if h_in.grad is not None else torch.zeros_like(h_in)
            if s > 0:
                ax.send(g_in, s - 1)
            g_h.append(g_in if s == 0 else torch.zeros_like(h_in))
            g_c.append(c_in.grad if c_in.grad is not None else torch.zeros_like(c_in))
            g_t.append(t_in.grad if t_in.grad is not None else torch.zeros_like(t_in))
        parts = [torch.cat(g_h), torch.cat(g_c), torch.cat(g_t)]
        # One float32 all-reduce; each sum back at its part's dtype.
        bucket = ax.all_reduce(torch.cat([p.reshape(-1).float() for p in parts]))
        out = torch.split(bucket, [p.numel() for p in parts])
        return tuple(o.view_as(p).to(p.dtype) for o, p in zip(out, parts))


def make_pp_backbone(cfg: CFG, mesh: Mesh, num_microbatches: int, axis: str = PIPE_AXIS,
                     data_axis: Optional[str] = None) -> PPBackbone:
    """The pipelined backbone (see :class:`PPBackbone`)."""
    return PPBackbone(cfg, mesh, num_microbatches, axis, data_axis)


# ---------------------------------------------------------------------------
# the pipeline-parallel trainer
# ---------------------------------------------------------------------------


def _is_block(name: str) -> bool:
    return name.startswith("decoder." + _LAYERS)


class PPTrainer(Trainer):
    """Trainer whose decoder forward pipelines over the ``pipe`` axis.

    Every loss, phase step and validation calls the decoder through
    ``Trainer._decode``; this subclass routes a ``StageDecoder`` (student
    and EMA teacher alike) through the pipelined backbone and schedules the
    backward (``_backward``); ``create_pp_state`` gives the stage's
    optimizer the norm summed over the stages (``stage_norm_fn``): all
    three phases and both exact objectives pipeline with no loss math of
    their own."""

    def __init__(self, cfg: CFG, encoder, decoder, schedule, mesh: Mesh,
                 num_microbatches: int, axis: str = PIPE_AXIS,
                 data_axis: Optional[str] = None, device=None):
        super().__init__(cfg, encoder, decoder, schedule, device=device)
        self.mesh = mesh
        self.pipe_axis = axis
        self.data_axis = data_axis
        self.num_microbatches = num_microbatches
        self.backbone = make_pp_backbone(cfg, mesh, num_microbatches, axis, data_axis)

    def _decode(self, decoder, x_t, t, generator=None, sem_mask=None, mel_mask=None, **cond):
        if not isinstance(decoder, StageDecoder):
            return super()._decode(decoder, x_t, t, generator=generator, sem_mask=sem_mask,
                                   mel_mask=mel_mask, **cond)
        h0, context, t_cond = decoder.prelude(x_t, t, **cond)
        h = self.backbone(decoder, h0, context, t_cond, generator=generator,
                          mel_mask=mel_mask, ctx_mask=sem_mask)
        return decoder.postlude(h)

    def _backward(self, loss: torch.Tensor) -> None:
        calls, self.backbone.calls = self.backbone.calls, []
        if not calls:
            loss.backward()
            return
        g_outs = torch.autograd.grad(loss, [c.leaf for c in calls], retain_graph=True,
                                     allow_unused=True)
        roots, grads = [loss], [torch.ones_like(loss)]
        for call, g in reversed(list(zip(calls, g_outs))):
            g = torch.zeros_like(call.leaf) if g is None else g
            for t, g_in in zip(call.inputs, self.backbone.backward(call, g)):
                if t.requires_grad:
                    roots.append(t)
                    grads.append(g_in)
        torch.autograd.backward(roots, grads)


def stage_norm_fn(ax: Axis) -> Callable:
    """The clip's global norm for a stage's optimizer (``Optimizer.norm_fn``):
    the blocks' squares summed over the stages on ``ax``, the replicated
    tensors' counted once.  Float32 gradients sum their squares in float32;
    any other dtype follows ``training.state.global_norm``: each tensor's
    sum of squares in its dtype, then a running sum in the whole model's
    order (every stage's per-tensor sums gathered over ``ax``), so a
    pipeline stage clips exactly as the single-device step does."""

    def norm(names, grads) -> torch.Tensor:
        if any(g.dtype != torch.float32 for g in grads):
            return _ordered_norm(ax, names, grads)
        blocks = [g for n, g in zip(names, grads) if _is_block(n)]
        rest = [g for n, g in zip(names, grads) if not _is_block(n)]
        sq = torch.stack([g.float().square().sum() for g in blocks]).sum() if blocks \
            else torch.zeros((), device=grads[0].device)
        sq = ax.all_reduce(sq.reshape(1))[0]
        if rest:
            sq = sq + global_norm(rest).square()
        return sq.sqrt()

    return norm


def _ordered_norm(ax: Axis, names, grads) -> torch.Tensor:
    """``global_norm`` of the whole model's gradients, from one stage's:
    each tensor's sum of squares at its dtype, the blocks' gathered over
    ``ax`` (one float32 all-gather: the values cross exactly), then added in
    the whole model's order (a stage's names are the model's with its blocks
    in place of every stage's, renumbered from 0)."""
    sq = [g.square().sum() for g in grads]
    blocks = [i for i, n in enumerate(names) if _is_block(n)]
    gathered = []
    if blocks:
        flat = torch.stack([sq[i].float() for i in blocks])
        gathered = ax.all_gather(flat[None], 0)  # [stages, blocks]
    total, done = 0, False
    for i, n in enumerate(names):
        if not _is_block(n):
            total = total + sq[i]
        elif not done:  # every stage's blocks, stage by stage, where the blocks stand
            done = True
            for stage in gathered:
                for j, v in zip(blocks, stage):
                    total = total + v.to(sq[j].dtype)
    return total.sqrt()


def make_pp_trainer(trainer: Trainer, mesh: Mesh, num_microbatches: int,
                    axis: str = PIPE_AXIS, data_axis: Optional[str] = None) -> PPTrainer:
    """Lift an existing Trainer's modules into a PPTrainer."""
    return PPTrainer(trainer.cfg, trainer.encoder, trainer.decoder, trainer.schedule, mesh,
                     num_microbatches, axis=axis, data_axis=data_axis, device=trainer.device)


class PPTrainState(TrainState):
    """A pipeline stage's train state: its ``StageDecoder`` (and teacher),
    the optimizer over its blocks and the replicated parameters.
    ``state_dict()`` is collective (every stage calls it) and returns the
    whole model in the packed layout; ``load_state_dict`` takes the packed
    or the canonical layout and keeps this stage's slice."""

    def __init__(self, encoder, decoder: StageDecoder, optimizer, ax: Axis,
                 teacher=None, step: int = 0):
        super().__init__(encoder, decoder, optimizer, teacher, step)
        self.ax = ax

    def _device(self):
        return next(self.decoder.parameters()).device

    def _pack_named(self, named: Mapping) -> Dict[str, torch.Tensor]:
        dec = {n[len("decoder."):]: t for n, t in named.items() if n.startswith("decoder.")}
        packed = pp_pack_decoder(_canonical(dec, self.ax, self._device()))
        out = {n: t for n, t in named.items() if not n.startswith("decoder.")}
        for part in ("pp_stack", "pp_rest"):
            out.update({f"decoder.{part}.{n}": t for n, t in packed[part].items()})
        return out

    def _unpack_named(self, named: Mapping) -> Dict[str, torch.Tensor]:
        if not any(n.startswith("decoder.pp_stack.") for n in named):
            canonical = {n[len("decoder."):]: t for n, t in named.items()
                         if n.startswith("decoder.")}
        else:
            packed = {"pp_stack": {}, "pp_rest": {}}
            for n, t in named.items():
                for part in packed:
                    if n.startswith(f"decoder.{part}."):
                        packed[part][n[len(f"decoder.{part}."):]] = t
            canonical = pp_unpack_decoder(packed)
        out = {n: t for n, t in named.items() if not n.startswith("decoder.")}
        out.update({f"decoder.{n}": t for n, t in self.decoder.stage_slice(canonical).items()})
        return out

    def canonical_decoder_state(self) -> Dict[str, torch.Tensor]:
        """The whole decoder's state dict (collective)."""
        return _canonical(self.decoder.state_dict(), self.ax, self._device())

    def state_dict(self, with_hubert: bool = True) -> dict:
        d = super().state_dict(with_hubert)
        dev = self._device()
        d["decoder"] = pp_pack_decoder(_canonical(d["decoder"], self.ax, dev))
        if d["teacher"] is not None:
            d["teacher"] = pp_pack_decoder(_canonical(d["teacher"], self.ax, dev))
        opt = d["optimizer"]
        for key in ("mu", "nu", "acc"):
            if opt[key] is not None:
                opt[key] = self._pack_named(opt[key])
        return d

    def load_state_dict(self, d: dict) -> None:
        d = dict(d)

        def local(tree):
            canonical = pp_unpack_decoder(tree) if is_pp_packed(tree) else tree
            return self.decoder.stage_slice(canonical)

        d["decoder"] = local(d["decoder"])
        if d.get("teacher") is not None:
            d["teacher"] = local(d["teacher"])
        opt = dict(d["optimizer"])
        for key in ("mu", "nu", "acc"):
            if opt.get(key) is not None:
                opt[key] = self._unpack_named(opt[key])
        d["optimizer"] = opt
        super().load_state_dict(d)


def canonical_decoder(state: PPTrainState) -> EdgeDiffusionDecoder:
    """The whole decoder of a pipeline run, on the host (collective), at the
    stage decoder's compute and parameter dtypes."""
    sd = state.canonical_decoder_state()
    dec = _like(EdgeDiffusionDecoder(state.decoder.cfg, dtype=state.decoder.dtype),
                state.decoder)
    dec.load_state_dict(sd)
    return dec


def create_pp_state(trainer: PPTrainer, total_updates: int, base_lr: Optional[float] = None,
                    learning_rate: Optional[Callable] = None) -> PPTrainState:
    """This stage's decoder cut from ``trainer.decoder`` and a fresh
    ``PPTrainState`` around it: moments at zero (pack at a phase start or
    step 0), the clip's norm summed over the stages."""
    ax = trainer.backbone.ax
    dec = make_stage_decoder(trainer.decoder, ax.index, ax.size)
    opt = make_optimizer(trainer.cfg, trainer.encoder, dec, total_updates, base_lr,
                         learning_rate)
    opt.norm_fn = stage_norm_fn(ax)
    return PPTrainState(trainer.encoder, dec, opt, ax)


def make_pp_diffusion_step(trainer: Trainer, mesh: Mesh, num_microbatches: int,
                           vq_weight: Optional[float] = None, axis: str = PIPE_AXIS,
                           data_axis: Optional[str] = None) -> Callable:
    """Phase-1 step with the decoder backbone pipelined over ``axis``, on a
    ``create_pp_state`` state: ``Trainer.make_diffusion_step`` with the
    decode pipelined, so with dropout 0 one PP step equals the
    single-device step to float32 rounding.  ``data_axis`` composes DP x PP:
    the step takes the data shard's rows and averages the gradients over
    ``data_axis`` as the data-parallel step does."""
    pp = trainer if isinstance(trainer, PPTrainer) else make_pp_trainer(
        trainer, mesh, num_microbatches, axis=axis, data_axis=data_axis)
    if data_axis is None:
        return pp.make_diffusion_step(vq_weight)
    from .data_parallel import make_dp_diffusion_step

    return make_dp_diffusion_step(pp, mesh, vq_weight, axis=data_axis)
