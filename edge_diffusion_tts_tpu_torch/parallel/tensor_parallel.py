"""Tensor parallelism for the HuBERT semantic encoder over the ``model``
axis (counterpart of ``edge_diffusion_tts_tpu/parallel/tensor_parallel.py``).

Megatron placement, in the port's ``nn.Linear`` layout (weight [out, in]):

  q/k/v projections   weight [H, H]   -> split dim 0 (each rank its heads)
  attention out_proj  weight [H, H]   -> split dim 1 (row-parallel)
  FFN intermediate    weight [4H, H]  -> split dim 0 (column-parallel)
  FFN output          weight [H, 4H]  -> split dim 1 (row-parallel)
  biases of column-parallel layers    -> split
  everything else (convs, norms, projection, quantizer) -> replicated

A row-parallel layer's partial products are summed by one all-reduce, and
its bias is added once, after it.  Those two collectives are all the TP
code adds: the encoder's own forward runs on this rank's slices
(``functional_call`` on a structural copy whose ``out_proj`` and
``output_dense`` are ``_RowParallel``; the attention takes its head count
from q_proj's rows).  The batch is split over the data axis and the tokens
gathered back, so every rank returns the whole batch's.  The encoder's
structure is rebuilt at its compute dtype, and its tensors keep their
dtypes; its conv frontend takes the route the encoder owns
(models/hubert.py), on the packed weights the encoder holds as buffers.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..layers.dtypes import cast
from ..models.encoder import SemanticEncoder
from ..models.hubert import HubertConfig
from .mesh import DATA_AXIS, MODEL_AXIS, Axis, Mesh, Placement

_COL_PARALLEL = ("q_proj", "k_proj", "v_proj", "intermediate_dense")
_ROW_PARALLEL = ("out_proj", "output_dense")


def hubert_param_spec(name: str) -> Tuple[Optional[str], ...]:
    """The placement spec of one HuBERT tensor from its state-dict name
    (``encoder.layers.3.attention.q_proj.weight`` ...): per dim, the axis
    it splits over, or None."""
    parts = name.split(".")
    module, leaf = (parts[-2], parts[-1]) if len(parts) >= 2 else ("", name)
    if module in _COL_PARALLEL:
        return (MODEL_AXIS, None) if leaf == "weight" else (MODEL_AXIS,)
    if module in _ROW_PARALLEL and leaf == "weight":
        return (None, MODEL_AXIS)
    return ()


def encoder_param_shardings(enc_params, mesh: Mesh) -> Dict[str, Placement]:
    """``{name: Placement}`` for a ``SemanticEncoder``'s state dict (or the
    module): the HuBERT's tensors take the Megatron placement, the
    projection and the quantizer stay replicated."""
    names = enc_params.state_dict() if isinstance(enc_params, torch.nn.Module) else enc_params
    out = {}
    for name in names:
        parts = name.split(".")
        if "hubert" in parts:
            sub = ".".join(parts[parts.index("hubert") + 1:])
            out[name] = Placement(mesh, hubert_param_spec(sub))
        else:
            out[name] = Placement(mesh, ())
    return out


def shard_encoder_params(enc_params, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of every encoder tensor (whole for the replicated
    ones), as contiguous copies."""
    sd = enc_params.state_dict() if isinstance(enc_params, torch.nn.Module) else enc_params
    places = encoder_param_shardings(sd, mesh)
    return {k: places[k].local(v.detach()).contiguous() for k, v in sd.items()}


def _sub(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


class _RowParallel(nn.Linear):
    """A row-parallel linear at ``linear``'s compute dtype: this rank's
    partial product in float32 (of the operands at the compute dtype),
    summed over the model axis by one float32 all-reduce, the bias added
    once, then one rounding to the compute dtype, as the whole product
    accumulates and rounds on one device."""

    def __init__(self, linear: nn.Linear, axis: Axis):
        super().__init__(linear.in_features, linear.out_features, device="meta")
        self.axis = axis
        self.compute_dtype = getattr(linear, "compute_dtype", torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, f32 = self.compute_dtype, torch.float32
        part = F.linear(cast(cast(x, dt), f32), cast(cast(self.weight, dt), f32))
        return cast(self.axis.all_reduce(part) + cast(cast(self.bias, dt), f32), dt)


class TPEncode:
    """``encode(enc_params, wav [B, T]) -> token indices [B, S]`` with the
    HuBERT's heads and FFN split over the model axis and the rows over the
    data axis; ``features(enc_params, wav)`` the HuBERT layer features it
    quantizes.  ``enc_params`` is ``shard_encoder_params(encoder, mesh)``."""

    def __init__(self, encoder, mesh: Mesh, axis: str = DATA_AXIS):
        self.encoder = encoder
        self.model = mesh.axis(MODEL_AXIS)
        self.data = mesh.axis(axis)
        hc = encoder.hubert_cfg
        if not isinstance(hc, HubertConfig):
            raise ValueError("tensor-parallel encode splits HuBERT's and WavLM's layers, not "
                             f"w2v-BERT's Conformer layers ({type(hc).__name__}): encode it on "
                             "one rank")
        n = self.model.size
        if hc.num_heads % n or hc.intermediate_size % n:
            raise ValueError(f"{hc.num_heads} heads and FFN width {hc.intermediate_size} "
                             f"must divide over the {n}-rank model axis")
        self.layer = min(encoder.cfg.hubert_layer, hc.num_layers)
        # The encoder's structure without storage; every call hands it this
        # rank's tensors.  Buffers outside the state dict (the FSQ's levels,
        # the packed frontend weights) are the encoder's own.
        with torch.device("meta"):
            self.local = SemanticEncoder(encoder.cfg, hc, use_dropout=encoder.use_dropout,
                                         dtype=encoder.dtype)
        for layer in self.local.hubert.encoder.layers:
            layer.attention.out_proj = _RowParallel(layer.attention.out_proj, self.model)
            layer.feed_forward.output_dense = _RowParallel(layer.feed_forward.output_dense,
                                                           self.model)
        saved = encoder.state_dict()
        self.fixed = {k: b for k, b in encoder.named_buffers() if k not in saved}

    def _local(self, enc_params: Dict[str, torch.Tensor], wav: torch.Tensor):
        """This rank's rows of ``wav`` and its tensors."""
        B, ax = wav.shape[0], self.data
        if B % ax.size:
            raise ValueError(f"batch {B} does not divide over the {ax.size}-rank data axis")
        n = B // ax.size
        return wav[ax.index * n:(ax.index + 1) * n], {**self.fixed, **enc_params}

    @torch.inference_mode()
    def features(self, enc_params: Dict[str, torch.Tensor], wav: torch.Tensor) -> torch.Tensor:
        """HuBERT layer ``cfg.hubert_layer`` features of the whole batch."""
        wav, params = self._local(enc_params, wav)
        h = functional_call(self.local.hubert, _sub(params, "hubert."), (wav,),
                            dict(num_layers=self.layer))[self.layer]
        return self.data.all_gather(h, 0)

    @torch.inference_mode()
    def __call__(self, enc_params: Dict[str, torch.Tensor], wav: torch.Tensor) -> torch.Tensor:
        wav, params = self._local(enc_params, wav)
        idx = functional_call(self.local, params, (wav,))[1]
        return self.data.all_gather(idx, 0)


def make_tp_encode(encoder, mesh: Mesh, axis: str = DATA_AXIS) -> TPEncode:
    """Batched wav -> semantic token indices with model-parallel HuBERT:
    ``encode(shard_encoder_params(encoder, mesh), wav)``, the batch split
    over ``axis``.  Head count and FFN width must divide by the model axis."""
    return TPEncode(encoder, mesh, axis)
