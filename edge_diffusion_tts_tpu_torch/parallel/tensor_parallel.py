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
gathered back, so every rank returns the whole batch's.  On the
hubert-base conv stack the frontend runs on the conv-frontend kernel
(``ops/fused_frontend.conv_frontend``), as ``fast_encode`` runs it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..models.encoder import SemanticEncoder
from ..ops.fused_frontend import conv_frontend, kernel_serves, pack_frontend_weights
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
    """A row-parallel linear: this rank's partial product, summed over the
    model axis by one all-reduce, then the bias once."""

    def __init__(self, linear: nn.Linear, axis: Axis):
        super().__init__(linear.in_features, linear.out_features, device="meta")
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.axis.all_reduce(F.linear(x, self.weight)) + self.bias


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
        n = self.model.size
        if hc.num_heads % n or hc.intermediate_size % n:
            raise ValueError(f"{hc.num_heads} heads and FFN width {hc.intermediate_size} "
                             f"must divide over the {n}-rank model axis")
        self.layer = min(encoder.cfg.hubert_layer, hc.num_layers)
        self.frontend_weights = (pack_frontend_weights(encoder.hubert.feature_extractor)
                                 if kernel_serves(hc) else None)
        # The encoder's structure without storage; every call hands it this
        # rank's tensors.  Buffers outside the state dict (the FSQ's levels)
        # are the encoder's own.
        with torch.device("meta"):
            self.local = SemanticEncoder(encoder.cfg, hc, use_dropout=encoder.use_dropout)
        for layer in self.local.hubert.encoder.layers:
            layer.attention.out_proj = _RowParallel(layer.attention.out_proj, self.model)
            layer.feed_forward.output_dense = _RowParallel(layer.feed_forward.output_dense,
                                                           self.model)
        saved = encoder.state_dict()
        self.fixed = {k: b for k, b in encoder.named_buffers() if k not in saved}

    def _local(self, enc_params: Dict[str, torch.Tensor], wav: torch.Tensor):
        """This rank's rows of ``wav``, its tensors and its frontend features
        (None off the kernel's stack: the module's conv stack runs)."""
        B, ax = wav.shape[0], self.data
        if B % ax.size:
            raise ValueError(f"batch {B} does not divide over the {ax.size}-rank data axis")
        n = B // ax.size
        wav = wav[ax.index * n:(ax.index + 1) * n]
        feats = (conv_frontend(wav.float().contiguous(), self.frontend_weights)
                 if self.frontend_weights is not None else None)
        return wav, {**self.fixed, **enc_params}, feats

    @torch.inference_mode()
    def features(self, enc_params: Dict[str, torch.Tensor], wav: torch.Tensor) -> torch.Tensor:
        """HuBERT layer ``cfg.hubert_layer`` features of the whole batch."""
        wav, params, feats = self._local(enc_params, wav)
        h = functional_call(self.local.hubert, _sub(params, "hubert."), (wav,),
                            dict(conv_feats=feats, num_layers=self.layer))[self.layer]
        return self.data.all_gather(h, 0)

    @torch.inference_mode()
    def __call__(self, enc_params: Dict[str, torch.Tensor], wav: torch.Tensor) -> torch.Tensor:
        wav, params, feats = self._local(enc_params, wav)
        idx = functional_call(self.local, params, (wav,), dict(conv_feats=feats))[1]
        return self.data.all_gather(idx, 0)


def make_tp_encode(encoder, mesh: Mesh, axis: str = DATA_AXIS) -> TPEncode:
    """Batched wav -> semantic token indices with model-parallel HuBERT:
    ``encode(shard_encoder_params(encoder, mesh), wav)``, the batch split
    over ``axis``.  Head count and FFN width must divide by the model axis."""
    return TPEncode(encoder, mesh, axis)
