"""Reference checkpoints -> the port's state dicts (counterpart of
``edge_diffusion_tts_tpu/utils/torch_compat.py``).

The PyTorch reference saves ``edge_model_final.pt`` / ``best_model.pt``;
``convert_reference_checkpoint`` turns one into the port decoder's and
encoder's state dicts and a config dict, which ``weights.save_checkpoint``
writes as a port checkpoint (the CLI's ``migrate``).  Two layouts:

  v1 ``{encoder_proj, encoder_vq, decoder, cfg}``, VQ or FSQ under
     ``encoder_vq``;
  v2 ``{encoder_proj, encoder_fsq, decoder, ...}``.

The decoder's reference names are the port's own, so it is taken by name.
The encoder projection is a ``Sequential`` there (0 Linear, 1 GELU,
2 LayerNorm, then the final Linear at 3, or at 4 behind a Dropout in the
fast layout) and ``proj_fc1``/``proj_ln``/``proj_fc2`` here; the VQ's
``codebook.weight`` is the port's ``vq.codebook`` buffer, its update count
int32.  The reference saves no HuBERT: ``hubert_state`` (a ``HubertEncoder``
state dict, e.g. ``weights.hubert_state_dict_from_hf``) fills it, and
without one the encoder state holds no HuBERT weights at all.

Reference files are read with ``torch.load(weights_only=True)``: a file
that needs pickled code to load is refused.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import CFG


def _t(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().cpu().to(torch.float32).contiguous()


def load_reference_checkpoint(path: str) -> dict:
    """A reference ``.pt`` as a dict of tensors, numbers and strings
    (``weights_only=True``); a file that needs pickled code raises ValueError."""
    import pickle

    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path} needs pickled code to load, which is refused: only tensors, numbers "
            f"and strings are read (torch.load weights_only=True): {e}") from None


def convert_decoder_state_dict(sd: Dict, num_layers: int) -> Dict[str, torch.Tensor]:
    """The reference decoder's state dict -> the port decoder's (float32):
    every name of a ``num_layers``-block decoder without the depthwise
    pre-net, taken by name; a missing one raises KeyError."""
    from ..models import EdgeDiffusionDecoder

    with torch.device("meta"):
        wanted = list(EdgeDiffusionDecoder(CFG(layers=num_layers)).state_dict())
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError(f"reference decoder lacks {missing[:5]} ({len(missing)} keys)")
    return {k: _t(sd[k]) for k in wanted}


def convert_encoder_proj_state_dict(sd: Dict, fast: bool = False) -> Dict[str, torch.Tensor]:
    """The reference ``SemanticEncoder.proj`` (a ``Sequential``) -> the
    port's ``proj_fc1``/``proj_ln``/``proj_fc2``; the final Linear is index
    4 in the fast layout, 3 otherwise."""
    last = "4" if fast else "3"
    names = {"proj_fc1": "0", "proj_ln": "2", "proj_fc2": last}
    return {f"{port}.{p}": _t(sd[f"{ref}.{p}"]) for port, ref in names.items()
            for p in ("weight", "bias")}


def convert_fsq_encoder_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """The reference ``FSQEncoder`` -> the port's ``vq.proj_down``/``vq.proj_up``."""
    return {f"vq.{m}.{p}": _t(sd[f"{m}.{p}"]) for m in ("proj_down", "proj_up")
            for p in ("weight", "bias")}


def convert_vq_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """The reference ``VectorQuantizer``'s buffers -> the port VQ's."""
    return {
        "vq.codebook": _t(sd["codebook.weight"]),
        "vq.ema_cluster_size": _t(sd["ema_cluster_size"]),
        "vq.ema_w": _t(sd["ema_w"]),
        "vq.update_count": torch.as_tensor(sd["update_count"]).to(torch.int32).reshape(()),
    }


def convert_reference_checkpoint(
    ckpt: Dict, num_layers: int = 4, hubert_state: Optional[Dict] = None
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Optional[dict]]:
    """A reference checkpoint dict -> ``(decoder_sd, encoder_sd, cfg_dict)``.

    ``encoder_sd`` is the port ``SemanticEncoder``'s state dict with the
    HuBERT under ``hubert.`` only when ``hubert_state`` is given.
    ``cfg_dict`` is the reference's ``cfg`` (None when it has none) with
    ``use_depthwise`` turned off: the reference declares it but no reference
    model consumes it, so its checkpoints carry no pre-net weights, and the
    port's decoder would expect them.
    """
    decoder = convert_decoder_state_dict(ckpt["decoder"], num_layers)
    # The fast/v2 projection puts a Dropout at index 3 and the Linear at 4.
    fast = any(k.startswith("4.") for k in ckpt["encoder_proj"])
    encoder = convert_encoder_proj_state_dict(ckpt["encoder_proj"], fast=fast)
    if "encoder_fsq" in ckpt:  # v2 layout
        encoder.update(convert_fsq_encoder_state_dict(ckpt["encoder_fsq"]))
    elif "proj_down.weight" in ckpt["encoder_vq"]:  # v1 layout, FSQ
        encoder.update(convert_fsq_encoder_state_dict(ckpt["encoder_vq"]))
    else:  # v1 layout, VQ
        encoder.update(convert_vq_state_dict(ckpt["encoder_vq"]))
    if hubert_state is not None:
        encoder.update({f"hubert.{k}": _t(v) for k, v in hubert_state.items()})
    cfg = ckpt.get("cfg")
    if isinstance(cfg, dict) and cfg.get("use_depthwise"):
        cfg = dict(cfg, use_depthwise=False)
    return decoder, encoder, cfg
