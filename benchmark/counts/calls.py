"""The counts of one synthesis call or one training step, from the sizes the
driver records for it (``TraceView.info``)."""

from __future__ import annotations

from . import decoder, frontend, hubert, least_s


def synth_loop(info: dict, call: dict) -> dict:
    return decoder.loop(info["cfg"], call["rows"], call["frames"], call["tokens"], info["steps"],
                        info["compute"])


def synth_loop_least_s(info: dict, call: dict) -> float:
    n = synth_loop(info, call)
    return least_s(n["products"], info["compute"], n["bytes"], n["f32"])


def frontend_least_s(rows: int, samples: int, compute: str) -> float:
    n = frontend.conv_stack(rows, samples, compute=compute)
    return least_s(n["rest"], compute, n["bytes"], f32=n["conv0"])


def synth_model_flops(info: dict, call: dict) -> float:
    """Every product of the call: the loop's steps, the context's K/V and,
    for audio in, the conv stack, HuBERT to its layer, projection and FSQ."""
    cfg, B, S = info["cfg"], call["rows"], call["tokens"]
    n = synth_loop(info, call)
    flops = n["products"] + n["f32"] + decoder.context_products(cfg, B, S)
    if call.get("samples"):
        fe = frontend.conv_stack(B, call["samples"])
        flops += fe["conv0"] + fe["rest"] + hubert.encoder_products(info["hubert"], cfg, B, S)
    return flops


def train_step_flops(info: dict) -> float:
    """A diffusion data step's model products: the frozen conv stack and
    HuBERT once, the trained projection, FSQ and decoder three times
    (forward and backward)."""
    cfg, h, B, N = info["cfg"], info["hubert"], info["rows"], info["samples"]
    S = frontend.frames(N)[-1]
    T = N // cfg["hop_length"] + 1
    fe = frontend.conv_stack(B, N)
    frozen = fe["conv0"] + fe["rest"] + hubert.hubert_products(h, cfg, B, S)
    # the projection and FSQ; the features' projection into the decoder twice
    # (the context and the token-alignment loss)
    trained = hubert.projection_products(h, cfg, B, S) \
        + B * S * 2 * 2 * cfg["semantic_dim"] * cfg["hidden"]
    trained += decoder.forward_products(cfg, B, T, S) + decoder.forward_f32(cfg, B, T)
    trained += decoder.context_products(cfg, B, S)
    return frozen + 3 * trained
