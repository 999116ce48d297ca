#!/usr/bin/env python3
"""Fingerprints of the port's kernels' outputs at seeded inputs, to show that
a change leaves them bit for bit.

On a machine with one NVIDIA GPU, from the root of a checkout:

    python3 tools/kernel_bits.py OUT.json
    python3 tools/kernel_bits.py --compare A.json B.json

The first form runs, at fixed seeded inputs, the band kernel (three shapes
and the strided [B, T, H, d] call, float32 and on bf16 q, k, v), the
decoder-step GEMM in each variant at four shapes, the pre-net's kernels,
the fused DDIM loop (B=1, S=250, 4 steps, eps and v; the default decoder
and configs/flagship.json's with the pre-net), the fused DDPM loop (50
steps, injected and Philox noise, both decoders), the conv frontend
(float32 and bf16 at [1, 80000] and [4, 32000]), then the bf16 decoder
step: its GEMM in each variant at the same shapes (a bf16 A where it takes
one), its attention alone (self and cross, [1, 4, 500, 40]) and the two
loops at bf16, then the positional-conv kernel (48 and 64 channels a
group, at the audio cell's 10 s bucket and a ragged batch), then the
encoders' relative-position attentions (WavLM's gated mode, and where the
checkout has it w2v-BERT's relative-key mode, [4, 149] and [4, 499] at 16
heads of 64), and writes
{case: sha256 of the output's bytes}.  It calls only entry points whose
signatures are those of earlier commits (for the bf16 cases, those since
the bf16 variants were ported; a checkout without the positional-conv
kernel has none of its cases), so a copy of this file run inside an older
checkout fingerprints that checkout's kernels.  The second form prints the
cases whose fingerprints differ and the cases only one file has, and exits
1 if any case both files have differs.  Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys

import numpy as np


def _digest(t) -> str:
    import torch

    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:  # numpy has no bf16: hash its bits
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def _decoder(torch, cfg, seed: int):
    from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder

    torch.manual_seed(seed)
    dec = EdgeDiffusionDecoder(cfg)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.02 * torch.randn(p.shape))
    return dec.to("cuda").eval()


def fingerprints(torch) -> dict:
    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.models.hubert import FeatureExtractor, HubertConfig
    from edge_diffusion_tts_tpu_torch.ops import fused_denoise as fd
    from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
    from edge_diffusion_tts_tpu_torch.ops import window_attention as wa
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule

    out = {}
    rng = np.random.RandomState(0)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32)).cuda()

    for B, T in ((1, 500), (1, 4000), (2, 4000)):
        q, k, v = t(B, 4, T, 40), t(B, 4, T, 40), t(B, 4, T, 40)
        out[f"band [{B},4,{T},40]"] = _digest(wa.banded_attention(q, k, v, 64))
    qkv = t(2, 4000, 3, 4, 40)
    qs, ks, vs = qkv.permute(2, 0, 3, 1, 4)
    out["band strided bthd"] = _digest(wa.banded_attention(qs, ks, vs, 64, out_layout="bthd"))
    q = t(2, 2, 1000, 48)
    out["band seq_len"] = _digest(wa.banded_attention(q, q, q, 200, seq_len=900))
    bf16 = torch.bfloat16
    for B, T in ((1, 4000), (2, 4000)):
        q, k, v = (t(B, 4, T, 40).to(bf16) for _ in range(3))
        out[f"band bf16 [{B},4,{T},40]"] = _digest(wa.banded_attention(q, k, v, 64))
    out["band bf16 strided bthd"] = _digest(wa.banded_attention(
        qs.to(bf16), ks.to(bf16), vs.to(bf16), 64, out_layout="bthd"))

    gemm16 = []
    for M, N, K in ((500, 480, 160), (2000, 160, 160), (500, 80, 80), (77, 160, 320)):
        a, w, w2 = t(M, K), t(N, K, scale=K ** -0.5), t(2 * N, K, scale=K ** -0.5)
        cases = {
            "plain": (w, {}), "bias_pos": (w, dict(bias=t(N), pos=t(50, N))),
            "residual": (w, dict(residual=t(M, N))),
            "swiglu": (w2, dict(bias=t(2 * N), swiglu=True)),
            "adaln_rms": (w, dict(norm="rms", scale=1 + t(K, scale=0.1), shift=t(K, scale=0.1))),
            "rms_w": (w, dict(norm="rms", scale=1 + t(K, scale=0.1))),
            "ln": (w, dict(norm="ln", scale=1 + t(K, scale=0.1), shift=t(K, scale=0.1),
                           bias=t(N))),
        }
        for name, (W, kw) in cases.items():
            out[f"gemm {name} [{M},{N},{K}]"] = _digest(fd.decoder_gemm(a, W, **kw))
            gemm16.append((f"{name} [{M},{N},{K}]", a, W, kw))

    with open(os.path.join("configs", "flagship.json")) as f:
        pcfg = CFG.from_dict(dict(json.load(f), dropout=0.0))
    loops16 = []
    for tag, cfg, seed in (("", CFG(dropout=0.0), 7), (" pre-net", pcfg, 9)):
        dec = _decoder(torch, cfg, seed)
        w = fd.pack_decoder_weights(dec)
        sem_idx = torch.from_numpy(rng.randint(0, 2304, (1, 250))).cuda()
        x_T = t(1, 500, 80)
        ts, coef = fd.ddim_coefficients(DiffusionSchedule.create(1000), 4)
        loop = fd.prepare_loop_inputs(dec, sem_idx, 500, ts)
        args = (x_T, loop["pos"], loop["mods"], loop["ckv"], coef.cuda(), w)
        for prediction in ("eps", "v"):
            out[f"ddim {prediction}{tag}"] = _digest(fd.fused_ddim(
                *args, heads=cfg.heads, window=cfg.attn_window_size, prediction=prediction))
        ts = list(range(49, -1, -1))
        loop = fd.prepare_loop_inputs(dec, sem_idx, 500, ts,
                                      step_idx=torch.zeros(50, dtype=torch.long))
        args = (x_T, loop["pos"], loop["mods"], loop["ckv"],
                fd.ddpm_coefficients(DiffusionSchedule.create(50)).cuda(), w)
        kw = dict(heads=cfg.heads, window=cfg.attn_window_size)
        out[f"ddpm injected{tag}"] = _digest(fd.fused_ddpm(*args, noise=t(1, 50, 500, 80), **kw))
        out[f"ddpm philox{tag}"] = _digest(fd.fused_ddpm(*args, key=(7, 0x5EED), **kw))
        if cfg.use_depthwise:
            out["prenet"] = _digest(fd.decoder_prenet(t(2, 41, cfg.hidden), loop["pos"][:41],
                                                      w))
        loops16.append((tag, cfg, dec, sem_idx, x_T))

    torch.manual_seed(3)
    fe = FeatureExtractor(HubertConfig()).cuda().eval()
    for dtype in (torch.float32, torch.bfloat16):
        wts = ff.pack_frontend_weights(fe, dtype)
        for B, samples in ((1, 80000), (4, 32000)):
            wav = t(B, samples, scale=0.2)
            out[f"frontend {dtype} [{B},{samples}]"] = _digest(
                ff.conv_frontend(wav, wts, compute_dtype=dtype))

    # The bf16 decoder step: its GEMMs (a bf16 A where there is no norm, the
    # output bf16 where there is no residual), its attention alone, its loops.
    for name, a, W, kw in gemm16:
        a16 = a if "norm" in kw else a.to(bf16)
        od = torch.float32 if "residual" in kw else bf16
        out[f"gemm bf16 {name}"] = _digest(fd.decoder_gemm(
            a16, W.to(bf16), compute_dtype=bf16, out_dtype=od, **kw))
    q, k, v = (t(1, 4, n, 40, scale=s).to(bf16) for n, s in ((500, 0.5), (500, 1), (500, 1)))
    out["step attention bf16 self"] = _digest(fd.step_attention(q, k, v, 64, compute_dtype=bf16))
    out["step attention bf16 cross"] = _digest(fd.step_attention(
        q, k[:, :, :250].contiguous(), v[:, :, :250].contiguous(), None, compute_dtype=bf16))
    for tag, cfg, dec, sem_idx, x_T in loops16:
        ts, coef = fd.ddim_coefficients(DiffusionSchedule.create(1000), 4)
        loop = fd.prepare_loop_inputs(dec, sem_idx, 500, ts)
        args = (x_T, loop["pos"], loop["mods"], loop["ckv"].to(bf16), coef.cuda(),
                fd.pack_decoder_weights(dec, bf16))
        out[f"ddim bf16 v{tag}"] = _digest(fd.fused_ddim(
            *args, heads=cfg.heads, window=cfg.attn_window_size, prediction="v",
            compute_dtype=bf16))
        ts = list(range(49, -1, -1))
        zeros = torch.zeros(50, dtype=torch.long)
        loop = fd.prepare_loop_inputs(dec, sem_idx, 500, ts, step_idx=zeros, mods_dtype=bf16)
        args = (x_T, loop["pos"], loop["mods"], loop["ckv"].to(bf16),
                fd.ddpm_coefficients(DiffusionSchedule.create(50)).cuda(),
                fd.pack_decoder_weights(dec, bf16))
        out[f"ddpm bf16 philox{tag}"] = _digest(fd.fused_ddpm(
            *args, heads=cfg.heads, window=cfg.attn_window_size, key=(7, 0x5EED),
            compute_dtype=bf16))

    if importlib.util.find_spec("edge_diffusion_tts_tpu_torch.ops.pos_conv"):
        from edge_diffusion_tts_tpu_torch.ops import pos_conv as pc

        for cpg in (48, 64):
            G = 16
            weight = t(G * cpg, cpg, pc.TAPS, scale=(cpg * pc.TAPS) ** -0.5)
            w, bias = pc.pack_pos_conv_weights(weight), t(G * cpg, scale=0.1)
            for B, S in ((32, 499), (3, 131)):
                out[f"pos_conv {cpg} [{B},{S}]"] = _digest(
                    pc.positional_conv(t(B, S, G * cpg), w, bias))
    # The encoders' relative-position attentions at bf16 (WavLM's gated mode
    # and w2v-BERT's relative-key mode), B = 4, 16 heads of 64.
    if importlib.util.find_spec("edge_diffusion_tts_tpu_torch.ops.relpos_attention"):
        from edge_diffusion_tts_tpu_torch.ops import relpos_attention as ra

        packed = {S: t(4, S, 16 * (3 * 64 + 8)).to(bf16) for S in (149, 499)}
        for S, y in packed.items():
            rel, const = t(16, 2 * S - 1, scale=0.25), t(16, scale=0.25)
            out[f"relpos [4,{S}]"] = _digest(ra.relpos_attention16(y, rel, const))
        if hasattr(ra, "relkey_attention16"):  # drawn after every earlier case's inputs
            E = t(73, 64).to(bf16)
            for S, y in packed.items():
                out[f"relkey [4,{S}]"] = _digest(ra.relkey_attention16(
                    y[..., :3 * 1024].contiguous(), E, 64))
    torch.cuda.synchronize()
    return out


def main() -> int:
    if sys.argv[1:2] == ["--compare"]:
        a, b = (json.load(open(p)) for p in sys.argv[2:4])
        both = set(a) & set(b)
        differ = sorted(k for k in both if a[k] != b[k])
        for k in differ:
            print(f"[bits] differs: {k}")
        for k in sorted(set(a) ^ set(b)):
            print(f"[bits] only in {sys.argv[2] if k in a else sys.argv[3]}: {k}")
        print(f"[bits] {len(both) - len(differ)} of {len(both)} shared cases bit-equal")
        return 1 if differ else 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_bits: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        fp = fingerprints(torch)
    with open(sys.argv[1], "w") as f:
        json.dump(fp, f, indent=1, sort_keys=True)
    print(f"[bits] {len(fp)} cases -> {sys.argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
