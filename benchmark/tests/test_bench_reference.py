"""The plain reference against the port's eager modules on the CPU at
configs/tiny_smoke.json's sizes (HuBERT: the base conv stack at 128 channels
under a small transformer), on the benchmark's seeded weights."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.harness import weights
from benchmark.harness.manifest import ROOT
from benchmark.reference import decoder as rdec, hubert as rhub, schedule as rsched
from benchmark.reference import train as rtrain
from benchmark.reference.precision import Ops, round_to

SEED = 2**31 + 21
HUB = dict(conv_dim=[128] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
           hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


@pytest.fixture(scope="module")
def tiny():
    from edge_diffusion_tts_tpu_torch.config import CFG

    with open(ROOT / "configs" / "tiny_smoke.json") as f:
        c = CFG.from_dict(json.load(f)).to_dict()
    c["hubert"] = HUB
    return c


def port_modules(c):
    from edge_diffusion_tts_tpu_torch.config import CFG
    from edge_diffusion_tts_tpu_torch.models import (EdgeDiffusionDecoder, HubertConfig,
                                                     SemanticEncoder)

    cfg = CFG.from_dict(c)
    h = HubertConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in c["hubert"].items()})
    dec, enc = EdgeDiffusionDecoder(cfg), SemanticEncoder(cfg, h)
    W_dec = weights.make(rdec.parameter_shapes(c), SEED, "cpu", "decoder")
    W_enc = weights.make(rhub.encoder_shapes(c, c["hubert"]), SEED, "cpu", "encoder")
    dec.load_state_dict(W_dec)
    enc.load_state_dict(W_enc)
    return cfg, dec.eval(), enc.eval(), W_dec, W_enc


def test_parameter_names_and_shapes_are_the_ports(tiny):
    _, dec, enc, _, _ = port_modules(tiny)
    assert {k: tuple(v.shape) for k, v in dec.state_dict().items()} == rdec.parameter_shapes(tiny)
    assert {k: tuple(v.shape) for k, v in enc.state_dict().items()} == \
        rhub.encoder_shapes(tiny, tiny["hubert"])


def test_decoder_forward_and_ddim_match_the_eager_port(tiny):
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule, ddim_sample

    cfg, dec, _, W, _ = port_modules(tiny)
    g = torch.Generator().manual_seed(1)
    B, S = 2, 37
    tokens = torch.randint(0, cfg.effective_codebook_size(), (B, S), generator=g)
    x = torch.randn(B, 2 * S, cfg.n_mels, generator=g)
    t, i = torch.tensor([999, 400]), torch.tensor([0, 3])
    ops = Ops("float32")
    with torch.no_grad():
        want = dec(x, t, sem_idx=tokens, step_idx=i)
        got = rdec.forward(W, tiny, x, t, i, rdec.token_context(W, tokens), ops)
        assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)
        sched = DiffusionSchedule.create(cfg.diff_steps)
        want = ddim_sample(sched, lambda xt, tt, ii: dec(xt, tt, sem_idx=tokens, step_idx=ii),
                           x, 4, prediction="v")

        def model(xt, tt, ii):
            return rdec.forward(W, tiny, xt, torch.full((B,), tt), torch.full((B,), ii),
                                rdec.token_context(W, tokens), ops)

        got = rsched.ddim(model, x, cfg.diff_steps, 4, "v")
    assert torch.allclose(got, want, atol=1e-3)
    assert (got - want).abs().max() < 1e-4 or (got - want).abs().gt(1e-4).float().mean() < 1e-2


def test_hubert_projection_and_tokens_match_the_port(tiny):
    _, _, enc, _, W = port_modules(tiny)
    g = torch.Generator().manual_seed(2)
    wav = weights.synthetic_wavs(2, 6400, g, "cpu")
    layer = min(tiny["hubert_layer"], HUB["num_layers"])
    with torch.no_grad():
        want = enc.extract_hubert(wav)
        got = rhub.layer(W, HUB, wav, Ops("float32"), layer)
        assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
        tokens, scaled = rhub.encode(W, tiny, HUB, wav, Ops("float32"))
        port_tokens = enc.encode(wav)
    fsq = rhub.FSQ(tiny["fsq_levels"], "cpu")
    assert rhub.flip_margin(fsq, scaled, port_tokens) < 1e-4
    assert (tokens == port_tokens).float().mean() > 0.99


def test_flip_margin_reads_the_distance_of_a_flipped_digit():
    fsq = rhub.FSQ([4, 2], "cpu")
    scaled = torch.tensor([[[1.49, 0.2], [2.9, 0.9]]])  # codes (1, 0) and (3, 1)
    tokens = fsq.tokens(fsq.round(scaled))
    assert rhub.flip_margin(fsq, scaled, tokens) == 0.0
    flipped = tokens.clone()
    flipped[0, 0] += 1  # digit 0: 1 -> 2, the edge at 1.5 lies 0.01 away
    assert rhub.flip_margin(fsq, scaled, flipped) == pytest.approx(0.01, abs=1e-6)
    flipped[0, 1] -= 4  # digit 1 of the second token: 1 -> 0, the edge at 0.5 lies 0.4 away
    assert rhub.flip_margin(fsq, scaled, flipped) == pytest.approx(0.4, abs=1e-6)


def test_training_loss_gradients_and_update_match_the_port(tiny):
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
    from edge_diffusion_tts_tpu_torch.training import (Trainer, create_train_state,
                                                       make_optimizer)

    tiny = dict(tiny, grad_accumulation=1)  # one update per data step, as the cell's config
    cfg, dec, enc, W_dec, W_enc = port_modules(tiny)
    trainer = Trainer(cfg, enc, dec, DiffusionSchedule.create(cfg.diff_steps), device="cpu")
    state = create_train_state(trainer.encoder, trainer.decoder,
                               make_optimizer(cfg, trainer.encoder, trainer.decoder, 4800))
    step = trainer.make_diffusion_step()
    g = torch.Generator().manual_seed(3)
    B, N = 2, tiny["segment_len"]
    T = N // tiny["hop_length"] + 1
    batches = [{"wav": weights.synthetic_wavs(B, N, g, "cpu"),
                "t": torch.randint(1, tiny["max_timestep"], (B,), generator=g),
                "noise": torch.randn(B, T, tiny["n_mels"], generator=g)} for _ in range(3)]
    gen = torch.Generator().manual_seed(4)
    losses = []
    for k, b in enumerate(batches):
        state, m = step(state, b, gen)
        losses.append(float(m["loss"]))
        if k == 0:
            first = {n: mu / 0.1 for n, mu in state.optimizer.mu.items()}
    W = {**{f"encoder.{n}": t for n, t in W_enc.items()},
         **{f"decoder.{n}": t for n, t in W_dec.items()}}
    ref = rtrain.run_steps(tiny, HUB, W, batches, torch.Generator().manual_seed(4), 4800,
                           Ops("float32"))
    assert ref["losses"] == pytest.approx(losses, rel=1e-5)
    for n, p in state.optimizer.params.items():
        assert torch.allclose(first[n], ref["first_grad"][n], atol=1e-6, rtol=1e-4), n
        assert torch.allclose(p.detach() - W[n], ref["change"][n], atol=1e-8, rtol=1e-3), n


def test_rounding_of_the_controls():
    x = torch.tensor([1.0 + 2**-12, 1.0 + 2**-11 + 2**-12, 3.0, -7.25])
    assert torch.equal(round_to(x, "tf32"), torch.tensor([1.0, 1.0 + 2**-10, 3.0, -7.25]))
    y = torch.linspace(-2.0, 2.0, 101)
    err = (round_to(y, "fp8") - y).abs().max()
    assert 0 < err <= 2.0 / 2**4
    z = y.clone().requires_grad_(True)
    round_to(z, "fp8").sum().backward()
    assert torch.equal(z.grad, torch.ones_like(z))
