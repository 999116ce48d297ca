"""The speech encoder owns its conv frontend's route, and every consumer
takes it: ``EdgeInference.generate_from_audio``, ``Trainer.hubert_features``,
``LongFormPipeline.encode`` and the tensor-parallel encode (``TPEncode``, on
a one-rank gloo group) each give, bit for bit, what the encoder's own
``encode`` / ``extract_hubert`` gives on the same wav, and that is the
encoder on the conv features of the route its stack takes at its dtype.

The stacks: hubert-base's kernels and strides with conv0's GroupNorm at
width 128, at float32 and at bf16 (the kernel's route: on the CPU
``conv_frontend``'s plain version); a WavLM-shaped LayerNorm stack at width
256, at bf16 (the kernel's LayerNorm mode) and at float32 (the modules: the
mode runs at bf16 only); and ``HubertConfig.tiny320()`` (the modules).  A
consumer built before the encoder's weights are loaded uses the loaded
weights.
"""

import pytest
import torch
import torch.distributed as dist

from edge_diffusion_tts_tpu_torch.config import CFG
from edge_diffusion_tts_tpu_torch.inference import EdgeInference
from edge_diffusion_tts_tpu_torch.models import (EdgeDiffusionDecoder, HubertConfig,
                                                 SemanticEncoder)
from edge_diffusion_tts_tpu_torch.models.hubert import conv_frame_lengths
from edge_diffusion_tts_tpu_torch.ops import fused_frontend as ff
from edge_diffusion_tts_tpu_torch.parallel import make_tp_encode, shard_encoder_params
from edge_diffusion_tts_tpu_torch.parallel.launch import free_port
from edge_diffusion_tts_tpu_torch.parallel.mesh import make_mesh
from edge_diffusion_tts_tpu_torch.pipeline import LongFormPipeline
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule
from edge_diffusion_tts_tpu_torch.training import Trainer, TrainState

BF16 = torch.bfloat16
SMALL = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
GROUP = HubertConfig(conv_dim=(128,) * 7, **SMALL)
LAYER = HubertConfig(conv_dim=(256,) * 7, feat_extract_norm="layer", do_stable_layer_norm=True,
                     num_buckets=320, max_bucket_distance=800, **SMALL)
# (stack, compute dtype, whether the frontend kernel takes it)
STACKS = {
    "group-f32": (GROUP, torch.float32, True),
    "group-bf16": (GROUP, BF16, True),
    "layer-bf16": (LAYER, BF16, True),
    "layer-f32": (LAYER, torch.float32, False),
    "tiny320": (HubertConfig.tiny320(), torch.float32, False),
}
CONSUMERS = ("edge_inference", "trainer", "longform", "tensor_parallel")


def _cfg(dtype) -> CFG:
    return CFG(hidden=32, layers=1, heads=2, dropout=0.0,
               compute_dtype="bfloat16" if dtype == BF16 else "float32")


def _weights(hc: HubertConfig, dtype, seed: int) -> dict:
    """A state dict for the encoder with every tensor drawn from ``seed``."""
    torch.manual_seed(seed)
    enc = SemanticEncoder(_cfg(dtype), hc, dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    return {k: v + 0.1 * torch.randn(v.shape, generator=g) if v.is_floating_point() else v
            for k, v in enc.state_dict().items()}


def _encoder(name: str, seed: int = 0) -> SemanticEncoder:
    hc, dtype, _ = STACKS[name]
    enc = SemanticEncoder(_cfg(dtype), hc, dtype=dtype)
    enc.load_state_dict(_weights(hc, dtype, seed))
    return enc.eval()


def _wav(B: int = 2, n: int = 6400, seed: int = 3) -> torch.Tensor:
    return 0.3 * torch.randn(B, n, generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def mesh():
    """A (data 1, model 1) mesh on a one-rank gloo group, taken down after
    the module's tests."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield make_mesh((1, 1))
    finally:
        dist.destroy_process_group()


class _Consumer:
    """A consumer of ``encoder``, built once: ``output(wav)`` is what it
    makes of ``wav``, ``want(encoder, wav)`` the same made from that
    encoder's own ``encode`` / ``extract_hubert`` / forward."""

    def __init__(self, kind: str, encoder: SemanticEncoder, mesh):
        self.kind, self.encoder, self.mesh = kind, encoder, mesh
        cfg = encoder.cfg
        torch.manual_seed(5)
        decoder = EdgeDiffusionDecoder(cfg)
        with torch.no_grad():  # the zero-init head would make every mel 0
            decoder.out_proj.weight.normal_(0, 0.05)
        schedule = DiffusionSchedule.create(cfg.diff_steps)
        if kind == "edge_inference":
            self.engine = EdgeInference(cfg, schedule, decoder, prediction="v", device="cpu",
                                        encoder=encoder)
        elif kind == "trainer":
            self.trainer = Trainer(cfg, encoder, decoder, schedule, device="cpu")
            self.state = TrainState(self.trainer.encoder, self.trainer.decoder, optimizer=None)
        elif kind == "longform":
            self.pipe = LongFormPipeline(cfg, schedule, decoder, encoder, device="cpu")
        else:
            self.tp = make_tp_encode(encoder, mesh)

    def _x_T(self, wav: torch.Tensor) -> torch.Tensor:
        S = conv_frame_lengths(self.encoder.hubert_cfg, wav.shape[1])[-1]
        return torch.randn(wav.shape[0], 2 * S, self.encoder.cfg.n_mels,
                           generator=torch.Generator().manual_seed(7))

    def output(self, wav: torch.Tensor) -> tuple:
        if self.kind == "edge_inference":
            return (self.engine.generate_from_audio(wav, num_steps=1, x_T=self._x_T(wav)),)
        if self.kind == "trainer":
            return (self.trainer.hubert_features(self.state, wav),)
        if self.kind == "longform":  # one row whole, one zero-padded past its wav_len
            return (torch.cat([self.pipe.encode(wav[i:i + 1], wav_len=n)
                               for i, n in enumerate(_lengths(wav))]),)
        params = shard_encoder_params(self.encoder, self.mesh)
        return self.tp.features(params, wav), self.tp(params, wav)

    def want(self, encoder: SemanticEncoder, wav: torch.Tensor) -> tuple:
        with torch.no_grad():
            feats = _route_feats(encoder, wav)
            if self.kind == "edge_inference":
                return (self.engine.generate_mel(encoder.encode(wav, conv_feats=feats),
                                                 num_steps=1, x_T=self._x_T(wav)),)
            if self.kind == "trainer":
                return (encoder.extract_hubert(wav, conv_feats=feats),)
            if self.kind == "longform":
                rows = [wav[i:i + 1] for i in range(wav.shape[0])]
                return (torch.cat([encoder(x, wav_len=n, conv_feats=_route_feats(encoder, x, n))[0]
                                   for x, n in zip(rows, _lengths(wav))]),)
            return (encoder.extract_hubert(wav, conv_feats=feats),
                    encoder.encode(wav, conv_feats=feats))

    def check(self, encoder: SemanticEncoder, wav: torch.Tensor) -> tuple:
        got = self.output(wav)
        for g, w in zip(got, self.want(encoder, wav)):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)
        return got


def _route_feats(encoder: SemanticEncoder, wav: torch.Tensor, wav_len=None) -> torch.Tensor:
    """The conv features of the route the encoder's stack takes at its dtype:
    the frontend kernel's (its plain version) where ``kernel_serves``, else
    the modules'."""
    fe, dtype = encoder.hubert.feature_extractor, encoder.dtype
    if ff.kernel_serves(encoder.hubert_cfg, dtype):
        return ff.conv_frontend_plain(wav, ff.pack_frontend_weights(fe, dtype), wav_len, dtype)
    return fe(wav, wav_len=wav_len)


def _lengths(wav: torch.Tensor) -> tuple:
    return wav.shape[1], wav.shape[1] - 1000


@pytest.mark.parametrize("stack", list(STACKS))
def test_the_encoder_routes_its_frontend(stack):
    """The kernel's route (``conv_frontend`` on the packed buffers, at the
    encoder's dtype) where ``kernel_serves`` says so, the modules elsewhere;
    the buffers stay out of the state dict."""
    hc, dtype, kernel = STACKS[stack]
    enc = _encoder(stack)
    hubert = enc.hubert
    assert hubert.frontend_kernel == kernel == ff.kernel_serves(hc, dtype)
    assert not any("frontend_" in k for k in enc.state_dict())
    wav = _wav()
    with torch.no_grad():
        if kernel:
            w = hubert.packed_frontend()
            assert {k: (v.dtype, tuple(v.shape)) for k, v in w.items()} == {
                k: (v.dtype, tuple(v.shape))
                for k, v in ff.pack_frontend_weights(hubert.feature_extractor, dtype).items()}
            feats = ff.conv_frontend_plain(wav, w, compute_dtype=dtype)
        else:
            assert not any("frontend_" in k for k, _ in enc.named_buffers())
            feats = hubert.feature_extractor(wav)
        assert torch.equal(hubert.conv_features(wav), feats)
        assert torch.equal(enc.extract_hubert(wav), enc.extract_hubert(wav, conv_feats=feats))


@pytest.mark.parametrize("stack", list(STACKS))
@pytest.mark.parametrize("consumer", CONSUMERS)
def test_a_consumer_encodes_as_the_encoder(consumer, stack, mesh):
    enc = _encoder(stack)
    _Consumer(consumer, enc, mesh).check(enc, _wav())


@pytest.mark.parametrize("consumer", CONSUMERS)
def test_a_consumer_sees_weights_loaded_after_it_was_built(consumer, mesh):
    """The bf16 LayerNorm stack: weights loaded into the encoder after the
    consumer was built reach the packed frontend the consumer's next call
    runs on."""
    enc = _encoder("layer-bf16", seed=0)
    user = _Consumer(consumer, enc, mesh)
    wav = _wav()
    before = user.output(wav)
    hc, dtype, _ = STACKS["layer-bf16"]
    enc.load_state_dict(_weights(hc, dtype, seed=1))
    after = user.check(_encoder("layer-bf16", seed=1), wav)
    assert not torch.equal(before[0], after[0])


@pytest.mark.parametrize("stack", list(STACKS))
def test_the_mel_follows_the_tokens(stack):
    """The edge_inference cases compare mels: one token changed moves the
    mel, so equal mels are equal tokens."""
    user = _Consumer("edge_inference", _encoder(stack), None)
    wav = _wav()
    tokens = user.encoder.encode(wav)
    other = tokens.clone()
    other[0, 1] = (other[0, 1] + 1) % user.encoder.codebook_size
    x_T = user._x_T(wav)
    mels = [user.engine.generate_mel(t, num_steps=1, x_T=x_T) for t in (tokens, other)]
    assert not torch.equal(*mels)
