"""Long-form chunked generation: sliding window + inpainting + crossfade
(counterpart of ``edge_diffusion_tts_tpu/pipeline.py``).

- the global semantic encode of the whole utterance (padded to a whole
  latent of ``sem_stride`` samples);
- 2 s chunks with 0.5 s overlap, each refined from noise by a v-prediction
  DDIM loop with classifier-free guidance that re-injects the noised tail
  of the previous chunk over the overlap (inpainting);
- a triangular crossfade in linear-mel space, 5x3 average smoothing, the
  inverse mel scale and Griffin-Lim.

The refine is the decoder called once per step, the conditional and
unconditional CFG branches as one batch of 2B; there is no kernel of its
own here (chunks of 201 frames stay below the band kernel's
``pallas_min_seq_len``).  The encode is the encoder's own call, on the
conv-frontend route the encoder owns (models/hubert.py).

Randomness.  JAX's key chains cannot be reproduced in torch, so the same
seed gives another (identically distributed) result here than in the JAX
package.  A stream's integer ``seed`` gives every chunk one 63-bit seed,
drawn by ``stream_prep`` from a CPU ``torch.Generator`` (JAX's per-chunk
``split(rng, 3)`` pair of keys).  In the refine each row draws all of its
chunk's noise in one ``torch.randn((steps + 2, T, n_mels))`` from its own
generator: the coarse start, the noise of the initial ``q_sample``, and one
draw per step for the overlap's re-injection.  A row's draws therefore do
not depend on the batch it rides in (``serving.LongFormScheduler`` rests on
this).  Its bits may: cuBLAS picks its GEMM kernels by the row count, and
two kernels sum in two orders, so on the card a chunk refined beside other
streams differs from its solo refine by float32 rounding (a few 1e-6 after
50 steps on the H100).  ``row_quantum`` is 1, as in the JAX package
without a mesh: no row is padded.  With ``mesh`` (a list of devices) the
refine splits its rows over the devices, a decoder replica on each, and
pads the row count to a multiple of the list's length (``row_quantum``),
as the JAX package pads to its data axis: a padding row repeats row 0's
inputs, inpaints nothing, and is dropped.  The vocoder's start phase
comes from ``fold_seed(seed, 1)`` (offline) or ``fold_seed(seed, 1, w0)``
(per streaming window), where JAX folds the same integers into its key.
"""

from __future__ import annotations

import copy
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import CFG, resolve_device
from .ops.mel import MelFrontend, inverse_mel_scale
from .ops.vocoder import griffin_lim
from .schedule import DiffusionSchedule
from .utils.audio import normalize_mel


def fold_seed(*words: int) -> int:
    """A 63-bit seed from a tuple of integers (where JAX folds integers into
    a key): the same tuple gives the same seed on every run, and tuples of
    other lengths other seeds."""
    seq = np.random.SeedSequence([len(words)] + [int(w) % (1 << 64) for w in words])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def row_noise(seeds, shape, device) -> torch.Tensor:
    """[B, *shape] standard normal draws, row i from its own generator
    seeded with ``seeds[i]`` on ``device``."""
    out = []
    for s in np.asarray(seeds, np.int64).reshape(-1):
        g = torch.Generator(device=device).manual_seed(int(s))
        out.append(torch.randn(shape, generator=g, device=device))
    return torch.stack(out)


class LongFormPipeline:
    """Chunked long-form mel generation around a decoder and an encoder.

    ``decoder`` is an ``EdgeDiffusionDecoder`` (v-prediction).  ``encoder``
    is a ``SemanticEncoder``, or ``encoder_apply`` a callable ``(wav [1, T],
    wav_len=None) -> z_q [1, S, D]`` in its place.  ``prep_buckets`` (sample counts) pads every stream's
    encode to the smallest bucket that holds it, exactly (``wav_len``); a
    longer stream warns and is encoded at its own length.  The pipeline
    runs on ``device`` (the card unless told otherwise); ``mesh``, a list of
    devices (one may repeat), splits each refine's rows over them.
    """

    def __init__(
        self,
        cfg: CFG,
        schedule: DiffusionSchedule,
        decoder,
        encoder=None,
        chunk_seconds: float = 2.0,
        overlap_seconds: float = 0.5,
        mesh=None,
        prep_buckets=None,
        sem_stride: int = 320,
        device=None,
        encoder_apply=None,
    ):
        if encoder is not None and encoder_apply is not None:
            raise ValueError("pass an encoder or an encoder_apply, not both")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.schedule = schedule.to(self.device)
        self.decoder = decoder.to(self.device).eval()
        self.encoder = None if encoder is None else encoder.to(self.device).eval()
        self.encoder_apply = encoder_apply
        self.mel_frontend = MelFrontend(
            sample_rate=cfg.sample_rate, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
            win_length=cfg.win_length, n_mels=cfg.n_mels, f_min=cfg.f_min, f_max=cfg.f_max,
        ).to(self.device)
        self.sem_stride = int(sem_stride)
        self.chunk_samples = int(chunk_seconds * cfg.sample_rate)
        self.overlap_samples = int(overlap_seconds * cfg.sample_rate)
        self.hop_samples = self.chunk_samples - self.overlap_samples
        self.chunk_frames = self.chunk_samples // cfg.hop_length + 1
        self.overlap_frames = self.overlap_samples // cfg.hop_length + 1
        self.hop_frames = self.chunk_frames - self.overlap_frames
        self.prep_buckets = (
            tuple(sorted(int(b) for b in prep_buckets)) if prep_buckets else None
        )
        # stream_prep_async's stream on the card, beside the refine's, and the
        # point on the building thread's stream after which the weights and
        # buffers the prep reads are on the card.
        self.prep_stream = self.weights_ready = None
        if self.device.type == "cuda":
            self.prep_stream = torch.cuda.Stream(self.device)
            self.weights_ready = torch.cuda.Event()
            self.weights_ready.record(torch.cuda.current_stream(self.device))
        # Rows a refine runs in multiples of: the mesh's length, 1 without.
        self.mesh = None
        self.row_quantum = 1
        if mesh is not None:
            from .parallel.data_parallel import DeviceShares  # parallel/ imports this module

            try:
                devices = list(mesh)
            except TypeError:
                raise ValueError("LongFormPipeline's mesh is a list of devices to split the "
                                 "refine's rows over") from None
            self.mesh = DeviceShares(devices, self.device, (self.decoder, self.schedule),
                                     lambda r, d: (copy.deepcopy(r[0]).to(d), r[1].to(d)))
            self.row_quantum = len(self.mesh)

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.to(device=self.device, dtype=dtype)
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- chunk refine ---------------------------------------------------------

    @torch.inference_mode()
    def _refine(self, noise, sem_features, known_mel, have_known, *, strength: float,
                steps: int, cfg_scale: float) -> torch.Tensor:
        """noise [B, steps + 2, T, M] (coarse start, initial q_sample, one per
        step) -> refined chunk [B, T, M].  Reference semantics:
        inpaint_teacher_refine (JAX ``pipeline.py:126-246``).  Under a mesh
        the rows are padded to ``row_quantum`` and split over its devices."""
        sem = self._tensor(sem_features)
        known = self._tensor(known_mel)
        have = torch.as_tensor(np.asarray(have_known, bool).reshape(-1), device=self.device)
        kw = dict(strength=strength, steps=steps, cfg_scale=cfg_scale)
        if self.mesh is None:
            return self._refine_rows(self.decoder, self.schedule, noise, sem, known, have, **kw)
        n, q = noise.shape[0], self.row_quantum
        pad = (q - n % q) % q
        if pad:
            rep = lambda a: torch.cat([a, a[:1].expand(pad, *a.shape[1:])])  # noqa: E731
            noise, sem, known = rep(noise), rep(sem), rep(known)
            have = torch.cat([have, torch.zeros(pad, dtype=torch.bool, device=have.device)])
        return self.mesh.run(lambda rep, *share: self._refine_rows(*rep, *share, **kw),
                             noise, sem, known, have)[:n]

    def _refine_rows(self, decoder, sched, noise, sem, known, have, *, strength: float,
                     steps: int, cfg_scale: float) -> torch.Tensor:
        """The refine of ``noise``'s rows on their device."""
        device = noise.device
        B, T = noise.shape[0], noise.shape[2]
        t_start = int(self.cfg.diff_steps * strength)
        grid = np.linspace(t_start, 0, steps + 1).astype(np.int64)[:-1]
        t_next = np.concatenate([grid[1:], [0]])
        x, _ = sched.q_sample(noise[:, 0], torch.full((B,), t_start, device=device),
                              noise[:, 1])
        overlap = (torch.arange(T, device=device) < self.overlap_frames)
        overlap = overlap[None, :, None] & have[:, None, None]
        sem_both = torch.cat([sem, torch.zeros_like(sem)])
        s_idx = torch.zeros(2 * B, dtype=torch.long, device=device)
        for j, (t, tn) in enumerate(zip(grid.tolist(), t_next.tolist())):
            t_b = torch.full((B,), t, dtype=torch.long, device=device)
            known_noisy, _ = sched.q_sample(known, t_b, noise[:, 2 + j])
            x = torch.where(overlap, known_noisy, x)
            if cfg_scale != 1.0:
                v2 = decoder(torch.cat([x, x]), torch.cat([t_b, t_b]),
                             sem_features=sem_both, step_idx=s_idx)
                v_cond, v_uncond = v2[:B], v2[B:]
                v = v_uncond + cfg_scale * (v_cond - v_uncond)
            else:
                v = decoder(x, t_b, sem_features=sem, step_idx=s_idx[:B])
            x0 = sched.predict_x0_from_v(x, t_b, v).clamp(-3.0, 3.0)
            eps = sched.predict_eps_from_v(x, t_b, v)
            ab_next = sched.alpha_bar[tn]
            x = torch.sqrt(ab_next) * x0 + torch.sqrt(1.0 - ab_next) * eps
        return torch.where(overlap, known, x)

    def refine_chunk(self, x_coarse, sem_features, known_mel=None, strength: float = 0.2,
                     steps: int = 10, cfg_scale: float = 1.0, seed: int = 0) -> torch.Tensor:
        """Refine chunks [B, T, M]; ``known_mel`` [B, <=T, M] is the overlap to
        inpaint (none when None).  Row i's noise comes from ``seed`` (B=1) or
        ``fold_seed(seed, i)``, as ``refine_chunk_batch_seeds`` draws it."""
        x_coarse = self._tensor(x_coarse)
        B, T, M = x_coarse.shape
        have = known_mel is not None
        known = torch.zeros_like(x_coarse) if not have else F.pad(
            self._tensor(known_mel), (0, 0, 0, T - np.shape(known_mel)[1]))
        seeds = [seed] if B == 1 else [fold_seed(seed, i) for i in range(B)]
        noise = row_noise(seeds, (steps + 2, T, M), self.device)[:, 1:]
        return self.refine_chunk_batch(x_coarse, sem_features, known, [have] * B, noise,
                                       strength=strength, steps=steps, cfg_scale=cfg_scale)

    def refine_chunk_batch(self, x_coarse, sem_features, known_mel, have_known, noise, *,
                           strength: float, steps: int, cfg_scale: float) -> torch.Tensor:
        """Batched refine over a leading stream axis, on injected noise:
        ``noise`` [B, steps + 1, T, M] is the initial q_sample's draw and
        then one per step.  ``known_mel`` is already padded to T frames;
        ``have_known`` [B] gates the inpainting per row.  Rows are computed
        independently."""
        x_coarse = self._tensor(x_coarse)
        noise = torch.cat([x_coarse[:, None], self._tensor(noise)], 1)
        return self._refine(noise, sem_features, known_mel, have_known, strength=strength,
                            steps=steps, cfg_scale=cfg_scale)

    def refine_chunk_batch_seeds(self, seeds, sem_features, known_mel, have_known, *,
                                 strength: float, steps: int, cfg_scale: float) -> torch.Tensor:
        """The serving entry point (JAX ``refine_chunk_batch_keys``): row i
        draws its coarse start and all of its noise from a generator seeded
        with ``seeds[i]``, and equals ``refine_chunk_batch`` fed those draws.
        Inputs may be host numpy; the result stays on the device."""
        T, M = np.shape(known_mel)[1:]
        noise = row_noise(seeds, (steps + 2, T, M), self.device)
        return self._refine(noise, sem_features, known_mel, have_known, strength=strength,
                            steps=steps, cfg_scale=cfg_scale)

    # -- stream prep ----------------------------------------------------------

    @torch.inference_mode()
    def encode(self, wav: torch.Tensor, wav_len=None) -> torch.Tensor:
        """wav [1, T] on the device -> quantized features [1, S, D] from the
        encoder, or from ``encoder_apply``; ``wav_len`` marks a zero-padded
        tail (exact: the frames past it are zero)."""
        if self.encoder is not None:
            return self.encoder(wav, wav_len=wav_len)[0]
        if self.encoder_apply is None:
            raise ValueError("pipeline constructed without an encoder")
        return (self.encoder_apply(wav) if wav_len is None
                else self.encoder_apply(wav, wav_len=wav_len))

    def num_chunks(self, total: int) -> int:
        return max(1, -(-(total - self.overlap_samples) // self.hop_samples))

    def stream_prep(self, wav: np.ndarray, seed: int = 0):
        """A long-form stream's prep: ``wav [1, total]`` -> host numpy
        ``(z_q_global [1, S, D], mean [N, 1, M], std [N, 1, M], seeds [N])``
        for its N chunks: the global semantic encode (padded to a whole
        latent, or with ``prep_buckets`` to the bucket, exact through
        ``wav_len``), every chunk's denormalization statistics
        (``normalize_mel(mel_frontend(chunk))``), and every chunk's refine
        seed, drawn in order from a CPU generator seeded with ``seed``.
        ``stream_prep_async``'s result, fetched at once."""
        return self.stream_prep_async(wav, seed)()

    @torch.inference_mode()
    def stream_prep_async(self, wav: np.ndarray, seed: int = 0):
        """Dispatch ``stream_prep`` without waiting for it: returns a zero-arg
        ``realize()`` that gives ``stream_prep``'s tuple, bit for bit.

        On a CUDA device the prep is enqueued on the pipeline's side stream
        (``prep_stream``), after ``weights_ready`` (the weights' upload when
        the pipeline was built) and after nothing else: the wav goes up from
        pinned memory, the results come down into pinned memory, and an
        event recorded after them is what ``realize()`` waits on.  Nothing
        between the dispatch and that event waits for the card, so streams
        submitted from several threads queue their preps back to back beside
        the refine that the scheduler queues on the default stream.  A
        caller that rewrites the weights in place afterwards orders that
        write itself (``torch.cuda.synchronize()``).  On the CPU the prep
        runs here and ``realize()`` returns its result.  The seeds are drawn
        here, in either case."""
        if self.encoder is None and self.encoder_apply is None:
            raise ValueError("pipeline constructed without an encoder")
        wav_np = np.asarray(wav, np.float32).reshape(1, -1)
        total = wav_np.shape[1]
        n = self.num_chunks(total)
        pad_to = None
        if self.prep_buckets:
            pad_to = next((b for b in self.prep_buckets if b >= total), None)
            if pad_to is None:
                warnings.warn(
                    f"stream of {total} samples exceeds the largest prep bucket "
                    f"{self.prep_buckets[-1]}; encoding it at its own length", stacklevel=2)
        seeds = torch.randint(0, (1 << 63) - 1, (n,), generator=torch.Generator().manual_seed(
            int(seed)), dtype=torch.int64).numpy()
        if self.device.type != "cuda":
            out = tuple(t.cpu().numpy() for t in self._prep(
                torch.tensor(wav_np, device=self.device), n, pad_to)) + (seeds,)
            return lambda: out
        host_wav = torch.empty(wav_np.shape, dtype=torch.float32, pin_memory=True)
        host_wav.numpy()[:] = wav_np
        side = self.prep_stream
        side.wait_event(self.weights_ready)
        with torch.cuda.stream(side):
            dev = self._prep(host_wav.to(self.device, non_blocking=True), n, pad_to)
            out = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in dev)
            for o, t in zip(out, dev):
                o.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)

        def realize(keep=host_wav):  # the pinned wav lives until its upload is done
            done.synchronize()
            return tuple(o.numpy() for o in out) + (seeds,)

        return realize

    def _prep(self, wav_t: torch.Tensor, n: int, pad_to: Optional[int]):
        """``stream_prep``'s device work on ``wav_t [1, total]`` on the current
        stream: ``(z_q_global, mean, std)`` as tensors."""
        total = wav_t.shape[1]
        st = self.sem_stride
        enc_len = total + (st - total % st) % st
        if pad_to is None:
            z = self.encode(F.pad(wav_t, (0, enc_len - total)))
        else:
            if self.encoder is not None:
                # On the device already: a Python int would go up to the card
                # with a blocking copy inside the encoder.
                enc_len = torch.full((1,), enc_len, dtype=torch.long, device=wav_t.device)
            z = self.encode(F.pad(wav_t, (0, pad_to - total)), wav_len=enc_len)
        cs, hop = self.chunk_samples, self.hop_samples
        padded = F.pad(wav_t[0], (0, max(0, (n - 1) * hop + cs - total)))
        idx = (torch.arange(n, device=wav_t.device) * hop)[:, None] + torch.arange(
            cs, device=wav_t.device)[None, :]
        _, mean, std = normalize_mel(self.mel_frontend(padded[idx]))
        return z, mean, std

    # -- full pipeline ----------------------------------------------------------

    @torch.inference_mode()
    def encode_global(self, wav_16k) -> torch.Tensor:
        """Global semantic features of the whole utterance (padded to a whole
        latent)."""
        wav = self._tensor(wav_16k).reshape(1, -1) if np.ndim(wav_16k) == 1 else \
            self._tensor(wav_16k)
        T = wav.shape[-1]
        return self.encode(F.pad(wav, (0, (self.sem_stride - T % self.sem_stride)
                                       % self.sem_stride)))

    def generate(self, wav: np.ndarray, strength: float = 0.6, steps: int = 50,
                 cfg_scale: float = 2.0, seed: int = 0, vocode: bool = True,
                 griffin_lim_iters: int = 100) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Full utterance -> (linear mel [n_mels, T], waveform or None), by
        draining ``generate_streaming``; the vocoder's seed is
        ``fold_seed(seed, 1)``."""
        wav = np.asarray(wav, np.float32).reshape(1, -1)
        segments = [seg for seg, _ in self.generate_streaming(
            wav, strength=strength, steps=steps, cfg_scale=cfg_scale, seed=seed)]
        final_mel = np.concatenate(segments, axis=1)
        if not vocode:
            return final_mel, None
        out = self.vocode(final_mel, fold_seed(seed, 1), n_iter=griffin_lim_iters)
        return final_mel, out[:wav.shape[1]]

    def generate_streaming(self, wav: np.ndarray, strength: float = 0.6, steps: int = 50,
                           cfg_scale: float = 2.0, seed: int = 0):
        """Yields (linear_mel_increment [n_mels, F], frame_offset) per chunk as
        soon as its crossfade is final: one stream's loop over
        ``ChunkStream``, through the same batched refine the scheduler
        calls (B=1)."""
        stream = ChunkStream(self, wav, strength=strength, steps=steps, cfg_scale=cfg_scale,
                             seed=seed)
        while not stream.done:
            s, z_chunk, known_mel, have = stream.next_job()
            x_ref = self.refine_chunk_batch_seeds(
                [s], z_chunk, known_mel, [have], strength=strength, steps=steps,
                cfg_scale=cfg_scale)
            yield from stream.complete(x_ref.cpu().numpy())

    def generate_streaming_audio(self, wav: np.ndarray, strength: float = 0.6,
                                 steps: int = 50, cfg_scale: float = 2.0, seed: int = 0,
                                 context_seconds: float = 0.5, crossfade_samples: int = 320,
                                 griffin_lim_iters: int = 50):
        """Streaming waveform generation: yields (wav_increment,
        sample_offset), each finalized mel increment vocoded in a window that
        carries ``context_seconds`` of final mel to its left, consecutive
        windows blended over ``crossfade_samples``.  The mel is
        ``generate(wav, seed=seed)``'s."""
        wav_in = np.asarray(wav, np.float32).reshape(1, -1)
        return self.stream_audio(
            self.generate_streaming(wav_in, strength=strength, steps=steps,
                                    cfg_scale=cfg_scale, seed=seed),
            total=wav_in.shape[1], seed=seed, context_seconds=context_seconds,
            crossfade_samples=crossfade_samples, griffin_lim_iters=griffin_lim_iters)

    def stream_audio(self, mel_iter, total: int, seed: int = 0, context_seconds: float = 0.5,
                     crossfade_samples: int = 320, griffin_lim_iters: int = 50):
        """Linear-mel increments -> waveform increments (the vocoder half of
        ``generate_streaming_audio``), over any source of ``(mel_seg,
        frame_offset)``; ``total`` caps the samples emitted.  The window
        that starts at frame w0 is vocoded with ``fold_seed(seed, 1, w0)``."""
        cfg = self.cfg
        hop = cfg.hop_length
        ctx_frames = max(int(context_seconds * cfg.sample_rate) // hop,
                         crossfade_samples // hop + 2)
        hist = np.zeros((cfg.n_mels, 0), np.float32)
        out_pos = 0
        tail = np.zeros((0,), np.float32)  # held-back crossfade samples

        def render(F_end: int):
            # The window reaches back past the first sample not yet emitted,
            # plus ctx_frames of context.
            w0 = max(0, min(F_end - self.hop_frames, out_pos // hop) - ctx_frames)
            return w0 * hop, self.vocode(hist[:, w0:F_end], fold_seed(seed, 1, w0),
                                         n_iter=griffin_lim_iters)

        it = iter(mel_iter)
        cur = next(it, None)
        while cur is not None:
            nxt = next(it, None)
            seg, _ = cur
            hist = np.concatenate([hist, seg.astype(np.float32)], axis=1)
            base, wav_win = render(hist.shape[1])
            avail_end = base + wav_win.shape[0]
            target_end = min(total, avail_end) if nxt is None else avail_end - crossfade_samples
            if target_end > out_pos:
                chunk = wav_win[out_pos - base:target_end - base].copy()
                n = min(tail.shape[0], chunk.shape[0])
                if n > 0:
                    ramp = np.linspace(0.0, 1.0, n, dtype=np.float32)
                    chunk[:n] = tail[:n] * (1.0 - ramp) + chunk[:n] * ramp
                yield chunk, out_pos
                tail = wav_win[target_end - base:
                               min(target_end + crossfade_samples, avail_end) - base].copy()
                out_pos = target_end
            cur = nxt

    @torch.inference_mode()
    def vocode(self, linear_mel: np.ndarray, seed: int, n_iter: int = 100) -> np.ndarray:
        """Linear mel [n_mels, T] -> waveform: 5x3 average smoothing (5 over
        mel bins, 3 over frames, the mean over in-bounds cells), the inverse
        mel scale, Griffin-Lim from a start phase seeded with ``seed``."""
        mel = self._tensor(linear_mel)[None, None]
        smoothed = F.avg_pool2d(mel, (5, 3), stride=1, padding=(2, 1),
                                count_include_pad=False)[:, 0]
        spec = inverse_mel_scale(smoothed.transpose(1, 2), self.mel_frontend.fbank_pinv)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        wav = griffin_lim(spec, gen, n_fft=self.cfg.n_fft, hop_length=self.cfg.hop_length,
                          win_length=self.cfg.win_length, n_iter=n_iter)
        return wav[0].cpu().numpy()


class ChunkStream:
    """Host-side state machine of ONE long-form stream, so that a scheduler
    can interleave many streams through the batched refine
    (``serving.LongFormScheduler``):

    - ``next_job()`` -> ``(seed, z_chunk [1, S, D], known_mel [1, T, M],
      have_known)``: the next chunk's inputs for
      ``refine_chunk_batch_seeds``; the chunk's result depends on them
      alone, whatever batch it rides in;
    - ``complete(x_ref [1, T, M])`` folds the refined chunk into the
      crossfade accumulator and returns the newly final ``(linear_mel_seg,
      frame_offset)`` increments (possibly none).

    The prep (``stream_prep_async``: encode, every chunk's statistics and
    seed) is dispatched when the stream is built and fetched at its first
    ``next_job()`` or ``complete()``, where the encoder's latent rate is
    checked; after that everything is host numpy around one refine per
    chunk.
    """

    def __init__(self, pipe: LongFormPipeline, wav: np.ndarray, strength: float = 0.6,
                 steps: int = 50, cfg_scale: float = 2.0, seed: int = 0):
        cfg = pipe.cfg
        self.pipe = pipe
        self.wav = np.asarray(wav, np.float32).reshape(1, -1)
        self.total = self.wav.shape[1]
        self.total_frames = self.total // cfg.hop_length + 1
        self.num_chunks = pipe.num_chunks(self.total)
        est_frames = self.total_frames + pipe.chunk_frames
        self.acc = np.zeros((cfg.n_mels, est_frames), np.float32)
        self.wsum = np.zeros((1, est_frames), np.float32)
        fade = pipe.overlap_frames
        self.window = np.ones((1, pipe.chunk_frames), np.float32)
        self.window[0, :fade] = np.linspace(0, 1, fade)
        self.window[0, -fade:] = np.linspace(1, 0, fade)
        self.sem_per_chunk = pipe.chunk_samples // pipe.sem_stride
        self.prev_tail = None
        self.emitted = 0
        self.i = 0
        # Dispatched, not waited for: the prep's results are fetched at the
        # first next_job() or complete().
        self._prep = pipe.stream_prep_async(self.wav, seed)

    def _ensure_prep(self):
        """Fetch the prep and check the encoder's latent rate; the prep is
        kept, and never fetched again, once it passes."""
        if self._prep is None:
            return
        prep = self._prep()
        # An encoder whose latent rate is not pipe.sem_stride would slice the
        # wrong features for every chunk: fail loudly, at every call.  The
        # encode input is the wav padded to a whole latent (or to its bucket).
        n_lat = prep[0].shape[1]
        st = self.pipe.sem_stride
        buckets = self.pipe.prep_buckets
        padded = next((b for b in buckets if b >= self.total), self.total) \
            if buckets else self.total
        expect = (padded + st - 1) // st
        if not 0.5 * expect <= n_lat <= 2.0 * expect:
            raise ValueError(
                f"encoder produced {n_lat} latents for {padded} samples but "
                f"pipe.sem_stride={st} expects ~{expect}: construct LongFormPipeline with "
                f"sem_stride=hubert_cfg.total_stride")
        self.z_q_global, self._mean, self._std, self._seeds = prep
        self._prep = None

    @property
    def done(self) -> bool:
        return self.i >= self.num_chunks

    def next_job(self):
        """Chunk ``i``'s refine inputs (host numpy; ``i`` does not advance)."""
        if self.done:
            raise RuntimeError("stream exhausted")
        self._ensure_prep()
        pipe = self.pipe
        lat0 = self.i * pipe.hop_samples // pipe.sem_stride
        z_chunk = self.z_q_global[:, lat0:lat0 + self.sem_per_chunk, :]
        if z_chunk.shape[1] < self.sem_per_chunk:
            z_chunk = np.pad(z_chunk, ((0, 0), (0, self.sem_per_chunk - z_chunk.shape[1]),
                                       (0, 0)))
        have = self.prev_tail is not None
        if have:
            known_mel = np.pad(self.prev_tail,
                               ((0, 0), (0, pipe.chunk_frames - self.prev_tail.shape[1]), (0, 0)))
        else:
            known_mel = np.zeros((1, pipe.chunk_frames, pipe.cfg.n_mels), np.float32)
        return int(self._seeds[self.i]), z_chunk, known_mel, have

    def complete(self, x_ref: np.ndarray):
        """Fold the refined chunk (host numpy [1, T, M]) in; return the newly
        final increments."""
        self._ensure_prep()
        pipe = self.pipe
        i, num_chunks = self.i, self.num_chunks
        x_ref = np.asarray(x_ref)
        self.prev_tail = x_ref[:, -pipe.overlap_frames:, :]
        lin = np.exp(x_ref * self._std[i:i + 1] + self._mean[i:i + 1]).astype(np.float32)[0].T
        # Boundary chunks keep full weight at the sequence's edges: a fade
        # there has no neighbour, and a weight-0 edge frame would be emitted
        # as silence.
        fade = pipe.overlap_frames
        win = self.window
        if i == 0 or i == num_chunks - 1:
            win = self.window.copy()
            if i == 0:
                win[0, :fade] = 1.0
            if i == num_chunks - 1:
                win[0, -fade:] = 1.0
        f0 = i * pipe.hop_frames
        self.acc[:, f0:f0 + pipe.chunk_frames] += lin * win
        self.wsum[:, f0:f0 + pipe.chunk_frames] += win
        self.i += 1
        # Frames before the next chunk's fade-in are final now.
        final_upto = self.total_frames if i == num_chunks - 1 else f0 + pipe.hop_frames
        final_upto = min(final_upto, self.total_frames)
        out = []
        if final_upto > self.emitted:
            seg = self.acc[:, self.emitted:final_upto] / np.clip(
                self.wsum[:, self.emitted:final_upto], 1e-5, None)
            out.append((seg, self.emitted))
            self.emitted = final_upto
        return out
