"""Micro-batched serving for EdgeInference and the long-form pipeline
(counterpart of ``edge_diffusion_tts_tpu/serving.py``).

- ``MicroBatcher`` gathers token requests into micro-batches (bounded by
  ``max_batch`` and ``max_wait_ms``), pads each to its length **bucket** and
  to ``max_batch`` rows, and runs one masked ``generate_mel`` per batch: the
  decoder excludes padded keys from attention, so at temperature 0 a row's
  valid frames equal its unpadded single-request generation.  At
  temperature > 0 a row's noise depends on the batch it rode in.
- ``LongFormScheduler`` interleaves concurrent long-form streams at chunk
  granularity: each tick runs one batched refine over the next chunk of up
  to ``max_streams`` streams that share a refine signature.  A row's noise
  comes from its own seed, so a stream's mel is its seed's alone, whatever
  shared its ticks (to float32 rounding: ``pipeline.py``).
- ``TTSServer`` speaks the JAX package's newline-delimited-JSON protocol,
  byte for byte: either package's ``request_tts`` / ``request_longform``
  works against either server.

The server runs one batcher thread, one scheduler thread and one handler
thread per client, on one card, or with ``run_server(mesh=N)`` on the
first N cards, every batch's rows split over them.  Every CUDA library is
built and loaded by ``run_server`` before it accepts connections (and the
build is locked: ``_build.py``).  A stream's prep
(``LongFormPipeline.stream_prep_async``) is dispatched by its handler
thread at submit, on the pipeline's side stream, and fetched by the
scheduler at the stream's first tick.
"""

from __future__ import annotations

import collections
import itertools
import json
import queue
import socket
import socketserver
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

import numpy as np


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; raises for oversize requests."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"request of {n} tokens exceeds the largest bucket {max(buckets)}"
    )


class Overloaded(RuntimeError):
    """Raised by MicroBatcher.submit when the predicted queueing delay
    exceeds ``max_queue_delay_ms`` (load shedding: fail fast instead of
    joining an unbounded tail)."""


@dataclass
class _Ticket:
    """One queued request; ``wait()`` blocks until the batch it joined ran."""

    tokens: np.ndarray
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[Exception] = None
    cancelled: bool = False
    enqueued_at: float = 0.0  # time.monotonic at submit
    queue_delay_ms: float = 0.0  # set when its batch dispatches

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            # Nobody will read the result: mark the ticket so the worker
            # drops it instead of spending a batch row + device time on it
            # (best-effort — a ticket already inside a running batch still
            # completes).
            self.cancelled = True
            raise TimeoutError("generation did not complete in time")
        if self.error is not None:
            raise self.error
        return self.result


class MicroBatcher:
    """Gathers requests into shape-bucketed, fixed-size padded batches.

    ``generate_fn(sem_idx, sem_mask) -> mel`` is called with
    ``sem_idx: int32 [max_batch, bucket]`` and ``sem_mask: bool`` of the same
    shape; it returns ``[max_batch, 2 * bucket, n_mels]`` (EdgeInference
    .generate_mel with ``sem_mask=...`` has exactly this contract).  Rows
    beyond the live requests are padding; row i of the result is cropped to
    ``2 * len(tokens_i)`` frames before being handed back.
    """

    def __init__(
        self,
        generate_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
        buckets: Sequence[int] = (128, 256, 512, 1024),
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        pad_token: int = 0,
        max_queue_delay_ms: Optional[float] = None,
    ):
        self.generate_fn = generate_fn
        self.buckets = tuple(sorted(buckets))
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.pad_token = int(pad_token)
        # SLO knob: bound the queueing-delay tail.  When set, (a) submit()
        # sheds load (raises Overloaded) once the PREDICTED delay —
        # queue depth ahead of the request, in batches, times the running
        # mean batch time — exceeds the bound, and (b) dispatch order is
        # oldest-ticket-first across bucket groups so a big-bucket straggler
        # is not starved behind a stream of small-bucket batches.  Batching
        # cannot create device capacity; bounding p99 at saturation means
        # refusing work that would miss the SLO anyway (the client sees a
        # clean Overloaded instead of a late result).
        self.max_queue_delay_ms = (
            float(max_queue_delay_ms) if max_queue_delay_ms else None
        )
        self._queue: "queue.Queue[_Ticket]" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()  # orders submit() against close()
        self.batches_run = 0  # observability; tests assert batching happened
        self.requests_served = 0  # == live rows summed over batches
        self.device_ms_total = 0.0  # wall time inside generate_fn
        self.shed_count = 0  # submits refused by the SLO bound
        # per-bucket {bucket: [batches, rows]} — starvation/fairness
        # visibility under mixed-length traffic
        self.bucket_counts: Dict[int, list] = {}
        self._delays = collections.deque(maxlen=1024)  # recent queue delays
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def reset_stats(self):
        """Zero the serving counters (e.g. after the warmup)."""
        self.batches_run = 0
        self.requests_served = 0
        self.device_ms_total = 0.0
        self.shed_count = 0
        self.bucket_counts = {}
        self._delays.clear()

    def predicted_delay_ms(self) -> float:
        """Expected queueing delay for a request submitted NOW: batches
        ahead of it (current depth, in program-sized groups, plus the one
        in flight) times the running mean batch time."""
        if self.batches_run == 0:
            return 0.0  # no signal until the first batch ran (post-warmup)
        mean_batch = self.device_ms_total / self.batches_run
        batches_ahead = self._queue.qsize() / self.max_batch + 1
        return batches_ahead * mean_batch

    def stats(self) -> dict:
        """Serving counters: batch occupancy is the throughput lever."""
        b = max(self.batches_run, 1)
        out = {
            "requests_served": self.requests_served,
            "batches_run": self.batches_run,
            "mean_batch_occupancy": round(
                self.requests_served / (b * self.max_batch), 3
            ),
            "mean_batch_ms": round(self.device_ms_total / b, 3),
            "queue_depth": self._queue.qsize(),
            "shed_count": self.shed_count,
            "per_bucket": {
                str(k): {
                    "batches": v[0],
                    "rows": v[1],
                    "occupancy": round(v[1] / (v[0] * self.max_batch), 3),
                }
                for k, v in sorted(self.bucket_counts.items())
            },
        }
        if self._delays:
            d = np.sort(np.asarray(self._delays))
            out["queue_delay_ms"] = {
                "p50": round(float(np.percentile(d, 50)), 1),
                "p95": round(float(np.percentile(d, 95)), 1),
                "p99": round(float(np.percentile(d, 99)), 1),
                "max": round(float(d[-1]), 1),
            }
        return out

    # -- client side ------------------------------------------------------

    def submit(self, tokens: np.ndarray) -> _Ticket:
        """Enqueue one request (1-D int token array); returns its ticket.

        With ``max_queue_delay_ms`` set, raises :class:`Overloaded` when the
        predicted queueing delay already exceeds the bound — fail fast at
        admission instead of serving a result the client stopped waiting
        for."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1 or tokens.size == 0:
            raise ValueError("tokens must be a non-empty 1-D int array")
        pick_bucket(tokens.size, self.buckets)  # validate size up front
        if (
            self.max_queue_delay_ms is not None
            and self.predicted_delay_ms() > self.max_queue_delay_ms
        ):
            self.shed_count += 1
            raise Overloaded(
                f"predicted queue delay {self.predicted_delay_ms():.0f} ms "
                f"exceeds max_queue_delay_ms={self.max_queue_delay_ms:.0f}"
            )
        t = _Ticket(tokens, enqueued_at=time.monotonic())
        # Check-and-put under the lock: a submit racing close() must either
        # raise here or have its ticket visible to close()'s drain — never
        # land in a dead queue after the drain already ran.
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.put(t)
        return t

    def generate(self, tokens: np.ndarray, timeout: float = 300.0) -> np.ndarray:
        """Blocking convenience wrapper: submit + wait."""
        return self.submit(tokens).wait(timeout)

    def close(self):
        with self._lock:
            self._closed = True
            self._queue.put(None)  # wake the worker
        self._worker.join(timeout=10.0)
        # Fail anything still queued so no client blocks until its timeout.
        while True:
            try:
                t = self._queue.get_nowait()
            except queue.Empty:
                break
            if t is not None:
                t.error = RuntimeError("MicroBatcher closed")
                t.done.set()

    # -- worker side ------------------------------------------------------

    def _gather(self) -> list:
        """Block for the first request, then drain more until the batching
        window closes or enough tickets arrived to fill every bucket's
        program.  The limit is max_batch PER BUCKET, not overall: mixed-
        bucket traffic split by _loop would otherwise run systematically
        half-empty programs while same-bucket requests sat in the queue."""
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        limit = self.max_batch * len(self.buckets)
        while len(batch) < limit:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                t = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if t is None:
                self._queue.put(None)  # re-signal shutdown after this batch
                break
            batch.append(t)
        return batch

    def _run_bucket(self, tickets: list, bucket: int):
        B = self.max_batch
        sem_idx = np.full((B, bucket), self.pad_token, np.int32)
        sem_mask = np.zeros((B, bucket), bool)
        now = time.monotonic()
        for i, t in enumerate(tickets):
            sem_idx[i, : t.tokens.size] = t.tokens
            sem_mask[i, : t.tokens.size] = True
            t.queue_delay_ms = (now - t.enqueued_at) * 1e3
            self._delays.append(t.queue_delay_ms)
        try:
            t0 = time.monotonic()
            mel = np.asarray(self.generate_fn(sem_idx, sem_mask))
            self.device_ms_total += (time.monotonic() - t0) * 1e3
            self.batches_run += 1
            self.requests_served += len(tickets)
            bc = self.bucket_counts.setdefault(bucket, [0, 0])
            bc[0] += 1
            bc[1] += len(tickets)
            for i, t in enumerate(tickets):
                # copy(): a view would pin the whole padded batch array in
                # memory until every client released its crop
                t.result = mel[i, : 2 * t.tokens.size].copy()
                t.done.set()
        except Exception as e:  # surface the failure on every ticket
            for t in tickets:
                t.error = e
                t.done.set()

    def _loop(self):
        while not self._closed:
            batch = self._gather()
            if not batch:
                continue
            try:
                by_bucket: dict = {}
                for t in batch:
                    if t.cancelled:
                        # The client's wait() already timed out: don't spend
                        # a batch row + device time on a result nobody reads.
                        continue
                    by_bucket.setdefault(
                        pick_bucket(t.tokens.size, self.buckets), []
                    ).append(t)
                # Oldest-first across bucket groups: a straggler in one
                # bucket must not wait behind every other bucket's program
                # just because its bucket sorts last (tail bound).
                order = sorted(
                    by_bucket,
                    key=lambda b: min(t.enqueued_at for t in by_bucket[b]),
                )
                for bucket in order:
                    group = by_bucket[bucket]
                    # max_batch rows per program: split oversized groups
                    for i in range(0, len(group), self.max_batch):
                        self._run_bucket(group[i : i + self.max_batch], bucket)
            except Exception as e:  # defensive: a worker crash must not
                for t in batch:     # leave clients blocked until timeout
                    if not t.done.is_set():
                        t.error = e
                        t.done.set()


# -- streaming long-form ----------------------------------------------------


@dataclass
class _LFStream:
    """One live long-form stream inside the scheduler."""

    chunk: object  # pipeline.ChunkStream
    group: tuple  # (steps, strength, cfg_scale): the refine's signature
    out: queue.Queue = field(default_factory=lambda: queue.Queue(maxsize=256))
    cancelled: bool = False
    error: Optional[Exception] = None

    def emit(self, item) -> None:
        """Hand an increment to the consumer WITHOUT blocking the scheduler:
        a consumer that stopped draining (but kept the stream open) fills
        its queue and is cancelled instead of stalling every other stream's
        tick."""
        try:
            self.out.put_nowait(item)
        except queue.Full:
            self.cancelled = True
            self.error = RuntimeError("long-form consumer stopped draining increments")

    def finish(self, err: Optional[Exception]) -> None:
        if err is not None:
            self.error = err
        try:
            self.out.put_nowait(None)
        except queue.Full:  # consumer gone; drain() checks error anyway
            self.cancelled = True


class LongFormScheduler:
    """Continuous batching of concurrent long-form streams.

    A long-form request arrives as a whole utterance and is generated chunk
    by chunk (``pipeline.ChunkStream``).  Each tick gathers the next chunk
    of up to ``max_streams`` live streams that share a refine signature
    (steps, strength, cfg_scale), first chunks first, and runs ONE batched
    refine (``refine_chunk_batch_seeds``) over those rows.  Streams join and
    leave between ticks.  Rows are computed independently from their own
    seeds, so a stream's mel equals its solo generation whatever shared its
    ticks, to the float32 rounding of the tick's row count (cuBLAS picks
    its kernels by shape; ``pipeline.py``).
    """

    def __init__(self, pipe, max_streams: int = 4):
        self.pipe = pipe
        self.max_streams = int(max_streams)
        # Under a mesh the refine splits rows over its devices: every tick's
        # row count is padded to that quantum, and full ticks must fit it.
        self.row_quantum = int(getattr(pipe, "row_quantum", 1))
        if self.max_streams % self.row_quantum:
            raise ValueError(f"max_streams={max_streams} must be a multiple of the pipeline's "
                             f"row_quantum={self.row_quantum} (the mesh's device count)")
        self._inbox: "queue.Queue[Optional[_LFStream]]" = queue.Queue()
        self._active: list = []
        self._closed = False
        self.batches_run = 0
        self.chunks_run = 0  # live rows summed over ticks
        self.device_ms_total = 0.0  # wall time of the ticks' refines
        self.tick_ms: Dict[int, list] = {}  # rows -> each tick's refine ms
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def stats(self) -> dict:
        b = max(self.batches_run, 1)
        return {
            "streams_active": len(self._active),
            "batches_run": self.batches_run,
            "chunks_run": self.chunks_run,
            "mean_row_occupancy": round(self.chunks_run / (b * self.max_streams), 3),
            "mean_batch_ms": round(self.device_ms_total / b, 3),
            "tick_ms_by_rows": {str(n): round(float(np.mean(v)), 3)
                                for n, v in sorted(self.tick_ms.items())},
        }

    def reset_stats(self) -> None:
        self.batches_run = self.chunks_run = 0
        self.device_ms_total = 0.0
        self.tick_ms = {}

    def warmup(self, steps: int = 50, strength: float = 0.6, cfg_scale: float = 2.0) -> None:
        """One refine at every batch shape a tick can form (1 to
        ``max_streams`` rows) at this signature, so that no live tick pays a
        first call's library setup."""
        pipe = self.pipe
        T, M = pipe.chunk_frames, pipe.cfg.n_mels
        S, D = pipe.chunk_samples // pipe.sem_stride, pipe.cfg.semantic_dim
        for B in range(1, self.max_streams + 1):
            pipe.refine_chunk_batch_seeds(
                np.arange(B), np.zeros((B, S, D), np.float32), np.zeros((B, T, M), np.float32),
                np.zeros((B,), bool), strength=float(strength), steps=int(steps),
                cfg_scale=float(cfg_scale)).cpu()

    # -- client side --------------------------------------------------------

    def submit(self, wav: np.ndarray, *, steps: int = 50, strength: float = 0.6,
               cfg_scale: float = 2.0, seed: int = 0):
        """Enqueue one stream; returns an iterator of (mel_seg, frame_offset).

        The stream's prep (encode, chunk statistics, seeds) is dispatched
        here, in the caller's thread, and not waited for: the scheduler
        fetches it at the stream's first tick, and a prep that fails there
        fails that stream alone.  Abandoning the iterator (close, GC, a
        transport error) cancels the stream: its remaining chunks are never
        scheduled.
        """
        from .pipeline import ChunkStream

        if self._closed:
            raise RuntimeError("LongFormScheduler is closed")
        chunk = ChunkStream(self.pipe, wav, strength=float(strength), steps=int(steps),
                            cfg_scale=float(cfg_scale), seed=int(seed))
        s = _LFStream(chunk, group=(int(steps), float(strength), float(cfg_scale)))
        self._inbox.put(s)

        def drain():
            try:
                while True:
                    try:
                        item = s.out.get(timeout=1.0)
                    except queue.Empty:
                        # A stream cancelled while its queue was full never
                        # gets a sentinel: surface the error here.
                        if s.cancelled:
                            raise s.error or RuntimeError("stream cancelled")
                        continue
                    if item is None:
                        if s.error is not None:
                            raise s.error
                        return
                    yield item
            finally:
                s.cancelled = True  # stop scheduling if abandoned mid-stream

        return drain()

    def close(self):
        self._closed = True
        self._inbox.put(None)  # wake the worker
        self._worker.join(timeout=10.0)
        err = RuntimeError("LongFormScheduler closed")
        for s in self._active:
            s.finish(err)
        self._active = []
        while True:
            try:
                s = self._inbox.get_nowait()
            except queue.Empty:
                break
            if s is not None:
                s.finish(err)

    # -- worker side --------------------------------------------------------

    def _absorb(self, block: bool):
        if block:
            try:
                # Short idle poll: its timeout adds straight to a fresh
                # stream's time to first increment.
                s = self._inbox.get(timeout=0.01)
            except queue.Empty:
                return
            if s is not None:
                self._active.append(s)
        while True:
            try:
                s = self._inbox.get_nowait()
            except queue.Empty:
                return
            if s is not None:
                self._active.append(s)

    def _tick(self):
        self._absorb(block=not self._active)
        self._active = [s for s in self._active if not s.cancelled]
        if not self._active:
            return
        group = self._active[0].group
        batch = [s for s in self._active if s.group == group]
        # First chunks first (stable sort): a fresh stream's chunk 0 must not
        # wait behind established streams' later chunks.
        batch.sort(key=lambda s: s.chunk.i > 0)
        batch = batch[:self.max_streams]
        for s in batch:  # a fresh stream's prep, fetched here, fails it alone
            try:
                s.chunk._ensure_prep()
            except Exception as e:
                s.finish(e)
                s.cancelled = True
        self._active = [s for s in self._active if not s.cancelled]
        batch = [s for s in batch if not s.cancelled]
        if not batch:
            return
        try:
            self._run_batch(batch, group)
        except Exception as e:  # fail the batch's streams, keep serving
            for s in batch:
                s.finish(e)
                s.cancelled = True
        finished = {id(s) for s in batch if s.chunk.done or s.cancelled}
        for s in batch:
            if s.chunk.done and not s.cancelled:
                s.finish(None)
        served = {id(s) for s in batch}
        remaining = [s for s in self._active if id(s) not in finished]
        # Served streams go to the back: other signature groups (and late
        # joiners) get the next tick.
        self._active = ([s for s in remaining if id(s) not in served]
                        + [s for s in remaining if id(s) in served])

    def _run_batch(self, batch: list, group: tuple):
        steps, strength, cfg_scale = group
        jobs = [s.chunk.next_job() for s in batch]
        t0 = time.monotonic()
        x_ref = self.pipe.refine_chunk_batch_seeds(
            np.asarray([j[0] for j in jobs], np.int64),
            np.concatenate([j[1] for j in jobs]), np.concatenate([j[2] for j in jobs]),
            np.asarray([j[3] for j in jobs]),
            strength=strength, steps=steps, cfg_scale=cfg_scale).cpu().numpy()
        ms = (time.monotonic() - t0) * 1e3
        self.device_ms_total += ms
        self.tick_ms.setdefault(len(jobs), []).append(ms)
        self.batches_run += 1
        self.chunks_run += len(jobs)
        for i, s in enumerate(batch):
            for seg, off in s.chunk.complete(x_ref[i:i + 1]):
                s.emit((seg, off))

    def _loop(self):
        while not self._closed:
            try:
                self._tick()
            except Exception:
                # _tick routes batch errors to their streams; one here is a
                # scheduler fault, which must not strand every later stream.
                time.sleep(0.01)


def make_longform_fn(pipe, max_streams: int = 4) -> Callable:
    """Adapt a ``LongFormPipeline`` to the server's long-form contract,
    batching concurrent streams through a ``LongFormScheduler``.

    Returns ``fn(wav [T], opts) -> iterator of (increment, offset)``: linear
    mel increments [n_mels, F] at frame offsets by default, waveform
    increments at sample offsets with ``opts["audio"]``.  ``opts["seed"]``
    pins the stream's randomness (the port's seeds, not the JAX package's),
    and the result equals an unbatched ``pipe.generate`` with that seed (to
    the float32 rounding of the ticks' row counts).
    The scheduler is ``fn.scheduler`` (stats, close).
    """
    sched = LongFormScheduler(pipe, max_streams=max_streams)

    def fn(wav: np.ndarray, opts: dict):
        seed = int(opts.get("seed", 0))
        mel_iter = sched.submit(
            wav, steps=int(opts.get("steps", 50)), strength=float(opts.get("strength", 0.6)),
            cfg_scale=float(opts.get("cfg_scale", 2.0)), seed=seed)
        if opts.get("audio"):
            # The vocoder runs in the caller's (handler) thread, per stream.
            return pipe.stream_audio(mel_iter, total=int(np.asarray(wav).size), seed=seed,
                                     griffin_lim_iters=int(opts.get("griffin_lim_iters", 50)))
        return mel_iter

    fn.scheduler = sched
    return fn


# -- TCP transport ---------------------------------------------------------


class _Handler(socketserver.StreamRequestHandler):
    def _send(self, resp: dict):
        self.wfile.write((json.dumps(resp) + "\n").encode())
        self.wfile.flush()

    def _handle_longform(self, req: dict):
        import base64

        fn = self.server.longform_fn
        if fn is None:
            raise RuntimeError(
                "server was not started with long-form support "
                "(serve --longform)"
            )
        if "wav_b64" in req:
            wav = np.frombuffer(base64.b64decode(req["wav_b64"]), "<f4")
        else:
            wav = np.asarray(req["wav"], np.float32)
        if wav.size == 0:
            raise ValueError("longform request carries no audio")
        n = 0
        # Concurrent long-form streams batch at chunk granularity through
        # the LongFormScheduler (one batched refine program serves them
        # all), so no device lock is needed — each handler thread just
        # drains its own stream's increments as they finalize.
        for seg, offset in fn(wav, req):
            seg = np.ascontiguousarray(np.asarray(seg, "<f4"))
            self._send({
                "seg_b64": base64.b64encode(seg.tobytes()).decode("ascii"),
                "shape": list(seg.shape),
                "offset": int(offset),
            })
            n += 1
        self._send({"done": True, "segments": n})

    def handle(self):
        for line in self.rfile:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                if req.get("stats"):
                    resp = {"stats": self.server.batcher.stats()}
                    sched = getattr(self.server.longform_fn, "scheduler", None)
                    if sched is not None:
                        resp["longform"] = sched.stats()
                    self.wfile.write((json.dumps(resp) + "\n").encode())
                    self.wfile.flush()
                    continue
                if "longform" in req:
                    # Streamed response: one line per finalized increment,
                    # then a {"done": true} terminator (protocol in the
                    # TTSServer docstring).  Mid-stream failures fall
                    # through to the shared error line below, which the
                    # client treats as the stream terminator.
                    self._handle_longform(req["longform"])
                    continue
                mel = self.server.batcher.generate(
                    np.asarray(req["tokens"], np.int32),
                    timeout=float(req.get("timeout", 300.0)),
                )
                mel = np.asarray(mel, np.float32)
                if req.get("binary"):
                    # ~7x smaller and no float->decimal->float loss: raw
                    # little-endian f32 frames, base64 on the JSON line.
                    import base64

                    resp = {
                        "mel_b64": base64.b64encode(
                            np.ascontiguousarray(mel, "<f4").tobytes()
                        ).decode("ascii"),
                        "shape": list(mel.shape),
                    }
                else:
                    resp = {"mel": mel.tolist()}
            except Exception as e:
                resp = {"error": f"{type(e).__name__}: {e}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class TTSServer(socketserver.ThreadingTCPServer):
    """Newline-delimited-JSON TCP front-end over a MicroBatcher.

    Protocol: one request per line
    ``{"tokens": [...], "timeout": s?, "binary": bool?}`` -> one response
    line ``{"mel": [[...], ...]}`` (frames x n_mels), or with
    ``binary`` ``{"mel_b64": <base64 of raw little-endian f32>,
    "shape": [frames, n_mels]}`` (~7x smaller, bit-exact), or
    ``{"error": "..."}``.  ``{"stats": true}`` returns the serving
    counters.  Concurrent connections share the batcher, so simultaneous
    requests ride the same device program.

    Long-form streaming (when started with a ``longform_fn``):
    ``{"longform": {"wav_b64": <b64 raw f32 @16k>, "audio": bool?,
    "steps": n?, "strength": s?, "cfg_scale": c?, "seed": k?}}`` streams
    one line per finalized increment —
    ``{"seg_b64": ..., "shape": [...], "offset": n}`` (linear mel
    ``[n_mels, F]`` at frame offsets, or 1-D waveform at sample offsets
    with ``audio``) — terminated by ``{"done": true, "segments": k}``.
    A mid-stream failure terminates with ``{"error": ...}`` instead.
    Concurrent long-form requests are continuously batched at chunk
    granularity (``LongFormScheduler``); results are seed-reproducible
    regardless of what shared their batch.
    """

    allow_reuse_address = True
    daemon_threads = True
    # Accept-backlog sized for bursty connection-per-request clients: the
    # socketserver default (5) overflows the SYN queue under concurrent
    # load, and the kernel retransmits after 1 s.
    request_queue_size = 128

    def __init__(self, addr, batcher: MicroBatcher, longform_fn=None):
        super().__init__(addr, _Handler)
        self.batcher = batcher
        self.longform_fn = longform_fn

    def shutdown(self):
        super().shutdown()
        sched = getattr(self.longform_fn, "scheduler", None)
        if sched is not None:
            sched.close()


def serve_tcp(
    batcher: MicroBatcher,
    host: str = "127.0.0.1",
    port: int = 7455,
    longform_fn=None,
) -> TTSServer:
    """Start serving in a background thread; returns the server (``.shutdown()``
    to stop).  Port 0 picks a free port (``server.server_address``)."""
    server = TTSServer((host, port), batcher, longform_fn=longform_fn)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def run_server(
    checkpoint: str,
    host: str = "127.0.0.1",
    port: int = 7455,
    steps: Optional[int] = None,
    buckets: Sequence[int] = (128, 256, 512, 1024),
    max_batch: int = 8,
    max_wait_ms: float = 5.0,
    max_queue_delay_ms: Optional[float] = None,
    sampler: str = "ddim",
    mesh: int = 0,
    warmup: bool = True,
    verbose: bool = True,
    seed: int = 0,
    longform: bool = False,
    longform_streams: int = 4,
    chunk_seconds: float = 2.0,
    overlap_seconds: float = 0.5,
    longform_prep_buckets: Sequence[float] = (8.0, 16.0, 32.0, 64.0),
    device=None,
):
    """A port checkpoint -> warmed MicroBatcher + live TCP server.

    ``checkpoint`` is a directory written by ``weights.save_checkpoint``
    (``cfg.json``, ``decoder.pt``; with ``longform`` also ``hubert.json``
    and ``encoder.pt``).  Returns ``(server, batcher)``; the caller owns
    shutdown (``server.shutdown(); batcher.close()``).  Buckets beyond the
    checkpoint's positional capacity are dropped up front.  The decoder's
    output is read per the checkpoint's objective (``cfg.use_v_prediction``).
    Runs on ``device`` (the card unless told otherwise).  ``mesh=N`` shards
    every micro-batch's rows (and, with ``longform``, every refine's) over
    the first N CUDA devices (``parallel.make_dp_generate``); ``max_batch``
    (and ``longform_streams``) must divide by N.

    Seeds: a batch's start noise comes from a torch generator seeded with
    ``fold_seed(seed, n)`` for the server's n-th batch, so repeated requests
    draw new samples.  These are torch streams, not JAX's: the same seed
    gives a different mel here than on the JAX package's server, and no
    seed-for-seed parity between the two is claimed.
    """
    import torch

    from .inference import EdgeInference
    from .models import EdgeDiffusionDecoder
    from .pipeline import fold_seed
    from .schedule import DiffusionSchedule
    from .weights import load_checkpoint

    def say(msg):
        if verbose:
            print(msg, flush=True)

    mesh_devices = None
    if mesh:
        if max_batch % mesh:
            raise ValueError("max_batch must be divisible by mesh")
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < mesh:
            raise ValueError(f"mesh={mesh} shards over {mesh} CUDA devices; {found} found")
        mesh_devices = [torch.device("cuda", i) for i in range(mesh)]
        if device is not None and torch.device(device) not in (torch.device("cuda"),
                                                               mesh_devices[0]):
            raise ValueError(f"mesh={mesh} serves from cuda:0 to cuda:{mesh - 1}, "
                             f"not device={device!r}")
        device = mesh_devices[0]
    cfg, dec_state, hubert_cfg, enc_state = load_checkpoint(checkpoint, with_encoder=longform)
    decoder = EdgeDiffusionDecoder(cfg)
    decoder.load_state_dict(dec_state)
    schedule = DiffusionSchedule.create(cfg.diff_steps)
    inf = EdgeInference(cfg, schedule, decoder, sampler=sampler,
                        prediction="v" if cfg.use_v_prediction else "eps", device=device)
    steps = steps if steps is not None else cfg.inference_steps
    if steps <= 0:
        raise ValueError(f"steps must be positive, got {steps}")
    batch_counter = itertools.count()

    cap = min(cfg.max_ctx_positions, cfg.max_mel_positions // 2)
    dropped = tuple(b for b in buckets if b > cap)
    buckets = tuple(b for b in buckets if b <= cap)
    if dropped:
        say(f"serve: dropping buckets {dropped} beyond this checkpoint's positional "
            f"capacity ({cap} tokens)")
    if not buckets:
        raise ValueError(f"no serve bucket fits the checkpoint's positional capacity "
                         f"({cap} tokens): pass smaller buckets")

    generate = inf.generate_mel
    if mesh_devices is not None:
        from .parallel import make_dp_generate

        generate = make_dp_generate(inf, mesh_devices, masked=True)

    def generate_fn(sem_idx, sem_mask):
        # Only the batcher's worker thread calls this, one batch at a time.
        g = torch.Generator(device=inf.device).manual_seed(fold_seed(seed, next(batch_counter)))
        return generate(sem_idx, num_steps=steps, generator=g, sem_mask=sem_mask).cpu().numpy()

    longform_fn = pipe = None
    if longform:
        from .models import SemanticEncoder
        from .pipeline import LongFormPipeline

        encoder = SemanticEncoder(cfg, hubert_cfg)
        encoder.load_state_dict(enc_state)
        pipe = LongFormPipeline(
            cfg, schedule, inf.decoder, encoder, chunk_seconds=chunk_seconds,
            overlap_seconds=overlap_seconds,
            prep_buckets=[int(s * cfg.sample_rate) for s in longform_prep_buckets]
            if longform_prep_buckets else None,
            # Chunk -> latent slicing follows the checkpoint's conv stack.
            sem_stride=hubert_cfg.total_stride, device=inf.device, mesh=mesh_devices)
        longform_fn = make_longform_fn(pipe, max_streams=longform_streams)

    if inf.device.type == "cuda":
        # Build and load every CUDA library before any thread can reach one.
        from .ops import fused_denoise, fused_frontend, window_attention

        for mod in (fused_denoise, fused_frontend, window_attention):
            mod._lib()
        say("serve: CUDA kernels built and loaded")
    batcher = MicroBatcher(generate_fn, buckets=buckets, max_batch=max_batch,
                           max_wait_ms=max_wait_ms, max_queue_delay_ms=max_queue_delay_ms)
    batcher.inference = inf
    if warmup:
        for b in buckets:  # a length-b request runs bucket b's shape
            batcher.generate([1] * b, timeout=3600.0)
            say(f"serve: bucket {b} warm")
        batcher.reset_stats()
        if longform:
            longform_fn.scheduler.warmup()
            longform_fn.scheduler.reset_stats()
            say(f"serve: long-form refine warm (rows 1 to {longform_streams})")
            # Through the side stream: its cuBLAS workspace and cuDNN plans
            # are made here, before the server accepts a connection.
            for b in pipe.prep_buckets or ():
                pipe.stream_prep(np.zeros((1, b), np.float32), 0)
                say(f"serve: long-form prep bucket {b} warm")
    server = serve_tcp(batcher, host=host, port=port, longform_fn=longform_fn)
    say(f"serving on {server.server_address[0]}:{server.server_address[1]} "
        f"(steps={steps}, buckets={buckets}, max_batch={max_batch}, device={inf.device})")
    return server, batcher


def request_tts(
    tokens: Sequence[int], host: str = "127.0.0.1", port: int = 7455,
    timeout: float = 300.0, binary: bool = True,
) -> np.ndarray:
    """Minimal client for the line-JSON protocol; returns mel [frames, n_mels].

    ``binary`` (default) transports the mel as base64 raw f32 — ~7x smaller
    than decimal float lists and bit-exact; set False for the plain-JSON
    form (e.g. non-numpy consumers).
    """
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(
            (json.dumps({"tokens": list(map(int, tokens)),
                         "timeout": timeout, "binary": binary}) + "\n").encode()
        )
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(1 << 20)
            if not chunk:
                break
            buf += chunk
    resp = json.loads(buf.decode())
    if "error" in resp:
        raise RuntimeError(resp["error"])
    if "mel_b64" in resp:
        import base64

        # copy(): frombuffer views are read-only; both transports must
        # return equally writable arrays.
        return np.frombuffer(
            base64.b64decode(resp["mel_b64"]), "<f4"
        ).reshape(resp["shape"]).copy()
    return np.asarray(resp["mel"], np.float32)


def request_longform(
    wav: np.ndarray,
    host: str = "127.0.0.1",
    port: int = 7455,
    timeout: float = 3600.0,
    audio: bool = False,
    **opts,
):
    """Stream a long-form generation; yields (increment, offset) live.

    ``wav`` is the source waveform at the model rate (f32, 16 kHz default).
    Yields linear-mel increments ``[n_mels, F]`` at frame offsets, or — with
    ``audio=True`` — playable 1-D waveform increments at sample offsets, as
    each becomes final on the server (TTSServer long-form protocol).  Extra
    ``opts`` pass through: steps, strength, cfg_scale, seed,
    griffin_lim_iters.
    """
    import base64

    wav = np.ascontiguousarray(np.asarray(wav, "<f4").reshape(-1))
    req = {"longform": dict(
        opts, wav_b64=base64.b64encode(wav.tobytes()).decode("ascii"),
        audio=bool(audio),
    )}
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while True:
            nl = buf.find(b"\n")
            if nl < 0:
                chunk = s.recv(1 << 20)
                if not chunk:
                    raise ConnectionError(
                        "server closed the long-form stream mid-way"
                    )
                buf += chunk
                continue
            line, buf = buf[:nl], buf[nl + 1:]
            resp = json.loads(line.decode())
            if "error" in resp:
                raise RuntimeError(resp["error"])
            if resp.get("done"):
                return
            seg = np.frombuffer(
                base64.b64decode(resp["seg_b64"]), "<f4"
            ).reshape(resp["shape"]).copy()
            yield seg, int(resp["offset"])
