"""Admission queue + request batching for LLM backends.

The service's coalescing table already collapses concurrent requests for the
*same* cell into one backend call; this module handles the orthogonal case —
concurrent requests for *different* cells on the same model.  A
``BatchingBackend`` wraps any ``LLMBackend`` and funnels its ``generate``
calls through a bounded admission queue drained by one worker thread: the
worker takes the oldest pending request, waits up to ``max_wait`` seconds for
companions (up to ``max_batch``), and issues one batched backend call for the
group (``generate_batch`` when the inner backend has real batched inference,
e.g. ``EngineBackend``'s single padded prefill; a per-item loop otherwise).

Admission control is the back-pressure story for the HTTP frontend: when
``max_pending`` requests are already queued, new arrivals are rejected with
:class:`AdmissionError` — the server maps that to ``503`` so clients retry
with backoff instead of piling onto an overloaded process.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time

from repro_torch.core.backends import LLMBackend, LLMBusyError, LLMResponse
from repro_torch.obs import trace as obs_trace


class AdmissionError(LLMBusyError):
    """The admission queue is full — shed load instead of queueing unboundedly.

    Subclasses :class:`LLMBusyError` so every admission-control path in the
    stack (threaded batcher, continuous batcher, async frontend) speaks one
    retryable error type that the wire layer maps to 503."""


@dataclasses.dataclass
class BatchStats:
    """Counters for one model's batching queue."""

    requests: int = 0        # admitted generate() calls
    rejected: int = 0        # refused at admission (queue full)
    batches: int = 0         # backend calls issued
    batched_requests: int = 0  # requests that shared a call with >=1 other
    max_batch_seen: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Pending:
    __slots__ = ("prompt", "meta", "event", "response", "error")

    def __init__(self, prompt: str, meta: dict):
        self.prompt = prompt
        self.meta = meta
        self.event = threading.Event()
        self.response: LLMResponse | None = None
        self.error: BaseException | None = None


class BatchingBackend:
    """LLMBackend adapter: same ``generate`` surface, batched execution.

    Transparent to the cache layer — ``name`` and ``cache_fingerprint``
    proxy to the wrapped backend, so content addresses are identical with
    and without batching."""

    def __init__(self, inner: LLMBackend, max_batch: int = 8,
                 max_wait: float = 0.01, max_pending: int = 256):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.inner = inner
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.stats = BatchStats()
        self._queue: "queue.Queue[_Pending]" = queue.Queue(maxsize=max_pending)
        self._mu = threading.Lock()
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()

    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def cache_fingerprint(self):
        return getattr(self.inner, "cache_fingerprint", None)

    # -- client side -------------------------------------------------------
    def generate(self, prompt: str, *, meta: dict) -> LLMResponse:
        if self._stop.is_set():
            raise AdmissionError(f"batching queue for {self.name!r} is closed")
        item = _Pending(prompt, meta)
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            with self._mu:
                self.stats.rejected += 1
            raise AdmissionError(
                f"admission queue full ({self._queue.maxsize} pending) for "
                f"model {self.name!r}") from None
        with self._mu:
            self.stats.requests += 1
            self._ensure_worker()
        # poll-wait so a close() racing this admission can never strand us:
        # close() drains the queue with errors, and anything it missed is
        # caught by the stop-flag check here
        with obs_trace.span("batch_wait", model=self.name):
            while not item.event.wait(0.1):
                if self._stop.is_set() and not item.event.is_set():
                    raise AdmissionError(
                        f"batching queue for {self.name!r} closed "
                        "while waiting")
        if item.error is not None:
            raise item.error
        return item.response  # type: ignore[return-value]

    # -- worker side -------------------------------------------------------
    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._drain, name=f"batcher-{self.name}", daemon=True)
            self._worker.start()

    def _collect(self) -> list[_Pending]:
        """Oldest pending request + companions arriving within max_wait.

        A full batch dispatches the instant the ``max_batch``-th request is in
        hand: already-queued companions are drained without blocking first, and
        the deadline loop is only entered for the remaining free slots — a
        burst of ``max_batch`` arrivals never sleeps out ``max_wait``."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        # eager pass: take whatever is already waiting, no timer involved
        while len(batch) < self.max_batch:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        if len(batch) >= self.max_batch:
            return batch
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _drain(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            with self._mu:
                self.stats.batches += 1
                self.stats.max_batch_seen = max(self.stats.max_batch_seen,
                                                len(batch))
                if len(batch) > 1:
                    self.stats.batched_requests += len(batch)
            try:
                t0 = time.monotonic()
                responses = self._run(batch)
                dt = time.monotonic() - t0
                for item, resp in zip(batch, responses):
                    item.response = resp
                    # the drain thread serves many requests, so attribution
                    # goes through each item's meta-carried trace snapshot
                    obs_trace.record_for_meta(
                        item.meta, "engine_generate", dt, batch=len(batch),
                        model=self.name)
            except BaseException as e:  # noqa: BLE001 — fan the error out
                for item in batch:
                    item.error = e
            finally:
                for item in batch:
                    item.event.set()

    def _run(self, batch: list[_Pending]) -> list[LLMResponse]:
        gen_batch = getattr(self.inner, "generate_batch", None)
        if gen_batch is not None and len(batch) > 1:
            return gen_batch([i.prompt for i in batch],
                             [i.meta for i in batch])
        return [self.inner.generate(i.prompt, meta=i.meta) for i in batch]

    def close(self) -> None:
        """Stop the worker and fail any still-pending request — callers must
        never be left blocking on an event nobody will set."""
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=1.0)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            item.error = AdmissionError(
                f"batching queue for {self.name!r} closed")
            item.event.set()


def batching_factory(backend_factory, max_batch: int = 8,
                     max_wait: float = 0.01, max_pending: int = 256):
    """Wrap a per-model backend factory so every model gets one shared
    BatchingBackend (the 'group concurrent derives for the same model into
    one batched call' knob of the serving stack).  The returned factory
    exposes ``.batchers`` for stats inspection."""
    batchers: dict[str, BatchingBackend] = {}
    mu = threading.Lock()

    def factory(model: str) -> BatchingBackend:
        with mu:
            if model not in batchers:
                batchers[model] = BatchingBackend(
                    backend_factory(model), max_batch=max_batch,
                    max_wait=max_wait, max_pending=max_pending)
            return batchers[model]

    factory.batchers = batchers
    return factory
