"""Continuous batching for the in-repo engine: per-step admission scheduler.

``serving/batching.py`` gathers a batch, runs it to completion, and only then
collects the next one — a derive arriving one millisecond after dispatch waits
out the *entire* decode of the in-flight batch.  This module replaces that
gather-then-drain loop with a step-interleaved scheduler:

* Requests admitted at the same step boundary form a **cohort** sharing one
  batched prefill and one KV cache (the transformer cache keeps a single
  position scalar per layer, so rows of one cache must decode in lock-step —
  cohorts are exactly the granularity at which that invariant holds).
* The worker advances every active cohort by **one decode step per scheduler
  tick**, so multiple cohorts at different positions interleave on the same
  device instead of queueing behind each other.
* New arrivals are admitted at the **next step boundary** — bounded by one
  decode step of latency, not a whole batch drain — as long as total active
  requests stay within ``decode_slots``.

Admission control mirrors the threaded batcher: a bounded pending queue sheds
with :class:`LLMBusyError` (wire 503), and requests that wait longer than
``admission_timeout`` before reaching a slot fail with :class:`LLMTimeoutError`
(wire 504).  :class:`ContinuousBatchingBackend` is a drop-in sync
``LLMBackend`` facade over the scheduler; :class:`AsyncEngineBackend` is the
``AsyncLLMBackend`` face with the ``start/close/health_check/warm`` lifecycle.

:class:`EngineStepper` drives the port's ``prefill`` / ``decode_step`` on the
engine backend's device.  ``torch.inference_mode`` is per thread, so the
scheduler's worker enters it around each pass itself.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import threading
import time
from typing import Protocol

import numpy as np

from repro_torch.core.backends import (
    EngineBackend,
    LLMBusyError,
    LLMResponse,
    LLMTimeoutError,
)
from repro_torch.obs import trace as obs_trace


class CohortStepper(Protocol):
    """Model-side contract the scheduler drives.

    ``prefill`` turns a group of prompts into opaque cohort state; ``step``
    advances the whole cohort one decode step and reports completion;
    ``finalize`` converts finished state into per-request responses."""

    def prefill(self, prompts: list[str]) -> object: ...

    def step(self, state: object) -> bool: ...

    def finalize(self, state: object,
                 metas: list[dict]) -> list[LLMResponse]: ...


@dataclasses.dataclass
class _EngineCohortState:
    toks: np.ndarray          # (B, prompt_tokens) int32 prompt tokens
    tok: object               # (B, 1) current sampled token (device tensor)
    cache: object             # per-cohort KV cache (rows share one position)
    generator: object         # torch.Generator when sampling, else None
    generated: list           # appended (B, 1) token tensors
    steps_done: int = 0
    t0: float = 0.0


class EngineStepper:
    """Drive ``EngineBackend``'s transformer one decode step at a time.

    Reuses the backend's tokenizer, params/config, synthesis fallback and
    energy model, so responses (and therefore content addresses) are
    indistinguishable from the drained-batch path — only the scheduling
    changes.  A sampling cohort draws from one ``torch.Generator`` seeded
    with the backend's seed, as ``serving.engine.generate`` does."""

    def __init__(self, backend: EngineBackend):
        self.backend = backend

    def prefill(self, prompts: list[str]) -> _EngineCohortState:
        import torch

        from repro_torch.models import transformer as T
        from repro_torch.serving.engine import greedy

        b = self.backend
        params, cfg = b._ensure_engine()
        toks = np.stack([b._tokenize(p, cfg.vocab_size) for p in prompts])
        t0 = time.monotonic()
        with torch.inference_mode():
            logits, cache = T.prefill(params, cfg, torch.from_numpy(toks))
            generator = None
            if b.temperature:
                generator = torch.Generator(
                    device=logits.device).manual_seed(b.seed)
            tok = greedy(logits[:, -1:, : cfg.vocab_size], generator,
                         b.temperature)
        return _EngineCohortState(toks=toks, tok=tok, cache=cache,
                                  generator=generator, generated=[], t0=t0)

    def step(self, state: _EngineCohortState) -> bool:
        import torch

        from repro_torch.models import transformer as T
        from repro_torch.serving.engine import greedy

        b = self.backend
        params, cfg = b._ensure_engine()
        state.generated.append(state.tok)
        with torch.inference_mode():
            logits, state.cache = T.decode_step(params, cfg, state.tok,
                                                state.cache)
            state.tok = greedy(logits[:, :, : cfg.vocab_size],
                               state.generator, b.temperature)
        state.steps_done += 1
        return state.steps_done >= b.max_new_tokens

    def finalize(self, state: _EngineCohortState,
                 metas: list[dict]) -> list[LLMResponse]:
        import torch

        b = self.backend
        sampled = torch.cat(state.generated, dim=1).cpu().numpy()
        per_seconds = (time.monotonic() - state.t0) / len(metas)
        return [b.respond(row, meta, state.toks.shape[1], state.steps_done,
                          per_seconds)
                for meta, row in zip(metas, sampled)]


@dataclasses.dataclass
class ContinuousStats:
    """Counters for one model's continuous-batching scheduler."""

    slots: int = 0             # configured decode_slots
    requests: int = 0          # admitted submit() calls
    rejected: int = 0          # shed at admission (pending queue full)
    timeouts: int = 0          # expired waiting for a free slot
    completed: int = 0         # responses delivered
    prefills: int = 0          # cohort prefills issued
    steps: int = 0             # decode steps across all cohorts
    cohorts: int = 0           # cohorts formed
    joined_inflight: int = 0   # requests admitted while >=1 cohort was decoding
    occupancy: int = 0         # active requests right now
    max_occupancy: int = 0     # high-water mark of concurrent active requests

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Req:
    __slots__ = ("prompt", "meta", "future", "enqueued")

    def __init__(self, prompt: str, meta: dict):
        self.prompt = prompt
        self.meta = meta
        self.future: concurrent.futures.Future = concurrent.futures.Future()
        self.enqueued = time.monotonic()


class _Cohort:
    __slots__ = ("reqs", "state", "t0")

    def __init__(self, reqs: list[_Req], state: object):
        self.reqs = reqs
        self.state = state
        self.t0 = time.monotonic()


class ContinuousBatcher:
    """Step-interleaved scheduler over a :class:`CohortStepper`.

    One worker thread owns the device: each tick it (1) expires requests that
    waited past ``admission_timeout``, (2) admits queued requests up to the
    free ``decode_slots`` as a fresh cohort (batched prefill), and (3)
    advances every active cohort exactly one decode step.  A request arriving
    mid-decode therefore starts at the next step boundary instead of waiting
    for the in-flight batch to drain."""

    IDLE_WAIT = 0.02

    def __init__(self, stepper: CohortStepper, decode_slots: int = 8,
                 max_pending: int = 256, admission_timeout: float = 30.0,
                 max_cohort: int | None = None):
        if decode_slots < 1:
            raise ValueError("decode_slots must be >= 1")
        self.stepper = stepper
        self.decode_slots = decode_slots
        self.max_pending = max_pending
        self.admission_timeout = admission_timeout
        self.max_cohort = max_cohort or decode_slots
        self.stats = ContinuousStats(slots=decode_slots)
        self._pending: collections.deque[_Req] = collections.deque()
        self._cohorts: list[_Cohort] = []
        self._mu = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None

    # -- client side -------------------------------------------------------
    def submit(self, prompt: str, meta: dict) -> concurrent.futures.Future:
        """Enqueue one request; resolves to an LLMResponse.  Sheds with
        LLMBusyError when ``max_pending`` requests already wait."""
        if self._stop.is_set():
            raise LLMBusyError("continuous batcher is closed")
        req = _Req(prompt, meta)
        with self._mu:
            if len(self._pending) >= self.max_pending:
                self.stats.rejected += 1
                raise LLMBusyError(
                    f"admission queue full ({self.max_pending} pending) for "
                    f"continuous batcher")
            self._pending.append(req)
            self.stats.requests += 1
            self._ensure_worker()
        self._work.set()
        return req.future

    def start(self) -> None:
        with self._mu:
            self._ensure_worker()

    # -- worker side -------------------------------------------------------
    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._loop, name="continuous-batcher", daemon=True)
            self._worker.start()

    def _expire(self, now: float) -> None:
        expired = []
        with self._mu:
            kept = collections.deque()
            while self._pending:
                req = self._pending.popleft()
                if now - req.enqueued > self.admission_timeout:
                    expired.append(req)
                else:
                    kept.append(req)
            self._pending = kept
            self.stats.timeouts += len(expired)
        for req in expired:
            req.future.set_exception(LLMTimeoutError(
                f"request waited > {self.admission_timeout:.1f}s for a free "
                f"decode slot"))

    def _admit(self) -> None:
        with self._mu:
            occupancy = sum(len(c.reqs) for c in self._cohorts)
            free = min(self.decode_slots - occupancy, self.max_cohort)
            admitted: list[_Req] = []
            while free > 0 and self._pending:
                req = self._pending.popleft()
                if not req.future.set_running_or_notify_cancel():
                    continue
                admitted.append(req)
                free -= 1
            if not admitted:
                return
            if self._cohorts:
                self.stats.joined_inflight += len(admitted)
        t_admit = time.monotonic()
        try:
            state = self.stepper.prefill([r.prompt for r in admitted])
        except BaseException as e:  # noqa: BLE001 — fan the error out
            for req in admitted:
                req.future.set_exception(e)
            return
        dt_prefill = time.monotonic() - t_admit
        for req in admitted:
            # the scheduler thread serves every request, so attribution goes
            # through each request's meta-carried trace snapshot
            obs_trace.record_for_meta(
                req.meta, "cohort_join", t_admit - req.enqueued,
                cohort=len(admitted))
            obs_trace.record_for_meta(
                req.meta, "engine_prefill", dt_prefill,
                cohort=len(admitted))
        with self._mu:
            self._cohorts.append(_Cohort(admitted, state))
            self.stats.prefills += 1
            self.stats.cohorts += 1
            occupancy = sum(len(c.reqs) for c in self._cohorts)
            self.stats.occupancy = occupancy
            self.stats.max_occupancy = max(self.stats.max_occupancy,
                                           occupancy)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._expire(time.monotonic())
            self._admit()  # step boundary: new arrivals join here
            with self._mu:
                cohorts = list(self._cohorts)
            if not cohorts:
                if self._work.wait(self.IDLE_WAIT):
                    self._work.clear()
                continue
            finished: list[tuple[_Cohort, BaseException | None]] = []
            for cohort in cohorts:
                try:
                    done = self.stepper.step(cohort.state)
                    with self._mu:
                        self.stats.steps += 1
                    if done:
                        finished.append((cohort, None))
                except BaseException as e:  # noqa: BLE001
                    finished.append((cohort, e))
            for cohort, err in finished:
                with self._mu:
                    self._cohorts.remove(cohort)
                if err is None:
                    try:
                        responses = self.stepper.finalize(
                            cohort.state, [r.meta for r in cohort.reqs])
                    except BaseException as e:  # noqa: BLE001
                        err = e
                if err is not None:
                    for req in cohort.reqs:
                        req.future.set_exception(err)
                else:
                    decode_s = time.monotonic() - cohort.t0
                    steps = getattr(cohort.state, "steps_done", 0)
                    for req, resp in zip(cohort.reqs, responses):
                        obs_trace.record_for_meta(
                            req.meta, "engine_decode", decode_s, steps=steps)
                        req.future.set_result(resp)
                    with self._mu:
                        self.stats.completed += len(cohort.reqs)
            with self._mu:
                self.stats.occupancy = sum(
                    len(c.reqs) for c in self._cohorts)
        self._fail_all(LLMBusyError("continuous batcher closed"))

    def _fail_all(self, err: BaseException) -> None:
        with self._mu:
            pending = list(self._pending)
            self._pending.clear()
            cohorts = list(self._cohorts)
            self._cohorts.clear()
            self.stats.occupancy = 0
        for req in pending:
            if not req.future.done():
                req.future.set_exception(err)
        for cohort in cohorts:
            for req in cohort.reqs:
                if not req.future.done():
                    req.future.set_exception(err)

    def close(self) -> None:
        self._stop.set()
        self._work.set()
        worker = self._worker
        if worker is not None:
            worker.join(timeout=5.0)
        # worker may have exited before _fail_all ran (or never started)
        self._fail_all(LLMBusyError("continuous batcher closed"))


class ContinuousBatchingBackend:
    """Sync ``LLMBackend`` facade over :class:`ContinuousBatcher` — drop-in
    for ``MappingService``: same ``generate`` surface, same content addresses
    (``name``/``cache_fingerprint`` proxy the wrapped engine backend)."""

    def __init__(self, inner: EngineBackend, decode_slots: int = 8,
                 max_pending: int = 256, admission_timeout: float = 30.0):
        self.inner = inner
        self.batcher = ContinuousBatcher(
            EngineStepper(inner), decode_slots=decode_slots,
            max_pending=max_pending, admission_timeout=admission_timeout)

    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def cache_fingerprint(self):
        return getattr(self.inner, "cache_fingerprint", None)

    @property
    def stats(self) -> ContinuousStats:
        return self.batcher.stats

    def generate(self, prompt: str, *, meta: dict) -> LLMResponse:
        fut = self.batcher.submit(prompt, meta)
        # poll-wait so close() racing this call can never strand us
        while True:
            try:
                return fut.result(timeout=0.1)
            except concurrent.futures.TimeoutError:
                if self.batcher._stop.is_set() and not fut.done():
                    raise LLMBusyError(
                        "continuous batcher closed while waiting") from None

    def close(self) -> None:
        self.batcher.close()


class AsyncEngineBackend:
    """``AsyncLLMBackend`` face of the continuous batcher: awaitable
    ``generate`` plus the ``start/close/health_check/warm`` lifecycle."""

    def __init__(self, inner: EngineBackend, decode_slots: int = 8,
                 max_pending: int = 256, admission_timeout: float = 30.0):
        self.inner = inner
        self.name = inner.name
        self.batcher = ContinuousBatcher(
            EngineStepper(inner), decode_slots=decode_slots,
            max_pending=max_pending, admission_timeout=admission_timeout)

    @property
    def cache_fingerprint(self):
        return getattr(self.inner, "cache_fingerprint", None)

    async def start(self) -> None:
        self.batcher.start()

    async def close(self) -> None:
        import asyncio

        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self.batcher.close)

    async def health_check(self) -> bool:
        if self.batcher._stop.is_set():
            return False
        worker = self.batcher._worker
        return worker is None or worker.is_alive()

    async def warm(self, timeout_s: float = 120.0) -> None:
        """Run one throwaway generation so params init and the first
        passes happen before the first real request."""
        import asyncio

        fut = self.batcher.submit(
            "warmup", {"domain": "tri2d", "stage": 0})
        await asyncio.wait_for(asyncio.wrap_future(fut), timeout=timeout_s)

    async def generate(self, prompt: str, *, meta: dict) -> LLMResponse:
        import asyncio

        fut = self.batcher.submit(prompt, meta)
        return await asyncio.wrap_future(fut)


def continuous_factory(backend_factory, decode_slots: int = 8,
                       max_pending: int = 256,
                       admission_timeout: float = 30.0):
    """Per-model factory mirroring ``batching_factory``: every model gets one
    shared :class:`ContinuousBatchingBackend`.  Exposes ``.batchers``."""
    batchers: dict[str, ContinuousBatchingBackend] = {}
    mu = threading.Lock()

    def factory(model: str) -> ContinuousBatchingBackend:
        with mu:
            if model not in batchers:
                batchers[model] = ContinuousBatchingBackend(
                    backend_factory(model), decode_slots=decode_slots,
                    max_pending=max_pending,
                    admission_timeout=admission_timeout)
            return batchers[model]

    factory.batchers = batchers
    return factory
