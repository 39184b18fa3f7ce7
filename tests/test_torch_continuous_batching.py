"""The port's continuous batching (``repro_torch.serving.async_engine``),
as ``tests/test_continuous_batching.py`` holds the JAX package's: the
step-interleaved cohort scheduler.

The headline property under test — a derive admitted while a decode batch is
in flight joins at the *next step boundary* instead of waiting for the batch
to drain — plus its admission-control contract (LLMBusyError on a full
queue, LLMTimeoutError past the admission deadline) and the real-engine
integration (responses indistinguishable from the drained-batch path), with
the engine on the CPU (``device="cpu"``).  Same timeouts and waits as the
reference's."""
import concurrent.futures
import threading
import time

import pytest

from repro_torch.core.backends import (
    EngineBackend, LLMBusyError, LLMResponse, LLMTimeoutError,
)
from repro_torch.serving.async_engine import (
    ContinuousBatcher, ContinuousBatchingBackend,
)

MODEL = "OSS:120b"


class FakeState:
    def __init__(self, prompts):
        self.prompts = tuple(prompts)
        self.steps_done = 0


class FakeStepper:
    """Scriptable CohortStepper: fixed step count, configurable per-step
    sleep, and an event log ordered exactly as the scheduler acted."""

    def __init__(self, steps: int = 4, step_sleep: float = 0.02):
        self.steps = steps
        self.step_sleep = step_sleep
        self.events: list[tuple] = []
        self._mu = threading.Lock()

    def prefill(self, prompts):
        with self._mu:
            self.events.append(("prefill", tuple(prompts)))
        return FakeState(prompts)

    def step(self, state):
        time.sleep(self.step_sleep)
        state.steps_done += 1
        with self._mu:
            self.events.append(("step", state.prompts, state.steps_done))
        return state.steps_done >= self.steps

    def finalize(self, state, metas):
        return [LLMResponse(text=f"gen:{p}", model="fake", tokens_in=1,
                            tokens_out=state.steps_done, seconds=0.0,
                            joules=0.0)
                for p in state.prompts]


def test_join_at_next_step_boundary():
    """A request arriving while cohort A decodes is prefilled as cohort B
    *between* A's steps — before A drains — and decode-slot occupancy
    exceeds the drained-batch baseline of one batch at a time."""
    stepper = FakeStepper(steps=6, step_sleep=0.03)
    batcher = ContinuousBatcher(stepper, decode_slots=4)
    try:
        fut_a = batcher.submit("A", {})
        # wait until A's cohort has visibly started decoding
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with stepper._mu:
                if any(e[0] == "step" and e[1] == ("A",)
                       for e in stepper.events):
                    break
            time.sleep(0.005)
        else:
            pytest.fail("cohort A never started decoding")
        fut_b = batcher.submit("B", {})
        assert fut_a.result(timeout=10.0).text == "gen:A"
        assert fut_b.result(timeout=10.0).text == "gen:B"
    finally:
        batcher.close()

    events = stepper.events
    b_prefill = events.index(("prefill", ("B",)))
    a_steps_before = [i for i, e in enumerate(events)
                      if e[0] == "step" and e[1] == ("A",) and i < b_prefill]
    a_steps_after = [i for i, e in enumerate(events)
                     if e[0] == "step" and e[1] == ("A",) and i > b_prefill]
    # B was admitted mid-flight: after >=1 of A's steps, before A finished
    assert a_steps_before, "B's prefill should come after A started decoding"
    assert a_steps_after, "B's prefill must land before A's batch drained"
    assert batcher.stats.joined_inflight >= 1
    # occupancy high-water: two requests decoding at once beats the
    # gather-then-drain baseline (one batch, occupancy 1, at a time)
    assert batcher.stats.max_occupancy >= 2
    assert batcher.stats.cohorts == 2
    assert batcher.stats.prefills == 2


def test_cohorts_interleave_stepwise():
    """With two cohorts in flight the scheduler alternates their steps
    (A B A B ...) rather than draining one before touching the other."""
    stepper = FakeStepper(steps=8, step_sleep=0.02)
    batcher = ContinuousBatcher(stepper, decode_slots=4)
    try:
        fut_a = batcher.submit("A", {})
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with stepper._mu:
                if any(e[0] == "step" for e in stepper.events):
                    break
            time.sleep(0.005)
        fut_b = batcher.submit("B", {})
        fut_a.result(timeout=10.0)
        fut_b.result(timeout=10.0)
    finally:
        batcher.close()
    # within the overlap window, consecutive steps alternate cohorts
    overlap = [e[1] for e in stepper.events if e[0] == "step"]
    first_b = overlap.index(("B",))
    last_a = len(overlap) - 1 - overlap[::-1].index(("A",))
    window = overlap[first_b:last_a + 1]
    assert window, "cohorts never overlapped"
    # strict alternation while both are live
    for prev, cur in zip(window, window[1:]):
        assert prev != cur, f"scheduler ran {prev} twice in a row mid-overlap"


def test_same_boundary_arrivals_share_one_cohort():
    """Requests already queued at a step boundary form ONE cohort (one
    batched prefill), not one cohort each."""
    stepper = FakeStepper(steps=30, step_sleep=0.03)
    batcher = ContinuousBatcher(stepper, decode_slots=8)
    try:
        # park a long-running cohort so the worker is provably mid-decode
        hog = batcher.submit("hog", {})
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not stepper.events:
            time.sleep(0.005)
        # all three queue before the next boundary (steps take 30ms)
        futs = [batcher.submit(p, {}) for p in ("A", "B", "C")]
        for f in futs:
            f.result(timeout=10.0)
        hog.result(timeout=10.0)
    finally:
        batcher.close()
    joint = [e for e in stepper.events
             if e[0] == "prefill" and len(e[1]) > 1]
    assert len(joint) == 1
    assert set(joint[0][1]) == {"A", "B", "C"}
    assert batcher.stats.cohorts == 2
    assert batcher.stats.max_occupancy == 4


def test_busy_shed_on_full_queue():
    stepper = FakeStepper(steps=50, step_sleep=0.05)
    batcher = ContinuousBatcher(stepper, decode_slots=1, max_pending=2)
    try:
        occupant = batcher.submit("hog", {})
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not stepper.events:
            time.sleep(0.005)
        batcher.submit("q1", {})
        batcher.submit("q2", {})
        with pytest.raises(LLMBusyError):
            batcher.submit("overflow", {})
        assert batcher.stats.rejected == 1
        assert not occupant.done()
    finally:
        batcher.close()


def test_admission_timeout_is_typed():
    """A request that cannot reach a decode slot before admission_timeout
    fails with LLMTimeoutError (the 504 of the wire layer), while the
    occupant keeps decoding unharmed."""
    stepper = FakeStepper(steps=40, step_sleep=0.05)
    batcher = ContinuousBatcher(stepper, decode_slots=1,
                                admission_timeout=0.2)
    try:
        occupant = batcher.submit("hog", {})
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not stepper.events:
            time.sleep(0.005)
        starved = batcher.submit("starved", {})
        with pytest.raises(LLMTimeoutError):
            starved.result(timeout=5.0)
        assert batcher.stats.timeouts == 1
        assert occupant.result(timeout=10.0).text == "gen:hog"
    finally:
        batcher.close()


def test_step_error_fans_out_to_cohort():
    class Exploding(FakeStepper):
        def step(self, state):
            raise RuntimeError("device fell over")

    batcher = ContinuousBatcher(Exploding(), decode_slots=4)
    futs = [batcher.submit(p, {}) for p in ("A", "B")]
    try:
        for fut in futs:
            with pytest.raises(RuntimeError, match="device fell over"):
                fut.result(timeout=5.0)
    finally:
        batcher.close()


def test_close_fails_pending_requests():
    stepper = FakeStepper(steps=100, step_sleep=0.05)
    batcher = ContinuousBatcher(stepper, decode_slots=1)
    inflight = batcher.submit("hog", {})
    queued = batcher.submit("queued", {})
    time.sleep(0.1)
    batcher.close()
    for fut in (inflight, queued):
        with pytest.raises(LLMBusyError):
            fut.result(timeout=1.0)


def test_engine_continuous_matches_drained_semantics():
    """The real engine through the continuous scheduler: concurrent
    generates complete, the smoke model's canonical-fallback responses are
    identical to the drained-batch path's, and occupancy shows true
    mid-flight joining."""
    inner = EngineBackend(MODEL, max_new_tokens=4, device="cpu")
    cb = ContinuousBatchingBackend(inner, decode_slots=4)
    try:
        meta = {"domain": "tri2d"}
        warm = cb.generate("warm", meta=meta)  # params init + first passes
        assert warm.tokens_out == 4

        results = {}
        mu = threading.Lock()
        gate = threading.Barrier(4)

        def go(i):
            gate.wait()  # submit all four within the same step window
            r = cb.generate(f"prompt {i}", meta=meta)
            with mu:
                results[i] = r

        threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        assert sorted(results) == [0, 1, 2, 3]
        # the untrained smoke model never synthesizes: every response is the
        # canonical fallback, exactly as EngineBackend.generate_batch yields
        baseline = inner.generate("prompt 0", meta=meta)
        for r in results.values():
            assert r.text == baseline.text
            assert r.tokens_out == baseline.tokens_out
            assert r.model == MODEL
        stats = cb.stats
        assert stats.completed >= 5
        assert stats.max_occupancy > 1, \
            "continuous path never held >1 request in decode slots"
    finally:
        cb.close()


def test_sync_facade_raises_after_close():
    batcher = ContinuousBatchingBackend(
        EngineBackend(MODEL, max_new_tokens=2, device="cpu"))
    batcher.close()
    with pytest.raises(LLMBusyError):
        batcher.generate("p", meta={"domain": "tri2d"})


def test_submit_returns_concurrent_future():
    stepper = FakeStepper(steps=2, step_sleep=0.0)
    batcher = ContinuousBatcher(stepper, decode_slots=2)
    try:
        fut = batcher.submit("A", {})
        assert isinstance(fut, concurrent.futures.Future)
        assert fut.result(timeout=5.0).tokens_out == 2
    finally:
        batcher.close()
