"""The port's ``EngineBackend`` (the in-repo serving engine as an LLM
backend) against the JAX package's, on the CPU (``device="cpu"``): the
cases of ``tests/test_engine.py`` that hold the backend, its cache
fingerprint and engine-derive content addresses string-equal to the
reference's for the same knobs, and, with the reference's weights loaded
through ``params_from_jax``, its sampled tokens and responses equal to the
reference's on both the drained-batch and the continuous-batching path.
The port's own init (a ``torch.Generator`` seeded 0) cannot reproduce
``jax.random.PRNGKey(0)``'s weights, so token parity is held on loaded
weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import backends as rb
from repro.core import pipeline as rpipeline
from repro.core.domains import DOMAINS as RDOMAINS
from repro.serving.engine import generate as ref_generate
from repro_torch.configs import get_smoke_config
from repro_torch.core import pipeline
from repro_torch.core.backends import (
    EngineBackend, MockLLMBackend, build_prompt, canonical_code,
)
from repro_torch.core.domains import DOMAINS
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.async_engine import ContinuousBatchingBackend

MODEL = "OSS:120b"
METAS = [{"domain": "tri2d", "stage": 20},
         {"domain": "msimplex3", "stage": 20},
         {"domain": "cantor2d", "stage": 40}]
KNOBS = [{}, {"max_new_tokens": 4}, {"max_new_tokens": 8, "prompt_tokens": 32},
         {"arch": "rwkv6-3b", "temperature": 0.7, "seed": 3}]


@pytest.fixture(scope="module")
def engine_backend():
    return EngineBackend("OSS:120b", max_new_tokens=4, device="cpu")


def test_engine_backend_fallback_is_canonical(engine_backend):
    """The untrained smoke model's sampled text fails synthesis, so the
    backend must emit the canonical derivation for the requested domain."""
    prompt = build_prompt(DOMAINS["tri2d"], 20)
    resp = engine_backend.generate(prompt, meta={"domain": "tri2d",
                                                 "stage": 20})
    assert canonical_code("tri2d") in resp.text
    assert resp.tokens_out == 4       # real decode steps, not replayed priors
    assert resp.seconds > 0 and resp.joules > 0


def test_engine_backend_batch_matches_single(engine_backend):
    """generate_batch (one padded prefill) and generate (singleton batch)
    must emit identical text for the same cell — batching is a throughput
    knob, never a behaviour change."""
    metas = METAS[:2]
    prompts = ["0 -> (0, 0)\n1 -> (1, 0)", "0 -> (0, 0, 0)\n1 -> (1, 0, 0)"]
    batch = engine_backend.generate_batch(prompts, metas)
    singles = [engine_backend.generate(p, meta=m)
               for p, m in zip(prompts, metas)]
    assert [r.text for r in batch] == [r.text for r in singles]
    assert batch[0].text != batch[1].text  # per-domain fallback, not shared


def test_engine_backend_cache_identity_distinct_from_mock(engine_backend):
    """Engine cells must occupy different content addresses than mock cells
    (and than an engine with different decode knobs)."""
    mock = MockLLMBackend("OSS:120b")
    other = EngineBackend("OSS:120b", max_new_tokens=8)
    fps = {engine_backend.cache_fingerprint, mock.cache_fingerprint,
           other.cache_fingerprint}
    assert len(fps) == 3
    # stable across instances with the same knobs
    twin = EngineBackend("OSS:120b", max_new_tokens=4)
    assert twin.cache_fingerprint == engine_backend.cache_fingerprint


@pytest.mark.parametrize("knobs", KNOBS)
def test_fingerprint_and_content_address_equal_reference(knobs):
    """Same knobs, same fingerprint string and same engine-derive key as
    the JAX package's, whatever device the port's engine is on."""
    ref = rb.EngineBackend(MODEL, **knobs)
    for device in (None, "cpu"):
        mine = EngineBackend(MODEL, device=device, **knobs)
        assert mine.cache_fingerprint == ref.cache_fingerprint
        for d, s in (("tri2d", 20), ("pyramid3d", 40)):
            want = rpipeline.prepare_request(RDOMAINS[d], ref, s,
                                             n_validate=2000,
                                             sample_every=1).key
            got = pipeline.prepare_request(DOMAINS[d], mine, s,
                                           n_validate=2000,
                                           sample_every=1).key
            assert got == want


@pytest.fixture(scope="module")
def loaded():
    """The reference's EngineBackend and the port's with its weights."""
    ref = rb.EngineBackend(MODEL, max_new_tokens=8)
    rparams, rcfg = ref._ensure_engine()
    mine = EngineBackend(MODEL, max_new_tokens=8, device="cpu")
    cfg = get_smoke_config("yi-6b").replace(max_seq=rcfg.max_seq)
    mine._engine = (params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                                    "cpu"), cfg)
    return ref, mine


def _prompts():
    """Prompts whose byte tails differ (a built prompt's tail is the
    template's last lines, the same for every cell)."""
    return ["0 -> (0, 0)\n1 -> (1, 0)", "0 -> (0, 0, 0)\n1 -> (1, 0, 0)",
            build_prompt(DOMAINS["cantor2d"], 40)]


def test_sampled_tokens_equal_reference_with_its_weights(loaded):
    ref, mine = loaded
    prompts = _prompts()
    rparams, rcfg = ref._ensure_engine()
    toks = np.stack([ref._tokenize(p, rcfg.vocab_size) for p in prompts])
    want = np.asarray(ref_generate(rparams, rcfg, jnp.asarray(toks),
                                   ref.max_new_tokens).tokens)
    got_toks, sampled, steps, seconds = mine.sample(prompts)
    np.testing.assert_array_equal(got_toks, toks)
    assert steps == ref.max_new_tokens and seconds > 0
    np.testing.assert_array_equal(sampled, want[:, ref.prompt_tokens:])


def test_responses_equal_reference_on_both_paths(loaded):
    """Drained batch and continuous batching give the reference's responses
    (timing fields aside) for the same prompts."""
    ref, mine = loaded
    prompts = _prompts()
    want = ref.generate_batch(prompts, METAS)
    cb = ContinuousBatchingBackend(mine, decode_slots=4)
    try:
        paths = {"batch": mine.generate_batch(prompts, METAS),
                 "continuous": [cb.generate(p, meta=m)
                                for p, m in zip(prompts, METAS)]}
    finally:
        cb.close()
    for got in paths.values():
        for g, w in zip(got, want):
            assert (g.text, g.model, g.tokens_in, g.tokens_out) \
                == (w.text, w.model, w.tokens_in, w.tokens_out)
            assert g.joules == pytest.approx(g.seconds * mine.power_w)


def test_continuous_steps_equal_the_drained_batch(loaded):
    """The stepper's prefill + decode steps sample the same tokens as one
    ``engine.generate`` call over the same cohort."""
    _, mine = loaded
    prompts = _prompts()
    _, want, _, _ = mine.sample(prompts)
    cb = ContinuousBatchingBackend(mine)
    try:
        stepper = cb.batcher.stepper
        state = stepper.prefill(prompts)
        while not stepper.step(state):
            pass
    finally:
        cb.close()
    got = np.concatenate([t.numpy() for t in state.generated], axis=1)
    np.testing.assert_array_equal(got, want)
