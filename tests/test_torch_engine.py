"""The port's serving engine and LM demo (repro_torch.serving.engine,
repro_torch.launch.serve) against the JAX package's, on the CPU, with
tests/test_engine.py's setup: the yi-6b smoke config (fp32), reference
parameters loaded through ``params_from_jax``; and the rwkv6-3b smoke config
(fp32), whose 64-token prompts take the chunked WKV (the wkv kernel's plain
version, ``pallas_interpret=True``) and whose decode steps take the scan."""
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import transformer as RT
from repro.serving.engine import generate as ref_generate
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import RemoteMappingService
from repro_torch.serving.engine import generate, greedy

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PROMPT_LEN = 8
MAX_NEW = 6


@pytest.fixture(scope="module")
def engine_setup():
    rcfg = ref_smoke("yi-6b").replace(max_seq=PROMPT_LEN + MAX_NEW)
    cfg = get_smoke_config("yi-6b").replace(max_seq=PROMPT_LEN + MAX_NEW)
    rparams = RT.init_params(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    return rcfg, cfg, rparams, params


def _prompts(seed, batch):
    return np.random.default_rng(seed).integers(
        0, 256, (batch, PROMPT_LEN)).astype(np.int32)


@pytest.mark.parametrize("batch,seed", [(1, 1), (3, 2), (4, 3)])
def test_greedy_tokens_match_reference(engine_setup, batch, seed):
    rcfg, cfg, rparams, params = engine_setup
    prompts = _prompts(seed, batch)
    want = ref_generate(rparams, rcfg, jnp.asarray(prompts), MAX_NEW)
    got = generate(params, cfg, torch.from_numpy(prompts), MAX_NEW)
    assert got.steps == want.steps == MAX_NEW
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_reference_prompt_tokens_match(engine_setup):
    """tests/test_engine.py's own prompt (jax.random, key 1)."""
    rcfg, cfg, rparams, params = engine_setup
    prompts = jax.random.randint(jax.random.PRNGKey(1), (1, PROMPT_LEN), 0,
                                 rcfg.vocab_size, jnp.int32)
    want = ref_generate(rparams, rcfg, prompts, MAX_NEW)
    got = generate(params, cfg, torch.from_numpy(np.array(prompts)),
                   MAX_NEW)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_eos_early_stop_matches_reference(engine_setup):
    rcfg, cfg, rparams, params = engine_setup
    prompts = _prompts(4, 1)
    full = generate(params, cfg, torch.from_numpy(prompts), MAX_NEW)
    eos = int(full.tokens[0, PROMPT_LEN])
    got = generate(params, cfg, torch.from_numpy(prompts), MAX_NEW,
                   eos_id=eos)
    want = ref_generate(rparams, rcfg, jnp.asarray(prompts), MAX_NEW,
                        eos_id=eos)
    assert got.steps == want.steps == 1
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_sampling_is_deterministic_under_a_seed(engine_setup):
    """temperature > 0 draws from a torch.Generator: the same seed gives the
    same tokens (not jax.random's); greedy ignores the seed."""
    _, cfg, _, params = engine_setup
    prompts = torch.from_numpy(_prompts(5, 2))
    a = generate(params, cfg, prompts, MAX_NEW, temperature=0.9, seed=42)
    b = generate(params, cfg, prompts, MAX_NEW, temperature=0.9, seed=42)
    assert torch.equal(a.tokens, b.tokens)
    g1 = generate(params, cfg, prompts, MAX_NEW, seed=1)
    g2 = generate(params, cfg, prompts, MAX_NEW, seed=2)
    assert torch.equal(g1.tokens, g2.tokens)


def test_greedy_is_argmax():
    logits = torch.tensor([[[0.1, 2.0, 2.0, -1.0]]])
    assert greedy(logits).tolist() == [[1]]


def test_cache_too_small_raises(engine_setup):
    _, cfg, _, params = engine_setup
    with pytest.raises(ValueError, match="cache too small"):
        generate(params, cfg, torch.from_numpy(_prompts(6, 1)), MAX_NEW + 1)


def test_lm_demo_runs_on_the_cpu(capsys):
    serve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "arch=yi-6b" in out and "device=cpu" in out
    assert "generated 4 steps x 2 seqs" in out


@pytest.fixture(scope="module")
def rwkv_setup():
    rcfg = ref_smoke("rwkv6-3b")
    cfg = get_smoke_config("rwkv6-3b").replace(pallas_interpret=True)
    rparams = RT.init_params(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    return rcfg, cfg, rparams, params


@pytest.mark.parametrize("prompt_len", [8, 64], ids=["scan", "chunked"])
@pytest.mark.parametrize("batch,seed", [(1, 1), (3, 2)])
def test_rwkv_greedy_tokens_match_reference(rwkv_setup, prompt_len, batch,
                                            seed):
    rcfg, cfg, rparams, params = rwkv_setup
    rcfg = rcfg.replace(max_seq=prompt_len + MAX_NEW)
    cfg = cfg.replace(max_seq=prompt_len + MAX_NEW)
    prompts = np.random.default_rng(seed).integers(
        0, 256, (batch, prompt_len)).astype(np.int32)
    want = ref_generate(rparams, rcfg, jnp.asarray(prompts), MAX_NEW)
    got = generate(params, cfg, torch.from_numpy(prompts), MAX_NEW)
    assert got.steps == want.steps == MAX_NEW
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_lm_demo_runs_rwkv_on_the_cpu(capsys):
    serve.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "64", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "arch=rwkv6-3b" in out and "device=cpu" in out
    assert "generated 4 steps x 2 seqs" in out


def test_lm_demo_serve_maps_is_not_ported(tmp_path):
    """``--serve-maps --backend engine`` (ROADMAP queue 1 item 7, now
    ported) as a user runs it, on a machine without a card: without
    ``--device cpu`` it refuses to start and names that flag; with it, both
    frontends serve a derive from the engine (continuous batching under
    asyncio, the batching queue threaded) and exit 0 on SIGINT."""
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC),
           "CUDA_VISIBLE_DEVICES": "",
           "REPRO_ARTIFACT_CACHE": str(tmp_path / "store")}
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--serve-maps",
            "--backend", "engine", "--port", "0", "--n-validate", "2000",
            "--max-new", "4"]
    refused = subprocess.run(argv, env=env, capture_output=True, text=True,
                             timeout=120)
    assert refused.returncode != 0 and "--device cpu" in refused.stderr
    for extra, section in (([], "continuous batching: decode_slots=8"),
                           (["--no-async"], None)):
        store = str(tmp_path / ("store" + "".join(extra)))  # cold each
        proc = subprocess.Popen([*argv, "--device", "cpu", *extra],
                                env={**env, "REPRO_ARTIFACT_CACHE": store},
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            first = proc.stdout.readline()
            assert first.startswith("mapping service on http://"), (
                first, proc.stderr.read() if proc.poll() is not None else "")
            assert "backend=engine" in first
            banner = [first]
            while not banner[-1].startswith("endpoints:"):
                banner.append(proc.stdout.readline())
            assert "engine: arch=yi-6b device=cpu" in "".join(banner)
            assert (section in "".join(banner)) if section else \
                "continuous batching" not in "".join(banner)
            client = RemoteMappingService(first.split()[3])
            res = client.derive("tri2d", "OSS:120b", 20)
            assert res.compiled and res.response.tokens_out == 4
            stats = client.metrics()["batching"]["OSS:120b"]
            assert ("max_occupancy" in stats) == bool(section)
            assert stats["completed" if section else "requests"] >= 1
            client.close()
            proc.send_signal(signal.SIGINT)
            _, err = proc.communicate(timeout=60)
            assert proc.returncode == 0, err
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
