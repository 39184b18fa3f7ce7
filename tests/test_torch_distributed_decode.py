"""Decode over a cache split along ``kv_seq`` (``launch/specs.py``'s
``decode_fn``; ``models/attention.py``'s attention over a block and
``combine_partials``; ``distribution/tensor_parallel.py``'s ``seq_block``)
on 4 gloo ranks on the CPU, held against the port's single-device
``decode_step``, which ``test_torch_models.py``, ``test_torch_mla.py`` and
``test_torch_hybrid.py`` hold against the reference's, and in one case
against the reference's ``decode_step`` itself.

The ranks run ``tests/_torch_dist_decode_worker.py`` once for the module,
every case in turn; the single-device side and the reference's are
computed here meanwhile.  Each case prefills 14 tokens on one device, lays
the cache out by ``cache_layout`` under the shape's rules, and runs 4
split decode steps, so that positions 14-17 cross the first block
boundary at 16 (``max_seq`` 64 in 4 blocks).  Cases, in float64:
  * on (1, 4) under decode_32k's rules (``kv_seq`` over ``model``): yi-6b
    (GQA) with ``kv_cache_quant`` off and on, and with 6 q heads, which
    divide no model axis of 4 (every rank computes every head over its
    block, no gather and no cut), deepseek-v2 (MLA) with
    ``mla_absorb`` "auto" (the absorbed decode) and "never" (the block
    up-projected for every head);
  * on (2, 2) under long_500k's rules (batch unsplit, ``kv_seq`` over
    ``data`` then ``model``): zamba2's shared-block caches.
Gates and checks:
  * after each step the logits (gathered over the vocab) and every cache
    leaf (gathered whole) within ``SERVE_RTOL`` (1e-5 of each tensor's
    max) of the single-device step's, on every rank;
  * every partial softmax saw a quarter of the cache, and no leaf with a
    ``kv_seq`` axis went through ``_gather_but_batch``;
  * a control, each rank normalising over its own block alone with the
    combine skipped, misses that gate by more than 100x;
  * in fp32, yi-6b's smoke config with the reference's weights
    (``params_from_jax``): the split decode's logits within
    ``test_torch_models.py``'s ``TOL`` (1e-4) of the reference's
    ``decode_step``'s."""
import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import transformer as RT
from repro_torch.models import transformer as T

import _torch_dist_decode_worker as D
import _torch_dist_ssm_worker as S

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

WORLD = 4
RANK_TIMEOUT = 300       # s, each rank's whole run
SERVE_RTOL = 1e-5        # logits and cache leaves, of each tensor's max
TOL = 1e-4               # against the reference, as test_torch_models.py
SPLIT_CASES = [c for c in D.CASES if c != "jax"]


def _snapshot(cache) -> dict:
    """Every leaf of a cache as a numpy copy (decode writes in place)."""
    return {n: np.array(v, copy=True) if isinstance(v, np.ndarray) else v
            for n, v in S._leaves(cache).items()}


@functools.lru_cache(maxsize=None)
def _single(case: str) -> dict:
    """Prefill and the decode steps on one device: logits and caches."""
    cfg = D.cfg_for(case)
    model = D.model_for(case)
    toks = D.tokens(cfg)
    _, cache = T.prefill(model, cfg, toks[:, :D.PREFILL])
    logits, caches = [], []
    for i in range(D.STEPS):
        out, cache = T.decode_step(
            model, cfg, toks[:, D.PREFILL + i:D.PREFILL + i + 1], cache)
        logits.append(out.numpy())
        caches.append(_snapshot(cache))
    return {"logits": logits, "caches": caches}


def _reference_params():
    rcfg = ref_smoke(D.CASES["jax"][0]).replace(max_seq=D.MAX_SEQ)
    return rcfg, RT.init_params(jax.random.PRNGKey(0), rcfg)


def _reference_logits(rcfg, rparams) -> list:
    """The reference's prefill and decode steps on the same tokens."""
    toks = np.asarray(D.tokens(D.cfg_for("jax")), dtype=np.int32)
    _, cache = RT.prefill(rparams, rcfg, jnp.asarray(toks[:, :D.PREFILL]))
    out = []
    for i in range(D.STEPS):
        logits, cache = RT.decode_step(
            rparams, rcfg, jnp.asarray(toks[:, D.PREFILL + i:
                                            D.PREFILL + i + 1]), cache)
        out.append(np.asarray(logits, dtype=np.float32))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results and the reference's logits: 4 gloo ranks, each
    joined with a timeout; the single-device and reference sides computed
    while they run."""
    out_dir = tmp_path_factory.mktemp("decode_ranks")
    rcfg, rparams = _reference_params()
    ref_path = out_dir / "ref_params.pkl"
    with open(ref_path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, rparams), f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               OMP_NUM_THREADS="1")
    code = ("import sys, _torch_dist_decode_worker as w; "
            "w.run(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(WORLD),
         str(out_dir / "store"), str(ref_path), str(out_dir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for case in SPLIT_CASES:
                _single(case)
        finally:
            torch.set_num_threads(threads)
        want_ref = _reference_logits(rcfg, rparams)
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    res = []
    for r in range(WORLD):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res, want_ref


def _case(ranks, key, rank=0):
    res, _ = ranks
    for name in res[rank]:
        if name.startswith("error/") and key.startswith(name[6:]):
            pytest.fail(res[rank][name])
    return res[rank][key]


def _error(got, want) -> float:
    """max |error| / max |want|; ints (cache positions) must be equal (inf
    where they are not)."""
    if not isinstance(want, np.ndarray):
        return 0.0 if got == want else float("inf")
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _worst(got: dict, want: dict) -> float:
    """The worst error over every step's logits and cache leaves."""
    worst = 0.0
    for i in range(D.STEPS):
        worst = max(worst, _error(got["logits"][i], want["logits"][i]))
        assert set(got["caches"][i]) == set(want["caches"][i])
        for n, w in want["caches"][i].items():
            worst = max(worst, _error(got["caches"][i][n], w))
    return worst


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_decode_equals_single_device_decode(ranks, case,
                                                  record_property):
    """4 split decode steps across the block boundary: logits and the whole
    caches within ``SERVE_RTOL`` of each tensor's max of the single-device
    steps', on every rank."""
    want = _single(case)
    worst = max(_worst(_case(ranks, f"decode/{case}", r), want)
                for r in range(WORLD))
    record_property("worst_err_of_max", worst)
    assert worst <= SERVE_RTOL


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_each_rank_attends_its_block_and_gathers_no_cache(ranks, case):
    """Every partial softmax of every rank ran over a quarter of the cache,
    one per attention cache a step, and no
    cache leaf with a ``kv_seq`` axis was gathered; the leaves without one
    (zamba2's Mamba states and conv tails) still are."""
    cfg = D.cfg_for(case)
    last = _single(case)["caches"][-1]
    n_attn = sum(n.endswith(("/k", "/ckv")) for n in last)
    n_other = (2 * cfg.n_layers if cfg.family == "hybrid" else 0)
    for r in range(WORLD):
        got = _case(ranks, f"decode/{case}", r)
        assert got["block_lengths"] == [D.MAX_SEQ // WORLD] * (
            n_attn * D.STEPS)
        assert got["kv_seq_gathered"] == 0
        assert got["other_gathered"] == n_other


def test_control_without_the_combine_fails_the_gate(ranks):
    """Each rank normalising over its own block alone (the GQA case with
    the combine skipped) misses the gate by more than 100x."""
    got = _case(ranks, "control/local_softmax")
    assert _worst(got, _single("gqa")) > 100 * SERVE_RTOL


def test_split_decode_matches_the_reference_decode_step(ranks,
                                                        record_property):
    """fp32, the reference's weights: the split decode's logits within
    ``TOL`` of ``repro.models.transformer.decode_step``'s, every step and
    every rank."""
    _, want = ranks
    worst = 0.0
    for r in range(WORLD):
        got = _case(ranks, "decode/jax", r)["logits"]
        worst = max(worst, max(float(np.abs(g - w).max())
                               for g, w in zip(got, want)))
    record_property("worst_abs_err", worst)
    assert worst < TOL
