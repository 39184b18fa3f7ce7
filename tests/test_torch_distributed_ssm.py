"""rwkv6's and mamba2's layers split over ``model`` in the port's split
step (``models/rwkv6.py``, ``models/mamba2.py`` under
``distribution/tensor_parallel.py``) on 4 gloo ranks on the CPU, held
against the port's single-device step, which ``test_torch_rwkv6.py``,
``test_torch_hybrid.py`` and ``test_torch_train.py`` hold against the
reference's.

The ranks run ``tests/_torch_dist_ssm_worker.py`` once for the module (its
own run, beside ``test_torch_distributed.py``'s), every case in turn; the
single-device side is computed here meanwhile.  Every case runs the smoke
configs in float64: the fp32 islands widen with it, and the WKV's plain
version and the fp32 weights (``decay_base``, ``bonus_u``, ``a_log``,
``dt_bias``, ``d_skip``) stay fp32.  In fp32 the smoke models amplify the
split's sums in another order past the gates: rwkv6's gradients land up
to 3.6e-5 of a tensor's max (2.5e-5 in every tensor of the
gathered-columns case), its prefill logits 1.0e-5, and zamba2's chunked
``a_log`` gradient 5.0e-5 even with the Mamba layers computed whole (the
parent's split step).  In float64 the split is the single-device step to
about 1e-14 on (1, 4) and to the fp32 weights' rounding, below 2e-7, on
(2, 2).  Cases:
  * the first batch's gradients, each rank's blocks gathered whole,
    within ``GRAD_RTOL`` (1e-5 of each tensor's max) of the single-device
    step's: rwkv6 and zamba2 at seq 64 (the chunked WKV in its plain
    version, the chunked SSD) on (2, 2) and (1, 4), and an rwkv6 whose 3
    heads divide no model axis while its d_model 96 does (the
    gathered-columns case) at seq 32 and 64 on (2, 2); seq 32 on every
    mesh is ``test_torch_distributed.py``'s ``FAMILY_CASES``;
  * on (1, 4) every ``wkv_chunked`` and chunked Mamba core call sees a
    quarter of the heads, and in the gathered-columns case every head;
  * two controls that must fail that gate: the gated norm without its sum
    over ``model``, and ``in_proj`` cut as its storage chunk instead of
    part by part;
  * ``T.prefill`` over 64 tokens and one ``T.decode_step`` on (1, 4): the
    logits, gathered over the vocab, and every cache leaf within 1e-5 of
    each tensor's max (the caches come back whole);
  * two steps of each family at seq 32 on (2, 2), at
    ``test_torch_distributed.py``'s gates (in fp32 Adam's near-eps
    elements move their parameters 1.5e-5 of their max even where nothing
    is split)."""
import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.models import transformer as T
from repro_torch.train.optimizer import init_state
from repro_torch.train.train_step import make_grads_fn, make_train_step

import _torch_dist_ssm_worker as S
import _torch_dist_worker as W

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

WORLD = 4
RANK_TIMEOUT = 300       # s, each rank's whole run
GRAD_RTOL = 1e-5         # of each tensor's max |value|
SERVE_RTOL = 1e-5        # logits and cache leaves, of each tensor's max
METRIC_RTOL = 1e-6
PARAM_RTOL = 1e-5
MOMENT_RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _single_grads(case: str, seq: int) -> dict:
    cfg = S.cfg_for(case)
    _, _, grads = make_grads_fn(cfg, S.TCFG)(W.model_for(cfg),
                                             S.batch_at(cfg, 0, seq))
    return {n: g.numpy() for n, g in grads.items()}


@functools.lru_cache(maxsize=None)
def _single_serve(case: str) -> dict:
    cfg = S.cfg_for(case)
    model = W.model_for(cfg)
    toks, nxt = S.prompt(cfg)
    logits, cache = T.prefill(model, cfg, toks)
    step, cache2 = T.decode_step(model, cfg, nxt, cache)
    return {"prefill": logits.numpy(), "decode": step.numpy(),
            "cache": S._leaves(cache), "cache2": S._leaves(cache2)}


@functools.lru_cache(maxsize=None)
def _single_steps(case: str):
    cfg = S.cfg_for(case)
    model = W.model_for(cfg)
    state = init_state(model)
    step = make_train_step(cfg, S.TCFG)
    metrics = []
    for s in range(2):
        model, state, m = step(model, state, S.batch_at(cfg, s, S.STEP_SEQ))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, W.whole_state(model, state)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: 4 gloo ranks, each joined with a timeout; the
    single-device side computed while they run."""
    out_dir = tmp_path_factory.mktemp("ssm_ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               OMP_NUM_THREADS="1")
    code = ("import sys, _torch_dist_ssm_worker as w; "
            "w.run(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(WORLD),
         str(out_dir / "store"), str(out_dir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for case, seq, _ in S.GRAD_CASES:
                _single_grads(case, seq)
            _single_grads("zamba", 32)
            for case in ("rwkv", "zamba"):
                _single_serve(case)
            for case in S.STEP_CASES:
                _single_steps(case)
        finally:
            torch.set_num_threads(threads)
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
    return res


def _case(ranks, key, rank=0):
    for name in ranks[rank]:
        if name.startswith("error/") and key.startswith(name[6:]):
            pytest.fail(ranks[rank][name])
    return ranks[rank][key]


def _errors(got: dict, want: dict) -> dict:
    """{name: max |error| / max |want|}; ints (cache positions) must be
    equal (inf where they are not)."""
    out = {}
    for n, w in want.items():
        if not isinstance(w, np.ndarray):
            out[n] = 0.0 if got[n] == w else float("inf")
            continue
        assert got[n].shape == w.shape, n
        out[n] = float(np.max(np.abs(got[n] - w))
                       / max(np.max(np.abs(w)), 1e-30))
    return out


GRAD_IDS = [f"{c}-{s}-{m}" for c, s, m in S.GRAD_CASES]


@pytest.mark.parametrize("case,seq,mesh", S.GRAD_CASES, ids=GRAD_IDS)
def test_split_gradients_equal_single_device_gradients(ranks, case, seq,
                                                       mesh,
                                                       record_property):
    """The first batch's gradients on every rank within ``GRAD_RTOL`` of
    each tensor's max of the single-device step's."""
    want = _single_grads(case, seq)
    worst = 0.0
    for r in range(WORLD):
        errs = _errors(_case(ranks, f"grads/{case}/{seq}/{mesh}", r)["grads"],
                       want)
        worst = max(worst, max(errs.values()))
        assert {n: e for n, e in errs.items() if e > GRAD_RTOL} == {}
    record_property("worst_grad_err_of_max", worst)


@pytest.mark.parametrize("case", ["rwkv", "zamba"])
def test_cores_run_on_a_quarter_of_the_heads_on_1x4(ranks, case):
    """On (1, 4) each chunked WKV (rwkv6) and chunked Mamba core (zamba2)
    call of the split step sees H / 4 heads: every layer's forward and its
    remat recompute."""
    cfg = S.cfg_for(case)
    kind, h = (("wkv", cfg.rwkv_heads) if case == "rwkv"
               else ("core", cfg.mamba_heads))
    for r in range(WORLD):
        heads = _case(ranks, f"grads/{case}/64/1x4", r)["heads"]
        assert heads == [(kind, h // 4)] * (2 * cfg.n_layers)


def test_gathered_columns_case_runs_every_head(ranks):
    """rwkv6 with 3 heads on a model axis of 2: the WKV runs on every
    head on every rank (r, k, v and w gathered over ``model``)."""
    cfg = S.cfg_for("rwkv_cols")
    assert cfg.rwkv_heads % 2 and cfg.d_model % 2 == 0
    for r in range(WORLD):
        heads = _case(ranks, "grads/rwkv_cols/64/2x2", r)["heads"]
        assert heads == [("wkv", 3)] * (2 * cfg.n_layers)


@pytest.mark.parametrize("control", S.CONTROLS)
def test_controls_fail_the_gradient_gate(ranks, control):
    """zamba2 at seq 32 on (2, 2): the gated norm without its sum over
    ``model``, and ``in_proj`` cut as its storage chunk, each move some
    gradient past 100× ``GRAD_RTOL``."""
    want = _single_grads("zamba", 32)
    errs = _errors(_case(ranks, f"control/{control}"), want)
    assert max(errs.values()) > 100 * GRAD_RTOL


@pytest.mark.parametrize("case", ["rwkv", "zamba"])
def test_prefill_and_decode_under_the_split_equal_single_device(
        ranks, case, record_property):
    """``T.prefill`` over 64 tokens and one ``T.decode_step`` on (1, 4):
    logits and every cache leaf (whole) within ``SERVE_RTOL`` of each
    tensor's max of the single-device calls', on every rank."""
    want = _single_serve(case)
    worst = 0.0
    for r in range(WORLD):
        got = _case(ranks, f"serve/{case}", r)
        for part in ("prefill", "decode"):
            err = _errors({part: got[part]}, {part: want[part]})[part]
            worst = max(worst, err)
            assert err <= SERVE_RTOL, part
        for part in ("cache", "cache2"):
            assert set(got[part]) == set(want[part])
            errs = _errors(got[part], want[part])
            worst = max(worst, max(errs.values()))
            assert {n: e for n, e in errs.items() if e > SERVE_RTOL} == {}
    record_property("worst_err_of_max", worst)


@pytest.mark.parametrize("case", S.STEP_CASES)
def test_float64_split_step_equals_single_device_step(ranks, case,
                                                      record_property):
    """Two float64 steps at seq 32 on (2, 2): metrics within 1e-6
    relative, every parameter and both moments within 1e-5 of each
    tensor's max."""
    got = _case(ranks, f"steps/{case}")
    metrics, want = _single_steps(case)
    for gm, wm in zip(got["metrics"], metrics):
        for k in wm:
            assert abs(gm[k] - wm[k]) <= METRIC_RTOL * max(abs(wm[k]),
                                                           1e-30), k
    for part in ("params", "m", "v"):
        errs = _errors(got[part], want[part])
        record_property(f"worst_{part}_err_of_max", max(errs.values()))
        tol = PARAM_RTOL if part == "params" else MOMENT_RTOL
        assert {n: e for n, e in errs.items() if e > tol} == {}
