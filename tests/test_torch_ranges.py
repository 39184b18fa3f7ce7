"""The model path's profiler ranges (``repro_torch.obs.trace.region``): none
entered without a profiler; under one, ``repro_torch.mixer`` and ``ffn``
once a layer, ``head``, ``loss`` and ``step`` once an item (the layers'
twice more under remat in a train step); every backward node's forward op
inside a range; the same losses either way.  CPU, smoke sizes."""
import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.obs import trace as obs_trace
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (
    TrainConfig, make_eval_step, make_train_step,
)

SEQ = 64
NODE = "autograd::engine::evaluate_function: "
RANGES = ("step", "mixer", "ffn", "head", "loss")


def _cfg(arch, attn_impl=None):
    """The smoke config, its kernels' plain versions; ``attn_impl``
    ``pallas_mapped`` runs tri_attn's (its backward the plain vjp)."""
    cfg = get_smoke_config(arch).replace(max_seq=SEQ, pallas_interpret=True)
    if attn_impl is not None:
        cfg = cfg.replace(attn_impl=attn_impl, attn_block=16)
    return cfg


def _model(cfg):
    return T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def _batch(cfg, rows=2):
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (rows, SEQ), generator=g)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    if cfg.family == "vlm":
        batch["extra"] = torch.randn(rows, cfg.vision_seq, cfg.d_model,
                                     generator=g)
    if cfg.family == "audio":
        batch["extra"] = torch.randn(rows, cfg.encoder_seq, cfg.d_model,
                                     generator=g)
    return batch


def _eval(cfg):
    model, batch = _model(cfg), _batch(cfg)
    step = make_eval_step(cfg, TrainConfig())
    return lambda: step(model, batch)["loss"]


def _train(cfg, microbatches=2):
    model, batch = _model(cfg), _batch(cfg)
    state = opt.init_state(model)
    step = make_train_step(cfg, TrainConfig(microbatches=microbatches))
    return lambda: step(model, state, batch)[2]["loss"]


def _traced(fn):
    """fn's result and the profiler that recorded one call of it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _counts(prof) -> dict:
    got = {e.key: e.count for e in prof.key_averages()}
    return {r: got.get(obs_trace.REGION_PREFIX + r, 0) for r in RANGES}


def _events(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def test_region_is_the_shared_noop_without_a_profiler():
    assert obs_trace.region("mixer") is obs_trace._NOOP
    with profile(activities=[ProfilerActivity.CPU]):
        live = obs_trace.region("mixer")
        assert live is not obs_trace._NOOP
        with live:
            pass
    assert obs_trace.region("mixer") is obs_trace._NOOP


@pytest.mark.parametrize("case", ["dense_eval", "dense_train", "ssm_eval"])
def test_no_profiler_enters_no_range(case, monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    arch = "rwkv6-3b" if case.startswith("ssm") else "yi-6b"
    fn = (_train if case.endswith("train") else _eval)(_cfg(arch))
    assert torch.isfinite(fn())
    assert entered == []


# eval counts (mixer, ffn) a family's smoke model shows, one item
EVAL_COUNTS = {
    "yi-6b": (3, 3),                    # dense: one of each a layer
    "rwkv6-3b": (3, 3),                 # ssm: the same as dense
    "moonshot-v1-16b-a3b": (3, 3),      # moe: the MoE in the ffn
    "llama-3.2-vision-11b": (10, 10),   # vlm: self and cross layers
    "zamba2-1.2b": (6 + 2, 2),          # hybrid: mamba layers + 2 firings
    "whisper-medium": (2 + 2, 2 + 2),   # audio: encoder + decoder layers
}


@pytest.mark.parametrize("arch", list(EVAL_COUNTS))
def test_eval_step_ranges(arch):
    cfg = _cfg(arch)
    _, prof = _traced(_eval(cfg))
    mixer, ffn = EVAL_COUNTS[arch]
    assert _counts(prof) == {"step": 1, "mixer": mixer, "ffn": ffn,
                             "head": 1, "loss": 1}


@pytest.mark.parametrize("arch,attn_impl", [
    ("yi-6b", None), ("yi-6b", "pallas_mapped"), ("rwkv6-3b", None)])
def test_train_step_ranges_under_remat(arch, attn_impl):
    """remat ``full`` and 2 microbatches: each layer's ranges in the
    forward and again in the recompute, a microbatch; the head and loss
    once a microbatch."""
    cfg = _cfg(arch, attn_impl)
    assert cfg.remat and cfg.remat_policy == "full"
    _, prof = _traced(_train(cfg))
    layers = 2 * cfg.n_layers * 2
    assert _counts(prof) == {"step": 1, "mixer": layers, "ffn": layers,
                             "head": 2, "loss": 2}


def _enclosing(ranges, t):
    inner = [r for r in ranges if r["ts"] <= t <= r["ts"] + r["dur"]]
    return max(inner, key=lambda r: r["ts"])["name"] if inner else None


@pytest.mark.parametrize("arch,attn_impl", [
    ("yi-6b", None), ("yi-6b", "pallas_mapped"), ("rwkv6-3b", None)])
def test_backward_nodes_resolve_to_a_layer(arch, attn_impl, tmp_path):
    """Each backward node the engine runs (outside another node's range)
    names by its sequence number a forward op, the last to start before it
    with that number; that op lies in a layer's range (mixer, ffn, head or
    loss), but the embedding's, which lies in the step alone."""
    _, prof = _traced(_train(_cfg(arch, attn_impl)))
    events = _events(prof, tmp_path)
    ranges = [e for e in events
              if e["name"].startswith(obs_trace.REGION_PREFIX)]
    nodes = sorted((e for e in events if e["name"].startswith(NODE)),
                   key=lambda e: e["ts"])
    ops = collections.defaultdict(list)
    for e in events:
        seq = e.get("args", {}).get("Sequence number")
        if seq is not None and seq >= 0 and not e["name"].startswith(NODE):
            ops[seq].append(e)
    top, end = [], -1.0
    for n in nodes:
        if n["ts"] > end:
            top.append(n)
            end = n["ts"] + n["dur"]
    where = collections.Counter()
    for n in top:
        if n["name"].endswith("AccumulateGrad"):
            continue                    # made for a leaf, by no forward op
        seq = n["args"]["Sequence number"]
        before = [e for e in ops[seq] if e["ts"] < n["ts"]]
        assert before, n["name"]
        op = max(before, key=lambda e: e["ts"])
        name = _enclosing(ranges, op["ts"])
        assert name is not None, (n["name"], op["name"])
        where[(name, n["name"][len(NODE):])] += 1
    outside = {node for (name, node) in where
               if name == obs_trace.REGION_PREFIX + "step"}
    assert outside == {"_LookupBackward"}
    for r in ("mixer", "ffn", "head", "loss"):
        assert any(name == obs_trace.REGION_PREFIX + r for name, _ in where)


@pytest.mark.parametrize("case", ["dense_eval", "dense_train", "ssm_eval"])
def test_losses_bitwise_equal_with_the_profiler_on(case):
    arch = "rwkv6-3b" if case.startswith("ssm") else "yi-6b"
    make = _train if case.endswith("train") else _eval
    off = make(_cfg(arch))()
    on, _ = _traced(make(_cfg(arch)))
    assert torch.equal(off, on)
