"""The yardstick's arithmetic against hand counts at the cells' shapes, the
end-to-end arithmetic on synthetic timings, and the trace readers on a
hand-written Chrome trace."""
import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import arith, drive, readers, spec
from bench.tracing import BACKWARD_RANGE, STEP_RANGE, TraceView

ROOT = Path(__file__).resolve().parents[2]


def _model(config):
    return json.loads((ROOT / "bench" / "configs" / f"{config}.json")
                      .read_text())["model"]


def test_tri_attn_at_yi_heads():
    # 2 products x 2 FLOPs x D x S(S+1)/2 pairs x H
    flops, nbytes = arith.tri_attn_forward(1, 32, 4, 4096, 128, "bfloat16")
    assert flops == 4 * 128 * (4096 * 4097 // 2) * 32
    assert f"{flops:.4g}" == "1.375e+11"
    assert nbytes == 2 * 4096 * 128 * (2 * 32 + 2 * 4)
    assert arith.least_time(flops, nbytes, "bfloat16") == pytest.approx(
        1.3747e11 / 989e12, rel=1e-4)
    bflops, _ = arith.tri_attn_backward(1, 32, 4, 4096, 128, "bfloat16")
    assert bflops == 2 * flops


def test_wkv_at_rwkv6_heads():
    flops, nbytes = arith.wkv_chunked(40, 4096, 64, 64, "bfloat16",
                                      "float32")
    assert f"{flops:.3g}" == "4.06e+09"
    assert f"{nbytes / 1e6:.0f}" == "148"
    # bound by the bytes: 148 MB at 3.35 TB/s
    assert arith.least_time(flops, nbytes, "bfloat16") == pytest.approx(
        nbytes / 3.35e12)


def _flops(config):
    cfg = json.loads((ROOT / "bench" / "configs" / f"{config}.json")
                     .read_text())
    return spec.flops_module(cfg)


def test_model_flops_at_the_cells():
    yi, stage, rw = _model("yi-6b"), _model("yi-6b-stage"), _model("rwkv6-3b")
    dense, rwkv = _flops("yi-6b"), _flops("rwkv6-3b")
    assert _flops("yi-6b-stage").forward is not None
    # a layer: q and o 4096 x 4096, k and v 4096 x 512, three 4096 x 11008;
    # the head 4096 x 64000
    layer = 2 * 4096 * 4096 + 2 * 4096 * 512 + 3 * 4096 * 11008
    assert dense.matmul_params(yi) == 32 * layer + 4096 * 64000 \
        == 5_798_625_280
    assert dense.matmul_params(stage) == 16 * layer + 4096 * 64000 \
        == 3_030_384_640
    assert rwkv.matmul_params(rw) == 2_904_555_520
    assert f"{dense.forward(yi, 1, 4096):.3g}" == "5.19e+13"
    assert f"{dense.forward(stage, 1, 4096):.3g}" == "2.7e+13"
    assert f"{rwkv.forward(rw, 1, 4096):.3g}" == "2.39e+13"
    train = spec.kind_module("train")
    assert f"{train.item_flops(dense, stage, {'rows': 2, 'seq': 4096}):.3g}" \
        == "1.62e+14"
    score = spec.kind_module("score")
    assert score.item_flops(dense, yi, {"rows": 1, "seq": 4096}) \
        == dense.forward(yi, 1, 4096)


def _items(durations, tokens=100, traced=()):
    t, out = 0.0, []
    for i, d in enumerate(durations):
        out.append({"t0": t, "t1": t + d, "answer": 1.0, "tokens": tokens,
                    "traced": i in traced})
        t += d
    return out


def test_throughput_over_the_whole_window_and_a_stall_moves_it():
    steady = _items([0.5] * 10)
    assert drive.throughput(steady) == pytest.approx(200.0)
    stalled = _items([0.5] * 5 + [2.5] + [0.5] * 4)
    assert drive.throughput(stalled) == pytest.approx(1000 / 7.0)
    cfg = json.loads((ROOT / "bench" / "configs" / "yi-6b.json").read_text())
    kind, flops = spec.kind_module("score"), spec.flops_module(cfg)
    traffic = {"rows": 1, "seq": 4096, "metric": "score_tokens_per_s"}
    assert kind.end_to_end(stalled, traffic) == {
        "score_tokens_per_s": pytest.approx(1000 / 7.0)}
    ctx = SimpleNamespace(items=steady, config=cfg, model=cfg["model"],
                          traffic=traffic, kind=kind, flops=flops)
    mfu = readers.step_mfu(ctx)
    assert mfu == pytest.approx(100 * flops.forward(cfg["model"], 1, 4096)
                                / 0.5 / 989e12)
    ctx.items = stalled
    assert readers.step_mfu(ctx) < mfu


def test_window_runs_whole_items_until_the_seconds_pass():
    clock = iter(range(100))
    items = drive.window(lambda: float(next(clock)), 0.0, 7)
    assert len(items) == 1 and items[0]["tokens"] == 7
    assert items[0]["traced"] is False


def _trace():
    """Two traced steps; an entry range with two kernels, its backward
    node with one; the longest idle gap 60 µs, under aten::mm."""
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 1, "tid": tid, "args": args}
    ev = [x("user_annotation", STEP_RANGE, 0, 100),
          x("user_annotation", STEP_RANGE, 100, 100),
          x("user_annotation", "bench.tri_attn", 10, 20),
          x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
          x("cuda_runtime", "cudaLaunchKernel", 15, 1, correlation=2),
          x("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=3),
          x("cpu_op", BACKWARD_RANGE.format("_CausalAttentionBackward"),
            110, 20, tid=2),
          x("cuda_runtime", "cudaLaunchKernel", 111, 1, tid=2,
            correlation=4),
          x("cpu_op", "aten::mm", 65, 50),
          x("kernel", "void ta_sm90_kernel<128>(int)", 20, 10,
            correlation=1),
          x("kernel", "ta_sm90_combine_kernel", 30, 10, correlation=2),
          x("kernel", "sm90_xmma_gemm_bf16", 40, 20, correlation=3),
          x("kernel", "elementwise_kernel", 120, 30, correlation=4),
          x("kernel", "elementwise_kernel", 190, 10, correlation=5)]
    return {"traceEvents": ev}


def test_trace_view_attributes_kernels_to_ranges():
    calls = {"tri_attn": [
        {"tensors": [((1, 32, 4096, 128), "bfloat16"),
                     ((1, 4, 4096, 128), "bfloat16")], "args": [],
         "kwargs": {}, "grad_fn": None}]}
    view = TraceView(_trace(), calls)
    assert view.window == (0.0, 200.0) and view.steps == 2
    assert view.busy_s == pytest.approx(80e-6)
    assert view.device_s(["bench.tri_attn"]) == pytest.approx(20e-6)
    bwd = BACKWARD_RANGE.format("_CausalAttentionBackward")
    assert view.device_s(["bench.tri_attn", bwd]) == pytest.approx(50e-6)
    assert view.analysis["top_kernels"][0] == ("elementwise_kernel", 40.0)
    gap_op, gap_us = view.analysis["idle_gaps"][0]
    assert (gap_op, gap_us) == ("aten::mm", 60.0)
    ctx = SimpleNamespace(trace=view, calls=calls)
    from bench.metrics import _tri_attn
    f, b = arith.tri_attn_forward(1, 32, 4, 4096, 128, "bfloat16")
    assert readers.roofline(ctx, "tri_attn", _tri_attn.cost) == \
        pytest.approx(100 * arith.least_time(f, b, "bfloat16") / 20e-6)


def test_idle_share_is_the_busy_time_of_an_item_over_the_untraced_ones():
    """Two traced steps with 80 µs of device time: 40 µs busy a step.
    Untraced steps of 50 µs leave the device idle 20% of the time; a stall
    in one of them widens the idle share, while the traced steps' own host
    time (stretched by the profiler) does not enter."""
    view = TraceView(_trace(), {})
    steady = _items([50e-6] * 4 + [500e-6] * 2, traced=(4, 5))
    ctx = SimpleNamespace(trace=view, items=steady)
    assert readers.idle_share(ctx) == pytest.approx(20.0)
    idle = spec.metric_reader("idle_share.score")
    assert idle.read(ctx) == pytest.approx(20.0)
    ctx.items = _items([50e-6] * 3 + [250e-6] + [500e-6] * 2, traced=(4, 5))
    assert readers.idle_share(ctx) == pytest.approx(60.0)
    ctx.items = _items([1.0], traced=(0,))
    assert idle.read(ctx) is None


def test_roofline_counts_forward_and_backward_once_a_backward():
    view = TraceView(_trace(), {})
    call = {"tensors": [((1, 32, 4096, 128), "bfloat16"),
                        ((1, 4, 4096, 128), "bfloat16")], "args": [],
            "kwargs": {}, "grad_fn": "_CausalAttentionBackward"}
    # two calls with a node (a forward and its recompute), one backward run
    ctx = SimpleNamespace(trace=view, calls={"tri_attn": [call, call]})
    from bench.metrics import _tri_attn
    f = arith.least_time(*arith.tri_attn_forward(1, 32, 4, 4096, 128,
                                                 "bfloat16"), "bfloat16")
    bk = arith.least_time(*arith.tri_attn_backward(1, 32, 4, 4096, 128,
                                                   "bfloat16"), "bfloat16")
    assert readers.roofline(ctx, "tri_attn", _tri_attn.cost) == \
        pytest.approx(100 * (f + bk) / 50e-6)


def test_readers_find_nothing_to_read_and_say_so():
    view = TraceView(_trace(), {})
    ctx = SimpleNamespace(trace=view, calls={}, items=_items([1.0], traced=(0,)))
    for name in ("wkv_roofline", "optimizer_ms", "tri_attn_roofline.score",
                 "score_mfu", "train_mfu"):
        assert spec.metric_reader(name).read(ctx) is None


def test_wkv_cost_reads_the_model_layout():
    wkv = spec.metric_reader("wkv_roofline")
    call = {"tensors": [((1, 4096, 40, 64), "bfloat16")] * 4, "args": [],
            "kwargs": {"chunk": 64, "out_dtype": "float32"}, "grad_fn": None}
    flops, nbytes, dtype = wkv.cost(call, False)
    assert (flops, nbytes) == arith.wkv_chunked(40, 4096, 64, 64, "bfloat16",
                                                "float32")
    assert dtype == "bfloat16" and math.isfinite(flops)


def test_a_non_finite_answer_fails_the_check():
    score = spec.kind_module("score")
    gaps = score.score_gaps([1e-3, -2e-3])
    assert gaps["loss_gap"] == pytest.approx(2e-3)
    assert gaps["loss_rms"] == pytest.approx(math.sqrt(2.5e-6))
    bad = score.score_gaps([1e-3, float("nan")])
    assert bad == {"loss_gap": math.inf, "loss_rms": math.inf}
