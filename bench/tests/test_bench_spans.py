"""``bench/metrics/_spans.py``'s rule on small Chrome traces made by hand,
and a CPU run of the harness in which the program's ranges are counted and
the readers of device time and launches read None."""
import time
import types

import pytest

from bench import harness, spec
from bench.metrics import _spans
from bench.tests.test_bench_runs import SEED, _smoke
from bench.tracing import STEP_RANGE, TraceView

MAIN, AUTOGRAD = 1, 2                   # the step's thread, autograd's


class Trace:
    """A Chrome trace under construction: ranges, ops, launches and the
    device events they lead to."""

    def __init__(self):
        self.events = []
        self.corr = 0

    def x(self, cat, name, tid, ts, dur, **args):
        self.events.append({"ph": "X", "cat": cat, "name": name, "pid": 7,
                            "tid": tid, "ts": ts, "dur": dur, "args": args})

    def range(self, name, tid, ts, dur):
        self.x("user_annotation", name, tid, ts, dur)

    def node(self, name, seq, tid, ts, dur):
        self.x("cpu_op", f"autograd::engine::evaluate_function: {name}",
               tid, ts, dur, **{"Sequence number": seq})

    def op(self, name, seq, tid, ts, dur=1.0):
        self.x("cpu_op", name, tid, ts, dur, **{"Sequence number": seq})

    def launch(self, tid, ts, us=10.0, device=True, corr=None,
               cat="cuda_runtime"):
        if corr is None:
            self.corr += 1
            corr = self.corr
        self.x(cat, "cudaLaunchKernel", tid, ts, 0.5, correlation=corr)
        if device:
            self.x("kernel", "k", 0, 1000.0 + corr, us, correlation=corr)
        return corr

    def view(self, items=1, step=True):
        for i in range(items):
            self.range(STEP_RANGE, MAIN, 0.0 + 1000.0 * i, 999.0)
            if step:
                self.range("repro_torch.step", MAIN, 1.0 + 1000.0 * i, 990.0)
        return TraceView({"traceEvents": self.events}, {})


def _ctx(view):
    return types.SimpleNamespace(trace=view)


def test_the_innermost_range_wins():
    t = Trace()
    t.range("repro_torch.mixer", MAIN, 10, 40)
    t.range("bench.tri_attn", MAIN, 20, 10)     # not the program's
    t.launch(MAIN, 25, us=3)
    t.launch(MAIN, 60, us=5)                    # in the step alone
    t.range("repro_torch.head", MAIN, 70, 20)
    t.range("repro_torch.loss", MAIN, 91, 20)
    t.launch(MAIN, 75, us=7)
    t.launch(MAIN, 95, us=11)
    view = t.view()
    assert _spans.charge(view) == {"mixer": (3, 1), "step": (5, 1),
                              "head": (7, 1), "loss": (11, 1)}
    assert _spans.ms_per_item(_ctx(view), ["head", "loss"]) \
        == pytest.approx(0.018)
    assert _spans.launches_per_item(_ctx(view)) == 4


def test_a_backward_node_goes_to_its_forward_ops_range():
    t = Trace()
    t.range("repro_torch.ffn", MAIN, 40, 30)
    t.range("repro_torch.mixer", MAIN, 10, 30)
    t.op("aten::arange", 5, MAIN, 12)   # read the counter: 5
    t.op("aten::mm", 5, MAIN, 15)       # made node 5
    t.op("aten::mm", 6, MAIN, 50)       # made node 6
    t.op("aten::mm", 5, AUTOGRAD, 14)   # another thread's 5
    t.node("MmBackward0", 5, AUTOGRAD, 200, 20)
    t.launch(AUTOGRAD, 205, us=2)
    t.node("MmBackward0", 6, AUTOGRAD, 230, 20)
    t.launch(AUTOGRAD, 235, us=4)
    t.node("torch::autograd::AccumulateGrad", None, AUTOGRAD, 260, 5)
    t.launch(AUTOGRAD, 262, us=8)       # no forward op: charged to none
    assert _spans.charge(t.view()) == {"mixer": (2, 1), "ffn": (4, 1)}


def test_the_last_op_of_a_number_made_the_node():
    t = Trace()
    t.range("repro_torch.mixer", MAIN, 10, 30)
    t.op("aten::arange", 9, MAIN, 30)   # read 9 at the mixer's end
    t.range("repro_torch.ffn", MAIN, 40, 30)
    t.op("aten::to", 9, MAIN, 45)       # made node 9
    t.node("ToCopyBackward0", 9, AUTOGRAD, 300, 10)
    t.launch(AUTOGRAD, 305, us=6)
    assert _spans.charge(t.view()) == {"ffn": (6, 1)}


def test_a_recompute_inside_a_node_is_charged_to_its_own_range():
    t = Trace()
    t.range("repro_torch.ffn", MAIN, 40, 30)
    t.op("aten::mm", 6, MAIN, 50)
    t.node("MmBackward0", 6, AUTOGRAD, 100, 60)
    t.range("repro_torch.mixer", AUTOGRAD, 105, 20)     # the recompute
    t.launch(AUTOGRAD, 110, us=3)
    t.launch(AUTOGRAD, 140, us=5)       # the node's own backward
    assert _spans.charge(t.view()) == {"mixer": (3, 1), "ffn": (5, 1)}


def test_a_node_made_in_the_backward_goes_with_the_node_around_it():
    """A plain vjp runs autograd inside its node: the nodes it evaluates
    carry numbers of the backward's thread, which the step's thread may
    hold too; they are charged as the outermost node."""
    t = Trace()
    t.range("repro_torch.mixer", MAIN, 10, 20)
    t.op("_CausalAttention", 3, MAIN, 12)
    t.range("repro_torch.head", MAIN, 40, 20)
    t.op("aten::mm", 4, MAIN, 45)       # the step thread's 4
    t.node("_CausalAttentionBackward", 3, AUTOGRAD, 100, 50)
    t.op("aten::bmm", 4, AUTOGRAD, 105)  # made in the backward: 4
    t.node("BmmBackward0", 4, AUTOGRAD, 110, 10)
    t.launch(AUTOGRAD, 112, us=2)
    t.launch(AUTOGRAD, 130, us=3)
    assert _spans.charge(t.view()) == {"mixer": (5, 2)}


def test_on_one_thread_the_backward_inside_the_step_gives_the_same():
    """On the CPU autograd runs on the caller's thread, inside the step."""
    t = Trace()
    t.range("repro_torch.mixer", MAIN, 10, 30)
    t.op("aten::mm", 5, MAIN, 15)
    t.node("MmBackward0", 5, MAIN, 200, 40)
    t.range("repro_torch.mixer", MAIN, 205, 10)         # recompute
    t.launch(MAIN, 207, us=1)
    t.launch(MAIN, 230, us=2)
    t.launch(MAIN, 300, us=4)           # the optimizer, in the step
    assert _spans.charge(t.view()) == {"mixer": (3, 2), "step": (4, 1)}


def test_a_launch_counts_once():
    t = Trace()
    t.range("repro_torch.mixer", MAIN, 10, 30)
    c = t.launch(MAIN, 15, us=2)
    t.x("kernel", "k2", 0, 2000.0, 3.0, correlation=c)   # a second kernel
    t.launch(MAIN, 16, corr=c, device=False, cat="cuda_driver")
    t.launch(AUTOGRAD, 17, corr=c, device=False)
    view = t.view(items=2)
    assert _spans.charge(view) == {"mixer": (5, 1)}
    assert _spans.launches_per_item(_ctx(view)) == 1


def test_launches_an_item_are_the_most_any_item_has():
    """The profiler loses the device records of its first launches: an
    item that lost some does not lower the count."""
    t = Trace()
    for item in range(3):
        t0 = 1000.0 * item
        t.range("repro_torch.ffn", MAIN, t0 + 10, 30)
        for k in range(4):
            t.launch(MAIN, t0 + 12 + k, device=item > 0 or k > 1)
    view = t.view(items=3)
    assert _spans.charge(view) == {"ffn": (100.0, 10)}
    assert _spans.launches_per_item(_ctx(view)) == 4


def test_a_launch_with_no_device_event_does_not_count():
    t = Trace()
    t.range("repro_torch.ffn", MAIN, 10, 30)
    t.launch(MAIN, 15, device=False)
    view = t.view()
    assert _spans.charge(view) == {}
    assert _spans.ms_per_item(_ctx(view), ["ffn"]) is None
    assert _spans.launches_per_item(_ctx(view)) is None


def test_none_where_the_program_opened_no_range():
    t = Trace()
    t.launch(MAIN, 15)
    view = t.view(step=False)
    assert _spans.charge(view) is None
    for name in ("mixer_ms.score", "ffn_ms.train", "head_ms.score",
                 "kernel_launches.train"):
        assert spec.metric_reader(name).read(_ctx(view)) is None


class _Keeping(harness.Tracer):
    views = []

    def view(self):
        v = super().view()
        self.views.append(v)
        return v


@pytest.mark.parametrize("cell", ["yi-6b.score", "rwkv6-3b.score",
                                  "yi-6b-stage.train"])
def test_cpu_run_counts_the_ranges_and_reads_no_device_time(cell,
                                                            monkeypatch):
    _Keeping.views = []
    monkeypatch.setattr(harness, "Tracer", _Keeping)
    ov = _smoke(cell)
    r = harness.run(cell, SEED, 0.5, True, t_start=time.perf_counter(),
                    device="cpu", overrides=ov)
    assert r["correct"] is True
    (view,) = _Keeping.views
    traffic = spec.load(cell).traffic
    heads = traffic.get("microbatches", 1)      # once a microbatch
    layers = ov["model"]["n_layers"] * heads * (
        2 if traffic["kind"] == "train" else 1)  # and the remat recompute
    assert view.count("repro_torch.step") == view.steps
    for name, n in (("mixer", layers), ("ffn", layers), ("head", heads),
                    ("loss", heads)):
        assert view.count("repro_torch." + name) == view.steps * n, name
    assert _spans.charge(view) == {}
    new = {"mixer_ms", "ffn_ms", "head_ms", "kernel_launches"}
    assert not {k.split(".")[0] for k in r["metrics"]} & new
