"""Whole runs of the harness on the CPU at small sizes, with the kernels'
plain versions: the result line's keys, each reference against the
program's CPU path, the planted faults and the fp8 control judged not
correct under each cell's own limits."""
import json
import time
from pathlib import Path

import pytest

from bench import calibrate, harness, spec
from repro_torch.configs import registry

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 3_000_000_019            # above 2**31, as the driver's are


def _smoke(cell: str, dtype: str = "float32", **traffic) -> dict:
    """The port's smoke configuration of the cell's model as overrides."""
    config = spec.load(cell).config
    smoke = registry.get_smoke_config(config["arch"])
    model = {k: getattr(smoke, k) for k in config["model"]
             if hasattr(smoke, k) and k not in ("attn_impl", "remat",
                                               "remat_policy")}
    model.update(dtype=dtype, max_seq=64, attn_block=16)
    return {"model": model, "traffic": {"seq": 64, **traffic}}


def _run(cell, trace=False, fault=None, dtype="float32", seconds=0.5):
    return harness.run(cell, SEED, seconds, trace,
                       t_start=time.perf_counter(), device="cpu",
                       overrides=_smoke(cell, dtype), fault=fault)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    r = _run("yi-6b.score", trace=trace)
    lines = r.pop("stderr")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r) == keys + (["breakdown"] if trace else []) + ["checks"]
    json.dumps(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert lines[-1].startswith("check loss_gap ")
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if trace:
        assert r["device"]["window_s"] > 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(m["unit"] for m in r["metrics"].values())
    else:
        assert set(r["metrics"]) == {"setup_s", "score_tokens_per_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program_on_the_cpu(cell):
    """fp32 at the smoke configuration: the plain reference and the
    program's CPU path agree to fp32 rounding."""
    r = _run(cell)
    assert r["correct"] is True
    for c in r["checks"].values():
        assert c["value"] < 1e-5


FAULTS = [(c, f) for c in CELLS for f in
          (("unchanged", "half_batch", "answer") if c.endswith(".train")
           else ("half_batch", "answer"))]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_not_correct(cell, fault):
    r = _run(cell, fault=fault)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_is_not_correct(cell):
    """The reference computed in fp8 in the program's place fails one of
    the cell's limits (here at the smoke sizes, in bf16 as configured)."""
    ov = _smoke(cell, "bfloat16")
    got = calibrate.readings(cell, SEED, 10, [], True, device="cpu",
                             overrides=ov)
    limits = spec.load(cell).workload["limits"]
    assert any(got["control"][k] > v for k, v in limits.items()), got
