"""``BENCHMARK.json`` and the files it names: every part found by name,
the contract's limits on names and numbers, and a cell, a traffic mix and a
metric added as new files with no existing file edited."""
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert BENCH["command"] == ["python3", "bench/run.py"]


def test_names_units_and_keys():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200


def test_bounds_and_run_length():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
    run = BENCH["run_seconds"]
    assert 1 <= run <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (run + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    c = spec.load(cell)
    assert c.workload["name"] == cell
    kind = spec.kind_module(c.traffic["kind"])
    for part in ("Driver", "end_to_end", "item_flops", "calibrate"):
        assert callable(getattr(kind, part)), part
    assert callable(spec.flops_module(c.config).forward)
    assert c.workload["limits"] and set(c.workload["limits"]) <= {
        "loss_gap", "loss_rms", "grad_gap", "change_gap"}
    if c.traffic["kind"] == "score":
        assert c.workload["check_requests"] >= 8
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and c.traffic["metric"] in reported
    assert c.per_layer, cell
    for m in c.per_layer:
        assert m["moves"] in reported
        reader = spec.metric_reader(m["name"])
        assert callable(reader.read) and isinstance(reader.SPANS, dict)
    spec.reference(c.config).leaves(c.model)


def test_every_config_used_and_its_cut_listed():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        changed = sorted(k for k, v in cfg["published"].items()
                         if cfg.get(k) != v)
        assert changed == sorted(c["reduced"])


YI = {"hidden_size": "d_model", "intermediate_size": "d_ff",
      "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
      "num_hidden_layers": "n_layers", "vocab_size": "vocab_size",
      "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps"}


@pytest.mark.parametrize("config,keys", [
    ("yi-6b", YI), ("yi-6b-stage", YI),
    ("rwkv6-3b", {"hidden_size": "d_model", "intermediate_size": "d_ff",
                  "num_hidden_layers": "n_layers", "vocab_size": "vocab_size",
                  "time_decay_extra_dim": "rwkv_decay_lora",
                  "layer_norm_epsilon": "norm_eps"}),
])
def test_config_runs_what_it_states(config, keys):
    """Each size the configuration states is the size the program runs,
    but where ``runs_instead`` names the value the port forces."""
    cfg = json.loads((ROOT / "bench" / "configs" / f"{config}.json")
                     .read_text())
    forced = cfg.get("runs_instead", {})
    assert set(forced) <= set(keys) and set(forced).isdisjoint(cfg["reduced"])
    for published, ours in keys.items():
        assert forced.get(published, cfg[published]) == cfg["model"][ours], \
            published


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((root / "bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_traffic_and_metric_are_new_files(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    before = _digest(tmp_path)
    (tmp_path / "bench" / "traffic" / "score_short.json").write_text(
        json.dumps(dict(json.loads((ROOT / "bench" / "traffic" /
                                    "score.json").read_text()), seq=1024)))
    (tmp_path / "bench" / "workloads" / "yi-6b.score_short.json").write_text(
        json.dumps({"name": "yi-6b.score_short", "config": "yi-6b",
                    "traffic": "score_short", "chips": 1, "why": "short",
                    "check_requests": 8, "limits": {"loss_gap": 0.1}}))
    (tmp_path / "bench" / "metrics" / "launches.score.py").write_text(
        "SPANS = {}\n\n\ndef read(ctx):\n    return 42.0\n")
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "yi-6b.score_short", "config": "yi-6b",
         "traffic": "score_short", "chips": 1, "why": "short"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "launches.score", "unit": "1", "better": "lower",
         "source": "program_counter", "layer": "scoring step",
         "moves": "score_tokens_per_s", "workloads": ["yi-6b.score_short"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    c = spec.load("yi-6b.score_short", root=tmp_path)
    assert c.traffic["seq"] == 1024 and c.config["name"] == "yi-6b"
    assert [m["name"] for m in c.per_layer][-1] == "launches.score"
    assert spec.metric_reader("launches.score", root=tmp_path).read(None) \
        == 42.0
    # the cells already there do not report the new metric
    old = spec.load("yi-6b.score", root=tmp_path)
    assert "launches.score" not in {m["name"] for m in old.per_layer}


def test_disagreeing_files_are_refused(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["traffic"] = "score"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="traffic"):
        spec.load(bench["workloads"][0]["name"], root=tmp_path)
    with pytest.raises(KeyError):
        spec.load("no-such.cell", root=tmp_path)


KIND = '''"""Traffic kind ``score_timed``: the score kind's requests, reporting
requests a second beside the traffic's tokens a second."""
from bench import spec

_score = spec.kind_module("score")
Driver, item_flops, calibrate = (_score.Driver, _score.item_flops,
                                 _score.calibrate)


def end_to_end(items, traffic):
    span = items[-1]["t1"] - items[0]["t0"]
    return dict(_score.end_to_end(items, traffic),
                score_requests_per_s=len(items) / span)
'''

RUN_COPY = """
import json, sys, time
from bench import harness
from bench.tests.test_bench_runs import _smoke
out = {{}}
for trace in (False, True):
    r = harness.run("yi-6b-copy.timed", 5, 0.2, trace, device="cpu",
                    t_start=time.perf_counter(),
                    overrides=_smoke("yi-6b-copy.timed"))
    out[trace] = sorted(r["metrics"]), r["correct"]
print(json.dumps(out))
"""


def test_new_kind_family_and_metric_run_from_new_files_alone(tmp_path):
    """A traffic kind, a model family's FLOP count, a configuration, a
    cell and an end-to-end metric added as new files: a run of the new cell
    reports the new metric and the step's share of the peak, and no file
    that was there changed."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path)
    b = tmp_path / "bench"
    (b / "traffic" / "score_timed.py").write_text(KIND)
    (b / "traffic" / "timed.json").write_text(json.dumps(dict(
        json.loads((b / "traffic" / "score.json").read_text()),
        kind="score_timed")))
    (b / "flops" / "dense_copy.py").write_text(
        "from bench import arith\n\n\n"
        "def forward(m, batch, seq):\n"
        "    return 2.0 * batch * seq * m['d_model'] ** 2\n")
    (b / "configs" / "yi-6b-copy.json").write_text(json.dumps(dict(
        json.loads((b / "configs" / "yi-6b.json").read_text()),
        name="yi-6b-copy", flops="dense_copy")))
    (b / "workloads" / "yi-6b-copy.timed.json").write_text(json.dumps(dict(
        json.loads((b / "workloads" / "yi-6b.score.json").read_text()),
        name="yi-6b-copy.timed", config="yi-6b-copy", traffic="timed")))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="yi-6b-copy",
                                 file="bench/configs/yi-6b-copy.json"))
    bench["workloads"].append({"name": "yi-6b-copy.timed",
                               "config": "yi-6b-copy", "traffic": "timed",
                               "chips": 1, "why": "copy"})
    bench["end_to_end"].append({
        "name": "score_requests_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.03, "source": "host_clock",
        "workloads": ["yi-6b-copy.timed"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("score_tokens_per_s", "score_mfu",
                         "idle_share.score"):
            m["workloads"].append("yi-6b-copy.timed")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert {k: v for k, v in _digest(tmp_path).items() if k in before} \
        == before
    out = subprocess.run(
        [sys.executable, "-c", RUN_COPY.format()], capture_output=True,
        text=True, timeout=600, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=f"{tmp_path}:{ROOT / 'src'}"))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["false"] == [["score_requests_per_s", "score_tokens_per_s",
                             "setup_s"], True]
    assert got["true"] == [["idle_share.score", "score_mfu"], True]
