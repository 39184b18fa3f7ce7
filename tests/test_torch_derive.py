"""The port's derive path (``repro_torch.core``: prompts, the mock replay
bank, synthesis, validation, complexity, the pipeline, energy, the dry run)
held against the JAX package's on the same inputs.

Content addresses first: ``cache_key`` hashes the prompt and the replay
bank's fingerprint, so one changed byte in a copied template changes every
key in the grid.  Records are compared without their two timing fields
(``wall_seconds``, ``created_unix``); everything else — the modelled
``response.seconds`` / ``joules`` included — must be equal.  Every grid here
runs with ``cache=None`` or a store of its own: both packages honour
``REPRO_ARTIFACT_CACHE``, and a shared root would let the port load the
reference's records and compare a record with itself."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core import backends as rb
from repro.core import complexity as rcx
from repro.core import energy as ren
from repro.core import paper_tables as rpt
from repro.core import pipeline as rp
from repro.core import synthesis as rsyn
from repro.core import validate as rval
from repro.core.domains import DOMAINS as RDOMAINS
from repro.core.maps import VARIANT_MAPS as RVARIANTS
from repro_torch.core import backends as tb
from repro_torch.core import complexity as tcx
from repro_torch.core import energy as ten
from repro_torch.core import paper_tables as tpt
from repro_torch.core import pipeline as tp
from repro_torch.core import synthesis as tsyn
from repro_torch.core import validate as tval
from repro_torch.core.domains import DOMAINS as TDOMAINS
from repro_torch.core.maps import VARIANT_MAPS as TVARIANTS
from repro_torch.core.maps import np_map_tri2d

ROOT = os.path.join(os.path.dirname(__file__), "..")
N_VALIDATE = 5_000
TIMING = ("wall_seconds", "created_unix")
PAPER_CELLS = [(d, m, s) for d in sorted(rpt.ACCURACY) for m in rpt.MODELS
               for s in rpt.STAGES]
EXTENSION = sorted(set(TDOMAINS) - set(tpt.ACCURACY))
#: the grid run through both pipelines: 6 paper domains x 3 models x 3 stages
GRID_MODELS = ("R1:70b", "OSS:120b", "Qw3:32b")


def _same(a, b) -> bool:
    """Equal dataclasses of the two packages: the same class name and equal
    fields (``==`` alone is False across the two packages' classes)."""
    if a is None or b is None:
        return a is b
    return (type(a).__name__ == type(b).__name__
            and dataclasses.asdict(a) == dataclasses.asdict(b))


def _record(pipeline, res) -> dict:
    rec = pipeline.record_from_result(res)
    for k in TIMING:
        rec.pop(k)
    return rec


# ---------------------------------------------------------------------------
# Tables, prompts and the replay bank
# ---------------------------------------------------------------------------


def test_paper_tables_equal_reference():
    names = [n for n in dir(rpt) if n.isupper()]
    assert names == [n for n in dir(tpt) if n.isupper()]
    for name in names:
        assert getattr(tpt, name) == getattr(rpt, name), name


def test_domain_sets_equal_reference():
    assert list(TDOMAINS) == list(RDOMAINS)


@pytest.mark.parametrize("stage", [20, 50, 100])
@pytest.mark.parametrize("domain", sorted(TDOMAINS))
def test_build_prompt_byte_equal(domain, stage):
    mine = tb.build_prompt(TDOMAINS[domain], stage)
    ref = rb.build_prompt(RDOMAINS[domain], stage)
    assert mine.encode() == ref.encode()


def test_replay_bank_fingerprint_equal():
    assert tb.PROMPT_TEMPLATE == rb.PROMPT_TEMPLATE
    assert tb.CODE_TEMPLATES == rb.CODE_TEMPLATES
    assert tb.MODEL_SPECS == rb.MODEL_SPECS
    assert tb.replay_bank_fingerprint() == rb.replay_bank_fingerprint()


def test_mock_generate_equal_on_every_paper_and_extension_cell():
    cells = PAPER_CELLS + [(d, m, s) for d in EXTENSION
                           for m in rpt.MODELS for s in rpt.STAGES]
    prompts = {}
    for d, m, s in cells:
        if (d, s) not in prompts:
            prompts[(d, s)] = tb.build_prompt(TDOMAINS[d], s)
        meta = {"domain": d, "stage": s}
        mine = tb.MockLLMBackend(m).generate(prompts[(d, s)], meta=meta)
        ref = rb.MockLLMBackend(m).generate(prompts[(d, s)], meta=meta)
        assert mine.__dict__ == ref.__dict__, (d, m, s)
        assert tb.response_fingerprint(mine) == rb.response_fingerprint(ref)
        assert tb.mock_behavior(d, m, s) == rb.mock_behavior(d, m, s)
    assert len(cells) == 198 + 33 * len(EXTENSION)


def test_canonical_code_equal_for_every_domain():
    for d in TDOMAINS:
        assert tb.canonical_code(d) == rb.canonical_code(d)


def test_engine_backend_waits_on_its_queue_item():
    """EngineBackend (ROADMAP queue 1 item 7) is ported: an engine derive
    on the CPU gives the reference's content address and, through the
    canonical fallback, its record (timing and inference fields aside)."""
    dom, stage = "tri2d", 20
    mine = tp.derive_mapping(
        TDOMAINS[dom], tb.EngineBackend("OSS:120b", max_new_tokens=4,
                                        device="cpu"),
        stage, n_validate=2000, sample_every=1, cache=None)
    ref = rp.derive_mapping(
        RDOMAINS[dom], rb.EngineBackend("OSS:120b", max_new_tokens=4),
        stage, n_validate=2000, sample_every=1, cache=None)
    assert mine.cache_key == ref.cache_key
    assert mine.source == ref.source and mine.compiled and ref.compiled
    assert mine.response.tokens_out == ref.response.tokens_out == 4
    ra, rr = mine.artifact.to_record(), ref.artifact.to_record()
    measured = {k for k in rr if k in ("created_unix", "inference_seconds")
                or "joule" in k or "energy" in k}
    assert set(ra) == set(rr) and "inference_seconds" in measured
    assert {k: v for k, v in ra.items() if k not in measured} \
        == {k: v for k, v in rr.items() if k not in measured}


# ---------------------------------------------------------------------------
# Synthesis: the rule check and the restricted namespace
# ---------------------------------------------------------------------------

REJECTED = {
    "syntax_error": "def map_to_coordinates(n:\n  return",
    "wrong_name": "def f(n):\n    return (n, n)\n",
    "forbidden_import": ("import os\ndef map_to_coordinates(n):\n"
                         "    return (n, n)\n"),
    "runtime_os": ("def map_to_coordinates(n):\n"
                   "    __import__('os').system('true')\n"
                   "    return (n, n)\n"),
    "import_torch": ("import torch\ndef map_to_coordinates(n):\n"
                     "    return (n, n)\n"),
    "runtime_torch": ("def map_to_coordinates(n):\n"
                      "    __import__('torch').zeros(1)\n"
                      "    return (n, n)\n"),
    "runtime_numpy": ("def map_to_coordinates(n):\n"
                      "    __import__('numpy')\n"
                      "    return (n, n)\n"),
    "runtime_open": ("def map_to_coordinates(n):\n"
                     "    open('/etc/passwd')\n"
                     "    return (n, n)\n"),
    "noncompiling": rb._NONCOMPILING,
    "empty": "```python\n```",
    "float_output": "def map_to_coordinates(n):\n    return (0.5, n)\n",
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_synthesis_rejects_like_reference(case):
    code = REJECTED[case]
    with pytest.raises(rsyn.SynthesisError) as ref:
        rsyn.synthesize(code)
    with pytest.raises(tsyn.SynthesisError) as mine:
        tsyn.synthesize(code)
    assert str(mine.value) == str(ref.value)


def test_synthesis_flags_hardcoded_chains_like_reference():
    code = ("def map_to_coordinates(n):\n"
            + "".join(f"    if n == {i}:\n        return ({i}, 0)\n"
                      for i in range(8))
            + "    return (n, 0)\n")
    mine = tsyn.synthesize(code)
    assert mine.rule_violations == rsyn.synthesize(code).rule_violations
    assert any("hardcoded" in v for v in mine.rule_violations)


def test_restricted_builtins_equal_reference():
    assert set(tsyn._SAFE_BUILTINS) == set(rsyn._SAFE_BUILTINS)
    for name, obj in rsyn._SAFE_BUILTINS.items():
        if name != "__import__":
            assert tsyn._SAFE_BUILTINS[name] is obj, name
    import math
    assert tsyn._restricted_import("math") is math
    for name in ("os", "torch", "numpy", "sys", "mathx"):
        with pytest.raises(ImportError):
            tsyn._restricted_import(name)


# ---------------------------------------------------------------------------
# Validation and complexity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dom_logic", sorted(rb.CODE_TEMPLATES))
def test_code_templates_perfect_and_reports_equal(dom_logic):
    dom = dom_logic[0]
    code = tb.CODE_TEMPLATES[dom_logic]
    mine = tval.validate_scalar_fn(tsyn.synthesize(code).fn, TDOMAINS[dom],
                                   n_points=3000)
    ref = rval.validate_scalar_fn(rsyn.synthesize(code).fn, RDOMAINS[dom],
                                  n_points=3000)
    assert _same(mine, ref)
    assert mine.ordered == 1.0 and mine.bijective and mine.error is None


@pytest.mark.parametrize("behavior", ["permuted", "rowmajor_fit",
                                      "wrong_base"])
def test_failed_candidates_report_equal(behavior):
    for d, m, s in PAPER_CELLS:
        if rb.mock_behavior(d, m, s)[0] == behavior:
            break
    code = rb.mock_behavior(d, m, s)[1]
    for every in (1, 7):
        mine = tval.validate_scalar_fn(tsyn.synthesize(code).fn,
                                       TDOMAINS[d], 4000, sample_every=every)
        ref = rval.validate_scalar_fn(rsyn.synthesize(code).fn,
                                      RDOMAINS[d], 4000, sample_every=every)
        assert _same(mine, ref), (d, m, s, every)
        assert mine.ordered < 1.0


def test_validate_vectorized_reports_equal():
    def permuted(lams):
        xy = np_map_tri2d(lams)
        return np.stack([xy[:, 0], xy[:, 0] - xy[:, 1]], axis=-1)

    n = TDOMAINS["tri2d"].size(140)
    for fn in (np_map_tri2d, permuted):
        mine = tval.validate_vectorized(fn, TDOMAINS["tri2d"], n)
        ref = rval.validate_vectorized(fn, RDOMAINS["tri2d"], n)
        assert _same(mine, ref)
    gt = TDOMAINS["tri2d"].enumerate_points(1000)
    for pred in (np.concatenate([gt[:500], gt[:500]]),
                 gt + np.array([0, 10**6])):
        assert _same(tval.evaluate_candidate_array(pred, gt, 1000),
                     rval.evaluate_candidate_array(pred, gt, 1000))
    pts = TDOMAINS["menger3d"].enumerate_points(8000)
    np.testing.assert_array_equal(tval.encode_coords(pts),
                                  rval.encode_coords(pts))
    assert _same(tval.FAILED(10, "x"), rval.FAILED(10, "x"))


def test_scalar_failures_report_equal():
    for fn in (lambda n: 1 // 0, lambda n: (n, n, n), lambda n: (-1, n)):
        assert _same(tval.validate_scalar_fn(fn, TDOMAINS["tri2d"], 100),
                     rval.validate_scalar_fn(fn, RDOMAINS["tri2d"], 100))


def test_variant_maps_keys_and_classes_equal():
    assert sorted(TVARIANTS) == sorted(RVARIANTS)
    for key in sorted(RVARIANTS):
        mine = tcx.classify(TVARIANTS[key])
        ref = rcx.classify(RVARIANTS[key])
        assert mine == ref, key


def test_classify_leaves_an_installed_tracer_in_place():
    seen = []

    def outer(frame, event, arg):
        seen.append(event)
        return None

    old = sys.gettrace()
    sys.settrace(outer)
    try:
        tcx.classify(TVARIANTS[("tri2d", "analytical")])
        assert sys.gettrace() is outer
    finally:
        sys.settrace(old)


# ---------------------------------------------------------------------------
# The grid: content addresses, records, energy
# ---------------------------------------------------------------------------


def test_content_addresses_equal_on_every_paper_cell():
    for d, m, s in PAPER_CELLS:
        mine = tp.prepare_request(TDOMAINS[d], tb.MockLLMBackend(m), s)
        ref = rp.prepare_request(RDOMAINS[d], rb.MockLLMBackend(m), s)
        assert mine.key == ref.key and mine.prompt == ref.prompt, (d, m, s)


@pytest.fixture(scope="module")
def grids():
    kw = dict(models=GRID_MODELS, n_validate=N_VALIDATE, cache=None)
    return tp.run_grid(**kw), rp.run_grid(**kw)


def test_run_grid_keys_and_records_equal(grids):
    mine, ref = grids
    assert list(mine) == list(ref)
    assert len(mine) == len(rpt.ACCURACY) * len(GRID_MODELS) * 3
    for cell in ref:
        a, b = mine[cell], ref[cell]
        assert a.cache_key == b.cache_key, cell
        assert _record(tp, a) == _record(rp, b), cell
        assert (a.perfect, a.silver, a.logic) == (b.perfect, b.silver,
                                                  b.logic)
        art_a, art_b = a.artifact, b.artifact
        assert (art_a is None) == (art_b is None)
        if art_a is not None:
            ra, rb_ = art_a.to_record(), art_b.to_record()
            for k in ("created_unix", "inference_seconds"):
                ra.pop(k)
                rb_.pop(k)
            assert ra == rb_, cell
    perfect = {c for c, r in mine.items() if r.perfect}
    want = {(d, m, s) for d, m, s in ref
            if rpt.ACCURACY[d][m][rpt.STAGES.index(s)][2]
            and rpt.ACCURACY[d][m][rpt.STAGES.index(s)][0] >= 100.0}
    assert perfect == want and not any(c[0] == "menger3d" for c in perfect)


def test_amortization_equal_on_every_cell(grids):
    mine, ref = grids
    for cell in ref:
        assert _same(mine[cell].amortization(), ref[cell].amortization()), \
            cell


@pytest.mark.parametrize("n_points", [1_000_000, 500_000_000])
def test_energy_estimates_equal(n_points):
    logics = ("analytical", "binsearch", "linear", "sqrt_loop", "approx_if",
              "cbrt_loop", "bitwise", "permuted", "binsearch_linear")
    for name in sorted(TDOMAINS):
        d, rd = TDOMAINS[name], RDOMAINS[name]
        assert _same(ten.estimate_bounding_box(d, n_points),
                     ren.estimate_bounding_box(rd, n_points))
        for logic in logics:
            key = ten._logic_key(logic, d)
            if key not in ten.A100_NS_PER_BLOCK:
                continue
            assert _same(ten.estimate_mapped(d, logic, n_points),
                         ren.estimate_mapped(rd, logic, n_points))
            assert _same(ten.amortization(d, logic, 1234.5, n_points),
                         ren.amortization(rd, logic, 1234.5, n_points))
    assert ten.points_per_joule(10**6, 7.0) == ren.points_per_joule(10**6,
                                                                   7.0)


def test_energy_a100_model_kept_and_h100_spec_values():
    assert ten.A100_NS_PER_BLOCK == ren.A100_NS_PER_BLOCK
    assert ten.A100_J_PER_BLOCK == ren.A100_J_PER_BLOCK
    assert ten.A100_POWER_W == ren.A100_POWER_W
    assert not any(n.startswith("TPU") for n in dir(ten))
    assert (ten.H100_BF16_FLOPS, ten.H100_FP32_FLOPS, ten.H100_HBM_BW,
            ten.H100_POWER_W) == (989e12, 67e12, 3.35e12, 700.0)
    proj = ten.h100_block_projection(0.0, 4096.0, 1000)
    assert proj["bound"] == "memory"
    assert proj["time_s"] == 4096.0 * 1000 / 3.35e12
    assert proj["energy_j"] == proj["time_s"] * 700.0


# ---------------------------------------------------------------------------
# The dry run's --domain-map entry point
# ---------------------------------------------------------------------------


def test_dryrun_domain_map_record_equals_reference(tmp_path, monkeypatch):
    from repro_torch.launch import dryrun

    env = {**os.environ, "PYTHONPATH": os.path.abspath(os.path.join(ROOT,
                                                                    "src")),
           "JAX_PLATFORMS": "cpu",
           "REPRO_ARTIFACT_CACHE": str(tmp_path / "ref_store")}
    out = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--domain-map", "tri2d",
         "--out", str(tmp_path / "ref")], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    monkeypatch.setenv("REPRO_ARTIFACT_CACHE", str(tmp_path / "port_store"))
    dryrun.main(["--domain-map", "tri2d", "--device", "cpu",
                 "--out", str(tmp_path / "port")])
    name = "domain_map__tri2d__OSS:120b.json"
    mine = json.loads((tmp_path / "port" / name).read_text())
    ref = json.loads((tmp_path / "ref" / name).read_text())
    assert mine.pop("kernel_s") >= 0 and ref.pop("kernel_s") >= 0
    assert mine == ref and mine["status"] == "ok"


def test_dryrun_refusals(tmp_path, monkeypatch):
    from repro_torch.launch import dryrun

    monkeypatch.setenv("REPRO_ARTIFACT_CACHE", str(tmp_path / "store"))
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--domain-map", "menger3d", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert "not deployable" in str(e.value.code)
    # the (arch x shape) dry run is ported (queue 1 item 10): a cell runs
    # on the fake production mesh; --arch alone is refused
    dryrun.main(["--arch", "yi-6b", "--shape", "train_4k", "--multi-pod",
                 "off", "--smoke", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "yi-6b__train_4k__sp.json").read_text())
    assert rec["status"] == "ok" and rec["step"]["flops_per_device"] > 0
    with pytest.raises(SystemExit, match="--arch and --shape"):
        dryrun.main(["--arch", "yi-6b"])
    # the default device is the card: without one it raises, never falls
    # back to the plain version
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--domain-map", "tri2d", "--out", str(tmp_path)])
