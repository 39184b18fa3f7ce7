"""The port's examples (``examples_torch/``) against the reference's
(``examples/``) on the CPU: every script run with ``--device cpu`` (the
kernels' plain versions), its results held against the reference's own
functions on the same arguments, the LM presets against the argv the
reference's scripts build, and every script raising where it is asked for
the card and there is none."""
import importlib.util
import os
import runpy
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as ref_pipeline
from repro.core.backends import MockLLMBackend as RefMockLLMBackend
from repro.core.domains import DOMAINS as REF_DOMAINS
from repro.kernels.domain_map import ops as ref_ops
from repro.kernels.tri_attn import ops as ref_attn
from repro_torch.core.artifact import ArtifactCache
from repro_torch.serving import MappingHTTPServer, MappingService

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ("quickstart", "fractal_compute", "derive_and_deploy", "serve_lm",
           "train_lm")


def example(name: str):
    """``examples_torch/<name>.py`` as a module; its main is not run."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def own_store(tmp_path, monkeypatch):
    """A fresh artifact store for the port's run, so nothing the reference
    derived earlier in the session is read back."""
    monkeypatch.setenv("REPRO_ARTIFACT_CACHE", str(tmp_path / "port_store"))


def reference_lines(script: str, argv: list, capsys, monkeypatch) -> list:
    """``examples/<script>.py`` run as a script, its printed lines."""
    monkeypatch.setattr(sys, "argv", [script, *argv])
    runpy.run_path(str(ROOT / "examples" / f"{script}.py"),
                   run_name="__main__")
    return capsys.readouterr().out.splitlines()


def reference_argv(script: str, argv: list, monkeypatch) -> list:
    """The argv ``examples/<script>.py`` hands its launcher's main, which
    is patched out."""
    import repro.launch.serve
    import repro.launch.train

    seen = []
    launcher = repro.launch.serve if script == "serve_lm" else repro.launch.train
    monkeypatch.setattr(launcher, "main", lambda: seen.append(sys.argv[1:]))
    monkeypatch.setattr(sys, "argv", [script, *argv])
    runpy.run_path(str(ROOT / "examples" / f"{script}.py"),
                   run_name="__main__")
    assert len(seen) == 1
    return seen[0]


def test_quickstart_against_the_reference(own_store):
    got = example("quickstart").main(["--device", "cpu"])
    res = got["result"]
    want = ref_pipeline.derive_mapping(
        REF_DOMAINS["tri2d"], RefMockLLMBackend("OSS:120b"), stage=20,
        n_validate=100_000, cache=None)
    assert got["perfect"] and want.perfect
    assert res.source == want.source
    assert vars(res.report) == vars(want.report)
    assert res.complexity_class == want.complexity_class
    assert res.inference_joules == want.inference_joules
    assert vars(got["amortization"]) == vars(want.amortization())
    assert got["route"] == "simt"
    # the phase 4 attention on the same seeded numpy q, k, v
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 4, 512, 64), dtype=np.float32)
               for _ in range(3))
    att = example("quickstart").attend(*map(torch.from_numpy, (q, k, v)))
    ref = np.asarray(ref_attn.causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 128, 128, "mapped",
        True))
    assert np.abs(att["out"].numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    for mode, key in (("bounding_box", "bb_steps"), ("mapped", "mapped_steps")):
        assert att[key] == ref_attn.grid_steps(512, 128, mode)
    assert (att["bb_steps"], att["mapped_steps"]) == (16, 10)
    assert got["lines"][-1].startswith(
        "deployment (the paper's A100 model, not measured here): ")


def test_fractal_compute_against_the_reference(own_store):
    mod = example("fractal_compute")
    got = mod.main(["--device", "cpu"])
    assert sorted(got["rows"]) == mod.FRACTALS == sorted(
        n for n, d in REF_DOMAINS.items() if d.kind == "fractal")
    for name, row in got["rows"].items():
        dom = REF_DOMAINS[name]
        ext = dom.bounding_box_extent(mod.N)
        assert row["extent"] == tuple(ext)
        assert row["bb_cells"] == int(np.prod(ext))
        assert row["waste_fraction"] == ref_ops.block_counts(
            name, mod.N)["waste_fraction"]
        # every box here runs in the reference's interpret mode in about a
        # second, so coordinates and masks are held bitwise against it
        want_coords = ref_ops.map_coordinates(name, mod.N, interpret=True)
        want_mask = ref_ops.bb_membership(name, ext, interpret=True)
        np.testing.assert_array_equal(row["coords"], want_coords)
        np.testing.assert_array_equal(row["mask"], want_mask)
        assert row["bb_count"] == int(want_mask.sum()) == row["mapped_count"]
        assert row["via"] == ("ground truth" if name == "menger3d"
                              else "artifact")
    assert got["client2"] == {"derivations": 0, "cache_hits": 6}


def test_derive_and_deploy_in_process_and_url(own_store, tmp_path, capsys,
                                             monkeypatch):
    mod = example("derive_and_deploy")
    want = reference_lines("derive_and_deploy", [], capsys, monkeypatch)
    # the table: the header and one row per paper domain
    start = next(i for i, ln in enumerate(want) if ln.startswith("domain"))
    want_table = want[start + 1:start + 7]
    got = mod.main(["--device", "cpu"])
    capsys.readouterr()
    assert got["table"] == want_table
    # the reference's lines but the first (its store's hits) and the
    # port's last (the A100 model's label)
    lines = "\n".join(got["lines"]).splitlines()
    assert lines[1:-1] == want[1:]
    assert "A100 cost model" in lines[-1]
    assert got["client2"] == {"derivations": 0, "cache_hits": 18}
    # --url: two remote clients against the port's server, one store
    svc = MappingService(cache=ArtifactCache(tmp_path / "server"),
                         n_validate=50_000, sample_every=10)
    with MappingHTTPServer(svc) as server:
        remote = mod.main(["--url", server.url, "--device", "cpu"])
    assert remote["table"] == want_table
    assert remote["second_all_hits"]
    assert remote["client1_server_hits"] == 0
    assert remote["client2_server_hits"] == 18


@pytest.mark.parametrize("mode", ["mapped", "bounding_box"])
def test_train_lm_attention_shape_against_the_reference(mode):
    """train_lm's smoke llama gives tri_attn (B, H, Hk, S, D) = (8, 6, 2,
    128, 8) in fp32, block 128: the simt route's plain version against the
    reference's interpret-mode kernel (GQA read in place there)."""
    from repro_torch.kernels.tri_attn.kernel import HEAD_DIMS, attention_route
    from repro_torch.kernels.tri_attn.ops import causal_attention

    assert 8 in HEAD_DIMS
    assert attention_route(torch.float32, 128, 8) == "simt"
    rng = np.random.default_rng(3)
    q = rng.standard_normal((8, 6, 128, 8), dtype=np.float32)
    k, v = (rng.standard_normal((8, 2, 128, 8), dtype=np.float32)
            for _ in range(2))
    want = np.asarray(ref_attn.causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 128, 128, mode,
        True))
    got = causal_attention(*map(torch.from_numpy, (q, k, v)), 128, 128, mode,
                           True)
    assert np.abs(got.numpy() - want).max() < 3e-5


@pytest.mark.parametrize("script,argv", [
    ("serve_lm", []), ("serve_lm", ["rwkv6-3b"]),
    ("train_lm", []), ("train_lm", ["--full"])])
def test_lm_presets_are_the_references(script, argv, monkeypatch):
    want = reference_argv(script, argv, monkeypatch)
    got = example(script).build_argv([*argv, "--device", "cpu"])
    if script == "train_lm":
        at = want.index("--ckpt-dir") + 1
        assert want[at] in ("/tmp/repro_train", "/tmp/repro_train_full")
        want[at] = os.path.join(tempfile.gettempdir(),
                                want[at].replace("/tmp/repro_", "repro_torch_"))
    assert got == want + ["--device", "cpu"]


def test_train_lm_passes_argv_through():
    got = example("train_lm").build_argv(["--steps", "2", "--device", "cpu",
                                          "--seq", "64"])
    assert got[-6:] == ["--device", "cpu", "--steps", "2", "--seq", "64"]


def test_serve_lm_runs_on_the_cpu():
    got = example("serve_lm").main(["--device", "cpu"])
    assert (got["steps"], got["seqs"]) == (24, 4)
    assert got["lines"][0].startswith("arch=yi-6b ")


def test_train_lm_runs_on_the_cpu(tmp_path):
    got = example("train_lm").main(["--device", "cpu", "--steps", "2",
                                    "--ckpt-dir", str(tmp_path)])
    assert set(got["final"]) >= {"loss", "ce", "grad_norm", "lr"}
    assert all(np.isfinite(v) for v in got["final"].values())
    assert got["lines"][0].startswith("arch=llama3.2-3b ")


@pytest.mark.parametrize("script", SCRIPTS)
def test_asking_for_the_card_without_one_raises(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        example(script).main(["--device", "cuda"])
