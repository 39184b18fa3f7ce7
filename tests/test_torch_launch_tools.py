"""The port's launch and analysis tooling against the JAX package's, on the
CPU: ``configs/shapes.py``, the model half of ``launch/analytic.py``,
``attn_impl="xla_mapped"`` (``_sdpa_mapped_causal``), the profiler-trace
reader ``launch/hlo_analysis.py`` and ``launch/roofline.py``.  Inputs are
made by numpy from a seed; the reference's attention weights come through
as numpy."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import applicable as ref_applicable
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.core.maps import np_map_tri2d
from repro.launch import analytic as ref_analytic
from repro.launch import roofline as ref_roofline
from repro.models import attention as ref_attn
from repro_torch.configs import (
    ARCH_IDS, SHAPES, applicable, get_config, get_smoke_config,
)
from repro_torch.launch import analytic, dryrun, hlo_analysis, roofline
from repro_torch.models import attention
from repro_torch.models import transformer as T

CELLS = [(a, s) for a in ARCH_IDS for s in sorted(SHAPES)]


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


# --- shapes and analytic -----------------------------------------------------


def test_shapes_equal_the_reference():
    assert set(SHAPES) == set(REF_SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(REF_SHAPES[name])
    skipped = [(a, s) for a, s in CELLS
               if not applicable(get_config(a), SHAPES[s])[0]]
    assert len(skipped) == 8
    for a, s in CELLS:
        assert applicable(get_config(a), SHAPES[s]) == ref_applicable(
            ref_get_config(a), REF_SHAPES[s])


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_cell_analytics_equal_the_reference(arch, shape_name):
    """``param_counts`` (the port's model on meta, leaves classed by the
    reference's names) and ``cell_analytics`` equal the reference's, for
    every full config and every shape."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch).replace(max_seq=shape.seq_len)
    rcfg = ref_get_config(arch).replace(max_seq=shape.seq_len)
    assert analytic.param_counts(cfg) == ref_analytic.param_counts(rcfg)
    assert analytic.cell_analytics(cfg, shape) == \
        ref_analytic.cell_analytics(rcfg, REF_SHAPES[shape_name])


def test_param_counts_allocate_nothing():
    """deepseek-v2-236b's 239,375,569,920 parameters are counted on meta,
    with no generator drawn from (a fresh one has no meta device)."""
    pc = analytic.param_counts(get_config("deepseek-v2-236b"))
    assert pc["total"] == 239_375_569_920
    params = T.init_params(get_config("deepseek-v2-236b"), device="meta")
    assert all(p.is_meta for p in params.parameters())


# --- xla_mapped --------------------------------------------------------------


def _gqa(**kw):
    """tests/test_perf_paths.py's config: yi-6b's smoke config at d 64,
    the reference's weights."""
    rcfg = ref_smoke("yi-6b").replace(d_model=64, **kw)
    cfg = get_smoke_config("yi-6b").replace(d_model=64, **kw)
    rp = ref_attn.gqa_init(jax.random.PRNGKey(0), rcfg, jnp.float32)
    p = attention.GQAAttention(*(torch.from_numpy(np.array(rp[k]))
                                 for k in ("wq", "wk", "wv", "wo")))
    return rcfg, cfg, rp, p


@pytest.mark.parametrize("s", [512, 768, 1024])
def test_xla_mapped_attention_matches_xla(s):
    """tests/test_perf_paths.py:14 on the port."""
    _, cfg, _, p = _gqa()
    x = torch.from_numpy((_rng(1).standard_normal((2, s, 64)) * 0.3)
                         .astype(np.float32))
    o_x, _ = attention.gqa_apply(p, cfg.replace(attn_impl="xla"), x)
    o_m, _ = attention.gqa_apply(p, cfg.replace(attn_impl="xla_mapped"), x)
    assert (o_x - o_m).abs().max() < 2e-5


def test_xla_mapped_gradients_match():
    """tests/test_perf_paths.py:25 on the port: autograd through the
    segment softmax."""
    _, cfg, _, p = _gqa()
    x0 = torch.from_numpy((_rng(1).standard_normal((2, 512, 64)) * 0.3)
                          .astype(np.float32))
    grads = []
    for impl in ("xla_mapped", "xla"):
        x = x0.clone().requires_grad_(True)
        out, _ = attention.gqa_apply(p, cfg.replace(attn_impl=impl), x)
        grads.append(torch.autograd.grad(out.sum(), x)[0])
    assert (grads[0] - grads[1]).abs().max() < 1e-4


@pytest.mark.parametrize("nb", [4, 7, 16, 31])
def test_xla_mapped_pair_tables_are_triangular(nb):
    """tests/test_perf_paths.py:36 on the port: the static λ -> (i, j)
    tables are the reference's exact map, padded to a multiple of 16 with
    fully masked pairs."""
    chunk = 8
    i_np, j_np, mask = attention._pair_tables(nb, chunk)
    n = nb * (nb + 1) // 2
    assert len(i_np) % 16 == 0 and len(i_np) - n < 16
    np.testing.assert_array_equal(np.stack([i_np[:n], j_np[:n]], -1),
                                  np_map_tri2d(np.arange(n)))
    assert not mask[n:].any()
    diag = i_np[:n] == j_np[:n]
    assert (mask[:n][diag] == np.tril(np.ones((chunk, chunk), bool))).all()
    assert mask[:n][~diag].all()


@pytest.mark.parametrize("s,h,hk", [(512, 4, 4), (768, 8, 2), (1024, 4, 1)])
def test_xla_mapped_matches_the_reference(s, h, hk):
    """The port's ``_sdpa_mapped_causal`` against the reference's on the
    same q, k, v (GQA included)."""
    r = _rng(s + h)
    q, k, v = ((r.standard_normal((2, s, n, 16)) * 0.5).astype(np.float32)
               for n in (h, hk, hk))
    want = ref_attn._sdpa_mapped_causal(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), hk)
    got = attention._sdpa_mapped_causal(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), hk)
    assert got.shape == tuple(want.shape)
    assert np.abs(_np(got) - _np(want)).max() < 2e-5


def test_xla_mapped_gqa_apply_matches_the_reference():
    rcfg, cfg, rp, p = _gqa(attn_impl="xla_mapped")
    x = (_rng(4).standard_normal((2, 512, 64)) * 0.3).astype(np.float32)
    want, _ = ref_attn.gqa_apply(rp, rcfg, jnp.asarray(x))
    got, _ = attention.gqa_apply(p, cfg, torch.from_numpy(x))
    assert np.abs(_np(got) - _np(want)).max() < 2e-5


# --- hlo_analysis: the profiler-trace reader ---------------------------------


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0, "args": args}


FIXTURE = {"traceEvents": [
    {"ph": "M", "name": "process_name", "args": {"name": "python"}},
    _x("Trace", "PyTorch Profiler (0)", 1000.0, 1000.0),
    # device: five busy runs, 410 µs in all
    _x("kernel", "void ta_sm90_kernel<128, 128>(Params)", 1100.0, 100.0),
    _x("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 1200.0, 100.0),
    _x("kernel", "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN", 1400.0, 50.0),
    _x("kernel", "ncclDevKernel_AllReduce_Sum_bf16_RING_LL(Params)", 1500.0,
       50.0),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1600.0, 10.0),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)",
       1700.0, 60.0),
    _x("kernel", "void at::native::(anonymous namespace)::reduce_kernel"
       "<512, 1>(Reduce)", 1750.0, 50.0),
    _x("kernel", "void ta_sm90_kernel<128, 128>(Params)", 1790.0, 10.0),
    # host
    _x("cpu_op", "aten::embedding", 1010.0, 50.0),
    _x("cpu_op", "aten::linear", 1200.0, 230.0),
    _x("cpu_op", "aten::mm", 1250.0, 170.0, flops=123),
    _x("cpu_op", "aten::copy_", 1820.0, 170.0),
    _x("cpu_op", "record_param_comms", 1490.0, 5.0,
       **{"Collective name": "allreduce", "Out msg nelems": 1024,
          "dtype": "BFloat16"}),
    _x("cpu_op", "record_param_comms", 1495.0, 5.0,
       **{"Collective name": "all_gather_into_tensor",
          "Out msg nelems": 10, "In msg nelems": 5, "dtype": "Float"}),
]}


def test_analyze_splits_a_known_trace_exactly():
    a = hlo_analysis.analyze(FIXTURE)
    assert a["window_us"] == 1000.0
    # union: [100,300] [400,450] [500,550] [600,610] [700,800]
    assert a["device_busy_us"] == 410.0
    assert a["busy_share"] == pytest.approx(0.41)
    assert a["idle_share"] == pytest.approx(0.59)
    assert a["time_by_category_us"] == {
        "own_kernels": 110.0, "library": 150.0, "other_kernels": 110.0,
        "nccl": 50.0, "memcpy_memset": 10.0}
    assert a["own_kernels_us"] == {"ta_sm90_kernel": 110.0}
    assert a["launches"]["ta_sm90_kernel"] == 2
    assert a["launches"]["vectorized_elementwise_kernel"] == 1
    assert sum(a["launches"].values()) == 8
    # gaps: 200 at the end, then the two of 100 in order; each labelled by
    # the host op that overlaps it most (the shorter of two equal ones)
    assert a["idle_gaps"] == [
        {"start_us": 800.0, "dur_us": 200.0, "host_op": "aten::copy_"},
        {"start_us": 0.0, "dur_us": 100.0, "host_op": "aten::embedding"},
        {"start_us": 300.0, "dur_us": 100.0, "host_op": "aten::mm"}]
    assert a["flops_by_op"] == {"aten::mm": 123.0}
    c = a["collectives"]
    assert c["all-reduce"] == {"count": 1, "bytes": 2048.0}
    assert c["all-gather"] == {"count": 1, "bytes": 40.0}
    assert c["total_bytes"] == 2088.0 and c["total_count"] == 2


def test_analyze_reads_a_file_and_a_profile(tmp_path):
    """The same fixture through a file, and a real CPU profile of the yi-6b
    smoke forward: every aten::mm's FLOPs are 2·M·N·K of its recorded
    shapes, and no device event means no busy time."""
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(FIXTURE))
    assert hlo_analysis.analyze(str(path)) == hlo_analysis.analyze(FIXTURE)

    from torch.profiler import ProfilerActivity, profile

    cfg = get_smoke_config("yi-6b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_rng(2).integers(0, cfg.vocab_size, (2, 32)))
    with profile(activities=[ProfilerActivity.CPU], with_flops=True,
                 record_shapes=True) as prof:
        T.forward(params, cfg, tokens)
    a = hlo_analysis.analyze(prof)
    mms = [e for e in prof.events() if e.name == "aten::mm"]
    assert mms
    want = 0
    for e in mms:
        (m, k), (k2, n) = e.input_shapes[:2]
        assert k == k2
        want += 2 * m * n * k
    assert a["flops_by_op"]["aten::mm"] == want
    assert a["device_busy_us"] == 0 and a["busy_share"] == 0
    assert a["window_us"] > 0 and a["idle_gaps"][0]["host_op"]


# --- roofline ----------------------------------------------------------------


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Records the port's dry run writes (smoke configs on the fake 16x16
    and 2x16x16 meshes), a skipped cell among them."""
    out = tmp_path_factory.mktemp("dryrun")
    for argv in (["--arch", "yi-6b", "--shape", "train_4k",
                  "--multi-pod", "both"],
                 ["--arch", "deepseek-v2-236b", "--shape", "decode_32k",
                  "--multi-pod", "off"],
                 ["--arch", "yi-6b", "--shape", "long_500k",
                  "--multi-pod", "off"]):
        dryrun.main([*argv, "--smoke", "--out", str(out)])
    return out


def _as_reference_record(rec: dict) -> dict:
    """A port record in the reference's keys: the step's counts where the
    reference has its HLO numbers, the peak where it has XLA's temp
    size."""
    if rec.get("status") != "ok":
        return rec
    st = rec["step"]
    out = {k: v for k, v in rec.items() if k not in ("step", "memory")}
    out["hlo"] = {"flops_per_device": st["flops_per_device"],
                  "hbm_bytes_per_device": st["unfused_bytes_per_device"],
                  "collectives": st["collectives"]}
    out["memory_analysis"] = {"temp_size_in_bytes":
                              rec["memory"]["peak_bytes"]}
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
def test_load_rows_equal_the_reference(records, tmp_path, monkeypatch,
                                       multi_pod):
    """``load_rows`` on the port's records against the reference's
    ``load_rows`` on the same records in its keys, with the reference
    module's four constants set to the port's."""
    for p in records.glob("*.json"):
        rec = json.loads(p.read_text())
        (tmp_path / p.name).write_text(json.dumps(_as_reference_record(rec)))
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW", "CHIPS"):
        monkeypatch.setattr(ref_roofline, name, getattr(roofline, name))
    got = roofline.load_rows(str(records), multi_pod=multi_pod)
    want = ref_roofline.load_rows(str(tmp_path), multi_pod=multi_pod)
    assert len(got) == len(want) == (1 if multi_pod else 3)
    for g, w in zip(got, want):
        assert (g["arch"], g["shape"], g["status"]) == \
            (w["arch"], w["shape"], w["status"])
        if g["status"] == "skipped":
            assert g["reason"] == w["reason"]
            continue
        for key in ("t_compute", "t_memory", "t_memory_ideal",
                    "t_collective", "dominant", "model_flops",
                    "useful_ratio", "roofline_fraction", "all_to_all",
                    "mem_gb", "kind"):
            assert g[key] == w[key], key
        assert g["step_flops_global"] == w["hlo_flops_global"]


def test_roofline_constants_are_the_h100s():
    from repro_torch.core import energy

    assert roofline.PEAK_FLOPS == energy.H100_BF16_FLOPS == 989e12
    assert roofline.HBM_BW == energy.H100_HBM_BW == 3.35e12
    assert roofline.LINK_BW == energy.H100_IB_NDR_BW == 50e9
    assert roofline.CHIPS == 256


def test_renderers_and_main(records, tmp_path):
    rows = roofline.load_rows(str(records))
    md = roofline.render_markdown(rows)
    lines = md.splitlines()
    assert len(lines) == 2 + 3
    assert "*skipped*" in md and "| yi-6b | train_4k |" in md
    hints = roofline.render_hints(rows)
    assert hints.count("\n") == 1       # the two cells that ran
    assert roofline.render_comparison(rows, rows).count("\n") == 3
    out = tmp_path / "roofline.md"
    roofline.main(["--dir", str(records), "--out", str(out)])
    assert md in out.read_text()


def test_an_absent_term_is_absent_not_zero(records):
    """A record without the unfused bytes has no memory term: it is
    ``None``, rendered "—", and the dominant term is the largest of the
    others."""
    rec = json.loads((records / "yi-6b__train_4k__sp.json").read_text())
    del rec["step"]["unfused_bytes_per_device"]
    d = records.parent / "absent"
    d.mkdir(exist_ok=True)
    (d / "yi-6b__train_4k__sp.json").write_text(json.dumps(rec))
    (row,) = roofline.load_rows(str(d))
    assert row["t_memory"] is None
    assert row["dominant"] == max(("compute", row["t_compute"]),
                                  ("collective", row["t_collective"]),
                                  key=lambda kv: kv[1])[0]
    assert "| — |" in roofline.render_markdown([row])
