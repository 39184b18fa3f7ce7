"""The port's (arch x shape) dry run (repro_torch.launch.{specs,dryrun}):
cache specs against the port's caches, every applicable cell's step run on
fake tensors at smoke size, the layouts of the batch, cache and moment
leaves against the reference's ``input_specs`` on the production mesh, the
record's counts, and ``--arch`` as a subprocess over a fake 256-rank group.
The reference's layouts come from ``input_specs`` on an ``AbstractMesh``,
as ``tests/test_torch_sharding.py`` holds the parameters'."""
import dataclasses
import json
import os
import subprocess
import sys
import types

import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro_torch.configs import (
    ARCH_IDS, SHAPES, applicable, get_config, get_smoke_config,
)
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import common
from repro_torch.models import transformer as T
from repro_torch.train import sharded

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CELLS = [(a, s) for a in ARCH_IDS for s in sorted(SHAPES)
         if applicable(get_config(a), SHAPES[s])[0]]


def _leaves(spec, tree, path=()):
    """(path, spec, leaf) of every tensor leaf of a cache tree."""
    if spec is None:
        return []
    if isinstance(spec, tuple):
        return [(path, spec, tree)]
    if isinstance(spec, list):
        return [x for i, (s, t) in enumerate(zip(spec, tree))
                for x in _leaves(s, t, path + (i,))]
    assert set(spec) == set(tree), (set(spec), set(tree))
    return [x for k in spec for x in _leaves(spec[k], tree[k], path + (k,))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_mirror_init_cache(arch):
    """tests/test_launch_specs.py:13 for the port: the spec tree has the
    cache's structure, one axis name per dim of every tensor, and ``None``
    where the leaf is not a tensor (``idx``)."""
    cfg = get_smoke_config(arch)
    extra_len = cfg.encoder_seq if cfg.family == "audio" else 0
    cache = T.init_cache(cfg, 2, 64, extra_len, device="meta")
    axes = specs.cache_specs(cfg)
    leaves = _leaves(axes, cache)
    assert leaves
    for path, spec, leaf in leaves:
        assert isinstance(leaf, torch.Tensor), path
        assert len(spec) == leaf.dim(), (arch, path, spec, leaf.shape)
        assert "batch" in spec, path

    def nones(spec, tree):
        if spec is None:
            assert not isinstance(tree, torch.Tensor)
        elif isinstance(spec, list):
            assert len(spec) == len(tree)
            for s, t in zip(spec, tree):
                nones(s, t)
        elif isinstance(spec, dict):
            for k in spec:
                nones(spec[k], tree[k])

    nones(axes, cache)


@pytest.fixture
def tiny_mesh():
    with dryrun.fake_group(1):
        yield make_local_mesh(1, 1, "cpu", fake=True)


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_run_on_tiny_mesh(tiny_mesh, arch, shape_name):
    """tests/test_launch_specs.py's abstract run of every applicable cell,
    at smoke dims (seq 256, batch 4) on a (1, 1) mesh: the port's step runs
    on fake tensors, train_4k included (which fails in the reference under
    its installed jax, ROADMAP queue 3), and the record's counts are
    there."""
    shape = dataclasses.replace(SHAPES[shape_name], seq_len=256,
                                global_batch=4)
    cfg = get_smoke_config(arch).replace(max_seq=256, attn_impl="xla")
    rec = dryrun.run_step(cfg, shape, tiny_mesh)
    st = rec["step"]
    assert st["flops_per_device"] > 0
    assert st["unfused_bytes_per_device"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["params_bytes"] > 0
    # what holds the peak: groups of live storages, largest first, within
    # the peak
    held = [g["bytes"] for g in st["peak_holders"]]
    assert held and held == sorted(held, reverse=True)
    assert sum(held) <= rec["memory"]["peak_bytes"]
    if shape.kind == "train":
        # every collective is a 1-rank one, and each is still counted:
        # the gradient mean and the global norm are raw all-reduces
        assert st["collectives"]["all-reduce"]["count"] > 0
        assert st["comm_debug_counts"]["c10d.allreduce_"] \
            == st["collectives"]["all-reduce"]["count"]


def _duck(axes: dict):
    return types.SimpleNamespace(shape=dict(axes))


def _ref_args(arch, shape_name, mesh_axes):
    shape = REF_SHAPES[shape_name]
    rcfg = ref_get_config(arch).replace(max_seq=shape.seq_len)
    mesh = AbstractMesh(tuple(mesh_axes.values()), tuple(mesh_axes))
    _, args, _ = ref_specs.input_specs(rcfg, shape, mesh)
    return args


def _spec(sds) -> tuple:
    return tuple(sds.sharding.spec)


def _ref_cache_leaf(cfg, ref_cache, path):
    """The reference's cache leaf for a port cache path, and how many
    stacked leading dims the port's leaf lacks."""
    if cfg.family == "vlm":            # layers[g]["self"][j][k]
        return ref_cache["layers"]["self"][path[-1]], 2
    if cfg.family == "hybrid":
        if path[0] == "shared":        # shared[j][k]
            return ref_cache["shared"][path[-1]], 1
        name = {"state": "mamba_state"}.get(path[-1], path[-1])
        return ref_cache[name], 1
    if path[0] == "cross":             # audio: stacked in both
        return ref_cache["cross"][path[-1]], 0
    return ref_cache["layers"][path[-1]], 1


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_layouts_equal_the_reference_input_specs(arch, shape_name):
    """On the 16x16 mesh, every batch input's, cache leaf's and moment's
    resolved spec equals the reference's ``input_specs`` sharding of the
    same leaf (less its stacked layer dims, which resolve to None)."""
    axes = {"data": 16, "model": 16}
    duck = _duck(axes)
    shape = SHAPES[shape_name]
    cfg = get_config(arch).replace(max_seq=shape.seq_len)
    rules = specs.act_rules_for(shape)
    args = _ref_args(arch, shape_name, axes)
    got = specs.batch_specs(cfg, shape, duck, rules)
    if shape.kind == "train":
        want = {k: _spec(v) for k, v in args[2].items()}
        assert got == want
        params = T.init_params(cfg, device="meta")
        lay = sharded.layout(params, cfg, duck)["opt_state"]
        for part in ("m", "v"):
            for name, sh in lay[part].items():
                keys, ix = common.jax_path(name)
                leaf = args[1][part]
                for k in keys:
                    leaf = leaf[k]
                ref = _spec(leaf) + (None,) * (leaf.ndim - len(_spec(leaf)))
                assert ref[:len(ix)] == (None,) * len(ix), name
                want = list(ref[len(ix):])
                while want and want[-1] is None:
                    want.pop()
                assert sh.spec == tuple(want), name
        return
    if shape.kind == "prefill":
        assert got["tokens"] == _spec(args[1])
        if args[2] is not None:
            assert got["extra"] == _spec(args[2])
        return
    assert got["tokens"] == _spec(args[1])
    if args[3] is not None:
        assert got["extra"] == _spec(args[3])
    extra_len = cfg.encoder_seq if cfg.family == "audio" else 0
    cache = T.init_cache(cfg, shape.global_batch, shape.seq_len, extra_len,
                         device="meta")
    layout = specs.cache_layout(cfg, cache, duck, rules)
    leaves = _leaves(specs.cache_specs(cfg), layout)
    assert leaves
    for path, _, spec in leaves:
        ref_leaf, lead = _ref_cache_leaf(cfg, args[2], path)
        ref = _spec(ref_leaf) + (None,) * (ref_leaf.ndim
                                           - len(_spec(ref_leaf)))
        assert ref[:lead] == (None,) * lead, path
        want = list(ref[lead:])
        while want and want[-1] is None:
            want.pop()
        assert spec == tuple(want), (path, spec, want)


def test_record_counts_the_a2a_dispatch_and_the_split():
    """An optimized moonshot cell (``moe_impl="a2a"``, ``xla_mapped``) on
    the fake 16x16 mesh at smoke size (16 experts, so they split over
    ``model``): the a2a dispatch's all-to-alls, the split products'
    all-reduces, the per-layer gathers of the weights and their gradients'
    reduce-scatters are counted, as CommDebugMode counts them; the
    placement bytes are each rank's shards.  The split: on a fake (4, 4)
    mesh the dense products (``aten.mm``: attention, the shared expert, the
    router, the logits) cost each rank what they cost on (16, 1), where
    data parallelism alone splits them; computed whole along ``model``
    they cost 4 times as much."""
    rec = dryrun.run_cell("moonshot-v1-16b-a3b", "train_4k", False,
                          verbose=False, profile="optimized", smoke=True,
                          overrides={"n_experts": 16})
    st = rec["step"]
    coll, debug = st["collectives"], st["comm_debug_counts"]
    assert coll["all-to-all"]["count"] > 0
    assert coll["reduce-scatter"]["count"] > 0
    for kind, names in (("all-to-all", ("all_to_all", "alltoall")),
                        ("all-reduce", ("all_reduce", "allreduce")),
                        ("all-gather", ("all_gather", "allgather")),
                        ("reduce-scatter", ("reduce_scatter",))):
        assert coll[kind]["count"] == sum(
            n for op, n in debug.items() if any(x in op for x in names))
    mem = rec["memory"]
    assert 0 < mem["params_bytes"] < mem["moments_bytes"]
    assert rec["mesh"] == {"data": 16, "model": 16}
    cfg, shape = dryrun._cell_config("moonshot-v1-16b-a3b", "train_4k", True)
    cfg, tcfg, rules = dryrun.apply_profile(cfg, shape, "optimized",
                                            {"n_experts": 16})
    mm = {}
    for dm in ((16, 1), (4, 4)):
        with dryrun.fake_group(16):
            step = dryrun.run_step(cfg, shape, make_local_mesh(
                *dm, "cpu", fake=True), tcfg, rules)["step"]
        mm[dm] = step["per_op_flops"]["aten.mm"]
    assert mm[(4, 4)] <= 1.05 * mm[(16, 1)]


def _split_flops_and_peak(arch: str, mesh_dims) -> tuple[int, int]:
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=256,
                                global_batch=4)
    cfg = get_smoke_config(arch).replace(max_seq=256, attn_impl="xla")
    with dryrun.fake_group(mesh_dims[0] * mesh_dims[1]):
        rec = dryrun.run_step(cfg, shape,
                              make_local_mesh(*mesh_dims, "cpu", fake=True))
    return rec["step"]["flops_per_device"], rec["memory"]["peak_bytes"]


def test_split_step_cuts_each_ranks_flops_and_peak():
    """yi-6b's smoke train step on a fake 4-rank group: on (1, 4), where
    heads, ffn and vocab split over ``model``, each rank does at most 0.4
    of the (1, 1) step's FLOPs and peaks below it."""
    f1, p1 = _split_flops_and_peak("yi-6b", (1, 1))
    f4, p4 = _split_flops_and_peak("yi-6b", (1, 4))
    assert f4 <= 0.4 * f1
    assert p4 < p1


def test_full_width_train_cell_fits_a_card():
    """yi-6b x train_4k at full width on the fake 16x16 group (about 20 s
    here): each rank's FLOPs at most 2.5x ``analytic_flops / 256`` (remat's
    recompute, the full square of ``xla``'s attention and the kv
    projections its q heads read come on top) and its peak of live bytes
    below 80 GB: its shards, one layer's weights gathered over ``data`` and
    the activations."""
    rec = dryrun.run_cell("yi-6b", "train_4k", False, verbose=False)
    share = rec["analytic"]["analytic_flops"] / 256
    assert rec["step"]["flops_per_device"] <= 2.5 * share
    assert rec["memory"]["peak_bytes"] < 80e9


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def test_split_decode_gathers_no_cache():
    """yi-6b's smoke decode_32k cell (seq 256, batch 4) on a fake (1, 4)
    group, ``kv_seq`` over ``model``: each rank attends its block of the
    cache, so its all-gathers (the queries over heads, the partial
    softmaxes) move less than a tenth of the whole cache's bytes, and its
    peak is below the (1, 1) step's."""
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=256,
                                global_batch=4)
    cfg = get_smoke_config("yi-6b").replace(max_seq=256, attn_impl="xla")
    rec = {}
    for dims in ((1, 1), (1, 4)):
        with dryrun.fake_group(dims[0] * dims[1]):
            rec[dims] = dryrun.run_step(cfg, shape, make_local_mesh(
                *dims, "cpu", fake=True))
    whole = _tensor_bytes(T.init_cache(cfg, 4, 256, device="meta"))
    gathered = rec[(1, 4)]["step"]["collectives"]["all-gather"]
    assert 0 < gathered["count"] and gathered["bytes"] < whole / 10
    assert rec[(1, 4)]["memory"]["cache_bytes"] == whole // 4
    assert rec[(1, 4)]["memory"]["peak_bytes"] \
        < rec[(1, 1)]["memory"]["peak_bytes"]


def test_full_width_decode_cell_fits_a_card():
    """moonshot-v1-16b-a3b x decode_32k at full width on the fake 16x16
    group (about 20 s here): with the cache split along ``kv_seq`` over
    ``model`` each rank holds and attends 2048 of the 32768 positions, so
    its peak of live bytes stays under 10 GB (whole caches: 111.7 GB)."""
    rec = dryrun.run_cell("moonshot-v1-16b-a3b", "decode_32k", False,
                          verbose=False)
    assert rec["memory"]["peak_bytes"] < 10e9


def test_inference_passes_take_the_plain_collectives(monkeypatch):
    """Prefill and decode run without autograd, so the MoE dispatch's
    gathers are the plain functional collectives (torch's autograd ones
    have no fake kernel under inference mode in every version), and a
    train step's are the autograd ones."""
    from repro_torch.models import moe

    seen = []

    def spy(name):
        real = getattr(moe.funcol, name)

        def call(*args, **kw):
            seen.append((name, torch.is_grad_enabled()))
            return real(*args, **kw)

        monkeypatch.setattr(moe.funcol, name, call)

    for name in ("all_gather_tensor", "all_gather_tensor_autograd"):
        spy(name)
    for shape_name in ("prefill_32k", "decode_32k", "train_4k"):
        shape = dataclasses.replace(SHAPES[shape_name], seq_len=64,
                                    global_batch=4)
        cfg = get_smoke_config("moonshot-v1-16b-a3b").replace(
            max_seq=64, attn_impl="xla")
        seen.clear()
        with dryrun.fake_group(16):
            dryrun.run_step(cfg, shape, make_local_mesh(4, 4, "cpu",
                                                        fake=True))
        want = ("all_gather_tensor_autograd", True) if shape.kind == \
            "train" else ("all_gather_tensor", False)
        assert seen and set(seen) == {want}, (shape_name, set(seen))


def test_fake_backend_only_on_the_dry_run_path():
    """A mesh over the fake group needs ``fake=True``; a real mesh refuses
    the fake backend, and a fake mesh refuses a real one."""
    with dryrun.fake_group(256):
        with pytest.raises(ValueError, match="gloo backend, not fake"):
            make_production_mesh(device_type="cpu")
        mesh = make_production_mesh(device_type="cpu", fake=True)
        assert mesh.shape == (16, 16)
        with pytest.raises(ValueError, match="on the CPU"):
            make_production_mesh(fake=True)


def test_dryrun_arch_subprocess(tmp_path):
    """``--arch`` on a smoke config over a fake 256- and 512-rank group as a
    subprocess: exit 0, two records with FLOPs, collectives by type,
    placement and peak bytes, and ``analytic``."""
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC),
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "yi-6b", "--shape", "train_4k", "--multi-pod", "both", "--smoke",
         "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "all requested cells passed" in out.stdout
    recs = {p.name: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert set(recs) == {"yi-6b__train_4k__sp.json",
                         "yi-6b__train_4k__mp.json"}
    for name, r in recs.items():
        assert r["status"] == "ok" and r["smoke"]
        assert r["step"]["flops_per_device"] > 0
        assert r["step"]["collectives"]["all-gather"]["count"] > 0
        assert r["step"]["collectives"]["total_bytes"] > 0
        assert r["memory"]["peak_bytes"] > r["memory"]["params_bytes"] > 0
        assert r["analytic"]["analytic_flops"] > 0
        assert r["lower_s"] >= 0 and r["run_s"] > 0
    assert recs["yi-6b__train_4k__mp.json"]["mesh"] == {
        "pod": 2, "data": 16, "model": 16}
