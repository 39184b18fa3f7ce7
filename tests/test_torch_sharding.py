"""The port's logical axes and their placements (repro_torch.models'
spec trees, ``param_axes``, ``optimizer.state_specs`` and
``distribution/sharding.py``) against the JAX package's, on the CPU.

Every full config's parameters come from a meta-device init in the port and
from ``jax.eval_shape`` in the reference.  Each port parameter is the
reference leaf at ``jax_path(name)``, less the stacked layer axes (two in
vlm's ``groups.self``): its logical axes must be that leaf's spec less the
same axes, and on the production meshes, ``(16, 16)`` and ``(2, 16, 16)``,
its resolved spec must be the reference's less the same (always ``None``)
entries.  The reference resolves against a ``jax.sharding.AbstractMesh``,
the port against anything with a ``.shape`` mapping, so no 256 ranks are
needed.  The last cases are the reference's own unit cases
(``tests/test_distribution.py:21-57``) run against the port."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as RefNamedSharding
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as ref_get_config
from repro.configs.registry import ARCH_IDS
from repro.distribution import compression as ref_comp
from repro.distribution import sharding as ref_shd
from repro.models import common as ref_common
from repro.models import transformer as RT
from repro.train import optimizer as ref_opt
from repro_torch.configs import get_config
from repro_torch.distribution import compression as comp
from repro_torch.distribution import sharding as shd
from repro_torch.models import common
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@functools.lru_cache(maxsize=None)
def _ref(arch):
    """(the reference's spec tree, its eval_shape tree) for a full config."""
    rcfg = ref_get_config(arch)
    shapes = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0),
                                                    rcfg))
    return RT.param_specs(rcfg), shapes


@functools.lru_cache(maxsize=None)
def _port(arch):
    """{name: shape} of the port's full config, initialised on meta."""
    cfg = get_config(arch)
    model = T.init_params(cfg, torch.Generator(), "meta")
    return cfg, {n: tuple(p.shape) for n, p in model.named_parameters()}


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _duck(axes: dict):
    return types.SimpleNamespace(shape=dict(axes))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_the_reference_specs(arch):
    """Every port parameter's logical axes are the reference's leaf at
    ``jax_path(name)`` without the stacked axes (each a ``layers`` axis),
    its shape is that leaf's less the same dims, and every reference leaf
    is some port parameter."""
    specs, shapes = _ref(arch)
    cfg, port = _port(arch)
    axes = T.param_axes(port, cfg)
    assert set(axes) == set(port)
    seen = set()
    for name, shape in port.items():
        keys, ix = common.jax_path(name)
        spec, leaf = _at(specs, keys), _at(shapes, keys)
        assert spec[:len(ix)] == (ref_common.LAYERS,) * len(ix), name
        assert axes[name] == spec[len(ix):], name
        assert shape == tuple(leaf.shape[len(ix):]), name
        seen.add(keys)
    ref_keys = {tuple(q.key for q in path) for path, _ in
                jax.tree_util.tree_leaves_with_path(shapes)}
    assert seen == ref_keys
    assert T.param_specs(cfg) == specs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_equal_the_reference(arch):
    """The optimizer state's axes: the reference's ``state_specs`` of its
    tree, at every port name of ``m`` and ``v``, and ``()`` for ``step``."""
    specs, _ = _ref(arch)
    cfg, port = _port(arch)
    ref_state = ref_opt.state_specs(specs)
    state = opt.state_specs(T.param_axes(port, cfg))
    assert state["step"] == ref_state["step"] == ()
    for part in ("m", "v"):
        assert set(state[part]) == set(port)
        for name, ax in state[part].items():
            keys, ix = common.jax_path(name)
            assert ax == _at(ref_state[part], keys)[len(ix):], name


def test_rule_sets_equal_the_reference():
    assert shd.PARAM_RULES == ref_shd.PARAM_RULES
    assert shd.ACT_RULES == ref_shd.ACT_RULES
    assert shd.ACT_RULES_SP == ref_shd.ACT_RULES_SP


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_production_mesh_placements_equal_the_reference(arch, mesh):
    """On the production mesh every leaf resolves as the reference's does,
    divisibility fallbacks included, and each rank's block has the shape
    the reference's ``NamedSharding`` gives it; the placements put
    ``Shard(d)`` on each mesh axis the spec names."""
    specs, shapes = _ref(arch)
    cfg, port = _port(arch)
    ref_mesh = AbstractMesh(tuple(MESHES[mesh].values()),
                            tuple(MESHES[mesh]))
    duck = _duck(MESHES[mesh])
    axes = T.param_axes(port, cfg)
    got = shd.param_sharding(axes, port, duck)
    sharded = 0
    for name, shape in port.items():
        keys, ix = common.jax_path(name)
        leaf = _at(shapes, keys)
        ref_spec = ref_shd.resolve_spec(_at(specs, keys), ref_shd.PARAM_RULES,
                                        ref_mesh, leaf.shape)
        entries = tuple(ref_spec)
        assert all(e is None for e in entries[:len(ix)]), name
        assert got[name].spec == entries[len(ix):], name
        ref_block = RefNamedSharding(ref_mesh, ref_spec).shard_shape(
            leaf.shape)
        assert got[name].shard_shape(shape) == tuple(ref_block[len(ix):])
        pl = got[name].placements
        for m, a in enumerate(MESHES[mesh]):
            dims = [d for d, e in enumerate(got[name].spec)
                    if e == a or (isinstance(e, tuple) and a in e)]
            assert pl[m] == (Shard(dims[0]) if dims else Replicate()), name
        sharded += any(isinstance(p, Shard) for p in pl)
    assert sharded > 0


def test_batch_placements_split_pod_then_data():
    """The batch's ``("pod", "data")`` entry is ``Shard(0)`` on both, and a
    batch that does not divide falls back to replicated."""
    duck = _duck(MESHES["2x16x16"])
    spec = shd.resolve_spec(("batch", "seq"), shd.ACT_RULES, duck, (64, 8))
    assert spec == (("pod", "data"),)
    assert shd.placements(spec, duck) == (Shard(0), Shard(0), Replicate())
    assert shd.resolve_spec(("batch",), shd.ACT_RULES, duck, (48,)) == ()
    with pytest.raises(ValueError, match="axis order"):
        shd.placements((("data", "pod"),), duck)


# --- the reference's unit cases (tests/test_distribution.py:21-57) --------


def test_resolve_spec_basic():
    mesh = _duck({"data": 1, "model": 1})
    spec = shd.resolve_spec(("embed", "ffn"), shd.PARAM_RULES, mesh,
                            (64, 128))
    assert spec == ("data", "model")


def test_resolve_spec_divisibility_fallback():
    mesh16 = _duck({"model": 1})
    spec = shd.resolve_spec(("heads",), {"heads": "model"}, mesh16, (24,))
    assert spec == ("model",)
    # axis absent from mesh -> dropped
    spec = shd.resolve_spec(("heads",), {"heads": "tensor"}, mesh16, (24,))
    assert spec == ()
    # a real 16-wide axis: 24 heads do not divide -> replicated, as the
    # reference's resolves it
    wide = {"data": 16, "model": 16}
    got = shd.resolve_spec(("embed", "heads"), shd.PARAM_RULES, _duck(wide),
                           (4096, 24))
    ref = ref_shd.resolve_spec(("embed", "heads"), ref_shd.PARAM_RULES,
                               AbstractMesh((16, 16), ("data", "model")),
                               (4096, 24))
    assert got == tuple(ref) == ("data",)


def test_resolve_spec_duplicate_axis_dropped():
    mesh = _duck({"data": 1, "model": 1})
    spec = shd.resolve_spec(("ffn", "ffn"), shd.PARAM_RULES, mesh, (8, 8))
    assert spec == ("model",)  # second use of the mesh axis is dropped


def test_logical_constraint_identity_outside_mesh():
    x = torch.ones((4, 4))
    assert shd.logical_constraint(x, "batch", None) is x
    with shd.use_sharding(_duck({"data": 2, "model": 1})):
        assert shd.current_ctx() is not None
        assert shd.logical_constraint(x, "batch", None) is x  # rank-local
    assert shd.current_ctx() is None


def test_quantize_roundtrip_error_bound():
    """The reference's bound on the port's quantizer, and both quantizers
    equal on the same numbers (int8 values, scales, round half to even) as
    the reference runs them, compiled (its ``/ 127`` becomes a multiply by
    the reciprocal, which the port computes)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1000,)) * 3.0
    q, s = comp._quantize(torch.from_numpy(x))
    back = comp._dequantize(q, s, (1000,), torch.float64)
    bound = comp.quantization_error_bound(torch.from_numpy(x)) + 1e-6
    assert float((back - torch.from_numpy(x)).abs().max()) <= bound
    ref_quantize = jax.jit(ref_comp._quantize)
    rq, rs = ref_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert bound - 1e-6 == pytest.approx(
        ref_comp.quantization_error_bound(jnp.asarray(x)), rel=1e-7)
    halves = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0] + [0.0] * 250)
    hq, _ = comp._quantize(halves)
    rhq, _ = ref_quantize(jnp.asarray(halves.numpy()))
    np.testing.assert_array_equal(hq.numpy(), np.asarray(rhq))
