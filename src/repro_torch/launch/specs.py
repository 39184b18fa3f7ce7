"""Abstract inputs and their layouts for every dry-run cell: the JAX
package's ``launch/specs.py``.

``input_specs(cfg, shape, mesh)`` returns ``(fn, args, donate)``: ``args``
are tensors of the cell's global shapes, the weights, moments and caches
laid out as DTensors on ``mesh`` by ``distribution/sharding.py`` (the
reference's ``ShapeDtypeStruct``s with ``NamedSharding``s), and ``fn`` is
the port's step for the shape's kind:

  train_*    -> train/sharded.py's step(params, opt_state, batch)
  prefill_*  -> prefill(params, tokens, extra): last-row logits, the cache
  decode_* / long_* -> decode_step(params, token, cache, extra)
       (one new token against a seq_len cache)

Call it under a ``FakeTensorMode`` (``launch/dryrun.py``): then nothing is
allocated, and ``fn(*args)`` runs the step on shapes alone.

The port's steps take the global batch, the same on every rank, and each
rank computes its rows of it (``batch`` over the data axes, as the cell's
activation rules say; ranks along ``model`` take the same rows): so tokens
and extra inputs are plain global tensors and ``batch_specs`` is the layout
the step applies.  The prefill and decode steps are split steps, as the
sharded train step is (``distribution/tensor_parallel.py``): each layer
gathers its weights over the data axes, and heads, ffn, vocab and experts
are split over ``model`` (their logits are this rank's vocab chunk).
Decode (``decode_fn``) hands ``decode_step`` each cache leaf with a
``kv_seq`` axis as this rank's block of it, split along the sequence as the
rules say (``model`` at decode_32k, ``data`` then ``model`` at long_500k),
and gets it back as that block, written in place: the attention runs every
head over the block and combines the partial softmaxes across the ranks
that hold the sequence (``models/attention.py``), so no such leaf is ever
gathered.  The other leaves (rwkv6's and mamba2's states, conv tails,
whisper's ``cross`` along ``frames``) are gathered over every mesh axis but
the batch's, and the rank keeps its shard of the new ones.

The port's cache is a list of per-layer dicts (``models/transformer.py``
``init_cache``), so ``cache_specs`` gives each layer's leaves the
reference's axes without the stacked ``layers`` axis; ``idx``, a Python
int, has no axes (``None``).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distribution import sharding as shd
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models import transformer as T
from repro_torch.train import sharded

# ---------------------------------------------------------------------------
# activation rule sets per shape kind
# ---------------------------------------------------------------------------


def act_rules_for(shape: ShapeSpec) -> dict:
    if shape.kind == "train" or shape.kind == "prefill":
        return dict(shd.ACT_RULES)
    if shape.name == "long_500k":  # batch=1: sequence parallelism instead
        return {**shd.ACT_RULES, "batch": None, "kv_seq": ("data", "model")}
    # decode: shard the cache's sequence dim over the tensor axis
    return {**shd.ACT_RULES, "kv_seq": "model"}


# ---------------------------------------------------------------------------
# logical spec trees for caches (mirror transformer.init_cache)
# ---------------------------------------------------------------------------


def _gqa_cache_specs(quant: bool = False) -> dict:
    s = {"k": ("batch", "kv_seq", "kv_heads", None),
         "v": ("batch", "kv_seq", "kv_heads", None),
         "idx": None}
    if quant:
        s["k_scale"] = ("batch", "kv_seq", "kv_heads", None)
        s["v_scale"] = ("batch", "kv_seq", "kv_heads", None)
    return s


def _mla_cache_specs() -> dict:
    # MLA caches never quantize (see attention.mla_cache_init)
    return {"ckv": ("batch", "kv_seq", "kv_lora"),
            "krope": ("batch", "kv_seq", None),
            "idx": None}


def cache_specs(cfg: ModelConfig) -> dict:
    """One logical-axes tuple per tensor of ``T.init_cache(cfg, ...)``, in
    its structure; ``None`` where the leaf is not a tensor (``idx``)."""
    if cfg.family in ("dense", "moe"):
        one = (_mla_cache_specs if cfg.attention_type == "mla"
               else lambda: _gqa_cache_specs(cfg.kv_cache_quant))
        return {"layers": [one() for _ in range(cfg.n_layers)]}
    if cfg.family == "vlm":
        return {"layers": [
            {"self": [_gqa_cache_specs(cfg.kv_cache_quant)
                      for _ in range(cfg.cross_attn_every - 1)]}
            for _ in range(cfg.n_layers // cfg.cross_attn_every)]}
    if cfg.family == "ssm":
        return {"layers": [{"tmix_x": ("batch", "embed"),
                            "cmix_x": ("batch", "embed"),
                            "wkv": ("batch", "heads", None, None)}
                           for _ in range(cfg.n_layers)]}
    if cfg.family == "hybrid":
        # shared attention caches stay unquantized (see init_cache)
        return {
            "layers": [{"state": ("batch", "heads", None, None),
                        "conv_tail": ("batch", None, "ffn")}
                       for _ in range(cfg.n_layers)],
            "shared": [_gqa_cache_specs()
                       for _ in range(cfg.n_layers // cfg.hybrid_attn_every)],
            "idx": None,
        }
    if cfg.family == "audio":
        return {
            "layers": [_gqa_cache_specs(cfg.kv_cache_quant)
                       for _ in range(cfg.decoder_layers)],
            "cross": {"k": ("layers", "batch", "frames", "kv_heads", None),
                      "v": ("layers", "batch", "frames", "kv_heads", None)},
        }
    raise ValueError(cfg.family)


def tree_map(fn, spec, *trees):
    """``fn(spec, *leaves)`` over trees of dicts and lists walked by the
    first, whose leaves are tuples; a ``None`` spec keeps the last tree's
    leaf as it is (``idx``)."""
    if spec is None:
        return trees[-1]
    if isinstance(spec, tuple):
        return fn(spec, *trees)
    if isinstance(spec, list):
        return [tree_map(fn, s, *(t[i] for t in trees))
                for i, s in enumerate(spec)]
    return {k: tree_map(fn, spec[k], *(t[k] for t in trees)) for k in spec}


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def _extra_shape(cfg: ModelConfig, batch: int):
    if cfg.family == "vlm":
        return (batch, cfg.vision_seq, cfg.d_model)
    if cfg.family == "audio":
        return (batch, cfg.encoder_seq, cfg.d_model)
    return None


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                rules: dict) -> dict:
    """{input name: spec tuple} of the step's batch inputs: the layout the
    step cuts each rank's rows by."""
    b, s = shape.global_batch, shape.seq_len
    rows = (b, 1) if shape.kind == "decode" else (b, s)
    names = ("tokens", "labels") if shape.kind == "train" else ("tokens",)
    out = {n: shd.resolve_spec(("batch", None), rules, mesh, rows)
           for n in names}
    extra = _extra_shape(cfg, b)
    if extra is not None:
        out["extra"] = shd.resolve_spec(("batch", None, None), rules, mesh,
                                        extra)
    return out


def cache_layout(cfg: ModelConfig, cache, mesh, rules: dict):
    """``cache_specs`` resolved on ``mesh`` against the shapes of ``cache``
    (tensors or shapes): a tree of spec tuples, ``idx`` as it is."""
    return tree_map(
        lambda spec, t: shd.resolve_spec(spec, rules, mesh,
                                         tuple(getattr(t, "shape", t))),
        cache_specs(cfg), cache)


def _rows(t, spec: tuple, mesh):
    """This rank's rows of a global tensor laid out by ``spec``."""
    if t is None:
        return None
    return shd.local_shard(t, mesh, shd.placements(spec, mesh))


def _gather_but(t: DTensor, dims: tuple) -> torch.Tensor:
    """This rank's block of ``t`` whole along every dim but ``dims`` (an
    all-gather over each other mesh dim it is sharded on)."""
    pl = [p if isinstance(p, Shard) and p.dim in dims else Replicate()
          for p in t.placements]
    if list(pl) != list(t.placements):
        t = t.redistribute(t.device_mesh, pl)
    return t.to_local()


def _gather_but_batch(t: DTensor, batch_dim: int) -> torch.Tensor:
    """This rank's block of ``t`` whole along every dim but ``batch_dim``:
    a cache leaf without a ``kv_seq`` axis."""
    return _gather_but(t, (batch_dim,))


def abstract_params(cfg: ModelConfig):
    """The model with each parameter an uninitialised CPU tensor of its
    shape and dtype (a shape alone under ``FakeTensorMode``): built on
    ``meta``, where the init draws nothing."""
    params = T.init_params(cfg, device="meta")
    for n, p in list(params.named_parameters()):
        shd.set_param(params, n, torch.empty(p.shape, dtype=p.dtype))
    return params


def _laid_out_params(cfg: ModelConfig, mesh):
    """The model's parameters as DTensors laid out by ``PARAM_RULES``."""
    params = abstract_params(cfg)
    for n, sh in sharded.layout(params, cfg, mesh)["params"].items():
        p = params.get_parameter(n)
        shd.set_param(params, n, shd.distribute(p.detach(), sh))
    return params


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, tcfg=None,
                rules=None):
    """Returns (fn, tuple_of_args, donate_argnums) for the cell."""
    rules = rules or act_rules_for(shape)
    b, s = shape.global_batch, shape.seq_len
    specs = batch_specs(cfg, shape, mesh, rules)
    dtype = T._dtype(cfg)
    extra_shape = _extra_shape(cfg, b)
    extra = (None if extra_shape is None
             else torch.zeros(extra_shape, dtype=dtype))

    if shape.kind == "train":
        from repro_torch.train.train_step import TrainConfig

        params, opt_state = sharded.shard_(abstract_params(cfg), cfg, mesh)
        batch = {"tokens": torch.zeros((b, s), dtype=torch.int64),
                 "labels": torch.zeros((b, s), dtype=torch.int64)}
        if extra is not None:
            batch["extra"] = extra
        step = sharded.make_sharded_train_step(cfg, tcfg or TrainConfig(),
                                               mesh)
        return step, (params, opt_state, batch), (0, 1)

    params = _laid_out_params(cfg, mesh)
    extra_spec = specs.get("extra")

    if shape.kind == "prefill":
        tokens = torch.zeros((b, s), dtype=torch.int64)

        def fn(p, t, e):
            with tp.use_split(p, mesh):
                logits, cache = T.prefill(p, cfg, _rows(t, specs["tokens"],
                                                        mesh),
                                          _rows(e, extra_spec, mesh))
            return logits[:, -1, :], cache

        return fn, (params, tokens, extra), ()

    # decode: one token against a seq_len cache
    extra_len = cfg.encoder_seq if cfg.family == "audio" else 0
    cache = lay_out_cache(cfg, T.init_cache(cfg, b, s, extra_len,
                                            device="cpu"), mesh, rules)
    token = torch.zeros((b, 1), dtype=torch.int64)
    dec_extra = extra if cfg.family == "vlm" else None
    return (decode_fn(cfg, shape, mesh, rules),
            (params, token, cache, dec_extra), (2,))


def lay_out_cache(cfg: ModelConfig, cache, mesh, rules: dict):
    """A cache every rank holds whole, the same, as DTensors laid out by
    ``cache_layout``; ``idx`` as it is."""
    return tree_map(
        lambda _, spec, t: shd.distribute(t, shd.NamedSharding(mesh, spec)),
        cache_specs(cfg), cache_layout(cfg, cache, mesh, rules), cache)


def _dims(ax: tuple) -> tuple:
    """The dims of a cache leaf that stay this rank's blocks in a decode
    step: the batch's, and the sequence's where the leaf has ``kv_seq``."""
    return tuple(ax.index(a) for a in ("batch", "kv_seq") if a in ax)


def decode_fn(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: dict):
    """The split decode step of a cell: ``fn(params, token, cache, extra)``
    with ``cache`` laid out by ``lay_out_cache`` (the global token, the
    vlm's global states) -> (this rank's rows and vocab chunk of the
    logits, its block of each new cache leaf).  Run it under
    ``shd.use_sharding(mesh, act_rules=rules)``."""
    specs = batch_specs(cfg, shape, mesh, rules)
    axes = cache_specs(cfg)

    def local(ax, leaf):
        # a kv_seq leaf: its block (to_local() under act_rules_for's rules)
        if "kv_seq" in ax:
            return _gather_but(leaf, _dims(ax))
        return _gather_but_batch(leaf, ax.index("batch"))

    def keep(ax, leaf, new):
        # the rows (and a kv_seq leaf's block) are this rank's already:
        # cut the other dims only
        pl = [Replicate() if isinstance(q, Shard) and q.dim in _dims(ax)
              else q for q in leaf.placements]
        return shd.local_shard(new, mesh, pl)

    def fn(p, t, c, e):
        with tp.use_split(p, mesh, kv_len=shape.seq_len):
            logits, new_cache = T.decode_step(
                p, cfg, _rows(t, specs["tokens"], mesh),
                tree_map(local, axes, c), _rows(e, specs.get("extra"), mesh))
        return logits, tree_map(keep, axes, c, new_cache)

    return fn
