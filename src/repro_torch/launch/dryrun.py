"""Dry runs: one (arch x shape x mesh) cell of a model step on a fake
production mesh, or one derived thread map deployed through its kernel.

``--arch A --shape S`` (or ``--all``) runs one step of the port's sharded
train step, prefill or decode (``launch/specs.py``) for the cell on the
16x16 mesh (and, with ``--multi-pod on|both``, 2x16x16), as the reference's
dry run lowers and compiles it on 512 placeholder host devices.  Here one
process stands for rank 0 of a ``"fake"`` process group of 256 or 512 ranks
(``FakeStore``: collectives move nothing), and the step runs under
``FakeTensorMode``: every tensor is a shape, nothing is allocated, and the
same command runs on a machine with or without a card.  The kernels'
routes are not taken: the cell runs ``attn_impl="xla"`` as the reference's
does, and the wkv op's plain version (``pallas_interpret``).

Each record holds, for rank 0 (per device):
  * ``step.flops_per_device`` and ``per_op_flops`` — ``FlopCounterMode``;
  * ``step.collectives`` — count and result bytes by type (all-gather,
    all-reduce, reduce-scatter, all-to-all), from the collectives' own ops:
    DTensor's, ``funcol``'s and the raw ``torch.distributed`` calls (the
    step's gradient mean, the a2a MoE dispatch); ``comm_debug_counts`` is
    ``CommDebugMode``'s count of the same ops;
  * ``step.unfused_bytes_per_device`` — operand + result bytes of every
    aten op that is not a view, as if nothing were fused: the analogue of
    the HLO parser's boundary-buffer bytes, and a pessimistic bound;
  * ``memory`` — parameter, moment, cache and batch bytes this rank holds
    by the placements, and the peak bytes of live (fake) storages during
    the step; ``step.peak_holders``, the largest groups of storages live at
    that peak (the aten op that made them, shape, dtype, count, bytes);
  * ``analytic`` — ``analytic.cell_analytics``, the idealized bound;
  * ``lower_s`` (building the inputs) and ``run_s`` (the fake step).
What the port does is what is recorded: each step is a split step
(``distribution/tensor_parallel.py``): heads, ffn, vocab and experts split
over ``model`` where their widths divide it (rwkv6's and mamba2's layers
included), each layer's weights gathered over the data axes as the layer
runs, and a decode step's caches kept split along ``kv_seq``, every head
attending the rank's block.  Per-device FLOPs exceed
``analytic_flops / 256`` by remat's recompute, ``xla``'s full square of
attention scores, and whatever stays whole along ``model``: a width that
does not divide it, such as rwkv6-3b's WKV and group norm on its 40 heads
over 16, and mamba2's B and C with the conv on them.

``--domain-map DOMAIN`` derives the domain's ``MappingArtifact`` (mock
backend, the artifact store at ``$REPRO_ARTIFACT_CACHE``), deploys it
through the mapped-grid CUDA kernel and checks the kernel's coordinates
against the artifact's own validated scalar map — the paper's Phase-4
integration proof for one artifact.  It writes one JSON record to
``--out``.  A derivation that is not deployable (menger3d: the paper's
"Menger limit") exits 1 without a launch.  The kernel runs on the card;
``--device cpu`` runs its plain torch version instead.  Without a card,
``--device cuda`` (the default) raises.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod both] --out DIR
    python -m repro_torch.launch.dryrun --domain-map tri2d --out DIR
    python -m repro_torch.launch.dryrun --domain-map tri2d --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import (
    ARCH_IDS, SHAPES, applicable, get_config, get_smoke_config,
)
from repro_torch.distribution import sharding as shd
from repro_torch.launch import analytic
from repro_torch.launch.specs import act_rules_for, input_specs

#: the collectives' ops -> the reference's collective names
#: (``hlo_analysis.COLLECTIVE_OPS``)
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
}
COLLECTIVE_TYPES = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
_DEVICE = torch.ops.prim.device.default     # ``t.device``: moves nothing
#: the smoke dry run's cut of every shape (``--smoke``): seq 256, and a
#: global batch that splits over the 2x16x16 mesh's 32 data ranks
SMOKE_SEQ, SMOKE_BATCH = 256, 32


def _tensors(tree) -> list:
    """The tensors of a tree, a DTensor as this rank's block."""
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class StepMeter(TorchDispatchMode):
    """Counts a step's aten ops: collectives by type (count and result
    bytes; an in-place c10d op's are its first argument's), the operand +
    result bytes of every other op that is not a view, and the live bytes of
    the storages the step holds (``track`` the inputs first): their peak,
    and what holds it (the live storages when it was last raised by more
    than ``PEAK_STEP`` of itself, by the op that made them, shape and
    dtype).  A DTensor-level op is skipped; its local ops come through
    again."""

    #: a new peak this share above the last one recorded is recorded
    PEAK_STEP = 0.01

    def __init__(self):
        super().__init__()
        self.collectives = {t: {"count": 0, "bytes": 0}
                            for t in COLLECTIVE_TYPES}
        self.unfused_bytes = 0
        self.live = 0
        self.peak = 0
        #: each live storage -> the op that made it, shape, dtype, bytes
        self._seen = WeakIdKeyDictionary()
        self._op = "input"
        self._at_peak, self._recorded = [], 0

    def _free(self, n: int) -> None:
        self.live -= n

    def track(self, tree) -> None:
        for t in _tensors(tree):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = (self._op, t.shape, t.dtype, n)
            weakref.finalize(st, self._free, n)
            self.live += n
        self.peak = max(self.peak, self.live)
        if self.live > self._recorded * (1 + self.PEAK_STEP):
            self._recorded = self.live
            self._at_peak = list(self._seen.values())

    def peak_holders(self, top: int = 5) -> list:
        """The largest groups of live storages at the recorded peak: op,
        shape, dtype, count and bytes."""
        groups = {}
        for op, shape, dtype, n in self._at_peak:
            g = groups.setdefault((op, shape, dtype), [0, 0])
            g[0] += 1
            g[1] += n
        rows = sorted(groups.items(), key=lambda kv: -kv[1][1])[:top]
        return [{"op": op, "shape": list(shape), "dtype": str(dtype),
                 "count": c, "bytes": b} for (op, shape, dtype), (c, b)
                in rows]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _DEVICE or any(issubclass(t, DTensor) for t in types):
            return out
        name = func._schema.name.split("::")[-1]
        self._op = name
        kind = COLLECTIVES.get(name)
        outs = _tensors(out)
        if kind is not None:
            moved = outs if func.namespace == "_c10d_functional" else args[0]
            self.collectives[kind]["count"] += 1
            self.collectives[kind]["bytes"] += _nbytes(moved)
        elif not func.is_view and name != "wait_tensor":
            self.unfused_bytes += _nbytes((args, kwargs)) + _nbytes(outs)
        self.track(outs)
        return out

    def summary(self) -> dict:
        per_type = self.collectives.values()
        coll = {k: dict(v) for k, v in self.collectives.items()}
        coll["total_bytes"] = sum(v["bytes"] for v in per_type)
        coll["total_count"] = sum(v["count"] for v in per_type)
        return {"collectives": coll, "unfused_bytes": self.unfused_bytes,
                "peak_bytes": self.peak, "peak_holders": self.peak_holders()}


@contextlib.contextmanager
def fake_group(world: int):
    """Rank 0 of a ``"fake"`` process group of ``world`` ranks for the
    block: its collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def apply_profile(cfg, shape, profile: str, overrides: dict | None = None):
    """Named optimization profiles (the reference's, copied).

    baseline  — the paper-faithful naive deployment (BB-masked XLA attention,
                global MoE dispatch, no MLA absorption, no microbatching).
    optimized — the beyond-paper configuration: mapped triangular attention,
                a2a MoE dispatch, MLA weight absorption (decode), 8-way
                microbatch accumulation, sequence-parallel attention
                fallback for head counts that don't divide the tensor axis.
    """
    from repro_torch.train.train_step import TrainConfig

    tcfg = None
    rules = act_rules_for(shape)
    if profile == "optimized":
        over = {"mla_absorb": "auto"}
        odd_heads = cfg.n_heads and cfg.n_heads % 16 != 0
        if shape.kind in ("train", "prefill") and (
                odd_heads or cfg.family == "moe"):
            over["attn_impl"] = "xla_mapped"
        if cfg.family == "moe":
            over["moe_impl"] = "a2a"   # grouped dispatch: moe_groups=16
        cfg = cfg.replace(**over)
        if shape.kind == "train":
            # microbatch only when saved layer-boundary activations would
            # overflow device memory (batch/16 per device, bf16, ~2 passes):
            eff_layers = (cfg.decoder_layers if cfg.family == "audio"
                          else cfg.n_layers)  # encoder seq is fixed/short
            act_gb = (eff_layers * (shape.global_batch / 16)
                      * shape.seq_len * cfg.d_model * 2 * 2) / 1e9
            if act_gb > 8.0:
                tcfg = TrainConfig(microbatches=8)
        if odd_heads:
            rules = {**rules, "attn_seq": "model"}
    else:
        cfg = cfg.replace(mla_absorb="never")
    for k, v in (overrides or {}).items():
        if k.startswith("rule:"):
            rules = {**rules, k[5:]: v}
        elif k == "microbatches":
            tcfg = TrainConfig(microbatches=v)
        else:
            cfg = cfg.replace(**{k: v})
    return cfg, tcfg, rules


def _cell_config(arch: str, shape_name: str, smoke: bool):
    shape = SHAPES[shape_name]
    if smoke:
        shape = dataclasses.replace(shape, seq_len=SMOKE_SEQ,
                                    global_batch=min(shape.global_batch,
                                                     SMOKE_BATCH))
        cfg = get_smoke_config(arch)
    else:
        cfg = get_config(arch)
    return cfg.replace(max_seq=shape.seq_len, attn_impl="xla"), shape


def run_step(cfg, shape, mesh, tcfg=None, rules=None) -> dict:
    """One step of the cell's ``fn`` under ``FakeTensorMode`` on ``mesh``
    (a mesh over the open process group): the record's measured part."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    rules = rules or act_rules_for(shape)
    cfg = cfg.replace(pallas_interpret=True)
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True), \
            shd.use_sharding(mesh, act_rules=rules):
        fn, args, _ = input_specs(cfg, shape, mesh, tcfg=tcfg, rules=rules)
        t_lower = time.time() - t0
        mem = _placement_bytes(args, shape.kind)
        meter = StepMeter()
        meter.track(args)
        with CommDebugMode() as comm, \
                FlopCounterMode(display=False) as flops, meter:
            out = fn(*args)
            del out
        t_run = time.time() - t0 - t_lower
    m = meter.summary()
    per_op = {str(k): int(v) for k, v in
              flops.get_flop_counts().get("Global", {}).items()}
    return {
        "lower_s": round(t_lower, 3), "run_s": round(t_run, 3),
        "step": {
            "flops_per_device": int(flops.get_total_flops()),
            "per_op_flops": per_op,
            "unfused_bytes_per_device": m["unfused_bytes"],
            "collectives": m["collectives"],
            "comm_debug_counts": {str(k): int(v) for k, v in
                                  comm.get_comm_counts().items()},
            "peak_holders": m["peak_holders"],
        },
        "memory": {**mem, "peak_bytes": m["peak_bytes"]},
    }


def _placement_bytes(args, kind: str) -> dict:
    """Bytes this rank holds of each input by its placements."""
    params = args[0]
    out = {"params_bytes": _nbytes(list(params.parameters()))}
    if kind == "train":
        out["moments_bytes"] = _nbytes([args[1]["m"], args[1]["v"]])
        out["batch_bytes"] = _nbytes(args[2])
    elif kind == "prefill":
        out["batch_bytes"] = _nbytes(args[1:])
    else:
        out["cache_bytes"] = _nbytes(args[2])
        out["batch_bytes"] = _nbytes([args[1], args[3]])
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, profile: str = "baseline",
             overrides: dict | None = None, smoke: bool = False) -> dict:
    """One step of one cell on a fake production mesh; returns the
    roofline-input record (``smoke``: the arch's smoke config and the shape
    cut to ``SMOKE_SEQ`` x ``SMOKE_BATCH``)."""
    from repro_torch.launch.mesh import make_production_mesh

    cfg, shape = _cell_config(arch, shape_name, smoke)
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}
    cfg, tcfg, rules = apply_profile(cfg, shape, profile, overrides)
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu",
                                    fake=True)
        measured = run_step(cfg, shape, mesh, tcfg, rules)
        record = {
            "arch": arch, "shape": shape_name,
            "multi_pod": multi_pod, "mesh": shd.mesh_shape(mesh),
            "status": "ok", "kind": shape.kind, "profile": profile,
            "smoke": smoke, "family": cfg.family,
            "seq_len": shape.seq_len, "global_batch": shape.global_batch,
            **measured,
        }
    record["analytic"] = analytic.cell_analytics(cfg, shape)
    if verbose:
        mp = "2x16x16" if multi_pod else "16x16"
        st = record["step"]
        print(f"[dryrun] {arch} x {shape_name} x {mp}: OK "
              f"(lower {record['lower_s']}s, run {record['run_s']}s, "
              f"flops/dev {st['flops_per_device']:.3e}, "
              f"coll/dev {st['collectives']['total_bytes']:.3e} B, "
              f"peak/dev {record['memory']['peak_bytes'] / 1e9:.1f} GB)",
              flush=True)
    return record


def run_domain_map_cell(artifact, n_points: int = 65_536,
                        block_n: int = 1024, interpret: bool = False,
                        verbose: bool = True) -> dict:
    """Deploy a validated ``MappingArtifact`` through the mapped-grid kernel
    (``interpret=True``: its plain version on the CPU) and verify the
    coordinates against the artifact's own validated scalar map."""
    from repro_torch.kernels.domain_map.ops import (
        block_counts, map_coordinates,
    )

    t0 = time.time()
    coords = map_coordinates(artifact, n_points, block_n=block_n,
                             interpret=interpret)
    t_run = time.time() - t0
    sample = np.linspace(0, n_points - 1, 256, dtype=np.int64)
    scalar = artifact.scalar_fn()
    ok = all(tuple(coords[i]) == tuple(scalar(int(i))) for i in sample)
    record = {
        "kind": "domain_map", "status": "ok" if ok else "mismatch",
        "domain": artifact.domain, "model": artifact.model,
        "stage": artifact.stage, "logic": artifact.logic,
        "report_digest": artifact.report_digest,
        "n_points": n_points, "block_n": block_n,
        "kernel_s": round(t_run, 3),
        "blocks": block_counts(artifact, n_points, block_n),
        "analytic": analytic.artifact_deployment_analytics(artifact),
    }
    if verbose:
        a = record["analytic"]
        where = "cpu (plain version)" if interpret else \
            torch.cuda.get_device_name(0)
        print(f"[dryrun] domain-map {artifact.domain} x {artifact.model} "
              f"s{artifact.stage}: {record['status']} on {where} "
              f"(kernel {t_run:.2f}s, A100-model speedup "
              f"{a['speedup']:.0f}x, energy {a['energy_reduction']:.0f}x)",
              flush=True)
    return record


def _run_domain_map(domain_name: str, model: str, out_dir: str,
                    interpret: bool) -> str:
    from repro_torch.core.backends import MockLLMBackend
    from repro_torch.core.domains import get_domain
    from repro_torch.core.pipeline import derive_mapping
    from repro_torch.kernels.domain_map.kernel import NO_CARD

    if not interpret and not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)
    res = derive_mapping(get_domain(domain_name), MockLLMBackend(model),
                         stage=100, n_validate=50_000, sample_every=10)
    art = res.artifact
    if art is None or not art.deployable:
        raise SystemExit(
            f"derivation not deployable: {domain_name} x {model} "
            f"(ordered {res.report.ordered_pct:.2f}%, error={res.error!r})")
    rec = run_domain_map_cell(art, interpret=interpret)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"domain_map__{domain_name}__{model}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if rec["status"] != "ok":
        raise SystemExit(f"domain-map dry-run MISMATCH: {path}")
    return path


def _run_cells(args) -> None:
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    pods = {"off": (False,), "on": (True,),
            "both": (False, True)}[args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in cells:
        for mp in pods:
            tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
            if args.profile != "baseline":
                tag += f"__{args.profile}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[dryrun] {tag}: cached, skipping")
                continue
            try:
                rec = run_cell(arch, shape, mp, profile=args.profile,
                               smoke=args.smoke)
            except Exception as e:
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "status": "failed", "error": repr(e)}
                failures.append(tag)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    if failures:
        raise SystemExit(f"dry-run FAILURES: {failures}")
    print("[dryrun] all requested cells passed")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_IDS)
    p.add_argument("--shape", choices=tuple(SHAPES))
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", choices=("off", "on", "both"),
                   default="both")
    p.add_argument("--out", default="results/dryrun")
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--profile", choices=("baseline", "optimized"),
                   default="baseline")
    p.add_argument("--smoke", action="store_true",
                   help="the arch's smoke config, every shape cut to seq "
                        f"{SMOKE_SEQ} and batch {SMOKE_BATCH}")
    p.add_argument("--domain-map", metavar="DOMAIN",
                   help="derive + deploy one domain's MappingArtifact "
                        "through the mapped-grid kernel instead of an "
                        "(arch x shape) cell")
    p.add_argument("--map-model", default="OSS:120b",
                   help="backend model for --domain-map")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="--domain-map: cuda, the CUDA kernel (default); "
                        "cpu, its plain version")
    args = p.parse_args(argv)

    if args.domain_map:
        _run_domain_map(args.domain_map, args.map_model, args.out,
                        interpret=args.device == "cpu")
        return
    _run_cells(args)


if __name__ == "__main__":
    main()
