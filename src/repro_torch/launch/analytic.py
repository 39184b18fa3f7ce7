"""Analytic FLOPs / bytes per (arch x shape), and the deployment analytics
of a thread map: the JAX package's ``launch/analytic.py``.

The model half is the idealized roofline bound of a cell (perfectly fused
attention kernel, params read once, activations touched twice per op).  The
dry run (``launch/dryrun.py --arch``) reports it as ``analytic`` beside what
the port's step measures under fake tensors.  MODEL_FLOPS follows the
assignment: 6·N·D dense, 6·N_active·D for MoE.  The arithmetic is the
reference's; the parameter counts come from the port's model on ``meta``.

The deployment half: for any map spec (a domain name, ``Domain``, registry
``MapEntry`` or validated ``MappingArtifact``), mapped against bounding-box
block accounting (exact, device independent) and the paper's A100 cost model
(``core/energy.py``: the paper's A100 calibration, not a measurement of
this port's card), plus, for an artifact, the amortization of its one-time
inference energy.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import energy
from repro_torch.core.artifact import resolve_spec
from repro_torch.core.domains import get_domain
from repro_torch.core.registry import REGISTRY
from repro_torch.models import transformer as T
from repro_torch.models.common import jax_path


def param_counts(cfg: ModelConfig) -> dict:
    """Exact parameter counts from the port's model built on the ``meta``
    device (no allocation).  Leaves are classed by the reference's leaf
    names (``jax_path``), so the counts mean what the reference's do."""
    params = T.init_params(cfg, device="meta")
    total = 0
    routed = 0
    embed_like = 0
    for name, leaf in params.named_parameters():
        n = leaf.numel()
        total += n
        keys = jax_path(name)[0]
        if "moe" in keys and keys[-1] in ("gate", "up", "down"):
            routed += n
        if keys[-1] in ("embed", "lm_head", "enc_pos", "dec_pos"):
            embed_like += n
    active = total
    if cfg.n_experts:
        active = total - routed + routed * (cfg.moe_top_k / cfg.n_experts)
    return {
        "total": total,
        "active": int(active),
        "routed": routed,
        "embed_like": embed_like,
        "matmul_total": total - embed_like,
        "matmul_active": int(active) - embed_like,
    }


def _bytes_of(cfg: ModelConfig) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def _attn_flops(cfg: ModelConfig, seq: int, batch: int, causal_exact: bool,
                fwd_only: bool) -> float:
    """Score+PV einsum FLOPs.  causal_exact=True models the paper's mapped
    triangular grid (T(nb) blocks ~ half the box); False is the BB square."""
    if cfg.family == "ssm":
        # chunked WKV: per chunk C^2 interactions per head-dim
        c = 64
        h, hd = cfg.rwkv_heads, cfg.d_model // cfg.rwkv_heads
        per_tok = 2 * c * (2 * hd * hd + hd) / 1  # P build + PV + state
        return 3 * batch * seq * per_tok * h * cfg.n_layers
    if cfg.family == "hybrid":
        c = 64
        h, p, n = cfg.mamba_heads, cfg.mamba_d_inner // cfg.mamba_heads, cfg.ssm_state
        ssd = 2 * batch * seq * c * h * (p + n) * cfg.n_layers
        n_attn = cfg.n_layers // cfg.hybrid_attn_every
        attn = 4 * batch * seq * seq * cfg.n_heads * cfg.head_dim * n_attn
        if causal_exact:
            attn *= 0.5
        return ssd + (attn if not fwd_only else attn / 3)
    # attention transformers
    if cfg.family == "audio":
        enc = 4 * batch * cfg.encoder_seq ** 2 * cfg.n_heads * cfg.head_dim \
            * cfg.encoder_layers
        dec_self = 4 * batch * seq * seq * cfg.n_heads * cfg.head_dim \
            * cfg.decoder_layers
        x = 4 * batch * seq * cfg.encoder_seq * cfg.n_heads * cfg.head_dim \
            * cfg.decoder_layers
        if causal_exact:
            dec_self *= 0.5
        total = enc + dec_self + x
    elif cfg.family == "vlm":
        n_groups = cfg.n_layers // cfg.cross_attn_every
        n_self = cfg.n_layers - n_groups
        self_f = 4 * batch * seq * seq * cfg.n_heads * cfg.head_dim * n_self
        x = 4 * batch * seq * cfg.vision_seq * cfg.n_heads * cfg.head_dim \
            * n_groups
        if causal_exact:
            self_f *= 0.5
        total = self_f + x
    else:
        hd = (cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim
              ) if cfg.attention_type == "mla" else 2 * cfg.head_dim
        total = 2 * batch * seq * seq * cfg.n_heads * hd * cfg.n_layers
        if causal_exact:
            total *= 0.5
    mult = 1.0 if fwd_only else 3.0
    return total * mult


def cell_analytics(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    pc = param_counts(cfg)
    bts = _bytes_of(cfg)
    b, s = shape.global_batch, shape.seq_len
    d_tokens = b * s
    out = {"params_total": pc["total"], "params_active": pc["active"]}

    if shape.kind == "train":
        model_flops = 6.0 * pc["matmul_active"] * d_tokens \
            + 6.0 * pc["embed_like"] / max(cfg.padded_vocab, 1) * 0  # embeds: gather
        # lm head matmul is real compute:
        model_flops += 6.0 * d_tokens * cfg.d_model * cfg.padded_vocab
        attn_bb = _attn_flops(cfg, s, b, causal_exact=False, fwd_only=False)
        attn_mapped = _attn_flops(cfg, s, b, causal_exact=True, fwd_only=False)
        out.update({
            "model_flops": model_flops,
            "attn_flops_bb": attn_bb,
            "attn_flops_mapped": attn_mapped,
            "analytic_flops": model_flops + attn_mapped,
            # idealized HBM bytes: params read fwd+bwd + grads written +
            # adam state rw (fp32 m,v) + activations ~2 passes/layer
            "analytic_bytes": (
                3 * pc["active"] * bts + pc["total"] * (4 + 16)
                + 4.0 * cfg.n_layers * d_tokens * cfg.d_model * bts),
        })
    elif shape.kind == "prefill":
        model_flops = 2.0 * pc["matmul_active"] * d_tokens \
            + 2.0 * d_tokens * cfg.d_model * cfg.padded_vocab
        attn_bb = _attn_flops(cfg, s, b, causal_exact=False, fwd_only=True)
        attn_mapped = _attn_flops(cfg, s, b, causal_exact=True, fwd_only=True)
        out.update({
            "model_flops": model_flops,
            "attn_flops_bb": attn_bb,
            "attn_flops_mapped": attn_mapped,
            "analytic_flops": model_flops + attn_mapped,
            "analytic_bytes": (
                pc["active"] * bts
                + 2.0 * cfg.n_layers * d_tokens * cfg.d_model * bts),
        })
    else:  # decode: one token, cache of length s
        model_flops = 2.0 * pc["matmul_active"] * b \
            + 2.0 * b * cfg.d_model * cfg.padded_vocab
        if cfg.family in ("ssm", "hybrid"):
            attn = 0.0
            cache_bytes = _state_bytes(cfg, b)
            if cfg.family == "hybrid":
                n_attn = cfg.n_layers // cfg.hybrid_attn_every
                attn = 4.0 * b * s * cfg.n_heads * cfg.head_dim * n_attn
                cache_bytes += 2.0 * b * s * cfg.n_kv_heads * cfg.head_dim \
                    * bts * n_attn
        elif cfg.attention_type == "mla":
            attn = 2.0 * b * s * cfg.n_heads * (
                cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim)
            attn += 4.0 * b * s * cfg.kv_lora_rank * cfg.n_heads * 0  # upproj
            attn *= cfg.n_layers
            cache_bytes = b * s * (cfg.kv_lora_rank + cfg.qk_rope_dim) * bts \
                * cfg.n_layers
        else:
            layers = cfg.decoder_layers if cfg.family == "audio" else cfg.n_layers
            attn = 4.0 * b * s * cfg.n_heads * cfg.head_dim * layers
            cache_bytes = 2.0 * b * s * cfg.n_kv_heads * cfg.head_dim * bts \
                * layers
        out.update({
            "model_flops": model_flops,
            "attn_flops_bb": attn, "attn_flops_mapped": attn,
            "analytic_flops": model_flops + attn,
            "analytic_bytes": pc["active"] * bts + cache_bytes,
        })
    return out


def _state_bytes(cfg: ModelConfig, b: int) -> float:
    if cfg.family == "ssm":
        h = cfg.rwkv_heads
        hd = cfg.d_model // h
        return 4.0 * b * h * hd * hd * cfg.n_layers
    h = cfg.mamba_heads
    return 4.0 * b * h * (cfg.mamba_d_inner // h) * cfg.ssm_state * cfg.n_layers


def _resolve_deployment(spec, n_points: int, block: int):
    """(domain, logic, mapped estimate, bb estimate) for any map spec.
    The logic class resolves through the MapRegistry (a bare domain name
    means its ground-truth entry), so the numbers reflect the tier that
    would deploy."""
    domain_name, logic = resolve_spec(spec)
    d = get_domain(domain_name)
    if logic is None:
        logic = REGISTRY.ground_truth(domain_name).logic
    mp = energy.estimate_mapped(d, logic, n_points, block)
    bb = energy.estimate_bounding_box(d, n_points, block)
    return d, logic, mp, bb


def _deployment_dict(domain_name: str, logic: str, n_points: int,
                     mp, bb) -> dict:
    return {
        "domain": domain_name, "logic": logic, "n_points": n_points,
        "mapped_time_ms": mp.time_ms, "mapped_energy_j": mp.energy_j,
        "mapped_blocks": mp.total_blocks,
        "bb_time_ms": bb.time_ms, "bb_energy_j": bb.energy_j,
        "bb_blocks": bb.total_blocks, "bb_wasted_blocks": bb.wasted_blocks,
        "bb_waste_fraction": bb.waste_fraction,
        "speedup": bb.time_ms / mp.time_ms if mp.time_ms > 0 else float("inf"),
        "energy_reduction": (bb.energy_j / mp.energy_j
                             if mp.energy_j > 0 else float("inf")),
    }


def map_deployment_analytics(spec, n_points: int = 500_000_000,
                             block: int = 256) -> dict:
    """Deployment economics of any map spec: mapped vs bounding-box block
    accounting (any dimensionality, incl. the m-simplex and embedded-fractal
    families) plus the paper's A100 cost model."""
    d, logic, mp, bb = _resolve_deployment(spec, n_points, block)
    return _deployment_dict(d.name, logic, n_points, mp, bb)


def artifact_deployment_analytics(artifact, n_points: int = 500_000_000,
                                  block: int = 256) -> dict:
    """Deployment economics of a validated ``MappingArtifact``: the registry
    accounting of :func:`map_deployment_analytics` plus the amortization of
    the artifact's one-time inference energy."""
    d, logic, mp, bb = _resolve_deployment(artifact, n_points, block)
    am = energy.amortization(d, logic, artifact.inference_joules, n_points,
                             bb=bb, mapped=mp)
    out = _deployment_dict(d.name, logic, n_points, mp, bb)
    out.update({
        "model": artifact.model, "stage": artifact.stage,
        "complexity_class": artifact.complexity_class,
        "report_digest": artifact.report_digest,
        "speedup": am.speedup, "energy_reduction": am.energy_reduction,
        "inference_joules": artifact.inference_joules,
        "runs_to_break_even": am.runs_to_break_even,
    })
    return out
