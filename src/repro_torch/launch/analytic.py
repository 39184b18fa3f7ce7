"""Deployment analytics of a thread map — the registry/artifact-driven half
of the JAX package's ``launch/analytic.py``.

For any map spec (a domain name, ``Domain``, registry ``MapEntry`` or
validated ``MappingArtifact``): mapped against bounding-box block
accounting (exact, device independent) and the paper's A100 cost model
(``core/energy.py``: the paper's A100 calibration, not a measurement of
this port's card), plus, for an artifact, the amortization of its one-time
inference energy.

The model half (``cell_analytics``, ``param_counts``: FLOPs and bytes per
(arch x shape)) is not ported yet: ROADMAP queue 1 item 10.
"""
from __future__ import annotations

from repro_torch.core import energy
from repro_torch.core.artifact import resolve_spec
from repro_torch.core.domains import get_domain
from repro_torch.core.registry import REGISTRY


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
