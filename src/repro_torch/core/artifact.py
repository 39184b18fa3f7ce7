"""Map-spec resolution, the part of ``repro.core.artifact`` that the
evaluation path needs.

A *map spec* names the geometry a kernel launch runs: a domain name, a
:class:`~repro_torch.core.domains.Domain` or a registry
:class:`~repro_torch.core.registry.MapEntry`.  ``MappingArtifact`` (an
LLM-derived, validated map) is not ported yet; until it is, a spec is one
of those three.
"""
from __future__ import annotations


def resolve_spec(spec) -> tuple[str, str | None]:
    """(domain, logic|None) from a str | Domain | MapEntry.

    MapEntry specs carry their logic class so consumers can prefer a
    logic-specific tier when one exists."""
    if isinstance(spec, str):
        return spec, None
    domain = getattr(spec, "domain", None)
    if isinstance(domain, str):  # MapEntry
        return domain, getattr(spec, "logic", None)
    name = getattr(spec, "name", None)
    if isinstance(name, str):    # Domain
        return name, None
    raise TypeError(f"cannot resolve a domain from {spec!r}")


def resolve_domain(spec) -> str:
    return resolve_spec(spec)[0]
