"""MappingArtifact — the persistent, registered product of a derivation.

The paper's economic claim is that LLM derivation is a one-time upfront
investment amortized across every subsequent launch.  This module makes that
literal: a successful (domain, model, stage) derivation becomes a
``MappingArtifact`` — validated source, accuracy report digest, complexity
class, inference-energy metadata, and a scalar callable rebuilt on demand
from the validated source.  The pipeline persists each cell (successes and
NC failures alike) as a JSON derivation record in the tiered artifact store
(``core/store.py``: memory LRU -> checksummed disk with TTL/size eviction
-> peer replication), so repeated pipeline calls skip inference *and* the
10^6-point validation entirely; ``MappingArtifact.to_record``/``from_record``
additionally serialize a standalone artifact for export (e.g. serving a
shared artifact store).

Storage:    see :mod:`repro_torch.core.store` — disk root $REPRO_ARTIFACT_CACHE,
            else ~/.cache/repro_thread_maps; opt out with
            REPRO_ARTIFACT_CACHE=off (or "0" / "none").
Key:        sha256 over {domain, model, stage, sha256(prompt), n_validate,
            sample_every} — any change to the prompt template, sampling
            stage or validation spec changes the key, which (plus the
            schema version + checksum in each record) is the entire
            invalidation story.

``ArtifactCache`` is the historical name of the disk tier; it and the
locking/keying primitives re-export here so existing imports keep working.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Any, Callable

from repro_torch.core import synthesis, validate
from repro_torch.core.domains import Domain, get_domain
from repro_torch.core.registry import REGISTRY, MapRegistry
from repro_torch.core.store import (  # noqa: F401 — storage layer re-exports
    SCHEMA_VERSION, ArtifactStore, DiskStore, FileLock, MemoryStore,
    PeerStore, TieredStore, build_store, cache_key, default_store,
)

#: historical name for the disk tier (older call sites and tests)
ArtifactCache = DiskStore

#: historical name for the process-default store
default_cache = default_store

#: complexity class -> calibrated logic-class table key (Sec. V.C costs).
_DENSE_LOGIC = {
    "O(1)": "analytical",
    "O(log N)": "binsearch",
    "O(N^1/3)": "linear",
    "O(N^1/2)": "linear",
    "O(N)": "linear",
}
_FRACTAL_LOGIC = {
    "O(1)": "bitwise",
    "O(log N)": "bitwise",
    "O(N^1/3)": "linear",
    "O(N^1/2)": "linear",
    "O(N)": "linear",
}


def logic_for(complexity_class: str | None, domain: Domain) -> str:
    """Map a measured complexity class onto the calibrated logic table."""
    table = _DENSE_LOGIC if domain.kind == "dense" else _FRACTAL_LOGIC
    default = "analytical" if domain.kind == "dense" else "bitwise"
    return table.get(complexity_class or "", default)


# ---------------------------------------------------------------------------
# MappingArtifact
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MappingArtifact:
    """A validated thread map plus everything deployment needs to trust it."""

    domain: str
    model: str
    stage: int
    source: str                       # validated map_to_coordinates source
    complexity_class: str | None
    report: validate.ValidationReport
    inference_joules: float
    inference_seconds: float          # derivation wall time (one-time cost)
    cache_key: str | None = None
    created_unix: float = dataclasses.field(default_factory=time.time)
    _scalar: Callable | None = dataclasses.field(
        default=None, repr=False, compare=False)

    # -- identity ----------------------------------------------------------
    @property
    def domainobj(self) -> Domain:
        return get_domain(self.domain)

    @property
    def logic(self) -> str:
        return logic_for(self.complexity_class, self.domainobj)

    @property
    def report_digest(self) -> str:
        payload = json.dumps(dataclasses.asdict(self.report), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    @property
    def deployable(self) -> bool:
        """Only a 100%-ordered map may drive the mapped-grid kernel."""
        return self.report.error is None and self.report.ordered >= 1.0

    # -- tiers -------------------------------------------------------------
    def scalar_fn(self) -> Callable:
        """Exact scalar callable, rebuilt from the validated source on first
        use (compile + probe only — the cached report vouches for accuracy)."""
        if self._scalar is None:
            self._scalar = synthesis.synthesize(self.source).fn
        return self._scalar

    def registered_entry(self):
        """The registry's ground-truth entry this artifact deploys through
        (vectorized/kernel tiers are per-domain geometry, licensed by the
        artifact's validation report)."""
        if not self.deployable:
            raise ValueError(
                f"artifact ({self.domain}, {self.model}, s{self.stage}) is "
                f"not deployable: ordered={self.report.ordered_pct:.2f}% "
                f"(error={self.report.error!r})")
        return REGISTRY.ground_truth(self.domain)

    def register(self, registry: MapRegistry | None = None,
                 logic: str | None = None):
        """Expose the derived scalar map through a registry under a
        model-attributed logic key (default ``derived:<model>:s<stage>``)."""
        reg = registry if registry is not None else REGISTRY
        logic = logic or f"derived:{self.model}:s{self.stage}"
        return reg.register(
            self.domain, logic,
            tiers={"scalar": self.scalar_fn()},
            complexity_class=self.complexity_class,
        )

    # -- (de)serialization -------------------------------------------------
    def to_record(self) -> dict[str, Any]:
        return {
            "domain": self.domain, "model": self.model, "stage": self.stage,
            "source": self.source, "complexity_class": self.complexity_class,
            "report": dataclasses.asdict(self.report),
            "report_digest": self.report_digest,
            "inference_joules": self.inference_joules,
            "inference_seconds": self.inference_seconds,
            "cache_key": self.cache_key, "created_unix": self.created_unix,
        }

    @classmethod
    def from_record(cls, rec: dict[str, Any]) -> "MappingArtifact":
        return cls(
            domain=rec["domain"], model=rec["model"], stage=rec["stage"],
            source=rec["source"], complexity_class=rec["complexity_class"],
            report=validate.ValidationReport(**rec["report"]),
            inference_joules=rec["inference_joules"],
            inference_seconds=rec["inference_seconds"],
            cache_key=rec.get("cache_key"),
            created_unix=rec.get("created_unix", 0.0),
        )


def resolve_spec(spec) -> tuple[str, str | None]:
    """(domain, logic|None) from a str | Domain | MapEntry | MappingArtifact.

    Artifacts must be deployable (100% ordered) — this is the integration
    gate of the paper's Phase 4.  MapEntry/artifact specs carry their logic
    class so consumers can prefer a logic-specific tier when one exists."""
    if isinstance(spec, str):
        return spec, None
    if isinstance(spec, MappingArtifact):
        spec.registered_entry()  # raises if not deployable
        return spec.domain, spec.logic
    domain = getattr(spec, "domain", None)
    if isinstance(domain, str):  # MapEntry
        return domain, getattr(spec, "logic", None)
    name = getattr(spec, "name", None)
    if isinstance(name, str):    # Domain
        return name, None
    raise TypeError(f"cannot resolve a domain from {spec!r}")


def resolve_domain(spec) -> str:
    return resolve_spec(spec)[0]
