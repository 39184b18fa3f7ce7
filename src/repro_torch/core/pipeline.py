"""The four-phase automated discovery pipeline (Fig. 3), as composable
stages.

  1. Context Sampling      — first N domain points (N in {20, 50, 100}),
  2. Symbolic Inference    — backend.generate over the Appendix-A prompt,
  3. Algorithmic Synthesis — code extraction + restricted compile + rule check,
  4. Integration           — validated map handed to the deployment layer
                             (the CUDA mapped-grid / bounding-box kernels)
                             as a MappingArtifact.

Each phase is an explicit stage function — ``prepare_request`` (phases 1+2
prep: context sampling, prompt, content address), ``stage_inference``,
``stage_synthesis``, ``stage_validation`` — and ``derive_mapping`` is their
composition plus the cache check.  The stages are what ``serving/
map_service.py`` fronts with locking and request coalescing; the content
address computed by ``prepare_request`` is the coalescing key, so the local
path and the served path can never disagree on cache identity.

Derivation is a one-time upfront investment: every cell is content-addressed
(domain + model + stage + prompt + validation spec) into the artifact cache,
so a repeated ``derive_mapping`` call is served from disk with zero backend
``generate`` calls and zero re-validation.  ``run_grid`` sweeps whole
(domain x model x stage) grids through the same cache.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Iterable, Sequence

import numpy as np

from repro_torch.core import complexity, energy, synthesis, validate
from repro_torch.core.artifact import MappingArtifact, cache_key, logic_for
from repro_torch.core.backends import LLMBackend, LLMResponse, build_prompt
from repro_torch.core.domains import DOMAINS, Domain
from repro_torch.core.store import ArtifactStore, default_store
from repro_torch.obs import trace as obs_trace

_USE_DEFAULT_CACHE = object()  # sentinel: "resolve default_store() at call"


@dataclasses.dataclass
class DerivationResult:
    domain: str
    model: str
    stage: int
    response: LLMResponse
    compiled: bool
    source: str | None
    report: validate.ValidationReport
    complexity_class: str | None
    wall_seconds: float
    inference_joules: float
    domainobj: Domain
    error: str | None = None
    cache_hit: bool = False
    cache_key: str | None = None
    created_unix: float = dataclasses.field(default_factory=time.time)

    @property
    def perfect(self) -> bool:
        return self.compiled and self.report.ordered >= 1.0

    @property
    def silver(self) -> bool:  # geometry right, order permuted
        return self.compiled and not self.perfect and self.report.any_order >= 0.999

    @property
    def logic(self) -> str:
        """Calibrated logic class implied by the measured complexity."""
        return logic_for(self.complexity_class, self.domainobj)

    @functools.cached_property
    def artifact(self) -> MappingArtifact | None:
        """The persistent product of this derivation (None if it failed).
        Memoized so repeated access shares one instance (and its compiled
        scalar callable)."""
        if not self.compiled or self.source is None:
            return None
        return MappingArtifact(
            domain=self.domain, model=self.model, stage=self.stage,
            source=self.source, complexity_class=self.complexity_class,
            report=self.report, inference_joules=self.inference_joules,
            inference_seconds=self.wall_seconds, cache_key=self.cache_key,
            created_unix=self.created_unix,
        )

    def amortization(self, n_points: int = 500_000_000):
        if not self.compiled or self.complexity_class is None:
            return None
        return energy.amortization(self.domainobj, self.logic,
                                   self.inference_joules, n_points)


# ---------------------------------------------------------------------------
# Cache record <-> result
# ---------------------------------------------------------------------------


def _record_from_result(res: DerivationResult) -> dict:
    r = res.response
    return {
        "domain": res.domain, "model": res.model, "stage": res.stage,
        "compiled": res.compiled, "source": res.source, "error": res.error,
        "complexity_class": res.complexity_class,
        "wall_seconds": res.wall_seconds,
        "report": dataclasses.asdict(res.report),
        "response": {
            "text": r.text, "model": r.model, "tokens_in": r.tokens_in,
            "tokens_out": r.tokens_out, "seconds": r.seconds,
            "joules": r.joules,
        },
        "created_unix": res.created_unix,
    }


def _result_from_record(rec: dict, domain: Domain, key: str) -> DerivationResult:
    """Rehydrate a cached derivation record (the serving layer's read path)."""
    return DerivationResult(
        domain=rec["domain"], model=rec["model"], stage=rec["stage"],
        response=LLMResponse(**rec["response"]),
        compiled=rec["compiled"], source=rec["source"],
        report=validate.ValidationReport(**rec["report"]),
        complexity_class=rec["complexity_class"],
        wall_seconds=rec["wall_seconds"],
        inference_joules=rec["response"]["joules"],
        domainobj=domain, error=rec["error"],
        cache_hit=True, cache_key=key,
        created_unix=rec.get("created_unix", 0.0),
    )


#: public names for the serving layer (same record schema, one code path)
record_from_result = _record_from_result
result_from_record = _result_from_record


# ---------------------------------------------------------------------------
# JSON wire schema (the HTTP serving layer's payloads)
# ---------------------------------------------------------------------------

#: bumped when the wire payload shape changes; the client refuses a
#: mismatched server rather than mis-parsing it.
WIRE_VERSION = 1


def wire_from_result(res: DerivationResult) -> dict:
    """One served cell as a self-describing JSON payload: the derivation
    record (the exact schema the cache stores) plus the envelope the remote
    client needs — content address, whether the server resolved it from its
    store, and the artifact record when the cell is deployable."""
    art = res.artifact
    return {
        "wire": WIRE_VERSION,
        "key": res.cache_key,
        "cache_hit": res.cache_hit,
        "record": _record_from_result(res),
        "artifact": art.to_record() if art is not None else None,
    }


def result_from_wire(payload: dict, domain: Domain | None = None) -> DerivationResult:
    """Rehydrate a wire payload into a DerivationResult (the remote client's
    read path).  The domain object is resolved locally — client and server
    share the domain registry, and the content address in the payload ties
    the record to the exact (domain, model, stage, prompt) cell."""
    if payload.get("wire") != WIRE_VERSION:
        raise ValueError(
            f"wire version mismatch: got {payload.get('wire')!r}, "
            f"want {WIRE_VERSION}")
    rec = payload["record"]
    if domain is None:
        domain = DOMAINS[rec["domain"]]
    res = _result_from_record(rec, domain, payload["key"])
    res.cache_hit = bool(payload["cache_hit"])
    return res


# ---------------------------------------------------------------------------
# Composable stages (one cell = prepare -> inference -> synthesis ->
# validation; the cache check wraps the whole chain)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DerivationRequest:
    """One fully-addressed pipeline cell: everything phases 2-4 need, plus
    the content address that identifies it in the cache and in the serving
    layer's coalescing table."""

    domain: Domain
    backend: LLMBackend
    stage: int
    n_validate: int
    sample_every: int
    prompt: str
    key: str


def prepare_request(
    domain: Domain,
    backend: LLMBackend,
    stage: int = 100,
    n_validate: int = 1_000_000,
    sample_every: int = 1,
) -> DerivationRequest:
    """Phases 1+2 prep: sample context, build the Appendix-A prompt, and
    content-address the cell.  The prompt is part of the address, so a
    prompt-template change invalidates the cache; backends may expose a
    content fingerprint (e.g. the mock replay bank) so behavior edits
    invalidate their cached cells too."""
    prompt = build_prompt(domain, stage)
    key = cache_key(domain.name, backend.name, stage, prompt,
                    n_validate=n_validate, sample_every=sample_every,
                    backend_fingerprint=getattr(backend, "cache_fingerprint",
                                                None))
    return DerivationRequest(domain=domain, backend=backend, stage=stage,
                             n_validate=n_validate, sample_every=sample_every,
                             prompt=prompt, key=key)


def stage_inference(req: DerivationRequest) -> LLMResponse:
    """Phase 2 — Symbolic Inference over the prepared prompt."""
    # the meta dict additionally snapshots the active request trace so a
    # shared batcher thread can attribute its generate work (see obs.trace)
    with obs_trace.span("inference", model=req.backend.name):
        return req.backend.generate(
            req.prompt, meta={"domain": req.domain.name, "stage": req.stage,
                              **obs_trace.meta_context()})


def stage_synthesis(resp: LLMResponse) -> synthesis.SynthesizedMap:
    """Phase 3 — extraction + rule check + restricted compile (raises
    ``SynthesisError`` => the cell is (NC))."""
    return synthesis.synthesize(resp.text)


def stage_validation(
    req: DerivationRequest,
    synth: synthesis.SynthesizedMap,
    gt: np.ndarray | None = None,
) -> tuple[validate.ValidationReport, str | None]:
    """Phase 3b — the paper's 10^6-point ground-truth check, plus the
    complexity classification of validated candidates."""
    rep = validate.validate_scalar_fn(
        synth.fn, req.domain, n_points=req.n_validate, gt=gt,
        sample_every=req.sample_every)
    cls = complexity.classify(synth.fn)["class"] if rep.error is None else None
    return rep, cls


def run_stages(
    req: DerivationRequest,
    gt: np.ndarray | Callable[[], np.ndarray] | None = None,
) -> DerivationResult:
    """Phases 2-4 for one prepared cell (no cache interaction)."""
    t0 = time.monotonic()
    resp = stage_inference(req)
    try:
        synth = stage_synthesis(resp)
    except synthesis.SynthesisError as e:
        return DerivationResult(
            domain=req.domain.name, model=req.backend.name, stage=req.stage,
            response=resp, compiled=False, source=None,
            report=validate.FAILED(req.n_validate, str(e)),
            complexity_class=None, wall_seconds=time.monotonic() - t0,
            inference_joules=resp.joules, domainobj=req.domain,
            error=str(e), cache_key=req.key,
        )
    if callable(gt):
        gt = gt()
    with obs_trace.span("validation", n_points=req.n_validate):
        rep, cls = stage_validation(req, synth, gt)
    return DerivationResult(
        domain=req.domain.name, model=req.backend.name, stage=req.stage,
        response=resp, compiled=True, source=synth.source, report=rep,
        complexity_class=cls, wall_seconds=time.monotonic() - t0,
        inference_joules=resp.joules, domainobj=req.domain, cache_key=req.key,
    )


def derive_mapping(
    domain: Domain,
    backend: LLMBackend,
    stage: int = 100,
    n_validate: int = 1_000_000,
    gt: np.ndarray | Callable[[], np.ndarray] | None = None,
    sample_every: int = 1,
    cache: ArtifactStore | None = _USE_DEFAULT_CACHE,  # type: ignore[assignment]
) -> DerivationResult:
    """Run the full pipeline for one (domain, model, stage) cell.

    ``cache`` accepts any :class:`~repro_torch.core.store.ArtifactStore` and
    defaults to the process-wide tiered store (``store.default_store()``):
    library callers and the served path share one memory -> disk -> peer
    scheme, so a cell derived here is a hot memory hit for the service and
    vice versa.  Pass ``cache=None`` to force a live derivation.  ``gt``
    may be the ground-truth array or a zero-arg callable producing it — the
    callable is only invoked on a cache miss, so cached sweeps never
    enumerate."""
    if cache is _USE_DEFAULT_CACHE:
        cache = default_store()
    req = prepare_request(domain, backend, stage, n_validate, sample_every)
    if cache is not None:
        rec = cache.load(req.key)
        if rec is not None:
            return _result_from_record(rec, domain, req.key)
    res = run_stages(req, gt)
    if cache is not None:
        cache.store(req.key, _record_from_result(res))
    return res


# ---------------------------------------------------------------------------
# Grid orchestrator
# ---------------------------------------------------------------------------


def run_grid(
    domains: Iterable[str] | None = None,
    models: Iterable[str] | None = None,
    stages: Sequence[int] | None = None,
    *,
    backend_factory: Callable[[str], LLMBackend] | None = None,
    n_validate: int = 100_000,
    sample_every: int = 50,
    cache: ArtifactStore | None = _USE_DEFAULT_CACHE,  # type: ignore[assignment]
    progress: Callable[[DerivationResult], None] | None = None,
) -> dict[tuple[str, str, int], DerivationResult]:
    """Sweep every (domain x model x stage) cell through the artifact cache.

    Ground truth is enumerated once per domain and shared across the sweep;
    cells already in the cache cost one JSON read.  Defaults sweep the
    paper's measured grid (the six Table-II..VII domains x 11 models x 3
    stages); extension domains (m-simplex, embedded fractals) are swept by
    passing them explicitly.  Returns a dict keyed (domain, model, stage)."""
    from repro_torch.core import paper_tables as pt
    from repro_torch.core.backends import MockLLMBackend

    domains = list(domains) if domains is not None else sorted(pt.ACCURACY)
    models = list(models) if models is not None else list(pt.MODELS)
    stages = list(stages) if stages is not None else list(pt.STAGES)
    backend_factory = backend_factory or MockLLMBackend
    if cache is _USE_DEFAULT_CACHE:
        cache = default_store()

    out: dict[tuple[str, str, int], DerivationResult] = {}
    for dom_name in domains:
        dom = DOMAINS[dom_name] if isinstance(dom_name, str) else dom_name
        gt_memo: dict[str, np.ndarray] = {}

        def lazy_gt(d=dom):  # enumerated once per domain, only on a miss
            if "gt" not in gt_memo:
                gt_memo["gt"] = d.enumerate_points(n_validate)
            return gt_memo["gt"]

        for model in models:
            backend = backend_factory(model)
            for stage in stages:
                res = derive_mapping(
                    dom, backend, stage, n_validate=n_validate, gt=lazy_gt,
                    sample_every=sample_every, cache=cache)
                out[(dom.name, model, stage)] = res
                if progress is not None:
                    progress(res)
    return out
