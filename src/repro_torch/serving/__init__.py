"""Serving layer: the LM prefill/decode engine (``engine``), the
concurrency-safe mapping-artifact service (``map_service``), and its
networked form — threaded HTTP frontend (``http``), asyncio event-loop
frontend (``aio``: inline hot path, backpressure-aware streaming),
keep-alive remote client (``client``), per-model request
batching/admission (``batching``: gather-then-drain), the consistent-hash
sharded fleet layer (``cluster``: ring placement, membership heartbeats,
anti-entropy repair), the batched map *evaluation* hot path (``evaluate``:
launcher groups behind ``POST /v1/evaluate``, the map and membership
kernels on the card), the load-aware request router (``router``: bounded
FIFO + retry lane, EWMA-latency/queue-depth replica selection with
epsilon-greedy exploration), and the binary evaluation wire codec
(``wire``: zero-copy array framing negotiated via ``Accept:
application/x-repro-binary``, plus the encoded-response LRU both frontends
serve warm evaluates from).  Both frontends carry the observability plane
(``repro_torch.obs``): per-request traces (``X-Repro-Trace-Id`` ->
``GET /v1/trace/<id>``) and a metrics registry served as JSON and
Prometheus text (``GET /metrics?format=prometheus``).

Continuous batching for the engine backend (``async_engine``) waits for
``EngineBackend``: ROADMAP queue 1 item 7."""
from repro_torch.serving.aio import AsyncMappingHTTPServer  # noqa: F401
from repro_torch.serving.batching import (  # noqa: F401
    AdmissionError, BatchingBackend, BatchStats, batching_factory,
)
from repro_torch.serving.client import (  # noqa: F401
    ClientStats, RemoteBusyError, RemoteMappingService, RemoteServiceError,
    RemoteTimeoutError,
)
from repro_torch.serving.cluster import (  # noqa: F401
    ClusterMembership, HashRing, Placement, RendezvousHash, make_placement,
)
from repro_torch.serving.evaluate import (  # noqa: F401
    EvalStats, EvaluationService, encoded_batch_response, hydrate_result,
    wire_result,
)
from repro_torch.serving.http import MappingHTTPServer  # noqa: F401
from repro_torch.serving.map_service import (  # noqa: F401
    MappingService, ServiceStats,
)
from repro_torch.serving.router import (  # noqa: F401
    ReplicaSelector, RequestQueue, RequestRouter, RouterStats,
)
from repro_torch.serving.wire import (  # noqa: F401
    WireCache, WireFormatError, decode_frame, encode_frame,
)
