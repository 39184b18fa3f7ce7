"""Serving launcher — the LM demo and the networked mapping service.

LM prefill/decode demo:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --batch 4 --prompt-len 32 --max-new 32

``--arch`` takes a ported family's arch: the dense ones (yi-6b,
llama3.2-3b, ...), moonshot-v1-16b-a3b (moe), llama-3.2-vision-11b (vlm),
rwkv6-3b (ssm), zamba2-1.2b (hybrid) and whisper-medium (audio); not
deepseek-v2-236b (MLA attention).  Weights are random, from a ``torch.Generator``
seeded 0 and made on ``--device`` (default ``cuda``; ``--device cpu`` for a
machine without a card, with ``--smoke`` for the reduced config).  The vlm
and audio archs get stub patch or frame embeddings (a seeded
``torch.Generator`` on ``--device``, × 0.1) as their ``extra`` input.

Networked mapping service (HTTP frontend over a MappingService):

    PYTHONPATH=src python -m repro_torch.launch.serve --serve-maps \
        --backend engine --port 8000 --max-batch 8 --max-wait 0.01

``--backend`` picks the inference backend behind the service: ``mock``
(paper replay bank), ``engine`` (real prefill/decode on the in-repo smoke
transformer of ``--arch``, default yi-6b, on the card unless ``--device
cpu`` — see ``core/backends.EngineBackend``) or ``ollama`` (live local GGUF
models).  Derive requests for the same model are admitted through a
batching queue (``--max-batch`` / ``--max-wait`` / ``--max-pending``);
same-cell requests coalesce inside the service.  ``POST /v1/evaluate``
launches the map and membership kernels on the card; without one, a query
must say ``"interpret": true`` (the kernels' plain versions on the CPU) or
it is refused.

By default the service runs on the asyncio event-loop frontend
(``serving/aio.py``) and — for the engine backend — continuous batching
(``--decode-slots`` / ``--admission-timeout``): new derives join in-flight
decode batches at the next step boundary.  ``--no-async`` restores the
threaded ``ThreadingHTTPServer`` + gather-then-drain batching.  The first
line printed names the URL.
"""
from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch


def _backend_factory(args):
    from repro_torch.core import backends

    if args.backend == "mock":
        return backends.MockLLMBackend
    if args.backend == "engine":
        return functools.partial(
            backends.EngineBackend, arch=args.arch,
            max_new_tokens=args.max_new, temperature=args.temperature,
            device=args.device)
    if args.backend == "ollama":
        return backends.OllamaBackend
    raise ValueError(f"unknown backend {args.backend!r}")


def _store_from_args(args):
    """Assemble the tiered store from the CLI knobs, falling back to the
    documented env surface (REPRO_STORE_TTL / REPRO_STORE_MAX_BYTES /
    REPRO_MEMORY_ENTRIES / REPRO_PEERS) for any flag left unset — the
    flag/env pairs in the README stay equivalent.  None = store off,
    coalescing-only degradation."""
    from repro_torch.core.store import build_store, env_knobs, split_peers

    knobs = env_knobs()
    if args.store_ttl is not None:
        knobs["ttl_seconds"] = args.store_ttl
    if args.store_max_bytes is not None:
        knobs["max_bytes"] = args.store_max_bytes
    if args.memory_entries is not None:
        knobs["memory_entries"] = args.memory_entries
    if args.peers is not None:
        knobs["peers"] = split_peers(args.peers)
    return build_store(**knobs)


def _pick(value, default):
    """``value`` unless unset — unlike ``or`` this keeps legitimate
    zeros (epsilon=0, gossip fanout 0 = auto)."""
    return default if value is None else value


def _env(name: str, flag_value, cast=str):
    """Flag wins; else the REPRO_CLUSTER_* env var; else None."""
    if flag_value is not None:
        return flag_value
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return cast(raw)
    except ValueError:
        import warnings

        warnings.warn(f"ignoring malformed {name}={raw!r}", stacklevel=2)
        return None


def _cluster_from_args(args, server):
    """Join a consistent-hash fleet when --cluster-seed (or
    REPRO_CLUSTER_SEED) names at least one live node.  The first node of a
    fleet seeds from its own URL; everyone else names any existing member.
    Returns the started ClusterMembership, or None (standalone: the static
    ``--peers`` mesh, byte-identical)."""
    from repro_torch.core.store import split_peers
    from repro_torch.serving.cluster import (
        DEFAULT_REPLICAS, DEFAULT_VNODES, ClusterMembership,
    )

    seeds = split_peers(_env("REPRO_CLUSTER_SEED", args.cluster_seed))
    if not seeds:
        return None
    self_url = _env("REPRO_CLUSTER_ADVERTISE", args.advertise_url) \
        or server.url
    cluster = ClusterMembership(
        self_url=self_url,
        seeds=seeds,
        vnodes=_env("REPRO_CLUSTER_VNODES", args.vnodes, int)
        or DEFAULT_VNODES,
        replicas=_env("REPRO_CLUSTER_REPLICAS", args.replicas, int)
        or DEFAULT_REPLICAS,
        heartbeat_interval=_env("REPRO_CLUSTER_HEARTBEAT",
                                args.heartbeat_interval, float) or 1.0,
        sync_interval=_env("REPRO_CLUSTER_SYNC_INTERVAL",
                           args.sync_interval, float) or 5.0,
        placement=_env("REPRO_CLUSTER_PLACEMENT", args.placement) or "ring",
        weight=_pick(_env("REPRO_CLUSTER_WEIGHT", args.weight, float), 1.0),
        gossip_fanout=_pick(
            _env("REPRO_CLUSTER_FANOUT", args.gossip_fanout, int), 0),
    )
    return server.attach_cluster(cluster)


def _router_from_args(args):
    """Build the per-node request router from the CLI knobs, falling back
    to the REPRO_ROUTER_* env surface for any flag left unset."""
    from repro_torch.serving.router import RequestRouter

    return RequestRouter(
        policy=_env("REPRO_ROUTER_POLICY", args.route_policy) or "loaded",
        max_pending=args.max_pending,
        ttl=_pick(_env("REPRO_ROUTER_TTL", args.router_ttl, float), 30.0),
        epsilon=_pick(
            _env("REPRO_ROUTER_EPSILON", args.router_epsilon, float), 0.05),
        depth_penalty_ms=_pick(
            _env("REPRO_ROUTER_DEPTH_PENALTY",
                 args.router_depth_penalty, float), 5.0),
    )


def serve_maps(args) -> None:
    """Boot the full stack: backend -> batching queue -> MappingService ->
    HTTP frontend (-> cluster membership), then serve until interrupted.

    ``--async`` (the default) serves from the asyncio event-loop frontend,
    with the engine backend behind continuous batching; ``--no-async``
    falls back to the threaded server, and every backend goes through the
    gather-then-drain batching queue.  The engine runs on ``--device``: on
    a machine without a card it refuses to start unless ``--device cpu``.
    ``POST /v1/evaluate`` launches the map kernels on the card (a query's
    ``"interpret": true`` runs their plain versions on the CPU instead)."""
    from repro_torch.core import compile_cache
    from repro_torch.core.backends import NO_CARD_ENGINE
    from repro_torch.serving import (
        AsyncMappingHTTPServer, MappingHTTPServer, MappingService,
        batching_factory, continuous_factory,
    )

    if (args.backend == "engine" and torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit(f"--backend engine: {NO_CARD_ENGINE}")

    # evaluation-plane knobs (flags win; REPRO_COMPILE_CACHE_* env fallback
    # is read inside configure_default/default_compile_cache)
    if args.compile_cache_entries is not None \
            or args.compile_cache_dir is not None:
        compile_cache.configure_default(
            max_entries=args.compile_cache_entries,
            persist_dir=args.compile_cache_dir)
    cc = compile_cache.default_compile_cache()

    if args.use_async and args.backend == "engine":
        # continuous batching: new derives join in-flight decodes at the
        # next step boundary instead of waiting for the batch to drain
        factory = continuous_factory(
            _backend_factory(args), decode_slots=args.decode_slots,
            max_pending=args.max_pending,
            admission_timeout=args.admission_timeout)
    else:
        factory = batching_factory(
            _backend_factory(args), max_batch=args.max_batch,
            max_wait=args.max_wait, max_pending=args.max_pending)
    service = MappingService(store=_store_from_args(args),
                             backend_factory=factory,
                             n_validate=args.n_validate)
    router = _router_from_args(args)
    serve_delay = _pick(_env("REPRO_SLOW_SERVE", args.slow_serve, float),
                        0.0)
    wire_entries = _pick(_env("REPRO_WIRE_CACHE_ENTRIES",
                              args.wire_cache_entries, int), 256)
    if args.use_async:
        server = AsyncMappingHTTPServer(
            service, host=args.host, port=args.port,
            max_pending=args.max_pending,
            observability=args.observability,
            router=router, serve_delay=serve_delay,
            wire_cache_entries=wire_entries)
        server.start()  # bind + loop up before cluster membership probes
    else:
        server = MappingHTTPServer(service, host=args.host, port=args.port,
                                   observability=args.observability,
                                   router=router, serve_delay=serve_delay,
                                   wire_cache_entries=wire_entries)
    cluster = _cluster_from_args(args, server)
    store = service.store
    if store is None:
        desc = "off"
    else:
        mem = store.memory.max_entries if store.memory is not None else 0
        peers = store.peer.peers if store.peer is not None else []
        disk = (f"{store.root} (ttl={store.disk.ttl_seconds}, "
                f"max_bytes={store.disk.max_bytes})"
                if store.disk is not None else "diskless")
        desc = f"{disk} memory={mem} entries, peers={peers or 'none'}"
    mode = "async" if args.use_async else "threaded"
    print(f"mapping service on {server.url}  "
          f"(backend={args.backend}, frontend={mode}, store={desc})",
          flush=True)
    print(f"observability: tracing={'on' if args.observability else 'off'} "
          f"(X-Repro-Trace-Id; GET /v1/trace/<id>), metrics=json+prometheus "
          f"(GET /metrics?format=prometheus)")
    if args.backend == "engine":
        print(f"engine: arch={args.arch} device={args.device}")
    if args.use_async and args.backend == "engine":
        print(f"continuous batching: decode_slots={args.decode_slots} "
              f"admission_timeout={args.admission_timeout}s")
    if cc is None:
        print("launcher cache: off")
    else:
        print(f"launcher cache: {cc.max_entries} entries")
    print(f"evaluate wire: binary framing via 'Accept: "
          f"application/x-repro-binary' or ?format=binary, "
          f"response LRU={wire_entries} entries")
    if cluster is not None:
        print(f"cluster: self={cluster.self_url} replicas="
              f"{cluster.replicas} vnodes={cluster.vnodes} "
              f"placement={cluster.placement} weight={cluster.weight} "
              f"gossip_fanout={cluster.gossip_fanout or 'auto'} "
              f"heartbeat={cluster.heartbeat_interval}s "
              f"sync={cluster.sync_interval}s "
              f"peers_up={cluster.live_peers() or 'none'}")
    print(f"router: policy={router.policy} epsilon={router.selector.epsilon} "
          f"ttl={router.queue.ttl}s max_pending={router.queue.capacity}")
    if serve_delay > 0:
        print(f"CHAOS: --slow-serve active, every derive sleeps "
              f"{serve_delay}s before serving")
    print("endpoints: POST /v1/derive  POST /v1/evaluate  "
          "GET|DELETE /v1/artifact/<key>  "
          "POST /v1/grid  GET /v1/store/stats  GET /v1/cluster  "
          "GET /v1/replicate/manifest  GET|POST /v1/replicate/<key>  "
          "GET /v1/trace/<id>  GET /v1/traces  GET /healthz  GET /metrics",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if cluster is not None:
            cluster.close()
        if args.use_async:
            server.close()
        else:
            server.httpd.server_close()


def lm_demo(args) -> None:
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.common import count_params
    from repro_torch.serving.engine import generate

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(max_seq=args.prompt_len + args.max_new)
    if args.device == "cpu":
        cfg = cfg.replace(pallas_interpret=True)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = T.init_params(cfg, gen, device=args.device)
    print(f"arch={cfg.arch_id} params={count_params(params):,} "
          f"device={args.device}")

    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int64)
    extra = None
    if cfg.family in ("vlm", "audio"):
        # stub patch / frame embeddings, already projected to d_model
        frames = cfg.vision_seq if cfg.family == "vlm" else cfg.encoder_seq
        extra = torch.randn(
            (args.batch, frames, cfg.d_model), device=args.device,
            generator=torch.Generator(device=args.device).manual_seed(1)) \
            * 0.1
    t0 = time.perf_counter()
    res = generate(params, cfg, torch.from_numpy(prompts), args.max_new,
                   extra=extra, temperature=args.temperature)
    if args.device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total_new = res.steps * args.batch
    print(f"generated {res.steps} steps x {args.batch} seqs in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s)")
    print("sample:",
          res.tokens[0, args.prompt_len:args.prompt_len + 16].tolist())


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="yi-6b",
                   help="model arch (LM demo; also the engine backend's "
                        "smoke config)")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--device", default="cuda",
                   help="where the weights live and the model runs (the LM "
                        "demo and the engine backend)")
    # networked mapping service
    p.add_argument("--serve-maps", action="store_true",
                   help="serve mapping derivations over HTTP instead of "
                        "running the LM demo")
    p.add_argument("--backend", choices=("mock", "engine", "ollama"),
                   default="mock",
                   help="inference backend for --serve-maps")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--n-validate", type=int, default=100_000,
                   help="ground-truth points per served validation")
    p.add_argument("--max-batch", type=int, default=8,
                   help="max derive requests per batched backend call")
    p.add_argument("--max-wait", type=float, default=0.01,
                   help="seconds the batcher waits to fill a batch")
    p.add_argument("--max-pending", type=int, default=256,
                   help="admission queue depth (beyond this: HTTP 503)")
    p.add_argument("--observability", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="per-request tracing (X-Repro-Trace-Id propagation "
                        "+ /v1/trace endpoints); --no-observability turns "
                        "tracing off (metrics always stay on)")
    p.add_argument("--async", dest="use_async", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="serve from the asyncio event-loop frontend "
                        "(--no-async falls back to the threaded server)")
    p.add_argument("--decode-slots", type=int, default=8,
                   help="continuous batching: max requests decoding "
                        "concurrently across cohorts (engine backend, "
                        "async mode)")
    p.add_argument("--admission-timeout", type=float, default=30.0,
                   metavar="SECONDS",
                   help="continuous batching: a request waiting longer than "
                        "this for a free decode slot fails with HTTP 504")
    # artifact-store lifecycle (see core/store.py)
    p.add_argument("--store-ttl", type=float, default=None, metavar="SECONDS",
                   help="evict records idle longer than this (default: never)")
    p.add_argument("--store-max-bytes", type=int, default=None,
                   metavar="BYTES",
                   help="disk budget; least-recently-accessed records are "
                        "evicted past it (default: unbounded)")
    p.add_argument("--memory-entries", type=int, default=None,
                   help="LRU hot-tier capacity in records (0 disables the "
                        "memory tier; default 256)")
    p.add_argument("--peers", default=None, metavar="URL[,URL...]",
                   help="static sibling servers to replicate with "
                        "(broadcast mesh; superseded by --cluster-seed)")
    # evaluation plane (see core/compile_cache.py + serving/evaluate.py)
    p.add_argument("--compile-cache-entries", type=int, default=None,
                   help="kernel-launcher LRU capacity for /v1/evaluate "
                        "(0 disables; default 128) "
                        "[REPRO_COMPILE_CACHE_ENTRIES]")
    p.add_argument("--compile-cache-dir", default=None, metavar="DIR",
                   help="accepted for parity with the JAX package; bound "
                        "launchers are not persisted "
                        "[REPRO_COMPILE_CACHE_DIR]")
    p.add_argument("--wire-cache-entries", type=int, default=None,
                   help="encoded evaluate-response LRU capacity (binary and "
                        "JSON blobs; 0 disables; default 256) "
                        "[REPRO_WIRE_CACHE_ENTRIES]")
    # consistent-hash sharded fleet (see serving/cluster.py); every flag
    # falls back to its REPRO_CLUSTER_* env var
    p.add_argument("--cluster-seed", default=None, metavar="URL[,URL...]",
                   help="join a sharded fleet by asking these live nodes "
                        "for the membership view (the first node of a "
                        "fleet seeds from its own URL) "
                        "[REPRO_CLUSTER_SEED]")
    p.add_argument("--replicas", type=int, default=None,
                   help="copies of each record across the fleet "
                        "(default 2) [REPRO_CLUSTER_REPLICAS]")
    p.add_argument("--vnodes", type=int, default=None,
                   help="virtual nodes per server on the hash ring "
                        "(default 64) [REPRO_CLUSTER_VNODES]")
    p.add_argument("--sync-interval", type=float, default=None,
                   metavar="SECONDS",
                   help="anti-entropy repair cadence (default 5.0) "
                        "[REPRO_CLUSTER_SYNC_INTERVAL]")
    p.add_argument("--heartbeat-interval", type=float, default=None,
                   metavar="SECONDS",
                   help="membership probe cadence (default 1.0) "
                        "[REPRO_CLUSTER_HEARTBEAT]")
    p.add_argument("--advertise-url", default=None, metavar="URL",
                   help="URL peers should reach this node at (default "
                        "http://HOST:PORT — set this when binding 0.0.0.0) "
                        "[REPRO_CLUSTER_ADVERTISE]")
    p.add_argument("--placement", choices=("ring", "rendezvous"),
                   default=None,
                   help="key->owner placement: weighted consistent-hash "
                        "ring (default) or rendezvous hashing "
                        "[REPRO_CLUSTER_PLACEMENT]")
    p.add_argument("--weight", type=float, default=None,
                   help="this node's capacity weight — scales its share "
                        "of the keyspace (default 1.0) "
                        "[REPRO_CLUSTER_WEIGHT]")
    p.add_argument("--gossip-fanout", type=int, default=None,
                   help="peers probed per heartbeat round: N>0 caps at N, "
                        "0 = auto ceil(log2(fleet))+2 (default), "
                        "negative = probe everyone [REPRO_CLUSTER_FANOUT]")
    # load-aware request router (see serving/router.py); every flag falls
    # back to its REPRO_ROUTER_* env var
    p.add_argument("--route-policy", choices=("loaded", "static"),
                   default=None,
                   help="replica selection: 'loaded' ranks owners by EWMA "
                        "latency + advertised queue depth (default); "
                        "'static' keeps placement order "
                        "[REPRO_ROUTER_POLICY]")
    p.add_argument("--router-ttl", type=float, default=None,
                   metavar="SECONDS",
                   help="queued forwards older than this expire instead of "
                        "dispatching (default 30.0) [REPRO_ROUTER_TTL]")
    p.add_argument("--router-epsilon", type=float, default=None,
                   help="epsilon-greedy exploration rate: probability a "
                        "non-best replica is promoted so cold replicas get "
                        "re-measured (default 0.05) [REPRO_ROUTER_EPSILON]")
    p.add_argument("--router-depth-penalty", type=float, default=None,
                   metavar="MS",
                   help="cost penalty per advertised queued request when "
                        "ranking replicas (default 5.0 ms) "
                        "[REPRO_ROUTER_DEPTH_PENALTY]")
    p.add_argument("--slow-serve", type=float, default=None,
                   metavar="SECONDS",
                   help="chaos knob: sleep this long before serving every "
                        "derive — makes this replica artificially slow so "
                        "load-aware routing can be demonstrated "
                        "[REPRO_SLOW_SERVE]")
    args = p.parse_args(argv)
    if args.serve_maps:
        serve_maps(args)
    else:
        lm_demo(args)


if __name__ == "__main__":
    main()
