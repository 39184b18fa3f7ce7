"""Full derivation sweep served through the MappingService: every paper
domain x a chosen model, with deployment accounting — the operational
framework of paper Fig. 3, as a *served* workload: the service streams
per-cell results, coalesces concurrent requests, and shares one artifact
store across clients, so a second client (or a second run of this script)
performs zero LLM calls and zero re-validation.

    PYTHONPATH=src python examples_torch/derive_and_deploy.py [model]

With ``--url`` the same sweep runs against a network server (boot one on
the card with ``python -m repro_torch.launch.serve --serve-maps``): two
RemoteMappingService clients share the *server's* store, so client 2's
whole grid is served from the server-side cache — the derivation cost is
paid once per fleet, not once per machine.

    PYTHONPATH=src python examples_torch/derive_and_deploy.py --url http://127.0.0.1:8000

The derive path is host code.  The speedup and energy columns are the
paper's A100 cost model (``core/energy.py``) at N = 5e8, not measurements
of this card.  ``--device`` names where the deployment runs, the card by
default: without one, and without ``--device cpu``, the script raises, as
every example does.
"""
import argparse

import torch

from repro_torch.core.domains import DOMAINS, PAPER_DOMAINS
from repro_torch.launch.analytic import artifact_deployment_analytics

N_DEPLOY = 500_000_000
STAGES = (20, 50, 100)
NO_CARD = "no CUDA device: pass --device cpu to run without the card"


def make_clients(args):
    """Two independent clients over one store: in-process services sharing
    the local cache, or remote clients sharing the server's cache."""
    if args.url:
        from repro_torch.serving import RemoteMappingService

        return (RemoteMappingService(args.url),
                RemoteMappingService(args.url))
    from repro_torch.serving import MappingService

    return (MappingService(n_validate=50_000, sample_every=10),
            MappingService(n_validate=50_000, sample_every=10))


def client_summary(args, c1, c2) -> str:
    if args.url:
        hits = c1.metrics()["service"]["cache_hits"]
        return (f"client 1: {c1.stats.server_cache_hits} server-side hits; "
                f"client 2: {c2.stats.server_cache_hits} server-side hits "
                f"(all {len(STAGES) * len(PAPER_DOMAINS)} cells); server "
                f"store served {hits} hits total")
    return (f"client 1: {c1.stats.derivations} derivations, "
            f"{c1.stats.cache_hits} cache hits; client 2 shared the store: "
            f"{c2.stats.cache_hits} hits, {c2.stats.derivations} derivations")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model", nargs="?", default="OSS:120b")
    p.add_argument("--url", default=None,
                   help="derivation server URL (e.g. http://127.0.0.1:8000); "
                        "omit for in-process services")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)
    names = sorted(d.name for d in PAPER_DOMAINS)
    lines = []

    def say(line: str = "") -> None:
        print(line, flush=True)
        lines.append(line)

    client1, client2 = make_clients(args)
    try:
        # client 1: streams the grid (derives on first pass, cache-served
        # after)
        grid = {}
        for res in client1.run_grid(domains=names, models=[args.model],
                                    stages=STAGES):
            grid[(res.domain, res.model, res.stage)] = res

        # client 2: a fresh client over the same store — every cell a hit
        second = list(client2.run_grid(domains=names, models=[args.model],
                                       stages=STAGES))
        if args.url and not all(r.cache_hit for r in second):
            raise AssertionError("client 2 must be served entirely from the "
                                 "server-side cache")
        summary = client_summary(args, client1, client2)
    finally:
        if args.url:
            client1.close()
            client2.close()

    say(f"model = {args.model}   ({summary})\n")
    say(f"{'domain':22s}{'stage':>6s}{'ordered':>9s}{'any':>8s}"
        f"{'class':>10s}{'speedup':>9s}{'energy x':>9s}")
    table = []
    for name in names:
        dom = DOMAINS[name]
        best = None
        for stage in STAGES:
            res = grid[(name, args.model, stage)]
            if best is None or res.report.ordered > best[1].report.ordered:
                best = (stage, res)
        stage, res = best
        art = res.artifact
        if art is not None and art.deployable:
            dep = artifact_deployment_analytics(art, N_DEPLOY)
            sp = f"{dep['speedup']:8.0f}x"
            ex = f"{dep['energy_reduction']:8.0f}x"
        else:
            sp = ex = "      --"
        row = (f"{dom.paper_name:22s}{stage:>6d}"
               f"{res.report.ordered_pct:>8.1f}%"
               f"{res.report.any_order_pct:>7.1f}%"
               f"{str(res.complexity_class):>10s}{sp}{ex}")
        table.append(row)
        say(row)
    say("\n'--' rows: the model never derived a perfect map (e.g. the "
        "paper's 'Menger limit'); deployment falls back to the "
        "bounding-box kernel.")
    say("speedup and energy x: the paper's A100 cost model at N = 5e8 "
        "(core/energy.py), not measured on this card.")
    out = {"device": args.device, "url": args.url, "table": table,
           "second_all_hits": all(r.cache_hit for r in second),
           "lines": lines}
    if args.url:
        out.update(client1_server_hits=client1.stats.server_cache_hits,
                   client2_server_hits=client2.stats.server_cache_hits)
    else:
        out.update(client1={"derivations": client1.stats.derivations,
                            "cache_hits": client1.stats.cache_hits},
                   client2={"derivations": client2.stats.derivations,
                            "cache_hits": client2.stats.cache_hits})
    return out


if __name__ == "__main__":
    main()
