"""Dry run of one derived thread map: derive, deploy, verify.

``--domain-map DOMAIN`` derives the domain's ``MappingArtifact`` (mock
backend, the artifact store at ``$REPRO_ARTIFACT_CACHE``), deploys it
through the mapped-grid CUDA kernel and checks the kernel's coordinates
against the artifact's own validated scalar map — the paper's Phase-4
integration proof for one artifact.  It writes one JSON record to
``--out``.  A derivation that is not deployable (menger3d: the paper's
"Menger limit") exits 1 without a launch.

The kernel runs on the card; ``--device cpu`` runs its plain torch version
instead.  Without a card, ``--device cuda`` (the default) raises.

The (arch x shape x mesh) half of the JAX package's dry run (``--arch``,
``--shape``, ``--all``) is not ported yet: ROADMAP queue 1 item 10.

Usage:
    python -m repro_torch.launch.dryrun --domain-map tri2d --out DIR
    python -m repro_torch.launch.dryrun --domain-map tri2d --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.launch import analytic

UNPORTED_ARCH = ("the (arch x shape) dry run (--arch, --shape, --all) is not "
                 "ported yet: ROADMAP queue 1 item 10 (launch and analysis "
                 "tooling)")


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


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", help="not ported yet (queue 1 item 10)")
    p.add_argument("--shape", help="not ported yet (queue 1 item 10)")
    p.add_argument("--all", action="store_true",
                   help="not ported yet (queue 1 item 10)")
    p.add_argument("--out", default="results/dryrun")
    p.add_argument("--domain-map", metavar="DOMAIN",
                   help="derive + deploy one domain's MappingArtifact "
                        "through the mapped-grid kernel")
    p.add_argument("--map-model", default="OSS:120b",
                   help="backend model for --domain-map")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: the CUDA kernel (default); cpu: its plain "
                        "version")
    args = p.parse_args(argv)

    if args.arch or args.shape or args.all:
        raise NotImplementedError(UNPORTED_ARCH)
    if not args.domain_map:
        p.error("--domain-map DOMAIN is required")
    _run_domain_map(args.domain_map, args.map_model, args.out,
                    interpret=args.device == "cpu")


if __name__ == "__main__":
    main()
