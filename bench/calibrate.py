"""Readings that set a cell's limits, on the chip at the cell's own size:

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control 1,2,3] [--faults half_batch,answer] [--items 10]

For each seed, in one process: the program's gaps against the fp32
reference (a training cell's first ``check_steps`` steps; a scoring cell's
first ``--items`` requests, sampled as a run samples them), the same with
each planted fault, and, on the ``--control`` seeds, the gaps of the
reference computed in fp8 in the program's place.  One JSON line a seed on
standard output.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(name: str, seed: int, items: int, fault_names: list,
             control: bool, device="cuda", overrides=None) -> dict:
    """{"program": gaps, <fault>: gaps, "control": gaps} for one seed, as
    the cell's traffic kind reads them."""
    from bench import harness, spec
    from bench.reference.common import Precision

    cell, ref, initial, mcfg = harness.prepare(name, seed, device, overrides)
    kind = spec.kind_module(cell.traffic["kind"])
    return kind.calibrate(cell, ref, initial, mcfg, seed, device, items,
                          fault_names, control, Precision("float32"),
                          Precision("float8"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--items", type=int, default=10)
    args = p.parse_args(argv)
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    control = {int(s) for s in args.control.split(",") if s}
    fault_names = [f for f in args.faults.split(",") if f]
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        r = readings(args.workload, seed, args.items, fault_names,
                     seed in control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
