"""Traffic kind ``train``: a trainer's closed loop of steps, each on a new
batch of ``rows`` × ``seq`` uniform tokens in ``microbatches``, its loss
read back on the host as a trainer's log line does.  Set-up runs the first
``check_steps`` steps through the window's own call and feed, and keeps
what the check compares: each step's loss, each leaf's first gradient as
the optimizer took it, and each leaf's change over those steps.  The
end-to-end metric (the traffic file's ``metric``) is the tokens of all
whole steps over the time from the first step's start to the last one's
end.

A traffic file of this kind holds ``kind``, ``metric``, ``rows``, ``seq``,
``microbatches``, ``check_steps``, ``z_loss_coef``, ``optimizer`` (the
program's AdamW settings) and ``trace``.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from bench import drive, faults, program
from bench.weights import Feed


class Driver:
    def __init__(self, cell, mcfg, initial, seed: int, device, fault=None):
        t = cell.traffic
        self.traffic, self.device = t, device
        self.marks = [("start", time.perf_counter())]
        self.model = program.build_model(mcfg, initial())
        self.state = program.optimizer_state(self.model)
        self.marks.append(("weights", time.perf_counter()))
        self.step = faults.wrap_answers(program.train_step(mcfg, t), fault)
        self.feed = Feed(cell.model["vocab_size"], t["rows"], t["seq"], seed,
                         "batches", device)
        losses, grads = [], None
        for i in range(t["check_steps"]):
            losses.append(self.item())
            if grads is None:
                grads = program.first_grad_norms(self.state,
                                                 t["optimizer"]["b1"])
            self.marks.append((f"step {i}", time.perf_counter()))
        start = initial()
        with torch.no_grad():
            change = {n: float(torch.linalg.vector_norm(
                p.float() - start[n].float()))
                for n, p in self.model.named_parameters()}
        del start
        self.marks.append(("change norms", time.perf_counter()))
        self.program_readings = {"losses": losses, "grad_norms": grads,
                                 "change_norms": change}
        self.tokens = t["rows"] * t["seq"]

    def item(self) -> float:
        _, _, metrics = self.step(self.model, self.state, self.feed.next())
        return float(metrics["loss"])

    def free(self) -> None:
        self.model = self.state = self.step = None

    def reference(self, ref, model: dict, initial, prec) -> dict:
        t = self.traffic
        return ref.train(initial, model, self.feed.fed[:t["check_steps"]],
                         t["microbatches"], t["optimizer"], t["z_loss_coef"],
                         prec)

    def readings(self, answers: list, ref, model: dict, initial, prec,
                 size: int = 0) -> dict:
        return compare_training(self.program_readings,
                                self.reference(ref, model, initial, prec))


def end_to_end(items: list[dict], traffic: dict) -> dict:
    return {traffic["metric"]: drive.throughput(items)}


def item_flops(flops, model: dict, traffic: dict) -> float:
    """Model FLOPs of one step: the forward and a backward of twice its
    work; recompute is not counted."""
    return 3.0 * flops.forward(model, traffic["rows"], traffic["seq"])


def compare_training(got: dict, want: dict, floor: float = 1e-3) -> dict:
    """The widest gap between the program's and the reference's step
    losses; by the worst leaf, the gap between their first-gradient norms
    and between their change norms, each over the reference's norm of that
    leaf or of the median leaf, whichever is larger.  Leaves whose
    reference gradient is under ``floor`` times the median leaf's are left
    out of both."""
    loss_gap = max(abs(a - b) if math.isfinite(a) else math.inf
                   for a, b in zip(got["losses"], want["losses"]))
    ref_g = want["grad_norms"]
    med_g = float(np.median(list(ref_g.values())))
    kept = [n for n in ref_g if ref_g[n] >= floor * med_g]
    med_c = float(np.median([want["change_norms"][n] for n in kept]))

    def worst(mine: dict, ref: dict, med: float) -> float:
        return max(abs(mine[n] - ref[n]) / max(ref[n], med, 1e-30)
                   if math.isfinite(mine[n]) else math.inf for n in kept)

    return {"loss_gap": loss_gap,
            "grad_gap": worst(got["grad_norms"], ref_g, med_g),
            "change_gap": worst(got["change_norms"], want["change_norms"],
                                med_c)}


def calibrate(cell, ref, initial, mcfg, seed: int, device, items: int,
              fault_names: list, control, fp32, fp8) -> dict:
    """One seed's readings: the program's first ``check_steps`` steps
    against the fp32 reference, the same with each planted fault, and with
    ``control`` the reference computed in fp8 in the program's place."""
    runs = {}
    for fault in [None] + fault_names:
        with faults.planted(fault):
            runs[fault or "program"] = Driver(cell, mcfg, initial, seed,
                                              device, fault)
        runs[fault or "program"].free()
        drive.free_memory(device)
    first = runs["program"]
    want = first.reference(ref, cell.model, initial, fp32)
    out = {who: compare_training(d.program_readings, want)
           for who, d in runs.items()}
    if control:
        drive.free_memory(device)
        out["control"] = compare_training(
            first.reference(ref, cell.model, initial, fp8), want)
    return out
