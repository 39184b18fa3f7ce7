"""What every traffic kind shares: the measured window and its throughput.

A traffic file's ``kind`` names the module that drives it,
``bench/traffic/<kind>.py``, which ``spec.kind_module`` finds by that name.
Such a module has

    Driver(cell, mcfg, initial, seed, device, fault)
                      set-up: the program built from the seed's weights,
                      the cell's shapes warmed up; ``marks`` times the
                      set-up, ``item()`` runs one item of the window and
                      returns its answer, ``tokens`` counts an item's
                      tokens, ``free()`` drops the program's state and
                      ``readings(answers, ref, model, initial, prec, size)``
                      gives the numbers the check compares
    end_to_end(items, traffic)        {metric: value} of the window
    item_flops(flops, model, traffic) model FLOPs of one item, from the
                      configuration's ``bench/flops/<family>.py``
    calibrate(...)    one seed's readings for ``bench/calibrate.py``

The window runs whole items until ``--seconds`` have passed since the first
one started; its throughput is every item's tokens over the time from the
first item's start to the last one's end.
"""
from __future__ import annotations

import contextlib
import gc
import time

import torch


def window(item, seconds: float, tokens: int, tracer=None) -> list[dict]:
    """Whole items until ``seconds`` have passed since the first began (and,
    with a tracer, until its last traced item is done)."""
    items = []
    while True:
        i = len(items)
        ctx = tracer.item(i) if tracer is not None \
            else contextlib.nullcontext(False)
        with ctx as traced:
            t0 = time.perf_counter()
            answer = item()
            t1 = time.perf_counter()
        items.append({"t0": t0, "t1": t1, "answer": answer,
                      "tokens": tokens, "traced": traced})
        if t1 - items[0]["t0"] >= seconds and (tracer is None
                                               or tracer.done(i)):
            return items


def throughput(items: list[dict]) -> float:
    """Tokens per second over the whole window."""
    return sum(i["tokens"] for i in items) / (items[-1]["t1"]
                                              - items[0]["t0"])


def free_memory(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
