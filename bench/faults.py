"""Faults planted under the timed path, for the tests that show the check
fails them and for the readings that set a training cell's limits.

    unchanged    the optimizer leaves the parameters and its state as
                 they were (a step that returns its state unchanged)
    half_batch   the loss takes the first half of each row's positions and
                 leaves the rest out (the mean taken over the rest)
    answer       each call reports the loss of the call before it (the
                 first call its own): an answer altered where it is made

``planted(name)`` patches the program's module attributes for the block;
``answer`` is applied by ``wrap_answers`` around the step the driver calls.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

FAULTS = ("unchanged", "half_batch", "answer")


def _unchanged(model, grads, state, cfg):
    zero = torch.zeros((), dtype=torch.float32,
                       device=next(iter(grads.values())).device)
    return {"grad_norm": zero, "lr": zero}


def _half_batch(real):
    def lm_loss(params, cfg, batch, *args, **kwargs):
        labels = batch["labels"]
        keep = torch.zeros(labels.shape, dtype=torch.float32,
                           device=labels.device)
        keep[:, :labels.shape[1] // 2] = 1.0
        return real(params, cfg, dict(batch, mask=keep), *args, **kwargs)
    return lm_loss


@contextlib.contextmanager
def planted(name: str | None):
    if name is not None and name not in FAULTS:
        raise ValueError(f"fault {name!r}; have {FAULTS}")
    saved = []
    if name == "unchanged":
        saved.append((opt, "apply_updates", opt.apply_updates))
        opt.apply_updates = _unchanged
    elif name == "half_batch":
        saved.append((ts, "lm_loss", ts.lm_loss))
        ts.lm_loss = _half_batch(ts.lm_loss)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def wrap_answers(step, name: str | None):
    """``step`` (returning a metrics dict with ``loss``), or, for the
    ``answer`` fault, ``step`` reporting each call the loss of the call
    before."""
    if name != "answer":
        return step
    prev = []

    def stale(*args):
        out = step(*args)
        metrics = out[-1] if isinstance(out, tuple) else out
        loss = metrics["loss"]
        metrics["loss"] = prev[-1] if prev else loss
        prev.append(loss)
        return out

    return stale
