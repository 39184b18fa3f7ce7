"""Big-O efficiency analysis of synthesized maps (Sec. IV.3 metric 3).

Dynamic analysis: count executed python lines (sys.settrace) of the candidate
at geometrically spaced lambda and fit the growth against the candidate cost
classes the paper observed — O(1), O(log N), O(N^{1/3}), O(N^{1/2}), O(N).
"""
from __future__ import annotations

import sys
from typing import Callable

import numpy as np

PROBE_LAMBDAS = (10**2, 10**3, 10**4, 10**5, 10**6)

_CLASSES: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "O(1)": lambda lam: np.ones_like(lam, dtype=float),
    "O(log N)": lambda lam: np.log2(lam.astype(float)),
    "O(N^1/3)": lambda lam: lam.astype(float) ** (1.0 / 3.0),
    "O(N^1/2)": lambda lam: lam.astype(float) ** 0.5,
    "O(N)": lambda lam: lam.astype(float),
}


def count_steps(fn: Callable[[int], tuple], lam: int) -> int:
    """Number of line events executed by fn(lam)."""
    counter = 0

    def tracer(frame, event, arg):
        nonlocal counter
        if event == "line":
            counter += 1
        return tracer

    old = sys.gettrace()
    sys.settrace(tracer)
    try:
        fn(lam)
    finally:
        sys.settrace(old)
    return counter


def classify(fn: Callable[[int], tuple],
             probes: tuple[int, ...] = PROBE_LAMBDAS) -> dict:
    """Fit step counts to a cost class; returns class + fit diagnostics.

    A candidate of class f(N) has steps(lambda) ~ a*f(lambda), so the ratio
    steps/f(lambda) is near-constant exactly for the right class — we pick the
    class minimizing the coefficient of variation of that ratio.
    """
    lams = np.asarray(probes, dtype=np.int64)
    steps = np.asarray([count_steps(fn, int(l)) for l in lams], dtype=float)
    cvs: dict[str, float] = {}
    for name, shape in _CLASSES.items():
        ratio = steps / shape(lams)
        cvs[name] = float(ratio.std() / (ratio.mean() + 1e-12))
    best = min(cvs, key=cvs.get)  # type: ignore[arg-type]
    return {
        "class": best,
        "steps": dict(zip((int(l) for l in lams), (int(s) for s in steps))),
        "cvs": cvs,
    }
