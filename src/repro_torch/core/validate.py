"""Validation against ground truth (Sec. IV.2/IV.3 of the paper).

Given a candidate `map_to_coordinates(n)` we verify over N points (default
10^6) that the induced mapping is bijective onto the domain, and score it with
the paper's two accuracy criteria:

  * Ordered   — % of indices where candidate(lambda) == ground_truth(lambda),
  * Any-order — % of unique ground-truth coordinates covered by the candidate
                regardless of traversal order ("silver standard").
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.domains import Domain

_ENC_SHIFT = 21  # coords < 2^21 per axis at N <= 1e6 for every dim<=3 domain


def encode_coords(coords: np.ndarray) -> np.ndarray:
    """Pack (N, dim) non-negative int coords into unique int64 keys.

    dim <= 3 uses 21 bits per axis; higher-dimensional domains (the
    m-simplex family) split the 63 bits evenly — their coordinates shrink
    as ~N^(1/m), so 15 (m=4) / 12 (m=5) bits per axis stay exact far past
    the 10^6-point validation scale."""
    c = np.asarray(coords, dtype=np.int64)
    shift = min(_ENC_SHIFT, 63 // c.shape[1])
    key = np.zeros(len(c), dtype=np.int64)
    for k in range(c.shape[1]):
        key = (key << shift) | (c[:, k] & ((1 << shift) - 1))
    return key


@dataclasses.dataclass(frozen=True)
class ValidationReport:
    n_points: int
    ordered: float          # fraction in [0, 1]
    any_order: float        # fraction in [0, 1]
    bijective: bool         # candidate visits every GT coord exactly once
    duplicates: int         # candidate outputs repeated coords
    out_of_domain: int      # candidate outputs not in GT set
    compiled: bool = True   # False => (NC) in the paper's tables
    error: str | None = None

    @property
    def ordered_pct(self) -> float:
        return 100.0 * self.ordered

    @property
    def any_order_pct(self) -> float:
        return 100.0 * self.any_order


FAILED = lambda n, err: ValidationReport(  # noqa: E731
    n_points=n, ordered=0.0, any_order=0.0, bijective=False,
    duplicates=0, out_of_domain=0, compiled=False, error=err,
)


def evaluate_candidate_array(
    pred: np.ndarray, gt: np.ndarray, n_points: int
) -> ValidationReport:
    """Score a candidate's coordinate array against ground truth."""
    if pred.shape != gt.shape:
        return FAILED(n_points, f"shape mismatch {pred.shape} vs {gt.shape}")
    if (pred < 0).any():
        return FAILED(n_points, "negative coordinates")
    ordered = float(np.mean(np.all(pred == gt, axis=1)))
    pk, gk = encode_coords(pred), encode_coords(gt)
    uniq_pred = np.unique(pk)
    uniq_gt = np.unique(gk)  # == n_points (GT enumeration never repeats)
    covered = np.intersect1d(uniq_pred, uniq_gt, assume_unique=True)
    any_order = float(len(covered)) / float(len(uniq_gt))
    duplicates = int(len(pk) - len(uniq_pred))
    out_of_domain = int(len(uniq_pred) - len(covered))
    bijective = duplicates == 0 and out_of_domain == 0 and len(covered) == len(uniq_gt)
    return ValidationReport(
        n_points=n_points, ordered=ordered, any_order=any_order,
        bijective=bijective, duplicates=duplicates, out_of_domain=out_of_domain,
    )


def validate_scalar_fn(
    fn: Callable[[int], Sequence[int]],
    domain: Domain,
    n_points: int = 1_000_000,
    gt: np.ndarray | None = None,
    sample_every: int = 1,
) -> ValidationReport:
    """Validate a scalar candidate `map_to_coordinates(n)` over [0, n_points).

    sample_every > 1 subsamples indices for expensive pure-python candidates;
    ordered/any-order are then estimates over the sampled set.
    """
    if gt is None:
        gt = domain.enumerate_points(n_points)
    idx = np.arange(0, n_points, sample_every, dtype=np.int64)
    try:
        rows = [fn(int(i)) for i in idx]
    except Exception as e:  # candidate raised at runtime
        return FAILED(n_points, f"runtime error: {e!r}")
    try:
        pred = np.asarray(rows, dtype=np.int64)
    except (ValueError, TypeError) as e:
        return FAILED(n_points, f"non-integer output: {e!r}")
    if pred.ndim != 2 or pred.shape[1] != domain.dim:
        return FAILED(n_points, f"wrong output arity {pred.shape}")
    return evaluate_candidate_array(pred, gt[idx], len(idx))


def validate_vectorized(
    np_fn: Callable[[np.ndarray], np.ndarray],
    domain: Domain,
    n_points: int = 1_000_000,
    gt: np.ndarray | None = None,
) -> ValidationReport:
    """Validate a numpy-vectorized candidate over the full [0, n_points)."""
    if gt is None:
        gt = domain.enumerate_points(n_points)
    lams = np.arange(n_points, dtype=np.int64)
    try:
        pred = np.asarray(np_fn(lams), dtype=np.int64)
    except Exception as e:
        return FAILED(n_points, f"runtime error: {e!r}")
    if pred.shape != (n_points, domain.dim):
        return FAILED(n_points, f"wrong output shape {pred.shape}")
    return evaluate_candidate_array(pred, gt, n_points)
