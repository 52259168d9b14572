"""Evaluation metrics: trajectory error, cluster agreement, flow error.

BASELINE.json's acceptance is "bit-matched clusters + tracker ATE within
bound". The reference ships no metric code (validation was OpenCV eyeball);
these are the executable definitions used by the test suite and benchmarks.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def ate(traj_a: Dict[int, List[Tuple[float, float]]],
        traj_b: Dict[int, List[Tuple[float, float]]]) -> float:
    """Absolute trajectory error between two label-keyed trajectory sets.

    For each label present in both, RMSE over the overlapping prefix of
    per-slice positions; returns the mean over labels (inf if no overlap).
    """
    errs = []
    for label, pa in traj_a.items():
        pb = traj_b.get(label)
        if not pb:
            continue
        n = min(len(pa), len(pb))
        if n == 0:
            continue
        a = np.asarray(pa[:n], float)
        b = np.asarray(pb[:n], float)
        errs.append(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))
    return float(np.mean(errs)) if errs else float("inf")


def trajectory_coverage(traj_a: Dict[int, list], traj_b: Dict[int, list]) -> float:
    """Fraction of labels of `traj_b` (the oracle) present in `traj_a`."""
    if not traj_b:
        return 1.0
    return len(set(traj_a) & set(traj_b)) / len(traj_b)


def cluster_set_agreement(labels_a: np.ndarray, labels_b: np.ndarray) -> float:
    """Pair-counting agreement (Rand index) between two clusterings with -1
    noise labels — "bit-matched clusters tolerating id permutation"
    (SURVEY §7 hard part 1)."""
    a = np.asarray(labels_a)
    b = np.asarray(labels_b)
    assert a.shape == b.shape
    n = len(a)
    if n < 2:
        return 1.0
    same_a = (a[:, None] == a[None, :]) & (a[:, None] >= 0)
    same_b = (b[:, None] == b[None, :]) & (b[:, None] >= 0)
    iu = np.triu_indices(n, 1)
    return float(np.mean(same_a[iu] == same_b[iu]))


def flow_endpoint_error(flow: np.ndarray, gt: np.ndarray) -> float:
    """Mean endpoint error between matched flow vectors (px/slice)."""
    flow = np.asarray(flow, float)
    gt = np.asarray(gt, float)
    if flow.size == 0:
        return float("inf")
    return float(np.mean(np.linalg.norm(flow - gt, axis=-1)))


def greedy_match_flow(flows: np.ndarray, centroids: np.ndarray,
                      gt_centers: np.ndarray, gt_vels: np.ndarray) -> float:
    """Match each reported cluster to its nearest ground-truth mover and
    return the mean flow endpoint error."""
    if len(flows) == 0:
        return float("inf")
    errs = []
    for f, c in zip(flows, centroids):
        k = int(np.argmin(np.linalg.norm(gt_centers - c, axis=1)))
        errs.append(np.linalg.norm(f - gt_vels[k]))
    return float(np.mean(errs))
