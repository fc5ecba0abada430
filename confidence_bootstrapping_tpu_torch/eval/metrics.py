"""Benchmark metric aggregation.

Port of ``confidence_bootstrapping_tpu/eval/metrics.py`` (host numpy, the
same keys and rounding): ``performance_metrics`` builds the reference's
metric dictionary (``inference.py:593-884``) from per-complex arrays, RMSD
and centroid fractions and percentiles, the min/top-5/top-10 variants, the
confidence-filtered and reverse-filtered variants and the steric
self-intersection fractions; ``min_self_distance`` is a pose's least
non-bonded heavy-atom distance.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _frac(x, thresh):
    return float(100 * (x < thresh).sum() / max(len(x), 1))


def _block(metrics: Dict, prefix: str, rmsds_1d, centroids_1d, self_dist_1d=None):
    metrics[f"{prefix}rmsds_below_2"] = round(_frac(rmsds_1d, 2), 2)
    metrics[f"{prefix}rmsds_below_5"] = round(_frac(rmsds_1d, 5), 2)
    for p in (25, 50, 75):
        metrics[f"{prefix}rmsds_percentile_{p}"] = round(float(np.percentile(rmsds_1d, p)), 2)
    metrics[f"{prefix}centroid_below_2"] = round(_frac(centroids_1d, 2), 2)
    metrics[f"{prefix}centroid_below_5"] = round(_frac(centroids_1d, 5), 2)
    for p in (25, 50, 75):
        metrics[f"{prefix}centroid_percentile_{p}"] = round(float(np.percentile(centroids_1d, p)), 2)
    if self_dist_1d is not None:
        metrics[f"{prefix}self_intersect_fraction"] = round(_frac(self_dist_1d, 0.4), 2)


def performance_metrics(
    rmsds: np.ndarray,  # [C, N] per-complex per-pose
    centroid_distances: np.ndarray,  # [C, N]
    confidences: Optional[np.ndarray] = None,  # [C, N]
    min_self_distances: Optional[np.ndarray] = None,  # [C, N]
    run_times: Optional[np.ndarray] = None,  # [C]
    prefix: str = "",
) -> Dict:
    C, N = rmsds.shape
    m: Dict = {}
    if run_times is not None:
        m[f"{prefix}run_times_mean"] = round(float(np.mean(run_times)), 2)
        m[f"{prefix}run_times_std"] = round(float(np.std(run_times)), 2)
    m[f"{prefix}mean_rmsd"] = float(rmsds.mean())
    m[f"{prefix}rmsds_below_2"] = 100 * float((rmsds < 2).sum()) / (C * N)
    m[f"{prefix}rmsds_below_5"] = 100 * float((rmsds < 5).sum()) / (C * N)
    for p in (25, 50, 75):
        m[f"{prefix}rmsds_percentile_{p}"] = round(float(np.percentile(rmsds, p)), 2)
    m[f"{prefix}min_rmsds_below_2"] = _frac(np.min(rmsds, axis=1), 2)
    m[f"{prefix}min_rmsds_below_5"] = _frac(np.min(rmsds, axis=1), 5)
    m[f"{prefix}mean_centroid"] = round(float(centroid_distances.mean()), 2)
    m[f"{prefix}centroid_below_2"] = round(100 * float((centroid_distances < 2).sum()) / (C * N), 2)
    m[f"{prefix}centroid_below_5"] = round(100 * float((centroid_distances < 5).sum()) / (C * N), 2)
    for p in (25, 50, 75):
        m[f"{prefix}centroid_percentile_{p}"] = round(float(np.percentile(centroid_distances, p)), 2)
    if min_self_distances is not None:
        m[f"{prefix}self_intersect_fraction"] = round(_frac(min_self_distances.reshape(-1), 0.4), 2)

    rows = np.arange(C)[:, None]
    for k in (5, 10):
        if N >= k:
            order = np.argsort(rmsds[:, :k], axis=1)
            topk = np.min(rmsds[:, :k], axis=1)
            topk_cent = centroid_distances[rows, order][:, 0]
            topk_self = min_self_distances[rows, order][:, 0] if min_self_distances is not None else None
            _block(m, f"{prefix}top{k}_", topk, topk_cent, topk_self)

    if confidences is not None:
        conf_order = np.argsort(confidences, axis=1)[:, ::-1]
        r_sorted = rmsds[rows, conf_order]
        c_sorted = centroid_distances[rows, conf_order]
        s_sorted = min_self_distances[rows, conf_order] if min_self_distances is not None else None
        _block(m, f"{prefix}filtered_", r_sorted[:, 0], c_sorted[:, 0], s_sorted[:, 0] if s_sorted is not None else None)
        # reverse-filtered: the LOWEST-confidence pose (sanity diagnostic)
        _block(
            m, f"{prefix}reverse_filtered_", r_sorted[:, -1], c_sorted[:, -1],
            s_sorted[:, -1] if s_sorted is not None else None,
        )
        for k in (5, 10):
            if N >= k:
                topk_f = np.min(r_sorted[:, :k], axis=1)
                order_k = np.argsort(r_sorted[:, :k], axis=1)
                topk_f_cent = c_sorted[rows, order_k][:, 0]
                topk_f_self = s_sorted[rows, order_k][:, 0] if s_sorted is not None else None
                _block(m, f"{prefix}top{k}_filtered_", topk_f, topk_f_cent, topk_f_self)
    return m


def min_self_distance(pos: np.ndarray, bonds) -> float:
    """Minimum non-bonded heavy-atom distance within a pose (steric clash
    diagnostic; reference inference.py computes min_self_distances)."""
    n = len(pos)
    if n < 3:
        return float("inf")
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    mask = ~np.eye(n, dtype=bool)
    for i, j, _ in bonds:
        mask[i, j] = mask[j, i] = False
    return float(d[mask].min()) if mask.any() else float("inf")
