"""Evaluation metrics (isdf_tpu/eval/metrics.py; reference
isdf/eval/metrics.py): numpy and scipy on the host, over modest point
counts, off the training path."""

from __future__ import annotations

import time

import numpy as np
from scipy.spatial import cKDTree as KDTree


def chomp_cost(sdf, epsilon: float = 2.0):
    """CHOMP collision cost (reference metrics.py:95-104; CHOMP eq. 21)."""
    sdf = np.asarray(sdf)
    cost = -sdf + epsilon / 2.0
    cost = np.where(sdf > 0, 1.0 / (2 * epsilon) * (sdf - epsilon) ** 2,
                    cost)
    return np.where(sdf > epsilon, 0.0, cost)


def linear_cost(sdf, epsilon: float = 1.5):
    """Linear collision cost (reference metrics.py:107-113)."""
    sdf = np.asarray(sdf)
    return np.where(sdf > epsilon, 0.0, -sdf + epsilon)


def binned_losses(sdf_diff, gt_sdf,
                  bin_limits=np.array([-1e99, 0.0, 0.1, 0.2, 0.5, 1.0,
                                       1e99])):
    """Mean |error| binned by GT distance to the surface (reference
    metrics.py:133-158). An empty bin gives NaN."""
    sdf_diff = np.asarray(sdf_diff)
    gt_sdf = np.asarray(gt_sdf)
    lb, ub = bin_limits[:-1], bin_limits[1:]
    masks = (gt_sdf > lb[:, None]) & (gt_sdf < ub[:, None])
    with np.errstate(invalid="ignore", divide="ignore"):
        out = (sdf_diff * masks).sum(1) / masks.sum(1)
    return out.tolist()


def accuracy(gt_points, rec_points):
    """Mean distance from reconstructed points to the GT surface
    (reference metrics.py:48-52)."""
    d, _ = KDTree(gt_points).query(rec_points)
    return float(np.mean(d))


def completion(gt_points, rec_points):
    """Mean distance from the GT surface to the reconstruction
    (reference metrics.py:55-59)."""
    d, _ = KDTree(rec_points).query(gt_points)
    return float(np.mean(d))


def completion_ratio(gt_points, rec_points, dist_th: float = 0.05):
    """Share of GT points within dist_th of the reconstruction."""
    d, _ = KDTree(rec_points).query(gt_points)
    return float(np.mean(d < dist_th))


def aligned_ate(t1, t2):
    """RMS of the distances between two aligned trajectories' positions."""
    ate = np.linalg.norm(np.asarray(t1) - np.asarray(t2), axis=1)
    return float(np.sqrt((ate * ate).sum() / len(ate)))


def start_timing():
    """A host wall-clock mark (reference metrics.py:13-38 times with CUDA
    events; the trainer's bundles are timed so, by utils/profiling.py::
    BundleClock)."""
    return time.perf_counter()


def end_timing(start) -> float:
    """Milliseconds since ``start``."""
    return (time.perf_counter() - start) * 1000.0
