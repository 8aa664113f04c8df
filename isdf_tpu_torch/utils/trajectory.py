"""Trajectory export in replica / franka / TUM formats
(isdf_tpu/utils/trajectory.py; reference isdf/datasets/data_util.py:117-141)."""

from __future__ import annotations

import numpy as np


def _quat_from_R(R):
    """Unit quaternion [w, x, y, z] from a rotation matrix."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([s / 4, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = s / 4
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def save_trajectory(traj, file_name, format="replica", timestamps=None):
    traj = np.asarray(traj)
    if timestamps is None:
        timestamps = np.arange(len(traj), dtype=float)
    with open(file_name, "w") as f:
        for idx, T_WC in enumerate(traj):
            t = timestamps[idx]
            if format == "replica":
                row = " ".join(f"{v:f}" for v in T_WC[:3, :].reshape(12))
                f.write(f"{t} {row}\n")
            elif format == "realsense_franka":
                row = " ".join(f"{v:f}" for v in T_WC.reshape(16))
                f.write(f"{t} {row}\n")
            elif format == "TUM":
                q = _quat_from_R(T_WC[:3, :3])
                q = np.roll(q, -1)  # -> [x, y, z, w]
                tr = T_WC[:3, 3]
                row = " ".join(f"{v:f}" for v in (*tr, *q))
                f.write(f"{t} {row}\n")
            else:
                raise ValueError(format)
