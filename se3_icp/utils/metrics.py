"""Evaluation metrics mirroring the reference's ``cc`` library and the
benchmark binaries.

Definitions preserved exactly (BASELINE.md):
  * SO(3) geodesic error in degrees: ``cc::angularErrorSO3`` (ref:cc:32-37)
    and the trace-acos variant ``angularErrorSO3_alt`` (ref:cc:39-61).
  * FilterReg point error (ref:cc:4-19).
  * Rotation Frobenius / translation L2 errors
    (examples/benchmark_synthetic.cpp:406-407).
  * Y-Z-X Tait-Bryan average euler-angle error
    (examples/benchmark_lounge.cpp:14-81).
  * Chamfer distance, Fan et al. squared form
    (examples/benchmark_lounge.cpp:490-503).
  * Success threshold: fail iff SO3 > 2 deg or trans > 0.25
    (examples/benchmark_synthetic.cpp:410-413, ref:cc:204-206).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import jax.numpy as jnp

from se3_icp.utils import se3


@jax.jit
def angular_error_so3(R1, R2):
    """deg geodesic error ||vee(log(R1^T R2))|| * 180/pi (ref:cc:32-37)."""
    R1, R2 = jnp.asarray(R1), jnp.asarray(R2)
    w = se3.so3_log_vee(R1.mT @ R2)
    return jnp.linalg.norm(w, axis=-1) * (180.0 / jnp.pi)


@jax.jit
def angular_error_so3_alt(R1, R2):
    """deg trace-acos error with clamped acos (ref:cc:39-61)."""
    R1, R2 = jnp.asarray(R1), jnp.asarray(R2)
    M = R1.mT @ R2
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    arg = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    return jnp.abs(jnp.arccos(arg)) * (180.0 / jnp.pi)


@jax.jit
def translation_error(t1, t2):
    return jnp.linalg.norm(jnp.asarray(t1) - jnp.asarray(t2), axis=-1)


@jax.jit
def rotation_frobenius_error(R1, R2):
    return jnp.linalg.norm((jnp.asarray(R1) - jnp.asarray(R2)),
                           axis=(-2, -1))


@jax.jit
def error_filterreg(points, T_gt, T_est):
    """mean ||T_gt p - T_est p|| over the cloud (ref:cc:4-19)."""
    p_gt = se3.transform_points(jnp.asarray(T_gt), jnp.asarray(points))
    p_est = se3.transform_points(jnp.asarray(T_est), jnp.asarray(points))
    return jnp.mean(jnp.linalg.norm(p_gt - p_est, axis=-1), axis=-1)


@functools.partial(jax.jit, static_argnames=("rot_thresh_deg", "trans_thresh"))
def success(T_gt, T_est, rot_thresh_deg: float = 2.0,
            trans_thresh: float = 0.25):
    """Reference convergence criterion (benchmark_synthetic.cpp:410-413)."""
    T_gt, T_est = jnp.asarray(T_gt), jnp.asarray(T_est)
    so3 = angular_error_so3(T_est[..., :3, :3], T_gt[..., :3, :3])
    tra = translation_error(T_gt[..., :3, 3], T_est[..., :3, 3])
    return (so3 <= rot_thresh_deg) & (tra <= trans_thresh)


@jax.jit
def rot2euler_yzx(R):
    """Rotation -> Y-Z-X Tait-Bryan (bank, attitude, heading) in radians.

    Matches ``rot2euler`` (examples/benchmark_lounge.cpp:14-52) including
    the +-0.998 gimbal-singularity branches.
    """
    R = jnp.asarray(R)
    m00, m02 = R[..., 0, 0], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m22 = R[..., 2, 0], R[..., 2, 2]
    north = m10 > 0.998
    south = m10 < -0.998
    sing = north | south
    bank = jnp.where(sing, 0.0, jnp.arctan2(-m12, m11))
    attitude = jnp.where(north, jnp.pi / 2,
                         jnp.where(south, -jnp.pi / 2,
                                   jnp.arcsin(jnp.clip(m10, -1.0, 1.0))))
    heading = jnp.where(sing, jnp.arctan2(m02, m22), jnp.arctan2(-m20, m00))
    return jnp.stack([bank, attitude, heading], -1)


@jax.jit
def avg_euler_error(R1, R2):
    """Mean absolute YZX euler-angle difference in degrees
    (examples/benchmark_lounge.cpp:55-81)."""
    e1 = _c_fmod(rot2euler_yzx(R1) * (180.0 / jnp.pi), 360.0)
    e2 = _c_fmod(rot2euler_yzx(R2) * (180.0 / jnp.pi), 360.0)
    diff = _c_fmod(e1 - e2, 360.0)
    diff = jnp.where(diff > 180.0, 360.0 - diff, diff)
    return jnp.mean(jnp.abs(diff), axis=-1)


def _c_fmod(x, m):
    """C-style fmod (result has the sign of x), unlike jnp.remainder."""
    x = jnp.asarray(x)
    return x - jnp.trunc(x / m) * m


def chamfer_distance_sq(src, tgt, src_valid=None, tgt_valid=None):
    """Fan et al. squared chamfer (benchmark_lounge.cpp:490-503).

    mean_i min_j ||s_i - t_j||^2 + mean_j min_i ||t_j - s_i||^2
    """
    from se3_icp.ops import knn
    d_st = knn.nn_distances(jnp.asarray(src), jnp.asarray(tgt), tgt_valid)
    d_ts = knn.nn_distances(jnp.asarray(tgt), jnp.asarray(src), src_valid)

    def _mean(d2, valid):
        if valid is None:
            return jnp.mean(d2)
        valid = jnp.asarray(valid)
        return jnp.sum(jnp.where(valid, d2, 0.0)) / jnp.sum(valid)

    return _mean(d_st, src_valid) + _mean(d_ts, tgt_valid)


def evaluate_lrf_quality(source_frames, target_frames, T_gt, corr_pairs):
    """Mean SO(3) trace-acos error between GT-transformed source LRFs and
    matched target LRFs (ref:cc:63-114).  ``corr_pairs``: [M,2] int."""
    source_frames = jnp.asarray(source_frames)
    target_frames = jnp.asarray(target_frames)
    T_gt = jnp.asarray(T_gt)
    corr = jnp.asarray(corr_pairs)
    src_R = (T_gt[:3, :3] @ source_frames[corr[:, 0], :3, :3])
    tgt_R = target_frames[corr[:, 1], :3, :3]
    return jnp.mean(angular_error_so3_alt(src_R, tgt_R))


def compute_corrs_with_gt(src, tgt, T_gt, tgt_valid=None):
    """GT-transform the source, 1-NN into the target -> "true"
    correspondence pairs [N,2] (cc::compute_corrs_with_gt,
    ref:cc:116-143)."""
    from se3_icp.ops import knn
    src_t = se3.transform_points(jnp.asarray(T_gt), jnp.asarray(src))
    n_tgt = None
    if tgt_valid is not None:
        n_tgt = jnp.sum(jnp.asarray(tgt_valid).astype(jnp.int32))
    idx, _ = knn.nn_argmin_xla(src_t, jnp.asarray(tgt), n_tgt)
    return jnp.stack([jnp.arange(src_t.shape[0], dtype=jnp.int32), idx], 1)


def compute_nearest_neighbor_correspondences(src, tgt, tgt_valid=None):
    """Plain 1-NN correspondence pairs (cc::
    compute_nearest_neighbor_correspondences, ref:cc:220-237)."""
    from se3_icp.ops import knn
    n_tgt = None
    if tgt_valid is not None:
        n_tgt = jnp.sum(jnp.asarray(tgt_valid).astype(jnp.int32))
    idx, _ = knn.nn_argmin_xla(jnp.asarray(src), jnp.asarray(tgt), n_tgt)
    return jnp.stack([jnp.arange(len(src), dtype=jnp.int32), idx], 1)


def evaluate_trajectory_quality(gt_traj, est_traj):
    """Avg rot/trans error + success rate over paired 4x4s (ref:cc:178-217)."""
    gt = np.asarray(gt_traj)
    est = np.asarray(est_traj)
    rot = np.asarray(angular_error_so3(gt[:, :3, :3], est[:, :3, :3]))
    tra = np.asarray(translation_error(gt[:, :3, 3], est[:, :3, 3]))
    fails = (rot > 2.0) | (tra > 0.25)
    return {
        "avg_translation_error": float(tra.mean()),
        "avg_rotation_error": float(rot.mean()),
        "success_rate": float(1.0 - fails.mean()),
    }
