"""Per-iteration rigid-transform estimators (C12/C13).

Masked/weighted re-designs of the Open3D estimators the reference
delegates to (ref:hpp:76-78, invoked at ref:cpp:524-532, 691-699,
1091-1099) plus the reference's own weighted GICP Gauss-Newton solve
(``optimize_generalizedICP_manual``, ref:cpp:57-110):

  * pt2pt: Umeyama/Kabsch without scale (Open3D
    ``TransformationEstimationPointToPoint::ComputeTransformation``).
  * pt2pl: linearized 6-DoF Gauss-Newton with J = [p x n ; n],
    r = (p - q) . n, solved via 6x6 normal equations and retracted with
    Open3D's Euler-ZYX ``TransformVector6dToMatrix4d`` convention.
  * gicp: per-correspondence whitening W = w * (Cs + Ct)^(-1/2)
    (3x3 inverse sqrt via the closed-form eigh), J = W [-skew(p) | I],
    r = W (p - q).  ``w`` is the confidence weight of the with_cf
    variant (ref:cpp:78 applies it INSIDE W, so it enters the normal
    equations quadratically -- reproduced).

Instead of selecting a compacted subset of correspondences, every
estimator takes a full-length 0/1 (or confidence) mask so shapes stay
static; the JtJ/Jtr reductions are single [6,3N]x[3N,6]-shaped
matmuls.  Failure of the 6x6 solve (singular /
non-finite) degrades to identity like Open3D's
``SolveJacobianSystemAndObtainExtrinsicMatrix``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from se3_icp.ops import eigh3
from se3_icp.utils import se3


def _identity_like(dtype):
    return jnp.eye(4, dtype=dtype)


def _safe_transform(T, ok):
    eye = jnp.eye(4, dtype=T.dtype)
    ok = ok & jnp.isfinite(T).all()
    return jnp.where(ok, T, eye)


def solve_normal_equations(JTJ, JTr):
    """Solve JTJ xi = -JTr, retract via Euler-ZYX; identity on failure.

    Mirrors Open3D ``SolveJacobianSystemAndObtainExtrinsicMatrix``.
    """
    xi = jnp.linalg.solve(JTJ, -JTr)
    ok = jnp.isfinite(xi).all()
    xi = jnp.where(jnp.isfinite(xi), xi, 0.0)
    T = se3.euler_zyx_retract(xi)
    return _safe_transform(T, ok)


def solve_pt2pt(src, tgt, weights):
    """Weighted Umeyama (no scale): argmin_R,t sum w ||R s + t - q||^2.

    With 0/1 trim weights this equals Open3D's unweighted Umeyama over
    the selected correspondence subset.
    """
    dtype = src.dtype
    w = weights.astype(dtype)[:, None]
    wsum = jnp.sum(w)
    ok = wsum > 2.5  # need >= 3 points for a rigid fit
    wsafe = jnp.maximum(wsum, jnp.asarray(1e-30, dtype))
    mu_s = jnp.sum(src * w, axis=0) / wsafe
    mu_t = jnp.sum(tgt * w, axis=0) / wsafe
    ds = (src - mu_s) * w
    dt = tgt - mu_t
    # Sigma_{ts} = sum w (t - mu_t)(s - mu_s)^T
    H = dt.T @ ds
    U, S, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(U) * jnp.linalg.det(Vt))
    D = jnp.diag(jnp.asarray([1.0, 1.0, 1.0], dtype)).at[2, 2].set(d)
    R = U @ D @ Vt
    t = mu_t - R @ mu_s
    return _safe_transform(se3.rt_to_T(R, t), ok)


def solve_pt2pl(src, tgt, tgt_normals, weights):
    """Point-to-plane GN step (Open3D TransformationEstimationPointToPlane).

    J_i = [s_i x n_i ; n_i],  r_i = (s_i - q_i) . n_i
    """
    dtype = src.dtype
    w = weights.astype(dtype)
    r = jnp.sum((src - tgt) * tgt_normals, axis=-1)          # [N]
    J = jnp.concatenate([jnp.cross(src, tgt_normals), tgt_normals],
                        axis=-1)                              # [N,6]
    Jw = J * w[:, None]
    JTJ = Jw.T @ J
    JTr = Jw.T @ r
    ok = jnp.sum(w) > 5.5  # 6 dof
    return _safe_transform(solve_normal_equations(JTJ, JTr), ok)


def solve_gicp(src, tgt, cov_src, cov_tgt, weights, conf=None):
    """(Weighted) generalized-ICP GN step.

    ``weights``: 0/1 trim mask.  ``conf``: optional per-correspondence
    confidence applied inside the whitening matrix exactly like the
    reference's ``optimize_generalizedICP_manual`` (ref:cpp:78).
    """
    dtype = src.dtype
    w = weights.astype(dtype)
    M = cov_src + cov_tgt
    W = eigh3.inv_sqrt_sym3(M)                               # [N,3,3]
    if conf is not None:
        W = W * conf.astype(dtype)[:, None, None]
    # J3 = W @ [-skew(s) | I]  -> [N,3,6]
    S = se3.skew(src)                                        # [N,3,3]
    J_rot = -(W @ S)                                         # W @ (-skew)
    J3 = jnp.concatenate([J_rot, W], axis=-1)                # [N,3,6]
    r3 = jnp.einsum("nij,nj->ni", W, src - tgt)              # [N,3]
    J3w = J3 * w[:, None, None]
    n = src.shape[0]
    JTJ = J3w.reshape(3 * n, 6).T @ J3.reshape(3 * n, 6)
    JTr = J3w.reshape(3 * n, 6).T @ r3.reshape(3 * n)
    ok = jnp.sum(w) > 5.5
    return _safe_transform(solve_normal_equations(JTJ, JTr), ok)


def estimate_transform(variant: str, src, tgt, weights, *,
                       tgt_normals=None, cov_src=None, cov_tgt=None,
                       conf=None):
    """Dispatch on the reference's variant-name surface
    ('pt2pt' | 'pt2pl' | 'gicp', ref:cpp:691-699)."""
    if variant == "pt2pt":
        return solve_pt2pt(src, tgt, weights)
    if variant == "pt2pl":
        return solve_pt2pl(src, tgt, tgt_normals, weights)
    if variant == "gicp":
        return solve_gicp(src, tgt, cov_src, cov_tgt, weights, conf)
    raise ValueError(f"Invalid ICP variant name: {variant!r}. "
                     "Valid names are pt2pt, pt2pl and gicp.")
