"""Batched closed-form 3x3 symmetric eigendecomposition.

Replaces Eigen's ``SelfAdjointEigenSolver<Matrix3d>`` used per point by the
reference's LRF estimation (ref:cpp:275-281, 158-167) and the matrix
inverse-sqrt in the weighted GICP solve (ref:cpp:78).

No LAPACK-style iteration per matrix: a branch-free Cardano +
cross-product/2x2-reduction scheme (Eberly's robust 3x3 eigensolver
shape) that vmaps and fuses elementwise across millions of matrices.  Eigenvalues are returned ascending, like Eigen; eigenvector signs
are arbitrary (as with Eigen), which every consumer here tolerates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


@jax.jit
def eigvalsh3(A):
    """Eigenvalues of symmetric [...,3,3], ascending (Cardano)."""
    dtype = A.dtype
    scale = jnp.maximum(jnp.max(jnp.abs(A), axis=(-2, -1)),
                        jnp.asarray(1e-30, dtype))
    As = A / scale[..., None, None]
    q = (As[..., 0, 0] + As[..., 1, 1] + As[..., 2, 2]) / 3.0
    B = As - q[..., None, None] * jnp.eye(3, dtype=dtype)
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 0.0))
    eps = jnp.asarray(1e-12 if dtype != jnp.float32 else 1e-7, dtype)
    p_safe = jnp.where(p < eps, jnp.ones_like(p), p)
    r = jnp.clip(_det3(B / p_safe[..., None, None]) * 0.5, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    two_p = jnp.where(p < eps, jnp.zeros_like(p), 2.0 * p)
    e2 = q + two_p * jnp.cos(phi)
    e0 = q + two_p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e1 = 3.0 * q - e0 - e2
    vals = jnp.stack([e0, e1, e2], -1) * scale[..., None]
    return vals


def _null_vec(M, eps):
    """Unit vector in the (approx) null space of symmetric M: max-norm
    cross product of row pairs, with a basis fallback when M ~ 0."""
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, -1)
    n02 = jnp.sum(c02 * c02, -1)
    n12 = jnp.sum(c12 * c12, -1)
    # pick the largest-norm candidate with pure selects (no argmax +
    # gather in the GICP per-iteration path)
    v12 = jnp.where((n02 >= n12)[..., None], c02, c12)  # ties: lower pair
    nb12 = jnp.maximum(n02, n12)
    v = jnp.where((n01 >= nb12)[..., None], c01, v12)
    nbest = jnp.maximum(n01, nb12)
    ok = nbest > eps * eps
    v = jnp.where(ok[..., None], v, jnp.zeros_like(v).at[..., 0].set(1.0))
    nrm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(nrm, eps)


def _complement(w, eps):
    """Orthonormal (U, V) spanning the plane perpendicular to unit w."""
    abs_w = jnp.abs(w)
    use_x = abs_w[..., 0] > abs_w[..., 2]
    inv1 = 1.0 / jnp.maximum(
        jnp.sqrt(w[..., 0] ** 2 + w[..., 1] ** 2), eps)
    inv2 = 1.0 / jnp.maximum(
        jnp.sqrt(w[..., 1] ** 2 + w[..., 2] ** 2), eps)
    u_a = jnp.stack([-w[..., 1] * inv1, w[..., 0] * inv1,
                     jnp.zeros_like(w[..., 0])], -1)
    u_b = jnp.stack([jnp.zeros_like(w[..., 0]), -w[..., 2] * inv2,
                     w[..., 1] * inv2], -1)
    U = jnp.where(use_x[..., None], u_a, u_b)
    V = jnp.cross(w, U)
    return U, V


@jax.jit
def eigh3(A):
    """Symmetric [...,3,3] -> (eigvals [...,3] ascending,
    eigvecs [...,3,3] with the k-th COLUMN the k-th eigenvector),
    mirroring Eigen's ``SelfAdjointEigenSolver`` layout."""
    dtype = A.dtype
    eps = jnp.asarray(1e-7 if dtype == jnp.float32 else 1e-14, dtype)
    scale = jnp.maximum(jnp.max(jnp.abs(A), axis=(-2, -1)),
                        jnp.asarray(1e-30, dtype))
    As = A / scale[..., None, None]
    vals_s = eigvalsh3(As)                       # unscaled eigenvalues
    e0, e1, e2 = vals_s[..., 0], vals_s[..., 1], vals_s[..., 2]
    eye = jnp.eye(3, dtype=dtype)

    # Choose the better-isolated extreme eigenvalue first.
    first_is_low = (e1 - e0) >= (e2 - e1)
    lam_first = jnp.where(first_is_low, e0, e2)
    w = _null_vec(As - lam_first[..., None, None] * eye, eps)

    # Reduce the complement to a 2x2 symmetric problem.
    U, V = _complement(w, eps)
    AU = jnp.einsum("...ij,...j->...i", As, U)
    AV = jnp.einsum("...ij,...j->...i", As, V)
    a = jnp.sum(U * AU, -1)
    b = jnp.sum(U * AV, -1)
    c = jnp.sum(V * AV, -1)
    # 2x2 eigvec for the *other* extreme eigenvalue.
    lam_other = jnp.where(first_is_low, e2, e0)
    # (a - lam) x + b y = 0  -> direction (b, lam - a) or (lam - c, b)
    d1 = jnp.stack([b, lam_other - a], -1)
    d2 = jnp.stack([lam_other - c, b], -1)
    n1 = jnp.sum(d1 * d1, -1)
    n2 = jnp.sum(d2 * d2, -1)
    d = jnp.where((n1 >= n2)[..., None], d1, d2)
    nd = jnp.linalg.norm(d, axis=-1, keepdims=True)
    # Degenerate 2x2 (equal remaining eigvals): any direction works.
    d = jnp.where(nd > eps, d / jnp.maximum(nd, eps),
                  jnp.zeros_like(d).at[..., 0].set(1.0))
    v_other = d[..., 0:1] * U + d[..., 1:2] * V
    v_mid = jnp.cross(w, v_other)

    v0 = jnp.where(first_is_low[..., None], w, v_other)
    v2 = jnp.where(first_is_low[..., None], v_other, w)
    vecs = jnp.stack([v0, v_mid, v2], -1)        # columns
    return vals_s * scale[..., None], vecs


@jax.jit
def smallest_eigvec3(A):
    """Unit eigenvector of the smallest eigenvalue (normal direction)."""
    _, vecs = eigh3(A)
    return vecs[..., 0]


@functools.partial(jax.jit, static_argnames=("eps_clamp",))
def inv_sqrt_sym3(A, eps_clamp=1e-12):
    """M^(-1/2) for symmetric PSD [...,3,3] via eigh (ref:cpp:78 uses
    Eigen ``M.inverse().sqrt()``)."""
    vals, vecs = eigh3(A)
    inv_sqrt = 1.0 / jnp.sqrt(jnp.maximum(vals, eps_clamp))
    return jnp.einsum("...ik,...k,...jk->...ij", vecs, inv_sqrt, vecs)
