"""Local-reference-frame estimation + normals + GICP covariances.

Batched re-design of the reference's per-point OpenMP loops:

  * TOLDI SE(3) frames (C3, ref:cpp:241-331) -- the core geometric
    novelty.  One gather of [N,k,3] neighborhoods, then fully vectorized
    centroid/covariance/eigh/arrow-weighting math on the VPU; the kNN
    itself is the brute-force search in ``ops.knn``.
  * SHOT SE(3) frames (C4, ref:cpp:121-239) -- the dormant alternate LRF,
    radius-based; implemented with a masked fixed-k neighborhood.
  * PCA normal estimation (Open3D ``EstimateNormals`` analog; kNN-30 for
    pt2pl at ref:cpp:643, kNN-20 inside GICP init at ref:cpp:43).
  * GICP covariance initialization (C14, ref:cpp:4-52), including the
    reference's ``c < -0.99 -> identity`` quirk in GetRotationFromE1ToX.

Intentional parity quirks (SURVEY.md §5):
  * TOLDI centroid off-by-one: neighbors ranked 1..k//3-1 are summed but
    the sum is divided by k//3 (ref:cpp:259-265), while the covariance
    uses ranks 1..k//3 (ref:cpp:268-272).  Reproduced exactly by default.
    NOTE (discovered by the equivariance test): because the divisor makes
    the centroid a non-affine combination (coefficients sum to
    (rz-1)/rz != 1), the reference's TOLDI covariance is NOT
    translation-invariant -- frames depend on the cloud's absolute
    position.  The reference gets away with it by centering clouds before
    frame estimation (ref:cpp:576-582).  ``exact_centroid=True`` divides
    by rz-1 instead, restoring full rigid equivariance; default stays
    reference-faithful.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from se3_icp.ops import eigh3, knn


def _gather_neighbors(points, idx):
    """points [N,3], idx [N,k] -> [N,k,3]."""
    return points[idx]


@functools.partial(jax.jit, static_argnames=("k", "exact_centroid"))
def toldi_frames(points, k: int, n_valid=None, exact_centroid: bool = False):
    """TOLDI SE(3) frames for every point of a cloud.

    Returns (rot [N,3,3] with columns x,y,z, origin [N,3]).
    Mirrors ``computeSingleTOLDISE3Frame`` (ref:cpp:241-316) with kNN
    search (k = ``number_of_nn_for_LRF_``, benchmarks use 90).
    """
    idx, d2 = knn.knn_self(points, k, n_valid)
    return toldi_frames_from_neighbors(points, idx,
                                       exact_centroid=exact_centroid)


@functools.partial(jax.jit, static_argnames=("exact_centroid",))
def toldi_frames_from_neighbors(points, idx, exact_centroid: bool = False):
    """TOLDI given precomputed ascending-by-distance neighbor indices.

    ``idx[:, 0]`` is the query point itself (FLANN convention,
    ref:cpp:253-256).  ``idx`` may cover a row SLICE of ``points``
    (model-parallel setup): the query is recovered from rank 0.
    """
    dtype = points.dtype
    n, k = idx.shape
    nb = _gather_neighbors(points, idx)                  # [N,k,3]
    p = nb[:, 0:1, :]                                    # query = rank-0 self

    # radius = distance to the farthest of the k neighbors (ref:cpp:256)
    radius = jnp.linalg.norm(nb[:, -1, :] - p[:, 0, :], axis=-1)

    rz = k // 3
    rank = jnp.arange(k)
    # centroid: ranks 1..rz-1 summed, divided by rz (off-by-one kept for
    # parity, ref:cpp:259-265; exact_centroid divides by rz-1, restoring
    # translation invariance -- see module docstring)
    cen_mask = ((rank >= 1) & (rank < rz)).astype(dtype)[None, :, None]
    divisor = (rz - 1) if exact_centroid else rz
    centroid = jnp.sum(nb * cen_mask, axis=1) / jnp.asarray(divisor, dtype)

    # covariance: ranks 1..rz about the centroid (ref:cpp:268-272)
    cov_mask = ((rank >= 1) & (rank < rz + 1)).astype(dtype)[None, :, None]
    diff = (nb - centroid[:, None, :]) * cov_mask
    cov = jnp.einsum("nki,nkj->nij", diff, diff)

    normal = eigh3.smallest_eigvec3(cov)                 # [N,3]

    # arrow accumulation over ranks 1..k-1 (ref:cpp:286-297)
    v = nb - p                                           # [N,k,3]
    arrow_mask = (rank >= 1).astype(dtype)[None, :, None]
    v = v * arrow_mask
    arrow_sum = jnp.sum(v, axis=1)
    vnorm = jnp.linalg.norm(v, axis=-1)                  # [N,k]
    ndot = jnp.einsum("ni,nki->nk", normal, v)
    w1 = (radius[:, None] - vnorm) ** 2
    w2 = ndot ** 2
    # masked ranks contribute v=0 already, but w1 would be radius^2*0=0 ok
    scaled_sum = jnp.sum((w1 * w2)[..., None] * v, axis=1)

    # z sign fix (ref:cpp:298)
    flip = jnp.sum(normal * arrow_sum, axis=-1) < 0.0
    z = jnp.where(flip[:, None], -normal, normal)

    # Gram-Schmidt x-axis (ref:cpp:300-303)
    x = scaled_sum - jnp.sum(scaled_sum * z, -1, keepdims=True) * z
    xn = jnp.linalg.norm(x, axis=-1, keepdims=True)
    eps = jnp.asarray(1e-30, dtype)
    x = x / jnp.maximum(xn, eps)

    y = jnp.cross(z, x)
    rot = jnp.stack([x, y, z], axis=-1)                  # columns x,y,z
    return rot, nb[:, 0, :]


@functools.partial(jax.jit,
                   static_argnames=("exact_centroid", "chunk"))
def toldi_frames_dense(points, d2sorted, n_valid=None,
                       exact_centroid: bool = False, chunk: int = 1024,
                       queries=None, row_offset=None):
    """Gather-free TOLDI: identical math to
    ``toldi_frames_from_neighbors`` but every neighborhood reduction is
    a masked [C,N]x[N,*] matmul instead of a [N,k,3] row gather.

    The masked reductions are dense matmuls, with no random row gather
    of [N,k,3] neighborhoods.  Rank membership is recovered from the SORTED kNN
    distances: ranks 1..r == {j : 0 < d2_ij <= d2sorted[i, r]}, with
    midpoint thresholds so a last-ulp difference between the distance
    matrix here and the one inside the kNN cannot flip boundary
    membership.  Query rows are processed in chunks so the [C,N]
    distance block stays bounded and KITTI-scale clouds (15k+) fit in
    device memory.

    ``d2sorted [N,k]``: ascending squared neighbor distances with self
    at rank 0 (from ``knn.knn_self``).

    ``queries``/``row_offset``: optional row SLICE of ``points``
    (model-parallel setup) -- queries are the slice, ``row_offset`` its
    starting global row, so self-exclusion still matches
    ``col != global_row``.  ``d2sorted`` then has one row per query.
    """
    queries_slice = queries
    dtype = points.dtype
    n = points.shape[0]
    k = d2sorted.shape[1]
    rz = k // 3
    divisor = jnp.asarray((rz - 1) if exact_centroid else rz, dtype)
    colv = jnp.ones(n, bool) if n_valid is None else (
        jnp.arange(n) < n_valid)
    # outer products p p^T flattened once: Sum_j m_ij p_j p_j^T by matmul
    P9 = (points[:, :, None] * points[:, None, :]).reshape(n, 9)

    if queries_slice is None:
        queries_slice = points
        gidx = jnp.arange(n, dtype=jnp.int32)
    else:
        off = jnp.asarray(0 if row_offset is None else row_offset,
                          jnp.int32)
        gidx = off + jnp.arange(queries_slice.shape[0], dtype=jnp.int32)
    nq = queries_slice.shape[0]
    pad = (-nq) % chunk
    qs = jnp.pad(queries_slice, ((0, pad), (0, 0)))
    qis = jnp.pad(gidx, (0, pad))
    d2s = jnp.pad(d2sorted, ((0, pad), (0, 0)))
    col = jnp.arange(n, dtype=jnp.int32)

    def one(args):
        q, qi, d2row = args                       # [C,3],[C],[C,k]
        c = q.shape[0]
        D2 = knn._pairwise_d2(q, points)          # [C,N]
        base = (col[None, :] != qi[:, None]) & colv[None, :]
        # midpoint thresholds: rank sets {1..rz-1}, {1..rz}, {1..k-1}
        thr_cen = 0.5 * (d2row[:, rz - 1] + d2row[:, rz])
        thr_cov = 0.5 * (d2row[:, rz] + d2row[:, rz + 1])
        # radius = distance to the k-th neighbor; when the cloud has
        # fewer than k valid points the k-th slot holds the masked-kNN
        # _BIG sentinel, and (radius - d)^2 overflows f32 to inf and
        # poisons every frame -- clamp to the last VALID neighbor.
        # (The reference would read FLANN garbage here; this is a
        # deliberate robustness improvement, exercised by
        # test_toldi_small_cloud_k_exceeds_n.)
        if n_valid is None:
            r2 = d2row[:, k - 1]
        else:
            last = jnp.minimum(k - 1,
                               jnp.maximum(n_valid - 1, 1)).astype(
                jnp.int32)
            r2 = jnp.take(d2row, last, axis=1)
        thr_all = r2 * (1.0 + 1e-6) + jnp.asarray(1e-30, dtype)
        f = lambda m: m.astype(dtype)             # noqa: E731
        Mcen = f(base & (D2 <= thr_cen[:, None]))
        Mcov = f(base & (D2 <= thr_cov[:, None]))
        Mall = f(base & (D2 <= thr_all[:, None]))

        cen = (Mcen @ points) / divisor           # [C,3]
        S1 = Mcov @ points                        # [C,3]
        S2 = (Mcov @ P9).reshape(c, 3, 3)
        m = jnp.sum(Mcov, axis=1)
        cov = (S2
               - S1[:, :, None] * cen[:, None, :]
               - cen[:, :, None] * S1[:, None, :]
               + m[:, None, None] * cen[:, :, None] * cen[:, None, :])
        normal = eigh3.smallest_eigvec3(cov)      # [C,3]

        cnt = jnp.sum(Mall, axis=1)
        arrow = Mall @ points - cnt[:, None] * q
        d = jnp.sqrt(jnp.maximum(D2, 0.0))
        radius = jnp.sqrt(jnp.maximum(r2, 0.0))
        w1 = (radius[:, None] - d) ** 2
        # (n_i . v_ij) = n_i . p_j - n_i . p_i  -- one [C,3]x[3,N] matmul
        zdot = normal @ points.T - jnp.sum(normal * q, -1, keepdims=True)
        W = Mall * w1 * zdot * zdot
        scaled = W @ points - jnp.sum(W, axis=1)[:, None] * q

        flip = jnp.sum(normal * arrow, axis=-1) < 0.0
        z = jnp.where(flip[:, None], -normal, normal)
        x = scaled - jnp.sum(scaled * z, -1, keepdims=True) * z
        xn = jnp.linalg.norm(x, axis=-1, keepdims=True)
        x = x / jnp.maximum(xn, jnp.asarray(1e-30, dtype))
        y = jnp.cross(z, x)
        return jnp.stack([x, y, z], axis=-1)

    rot = jax.lax.map(one, (qs.reshape(-1, chunk, 3),
                            qis.reshape(-1, chunk),
                            d2s.reshape(-1, chunk, k)))
    return rot.reshape(-1, 3, 3)[:nq], queries_slice


def shot_truncated_count(points, radius: float, max_k: int) -> int:
    """Host-side validation for the SHOT radius-search emulation: number
    of points whose true radius neighborhood exceeds the ``max_k`` cap
    (those neighborhoods are silently truncated to the nearest max_k,
    diverging from the reference's full radius semantics).  Callers
    (register_pair) warn when this is nonzero."""
    import numpy as np
    from scipy.spatial import cKDTree
    pts = np.asarray(points)
    counts = cKDTree(pts).query_ball_point(
        pts, r=float(radius), return_length=True)
    return int((counts > max_k).sum())


@functools.partial(jax.jit, static_argnames=("max_k",))
def shot_frames(points, radius: float, max_k: int = 128, n_valid=None):
    """SHOT LRF frames (C4, ref:cpp:121-223), radius neighborhood
    emulated with a masked top-``max_k`` kNN (neighborhoods denser than
    ``max_k`` are truncated to the nearest max_k -- see
    ``shot_truncated_count`` for the host-side validity check).

    Returns (rot [N,3,3] columns x,y,z, origin [N,3]).
    """
    dtype = points.dtype
    idx, d2 = knn.knn_self(points, max_k, n_valid)
    nb = _gather_neighbors(points, idx)                  # [N,K,3]
    p = points[:, None, :]
    d = jnp.sqrt(jnp.maximum(d2, 0.0))
    rank = jnp.arange(max_k)
    in_r = (d2 <= radius * radius) & (rank[None, :] >= 1)  # skip self
    w = jnp.where(in_r, radius - d, 0.0)                 # (radius - dist)
    diffs = nb - p                                       # [N,K,3]
    cov = jnp.einsum("nk,nki,nkj->nij", w, diffs, diffs)
    total = jnp.sum(w, axis=1)
    cov = cov / jnp.maximum(total, 1e-30)[:, None, None]

    vals, vecs = eigh3.eigh3(cov)
    x_plus = vecs[..., 2]                                # largest
    z_plus = vecs[..., 0]                                # smallest

    m = jnp.sum(in_r, axis=1)                            # num considered

    def _disambiguate(axis):
        dots = jnp.einsum("nki,ni->nk", diffs, axis)
        s = jnp.sum((dots >= 0) & in_r, axis=1)
        s2 = 2 * s - m
        # median tie-break (ref:cpp:183-194): 5 samples at neighbor
        # positions med-2..med+2 of the SELF-EXCLUSIVE ascending list
        # (diff_vectors[medianIndex - i]); ranks here are self-INCLUSIVE
        # (self at 0, neighbors 1..m), so position q maps to rank q+1.
        med = m // 2
        offs = jnp.arange(-2, 3)
        tie_rank = jnp.clip(med[:, None] + 1 - offs[None, :], 1,
                            max_k - 1)
        tie_dots = jnp.take_along_axis(dots, tie_rank, axis=1)
        s_tie = jnp.sum(tie_dots >= 0, axis=1)
        flip_tie = s_tie < 3
        flip = jnp.where(s2 == 0, flip_tie, s2 < 0)
        return jnp.where(flip[:, None], -axis, axis)

    x_plus = _disambiguate(x_plus)
    z_plus = _disambiguate(z_plus)
    y_plus = jnp.cross(z_plus, x_plus)
    rot = jnp.stack([x_plus, y_plus, z_plus], axis=-1)
    return rot, points


@functools.partial(jax.jit, static_argnames=("chunk", "tie_iters"))
def shot_frames_dense(points, radius: float, n_valid=None,
                      chunk: int = 1024, tie_iters: int = 40):
    """SHOT LRF frames with EXACT radius semantics -- no neighbor cap.

    Replaces ``shot_frames``'s top-``max_k`` radius emulation (which
    silently truncates neighborhoods denser than the cap) with the
    gather-free masked-matmul pattern of the TOLDI/normals dense paths:
      * the (radius - d)-weighted covariance is three [C,N]x[N,*]
        matmuls over the radius mask (reduction expanded about the
        query point, so it equals sum w (p-q)(p-q)^T exactly);
      * the sign-disambiguation counts are masked indicator sums;
      * the 5-sample median-rank tie-break band (neighbor positions
        med-2..med+2 of the self-exclusive ascending list,
        ref:cpp:183-194) is recovered sort-free by bisecting the
        neighbor-count function for the two bracketing order
        statistics -- the same idea as the setup threshold kernel.
    Reference: computeSingleSHOTSE3Frame, ref:cpp:121-223.  Boundary
    deviation (documented): when the band clips at the list ends
    (m < 5) the reference indexes out of bounds; here the band is the
    clipped intersection with valid positions (fewer than 5 samples).
    Ties in distance at the band edge include all tied points.

    Returns (rot [N,3,3] columns x,y,z, origin [N,3]).
    """
    dtype = points.dtype
    n = points.shape[0]
    colv = jnp.ones(n, bool) if n_valid is None else (
        jnp.arange(n) < n_valid)
    r2 = jnp.asarray(radius * radius, dtype)
    P9 = (points[:, :, None] * points[:, None, :]).reshape(n, 9)
    pad = (-n) % chunk
    qs = jnp.pad(points, ((0, pad), (0, 0)))
    gidx = jnp.arange(n + pad)

    def one(args):
        q, gi = args
        c = q.shape[0]
        D2 = knn._pairwise_d2(q, points)                     # [C,N]
        mask = ((D2 <= r2) & colv[None, :]
                & (gi[:, None] != jnp.arange(n)[None, :]))   # skip self
        d = jnp.sqrt(jnp.maximum(D2, 0.0))
        w = jnp.where(mask, radius - d, 0.0).astype(dtype)
        S0 = jnp.sum(w, axis=1)
        S1 = w @ points                                      # [C,3]
        S2 = (w @ P9).reshape(c, 3, 3)
        cov = (S2 - S1[:, :, None] * q[:, None, :]
               - q[:, :, None] * S1[:, None, :]
               + S0[:, None, None] * q[:, :, None] * q[:, None, :])
        cov = cov / jnp.maximum(S0, 1e-30)[:, None, None]
        _, vecs = eigh3.eigh3(cov)
        x_plus = vecs[..., 2]                                # largest
        z_plus = vecs[..., 0]                                # smallest
        m = jnp.sum(mask, axis=1)                            # [C] int32

        # median band thresholds: the c-th smallest neighbor d2 for
        # c = med-2 (below band) and med+3 (through band), by bisection
        med = m // 2
        c_lo = jnp.clip(med - 2, 0, m)
        c_hi = jnp.clip(med + 3, 0, m)

        def thr_for(count):
            def body(_, lh):
                lo, hi = lh
                mid = 0.5 * (lo + hi)
                cnt = jnp.sum(mask & (D2 <= mid[:, None]), axis=1)
                return (jnp.where(cnt < count, mid, lo),
                        jnp.where(cnt >= count, mid, hi))
            lo0 = jnp.zeros(c, dtype)
            hi0 = jnp.full(c, r2, dtype)
            _, hi = jax.lax.fori_loop(0, tie_iters, body, (lo0, hi0))
            # count==0 -> band opens at -inf so d2==0 duplicates stay in
            return jnp.where(count == 0, jnp.full(c, -jnp.inf, dtype), hi)
        t_lo = thr_for(c_lo)
        t_hi = thr_for(c_hi)
        band = mask & (D2 > t_lo[:, None]) & (D2 <= t_hi[:, None])

        def _disambiguate(axis):
            dots = (jnp.einsum("ni,ci->cn", points, axis)
                    - jnp.sum(q * axis, -1)[:, None])
            pos = dots >= 0
            s2 = 2 * jnp.sum(pos & mask, axis=1) - m
            s_tie = jnp.sum(pos & band, axis=1)
            flip = jnp.where(s2 == 0, s_tie < 3, s2 < 0)
            return jnp.where(flip[:, None], -axis, axis)

        x_d = _disambiguate(x_plus)
        z_d = _disambiguate(z_plus)
        y_d = jnp.cross(z_d, x_d)
        return jnp.stack([x_d, y_d, z_d], axis=-1)

    rot = jax.lax.map(one, (qs.reshape(-1, chunk, 3),
                            gidx.reshape(-1, chunk)))
    return rot.reshape(-1, 3, 3)[:n], points


@functools.partial(jax.jit, static_argnames=("k",))
def estimate_normals(points, k: int = 30, n_valid=None):
    """PCA normals via kNN neighborhoods (Open3D ``EstimateNormals``
    analog, default KNN(30)).  Unoriented, like the reference's usage."""
    idx, _ = knn.knn_self(points, k, n_valid)
    return normals_from_neighbors(points, idx)


@jax.jit
def normals_from_neighbors(points, idx):
    """PCA normal from precomputed neighbor indices [N,k].

    The engine computes one sorted kNN per cloud (k = max needed) and
    slices prefixes: the first k' of an ascending kNN ARE the exact
    k'-NN, so normals/covariances reuse the TOLDI neighborhood search
    (the full-width top-k runs once per cloud)."""
    nb = _gather_neighbors(points, idx)                  # [N,k,3]
    mean = jnp.mean(nb, axis=1, keepdims=True)
    diff = nb - mean
    cov = jnp.einsum("nki,nkj->nij", diff, diff) / nb.shape[1]
    return eigh3.smallest_eigvec3(cov)


@functools.partial(jax.jit, static_argnames=("k_use", "chunk"))
def normals_dense(points, d2sorted, k_use: int, n_valid=None,
                  chunk: int = 1024):
    """Gather-free PCA normals: same neighborhoods as
    ``normals_from_neighbors`` over ``idx[:, :k_use]`` (ranks 0..k_use-1
    INCLUDING self), recovered as the masked set
    {j : d2_ij <= midpoint(d2sorted[i, k_use-1], d2sorted[i, k_use])}
    -- so ``d2sorted`` must be at least k_use+1 wide.  Covariance
    reductions are [C,N]x[N,*] matmuls (see ``toldi_frames_dense`` for
    the why)."""
    dtype = points.dtype
    n = points.shape[0]
    if d2sorted.shape[1] <= k_use:
        raise ValueError(f"d2sorted width {d2sorted.shape[1]} must "
                         f"exceed k_use={k_use}")
    colv = jnp.ones(n, bool) if n_valid is None else (
        jnp.arange(n) < n_valid)
    P9 = (points[:, :, None] * points[:, None, :]).reshape(n, 9)
    kinv = jnp.asarray(1.0 / k_use, dtype)

    pad = (-n) % chunk
    qs = jnp.pad(points, ((0, pad), (0, 0)))
    thr = 0.5 * (d2sorted[:, k_use - 1] + d2sorted[:, k_use])
    thrs = jnp.pad(thr, (0, pad))

    def one(args):
        q, t = args
        c = q.shape[0]
        D2 = knn._pairwise_d2(q, points)
        M = ((D2 <= t[:, None]) & colv[None, :]).astype(dtype)
        S1 = M @ points
        S2 = (M @ P9).reshape(c, 3, 3)
        m = jnp.sum(M, axis=1)
        mean = S1 * kinv                       # gather path divides by k
        cov = (S2
               - S1[:, :, None] * mean[:, None, :]
               - mean[:, :, None] * S1[:, None, :]
               + m[:, None, None] * mean[:, :, None] * mean[:, None, :])
        return eigh3.smallest_eigvec3(cov * kinv)

    nrm = jax.lax.map(one, (qs.reshape(-1, chunk, 3),
                            thrs.reshape(-1, chunk)))
    return nrm.reshape(-1, 3)[:n]


@functools.partial(jax.jit, static_argnames=("k_use", "epsilon", "chunk"))
def gicp_covariances_dense(points, d2sorted, k_use: int,
                           epsilon: float = 1e-3, n_valid=None,
                           chunk: int = 1024):
    """Gather-free GICP covariance init (C14): dense normals ->
    Sigma = Rx diag(eps,1,1) Rx^T."""
    normals = normals_dense(points, d2sorted, k_use, n_valid, chunk)
    Rx = rotation_from_e1_to_x(normals)
    C = jnp.diag(jnp.asarray([epsilon, 1.0, 1.0], points.dtype))
    return Rx @ C @ Rx.mT


@jax.jit
def rotation_from_e1_to_x(x):
    """Open3D's private GetRotationFromE1ToX, copied by the reference
    (ref:cpp:4-14) -- INCLUDING the c < -0.99 -> identity quirk."""
    dtype = x.dtype
    e1 = jnp.zeros_like(x).at[..., 0].set(1.0)
    v = jnp.cross(e1, x)
    c = x[..., 0]                                        # e1 . x
    from se3_icp.utils.se3 import skew
    sv = skew(v)
    factor = 1.0 / (1.0 + jnp.where(c < -0.99, jnp.ones_like(c), c))
    R = (jnp.eye(3, dtype=dtype) + sv
         + (sv @ sv) * factor[..., None, None])
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), R.shape)
    return jnp.where((c < -0.99)[..., None, None], eye, R)


@functools.partial(jax.jit, static_argnames=("k", "epsilon"))
def gicp_covariances(points, k: int = 20, epsilon: float = 1e-3,
                     n_valid=None):
    """Per-point GICP covariances Sigma = Rx diag(eps,1,1) Rx^T from
    kNN-20 normals (C14, ref:cpp:33-52)."""
    idx, _ = knn.knn_self(points, k, n_valid)
    return gicp_covariances_from_neighbors(points, idx, epsilon)


@functools.partial(jax.jit, static_argnames=("epsilon",))
def gicp_covariances_from_neighbors(points, idx, epsilon: float = 1e-3):
    normals = normals_from_neighbors(points, idx)
    Rx = rotation_from_e1_to_x(normals)
    C = jnp.diag(jnp.asarray([epsilon, 1.0, 1.0], points.dtype))
    return Rx @ C @ Rx.mT
