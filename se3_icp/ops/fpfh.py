"""FPFH (Fast Point Feature Histograms) descriptors.

The reference uses Open3D's ``ComputeFPFHFeature`` as input to its FGR
comparison baseline (examples/registration_example_fgr.cpp:37-38,
benchmark_synthetic.cpp:387-388, benchmark_lounge.cpp:311-314,
benchmark_kitti.cpp:295-298), always with ``KDTreeSearchParamKNN(100)``
on normals estimated with ``KDTreeSearchParamKNN(30)``.

This module re-designs it as batched array code: the per-point neighbor loops become
one batched [N, k] pair-feature computation, and the 33-bin histogram
scatter becomes three one-hot matmul-style reductions that XLA fuses --
no KD-tree, no per-point loop.  Semantics follow Open3D's
``ComputePairFeatures`` / ``ComputeSPFHFeature`` / ``ComputeFPFHFeature``
(cpp/open3d/pipelines/registration/Feature.cpp):

  * per neighbor pair (p, q) with normals (n_p, n_q): order the pair so
    the point whose normal is closest (by |cos|) to the connecting line
    acts as the Darboux frame origin; features are
    f1 = atan2(w.n2, u.n2) in [-pi, pi], f2 = v.n2 in [-1, 1],
    f3 = u.d in [-1, 1];
  * SPFH: 3 x 11-bin histograms over the k-1 non-self neighbors, each
    neighbor contributing 100/(k-1);
  * FPFH_i = SPFH_i + sum_j SPFH_j / d2_ij, each 11-bin block re-scaled
    to sum 100 before the self term is added (Open3D's exact
    "simplification" of the PCL weighting, including dividing by the
    SQUARED neighbor distance).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

FPFH_DIM = 33
_NBINS = 11


def pair_features(p1, n1, p2, n2):
    """Darboux-frame pair features, vectorized over leading dims.

    Returns (f1, f2, f3, d): angle atan2 in [-pi,pi], two cosines in
    [-1,1], and the euclidean distance.  Zero features when the points
    coincide or the frame is degenerate (Open3D returns all-zeros then).
    """
    dtype = p1.dtype
    eps = jnp.asarray(1e-30, dtype)
    dp = p2 - p1
    d = jnp.linalg.norm(dp, axis=-1)
    dsafe = jnp.maximum(d, eps)[..., None]
    angle1 = jnp.sum(n1 * dp, axis=-1) / dsafe[..., 0]
    angle2 = jnp.sum(n2 * dp, axis=-1) / dsafe[..., 0]
    # acos(|a1|) > acos(|a2|)  <=>  |a1| < |a2|: swap roles.  In the
    # swapped branch Open3D sets f3 = -angle2 (the direction vector is
    # negated along with the role swap, Feature.cpp ComputePairFeatures)
    swap = jnp.abs(angle1) < jnp.abs(angle2)
    n1c = jnp.where(swap[..., None], n2, n1)
    n2c = jnp.where(swap[..., None], n1, n2)
    dpc = jnp.where(swap[..., None], -dp, dp)
    f3 = jnp.where(swap, -angle2, angle1)

    v = jnp.cross(dpc, n1c)
    vn = jnp.linalg.norm(v, axis=-1)
    v = v / jnp.maximum(vn, eps)[..., None]
    w = jnp.cross(n1c, v)
    f2 = jnp.sum(v * n2c, axis=-1)
    f1 = jnp.arctan2(jnp.sum(w * n2c, axis=-1),
                     jnp.sum(n1c * n2c, axis=-1))

    ok = (d > 0) & (vn > 0)
    zero = jnp.zeros_like(f1)
    return (jnp.where(ok, f1, zero), jnp.where(ok, f2, zero),
            jnp.where(ok, f3, zero), d)


def _hist11(value, lo, hi, weight):
    """[N,k] values -> [N,11] weighted histogram via one-hot reduction."""
    dtype = value.dtype
    b = jnp.floor(_NBINS * (value - lo) / (hi - lo)).astype(jnp.int32)
    b = jnp.clip(b, 0, _NBINS - 1)
    onehot = (b[..., None] ==
              jnp.arange(_NBINS, dtype=jnp.int32)).astype(dtype)
    return jnp.sum(onehot * weight[..., None], axis=1)


def spfh(points, normals, idx, nb_mask):
    """Simple Point Feature Histograms: [N, 33].

    ``idx [N,k]``: neighbor indices with self at rank 0 (dropped);
    ``nb_mask [N,k]``: True for real (non-padded) neighbors.
    """
    dtype = points.dtype
    nb_idx = idx[:, 1:]
    mask = nb_mask[:, 1:].astype(dtype)
    p1 = points[:, None, :]
    n1 = normals[:, None, :]
    # ONE row gather for position+normal instead of two
    pn = jnp.concatenate([points, normals], axis=-1)[nb_idx]
    p2, n2 = pn[..., :3], pn[..., 3:]
    f1, f2, f3, _ = pair_features(p1, n1, p2, n2)
    # hist_incr = 100 / (#neighbors excl. self)  (Feature.cpp SPFH loop)
    cnt = jnp.maximum(jnp.sum(mask, axis=1, keepdims=True), 1.0)
    w = 100.0 / cnt * mask
    pi = jnp.asarray(jnp.pi, dtype)
    h1 = _hist11(f1, -pi, pi, w)
    h2 = _hist11(f2, jnp.asarray(-1.0, dtype), jnp.asarray(1.0, dtype), w)
    h3 = _hist11(f3, jnp.asarray(-1.0, dtype), jnp.asarray(1.0, dtype), w)
    return jnp.concatenate([h1, h2, h3], axis=-1)


def fpfh_from_neighbors(points, normals, idx, d2, nb_mask,
                        n_valid=None, dense_sum: bool = True):
    """FPFH [N,33] from a precomputed sorted kNN (self at rank 0).

    ``d2``: squared neighbor distances (the weighting divisor Open3D
    uses -- FLANN returns squared distances and Feature.cpp divides by
    them directly).

    The neighbor-SPFH accumulation  sum_j spfh[j]/d2_ij  runs DENSELY
    (``dense_sum``): the kNN's own last distance column is the ball
    threshold, the weight matrix  w = (d2 <= thr) / d2  is recomputed
    tile-wise from positions, and the sum is one contraction
    ``w @ spfh`` per tile -- no [N,k,33] gather.  Ball-vs-rank
    semantics: a boundary tie may add a member or two, which the 1/d2-weighted histogram
    treats as noise-level.  ``dense_sum=False`` keeps the gathered
    route (oracle/tests).  ``n_valid``: valid-row count for the dense
    column mask (defaults to all rows).
    """
    dtype = points.dtype
    s = spfh(points, normals, idx, nb_mask)           # [N,33]
    n = points.shape[0]
    if dense_sum:
        thr = d2[:, -1]                    # rank-k ball radius^2
        tn = jnp.sum(points * points, axis=-1)        # [N]
        if n_valid is None:
            col_ok = jnp.ones((n,), bool)
        else:
            col_ok = jnp.arange(n) < n_valid
        cn = min(512, n)
        pad_n = (-n) % cn
        q_c = jnp.pad(points, ((0, pad_n), (0, 0))).reshape(-1, cn, 3)
        thr_c = jnp.pad(thr, (0, pad_n)).reshape(-1, cn)

        def one(c):
            q, t = c
            qn = jnp.sum(q * q, axis=-1, keepdims=True)
            prod = jax.lax.dot_general(
                q, points, dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=dtype,
                precision=jax.lax.Precision.HIGHEST)
            d2f = qn - 2.0 * prod + tn[None, :]       # [cn, N]
            w = jnp.where((d2f <= t[:, None]) & (d2f > 0)
                          & col_ok[None, :],
                          1.0 / jnp.maximum(d2f, 1e-30), 0.0)
            return jax.lax.dot_general(
                w, s, dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=dtype,
                precision=jax.lax.Precision.HIGHEST)  # [cn, 33]

        acc = jax.lax.map(one, (q_c, thr_c)).reshape(-1, s.shape[1])[:n]
    else:
        nb_idx = idx[:, 1:]
        nb_d2 = d2[:, 1:]
        mask = nb_mask[:, 1:] & (nb_d2 > 0)
        inv_d2 = jnp.where(mask, 1.0 / jnp.maximum(nb_d2, 1e-30),
                           0.0).astype(dtype)
        # gathered route: stream QUERY-ROW chunks (one gather of all
        # neighbors materializes [B,N,99,33] -- 13.9 GB padded at the
        # 64-pair serving batch).  Chunking the ROW axis keeps each
        # step's contraction over the full k.
        k_nb = nb_idx.shape[1]
        cn = min(256, n)
        pad_n = (-n) % cn
        idx_c = jnp.pad(nb_idx, ((0, pad_n), (0, 0))).reshape(
            -1, cn, k_nb)
        w_c = jnp.pad(inv_d2, ((0, pad_n), (0, 0))).reshape(-1, cn, k_nb)

        def one(c):
            ix, w = c
            return jnp.einsum("nk,nkf->nf", w, s[ix])

        acc = jax.lax.map(one, (idx_c, w_c)).reshape(-1, s.shape[1])[:n]
    # per-block renormalization to 100, then + own SPFH (Feature.cpp)
    blocks = acc.reshape(-1, 3, _NBINS)
    bsum = jnp.sum(blocks, axis=-1, keepdims=True)
    scale = jnp.where(bsum > 0, 100.0 / jnp.maximum(bsum, 1e-30), 0.0)
    return (blocks * scale).reshape(-1, FPFH_DIM) + s


@functools.partial(jax.jit, static_argnames=("knn",))
def fpfh(points, normals, n_valid=None, knn: int = 100):
    """FPFH descriptors for a (padded) cloud: [N, 33].

    Rows beyond ``n_valid`` are garbage and must be masked downstream.
    """
    from se3_icp.ops import knn as knn_ops
    idx, d2 = knn_ops.knn_self(points, knn, n_valid)
    n = points.shape[0]
    if n_valid is None:
        nb_mask = jnp.ones(idx.shape, bool)
    else:
        # a valid query always has n_valid real neighbors (incl. self);
        # padded targets sort to the back with _BIG distances
        nb_mask = (jnp.arange(idx.shape[1])[None, :]
                   < jnp.minimum(n_valid, idx.shape[1]))
        nb_mask = nb_mask & (jnp.arange(n)[:, None] < n_valid)
    return fpfh_from_neighbors(points, normals, idx, d2, nb_mask,
                               n_valid=n_valid)
