"""Fast Global Registration (FGR) -- the reference's comparison baseline.

The reference delegates to Open3D's
``FastGlobalRegistrationBasedOnFeatureMatching`` with default options on
FPFH(knn=100) features over normals(knn=30)
(examples/registration_example_fgr.cpp:37-54,
benchmark_synthetic.cpp:382-392, benchmark_lounge.cpp:307-319,
benchmark_kitti.cpp:291-303).  Algorithm: Zhou, Park, Koltun,
"Fast Global Registration", ECCV 2016.

Re-design -- the whole pipeline is ONE jitted program with
static shapes; no KD-trees, no dynamic correspondence lists:

  * feature matching: brute-force 33-D nearest neighbors in both
    directions; the reciprocity (cross-check) test becomes a mask
    over the fixed-length forward match array;
  * tuple test: instead of rejection-sampling until 1000 accepted
    tuples, draw a static batch of random triples, test all of them in
    parallel, and keep the first ``max_tuple_count`` accepted ones by
    cumulative rank; surviving correspondences get multiplicity weights
    via a segment-sum scatter;
  * graduated non-convexity: ``lax.fori_loop`` over 64 Gauss-Newton
    steps with Geman-McClure line-process weights
    l = (mu / (mu + r^2))^2, mu halving-by-1.4 every 4 iterations from
    the normalized global scale down to ``max_corr_dist`` (the original
    FGR schedule, which Open3D reproduces);
  * the 6x6 normal-equation solve and Euler-ZYX retraction are shared
    with the ICP engine (ops/solve.py), matching Open3D's
    ``TransformVector6dToMatrix4d`` convention.

Default options mirror ``FastGlobalRegistrationOption``:
division_factor 1.4, use_absolute_scale False, decrease_mu True,
maximum_correspondence_distance 0.025, iteration_number 64,
tuple_scale 0.95, maximum_tuple_count 1000.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from se3_icp.ops import fpfh as fpfh_ops
from se3_icp.ops import knn, lrf, solve
from se3_icp.utils import se3


@dataclass(frozen=True)
class FGRConfig:
    """Open3D ``FastGlobalRegistrationOption`` defaults + the fixed
    feature hyperparameters every reference call site uses."""

    division_factor: float = 1.4
    use_absolute_scale: bool = False
    decrease_mu: bool = True
    maximum_correspondence_distance: float = 0.025
    iteration_number: int = 64
    tuple_scale: float = 0.95
    maximum_tuple_count: int = 1000
    tuple_test: bool = True
    # feature pipeline (reference call sites)
    normals_knn: int = 30       # EstimateNormals KNN(30)
    fpfh_knn: int = 100         # ComputeFPFHFeature KNN(100)
    # static sampling budget replacing rejection sampling
    tuple_trials: int = 16384
    seed: int = 0

    def replace(self, **kw) -> "FGRConfig":
        return dataclasses.replace(self, **kw)


def _masked_centroid(pts, valid, n):
    w = valid.astype(pts.dtype)[:, None]
    return jnp.sum(pts * w, axis=0) / jnp.maximum(n.astype(pts.dtype), 1.0)


@functools.partial(jax.jit, static_argnames=("cfg",))
def fgr_register_arrays(src, n_src, tgt, n_tgt, cfg: FGRConfig):
    """One padded FGR registration.  Returns (T [4,4], iters, 0)
    with the same output contract as ``registration.register_arrays``
    so the pair-DP machinery can shard it identically."""
    with jax.default_matmul_precision("highest"):
        return _fgr_impl(src, n_src, tgt, n_tgt, cfg)


def _fgr_impl(src, n_src, tgt, n_tgt, cfg):
    dtype = src.dtype
    ns, nt = src.shape[0], tgt.shape[0]
    src_valid = jnp.arange(ns) < n_src
    tgt_valid = jnp.arange(nt) < n_tgt
    src = jnp.where(src_valid[:, None], src, 0.0)
    tgt = jnp.where(tgt_valid[:, None], tgt, 0.0)

    # --- features on ORIGINAL coordinates (reference computes normals +
    #     FPFH before any normalization); +1 kNN column so normals use
    #     the gather-free dense path (see lrf.normals_dense).  FPFH
    #     weights each neighbor by 1/d2, so distances stay float32 at
    #     HIGHEST precision; the RANKS tolerate approx_min_k (recall
    #     0.95), which ran 8% faster than the exact top-k on the GPU
    #     (docs/PERF.md).
    kw = max(cfg.fpfh_knn, cfg.normals_knn) + 1
    idx_s, d2_s = knn.knn_self(src, kw, n_src, method="approx_f32",
                               recall=0.95)
    idx_t, d2_t = knn.knn_self(tgt, kw, n_tgt, method="approx_f32",
                               recall=0.95)
    nrm_s = lrf.normals_dense(src, d2_s, cfg.normals_knn, n_src)
    nrm_t = lrf.normals_dense(tgt, d2_t, cfg.normals_knn, n_tgt)

    def nb_mask(nq, n_valid, k):
        m = jnp.arange(k)[None, :] < jnp.minimum(n_valid, k)
        return m & (jnp.arange(nq)[:, None] < n_valid)

    kf = cfg.fpfh_knn
    feat_s = fpfh_ops.fpfh_from_neighbors(
        src, nrm_s, idx_s[:, :kf], d2_s[:, :kf], nb_mask(ns, n_src, kf),
        n_valid=n_src)
    feat_t = fpfh_ops.fpfh_from_neighbors(
        tgt, nrm_t, idx_t[:, :kf], d2_t[:, :kf], nb_mask(nt, n_tgt, kf),
        n_valid=n_tgt)
    feat_s = jnp.where(src_valid[:, None], feat_s, 1e6)
    feat_t = jnp.where(tgt_valid[:, None], feat_t, 1e6)

    # --- reciprocal feature matching (AdvancedMatching's cross check)
    fwd, _ = knn.nn_argmin_xla(feat_s, feat_t, n_tgt)  # src i -> tgt fwd[i]
    bwd, _ = knn.nn_argmin_xla(feat_t, feat_s, n_src)  # tgt j -> src bwd[j]
    recip = (bwd[fwd] == jnp.arange(ns)) & src_valid

    # --- tuple test on the reciprocal set (static-batch redesign)
    if cfg.tuple_test:
        corr_w = _tuple_test(src, tgt, fwd, recip, cfg)
    else:
        corr_w = recip.astype(dtype)

    # --- scale normalization (original FGR NormalizePoints)
    cen_s = _masked_centroid(src, src_valid, n_src)
    cen_t = _masked_centroid(tgt, tgt_valid, n_tgt)
    src_c = jnp.where(src_valid[:, None], src - cen_s, 0.0)
    tgt_c = jnp.where(tgt_valid[:, None], tgt - cen_t, 0.0)
    if cfg.use_absolute_scale:
        # original FGR: points stay in metric units, mu starts at the
        # global max radius (StartScale)
        scale = jnp.asarray(1.0, dtype)
        mu0 = jnp.maximum(jnp.max(jnp.linalg.norm(src_c, axis=-1)),
                          jnp.max(jnp.linalg.norm(tgt_c, axis=-1)))
    else:
        scale = jnp.maximum(jnp.max(jnp.linalg.norm(src_c, axis=-1)),
                            jnp.max(jnp.linalg.norm(tgt_c, axis=-1)))
        scale = jnp.maximum(scale, jnp.asarray(1e-30, dtype))
        src_c = src_c / scale
        tgt_c = tgt_c / scale
        mu0 = jnp.asarray(1.0, dtype)  # normalized StartScale

    p = src_c                      # [Ns,3] sources
    q = tgt_c[fwd]                 # matched targets
    w_corr = corr_w.astype(dtype)

    max_cd = jnp.asarray(cfg.maximum_correspondence_distance, dtype)
    div = jnp.asarray(cfg.division_factor, dtype)

    def body(itr, carry):
        T, mu = carry
        if cfg.decrease_mu:
            shrink = (itr % 4 == 0) & (mu > max_cd)
            mu = jnp.where(shrink, mu / div, mu)
        pm = p @ T[:3, :3].T + T[:3, 3]
        r2 = jnp.sum((pm - q) ** 2, axis=-1)
        l2 = (mu / (mu + r2)) ** 2            # Geman-McClure line process
        w = w_corr * l2
        # pt2pt GN rows: J_i = [-skew(pm_i) | I], r_i = pm_i - q_i
        S = se3.skew(pm)                       # [N,3,3]
        J3 = jnp.concatenate(
            [-S, jnp.broadcast_to(jnp.eye(3, dtype=dtype),
                                  S.shape)], axis=-1)   # [N,3,6]
        r3 = pm - q
        J3w = J3 * w[:, None, None]
        n = p.shape[0]
        JTJ = J3w.reshape(3 * n, 6).T @ J3.reshape(3 * n, 6)
        JTr = J3w.reshape(3 * n, 6).T @ r3.reshape(3 * n)
        T_i = solve.solve_normal_equations(JTJ, JTr)
        return (T_i @ T, mu)

    # derive the initial carry from the inputs so its sharding
    # "varying-ness" matches the body outputs under shard_map/vmap
    zero_f = jnp.zeros((), dtype) * src[0, 0]
    T0 = jnp.eye(4, dtype=dtype) + zero_f
    T, _ = jax.lax.fori_loop(0, cfg.iteration_number, body,
                             (T0, mu0 + zero_f))

    # --- denormalize (GetTransformationOriginalScale):
    # x' = R(x - cen_s)/scale + t  =>  orig: R x + (scale*t - R cen_s + cen_t)
    R = T[:3, :3]
    t = T[:3, 3]
    t_orig = scale * t - R @ cen_s + cen_t
    T_out = se3.rt_to_T(R, t_orig)
    # degenerate correspondence sets: fall back to identity
    ok = jnp.sum(w_corr > 0) >= 3
    T_out = jnp.where(ok, T_out, jnp.eye(4, dtype=dtype))
    zero = jnp.zeros((), jnp.int32)
    return T_out, zero + cfg.iteration_number, zero


def _tuple_test(src, tgt, fwd, recip, cfg: FGRConfig):
    """Static-batch tuple test: random correspondence triples must have
    consistent edge-length ratios in both clouds
    (tau < |e_src|/|e_tgt| < 1/tau, tau = tuple_scale).  Returns per-
    correspondence multiplicity weights over the first
    ``maximum_tuple_count`` accepted triples."""
    dtype = src.dtype
    ns = src.shape[0]
    ncorr = jnp.maximum(jnp.sum(recip.astype(jnp.int32)), 1)
    # valid correspondence indices compacted to a prefix
    order = jnp.argsort(~recip, stable=True)        # valid first
    key = jax.random.key(cfg.seed)
    raw = jax.random.randint(key, (cfg.tuple_trials, 3), 0, 1 << 30)
    tri = order[raw % ncorr]                        # [T,3] source indices
    pi = src[tri]                                   # [T,3,3]
    qi = tgt[fwd[tri]]                              # [T,3,3]

    def edges(x):
        return jnp.stack([
            jnp.linalg.norm(x[:, 0] - x[:, 1], axis=-1),
            jnp.linalg.norm(x[:, 1] - x[:, 2], axis=-1),
            jnp.linalg.norm(x[:, 2] - x[:, 0], axis=-1)], axis=-1)

    li = edges(pi)
    lj = edges(qi)
    tau = jnp.asarray(cfg.tuple_scale, dtype)
    okr = (li * tau < lj) & (lj < li / tau)
    distinct = ((tri[:, 0] != tri[:, 1]) & (tri[:, 1] != tri[:, 2])
                & (tri[:, 0] != tri[:, 2]))
    accept = jnp.all(okr, axis=-1) & distinct
    rank = jnp.cumsum(accept.astype(jnp.int32))
    accept = accept & (rank <= cfg.maximum_tuple_count)
    # multiplicity weights via scatter-add over the 3 member indices
    contrib = accept.astype(dtype)[:, None] * jnp.ones((1, 3), dtype)
    w = jnp.zeros(ns, dtype).at[tri.reshape(-1)].add(contrib.reshape(-1))
    return w


def fgr_register(source_points, target_points,
                 cfg: FGRConfig | None = None, dtype=jnp.float32):
    """Host-facing FGR entry point (RegistrationResult contract)."""
    from se3_icp.models.registration import (RegistrationResult,
                                                 _bucket, sanitize_cloud)
    cfg = cfg or FGRConfig()
    # drop non-finite rows like register_pair does: one NaN point would
    # poison the kNN distance matrix, normals and FPFH features
    src = sanitize_cloud(source_points)
    tgt = sanitize_cloud(target_points)
    ns, nt = len(src), len(tgt)
    src_p = np.zeros((_bucket(ns), 3), dtype)
    src_p[:ns] = src
    tgt_p = np.zeros((_bucket(nt), 3), dtype)
    tgt_p[:nt] = tgt
    T, it, pure = fgr_register_arrays(
        jnp.asarray(src_p), jnp.asarray(ns, jnp.int32),
        jnp.asarray(tgt_p), jnp.asarray(nt, jnp.int32), cfg)
    T, it, pure = jax.device_get((T, it, pure))
    return RegistrationResult(np.asarray(T, np.float64), int(it),
                              int(pure))
