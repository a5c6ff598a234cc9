"""FPFH descriptor + FGR baseline tests.

The FPFH oracle transcribes Open3D's Feature.cpp semantics
(ComputePairFeatures / ComputeSPFHFeature / ComputeFPFHFeature) in plain
numpy loops; the reference consumes that implementation at
examples/registration_example_fgr.cpp:37-38.
"""

import numpy as np
import pytest
from scipy.spatial import cKDTree

import jax.numpy as jnp

from se3_icp.models import fgr
from se3_icp.ops import fpfh as fpfh_ops
from se3_icp.ops import knn, lrf
from se3_icp.utils import metrics_host


def _pair_features_oracle(p1, n1, p2, n2):
    dp = p2 - p1
    d = np.linalg.norm(dp)
    if d == 0:
        return np.zeros(4)
    a1 = n1 @ dp / d
    a2 = n2 @ dp / d
    if np.arccos(abs(a1)) > np.arccos(abs(a2)):
        n1, n2 = n2, n1
        dp = -dp
        f3 = -a2  # Open3D negates in the swapped branch
    else:
        f3 = a1
    v = np.cross(dp, n1)
    vn = np.linalg.norm(v)
    if vn == 0:
        return np.zeros(4)
    v /= vn
    w = np.cross(n1, v)
    f2 = v @ n2
    f1 = np.arctan2(w @ n2, n1 @ n2)
    return np.array([f1, f2, f3, d])


def _fpfh_oracle(points, normals, k):
    n = len(points)
    tree = cKDTree(points)
    d, idx = tree.query(points, k=k)
    spfh = np.zeros((n, 33))
    for i in range(n):
        hist_incr = 100.0 / (k - 1)
        for j in range(1, k):
            f = _pair_features_oracle(points[i], normals[i],
                                      points[idx[i, j]],
                                      normals[idx[i, j]])
            b = min(int(np.floor(11 * (f[0] + np.pi) / (2 * np.pi))), 10)
            spfh[i, max(b, 0)] += hist_incr
            b = min(int(np.floor(11 * (f[1] + 1) * 0.5)), 10)
            spfh[i, 11 + max(b, 0)] += hist_incr
            b = min(int(np.floor(11 * (f[2] + 1) * 0.5)), 10)
            spfh[i, 22 + max(b, 0)] += hist_incr
    feat = np.zeros((n, 33))
    for i in range(n):
        acc = np.zeros(33)
        for j in range(1, k):
            d2 = d[i, j] ** 2
            if d2 == 0:
                continue
            acc += spfh[idx[i, j]] / d2
        for blk in range(3):
            s = acc[11 * blk:11 * blk + 11].sum()
            if s != 0:
                acc[11 * blk:11 * blk + 11] *= 100.0 / s
        feat[i] = acc + spfh[i]
    return feat


def _rand_cloud(rng, n):
    # a curved surface so normals are informative
    xy = rng.uniform(-1, 1, size=(n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) * np.cos(2 * xy[:, 1])
    pts = np.column_stack([xy, z]) + rng.normal(scale=0.01, size=(n, 3))
    return pts


def test_fpfh_matches_oracle(rng):
    n, k = 160, 20
    pts = _rand_cloud(rng, n)
    # use the SAME normals for both (sign conventions differ between
    # implementations; FPFH is a function of points AND normals)
    idx, d2 = knn.knn_self(jnp.asarray(pts), k, None)
    nrm = np.asarray(lrf.normals_from_neighbors(jnp.asarray(pts), idx))
    got = np.asarray(fpfh_ops.fpfh_from_neighbors(
        jnp.asarray(pts), jnp.asarray(nrm), idx, d2,
        jnp.ones(idx.shape, bool)))
    want = _fpfh_oracle(pts, nrm, k)
    # histogram bin edges are knife-edge sensitive; compare in L1 per
    # descriptor (each block sums to ~200)
    err = np.abs(got - want).sum(axis=1) / np.abs(want).sum(axis=1)
    assert np.median(err) < 0.05
    assert np.mean(err) < 0.15


def test_fpfh_dense_sum_matches_gathered(rng):
    """The dense ball-threshold neighbor-SPFH sum must reproduce the
    gathered exact-kNN route up to boundary-membership noise (a tie at
    the rank-k radius may flip one lowest-weight member)."""
    n, k = 300, 25
    pts = _rand_cloud(rng, n)
    idx, d2 = knn.knn_self(jnp.asarray(pts), k, None)
    nrm = np.asarray(lrf.normals_from_neighbors(jnp.asarray(pts), idx))
    mask = jnp.ones(idx.shape, bool)
    dense = np.asarray(fpfh_ops.fpfh_from_neighbors(
        jnp.asarray(pts), jnp.asarray(nrm), idx, d2, mask,
        dense_sum=True))
    gathered = np.asarray(fpfh_ops.fpfh_from_neighbors(
        jnp.asarray(pts), jnp.asarray(nrm), idx, d2, mask,
        dense_sum=False))
    err = (np.abs(dense - gathered).sum(axis=1)
           / np.maximum(np.abs(gathered).sum(axis=1), 1e-9))
    assert np.median(err) < 1e-5, np.median(err)
    assert np.mean(err) < 0.02, np.mean(err)


def test_fgr_registers_synthetic_problem(rng):
    n = 400
    src = _rand_cloud(rng, n)
    ang = np.deg2rad(35.0)
    c, s = np.cos(ang), np.sin(ang)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    R = R @ np.array([[1, 0, 0],
                      [0, np.cos(0.4), -np.sin(0.4)],
                      [0, np.sin(0.4), np.cos(0.4)]])
    t = np.array([0.4, -0.3, 0.25])
    tgt = src @ R.T + t
    cfg = fgr.FGRConfig(fpfh_knn=40, normals_knn=20, tuple_trials=4096)
    res = fgr.fgr_register(src, tgt, cfg)
    rot = metrics_host.angular_error_so3(res.transformation[:3, :3], R)
    tra = metrics_host.translation_error(res.transformation[:3, 3], t)
    assert rot < 2.0, rot
    assert tra < 0.05, tra


def test_fgr_batched_sharded(rng):
    """fgr through the pair-DP machinery on the 8-device CPU mesh."""
    from se3_icp.bench import common
    from se3_icp.parallel import pairs as par

    problems = []
    gts = []
    for i in range(8):
        src = _rand_cloud(np.random.default_rng(i), 300)
        ang = 0.3 + 0.05 * i
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        t = np.array([0.2, 0.1 * i, -0.1])
        problems.append((src, src @ R.T + t))
        gts.append((R, t))
    cfg = fgr.FGRConfig(fpfh_knn=40, normals_knn=20, tuple_trials=4096)
    results = par.register_pairs(problems, "fgr", cfg,
                                 mesh=par.default_mesh())
    for res, (R, t) in zip(results, gts):
        rot = metrics_host.angular_error_so3(res.transformation[:3, :3], R)
        tra = metrics_host.translation_error(res.transformation[:3, 3], t)
        assert rot < 2.0 and tra < 0.05, (rot, tra)
    del common
