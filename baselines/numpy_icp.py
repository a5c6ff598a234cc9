"""CPU reference-proxy implementation of SE(3)-ICP (numpy + scipy).

The reference C++ binaries cannot be built here (no Open3D/PCL), so this
vectorized numpy + cKDTree implementation of the same algorithm serves
as the measured CPU baseline for ``bench.py``'s ``vs_baseline`` ratio:
cKDTree is compiled C (the same role FLANN plays in the reference), and
the per-point math is numpy-vectorized (the reference's OpenMP loops).
It follows run_se3_icp (ref:cpp:555-739) step for step, including the
TOLDI quirks, so it doubles as an end-to-end oracle.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree
from scipy.spatial.transform import Rotation


def toldi_frames_np(points: np.ndarray, k: int):
    tree = cKDTree(points)
    d, idx = tree.query(points, k=k)
    nb = points[idx]                                   # [N,k,3]
    radius = np.linalg.norm(nb[:, -1] - points, axis=1)
    rz = k // 3
    centroid = nb[:, 1:rz].sum(1) / rz                 # quirk kept
    diff = nb[:, 1:rz + 1] - centroid[:, None]
    cov = np.einsum("nki,nkj->nij", diff, diff)
    w, v = np.linalg.eigh(cov)
    normal = v[:, :, 0]
    vv = nb[:, 1:] - points[:, None]
    arrow = vv.sum(1)
    w1 = (radius[:, None] - np.linalg.norm(vv, axis=2)) ** 2
    w2 = np.einsum("ni,nki->nk", normal, vv) ** 2
    scaled = np.einsum("nk,nki->ni", w1 * w2, vv)
    flip = np.einsum("ni,ni->n", normal, arrow) < 0
    z = np.where(flip[:, None], -normal, normal)
    x = scaled - np.einsum("ni,ni->n", scaled, z)[:, None] * z
    x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=2)


def solve_pt2pl_np(src, tgt, normals):
    r = np.einsum("ni,ni->n", src - tgt, normals)
    J = np.concatenate([np.cross(src, normals), normals], axis=1)
    xi = np.linalg.solve(J.T @ J, -(J.T @ r))
    T = np.eye(4)
    T[:3, :3] = (Rotation.from_euler("z", xi[2]).as_matrix()
                 @ Rotation.from_euler("y", xi[1]).as_matrix()
                 @ Rotation.from_euler("x", xi[0]).as_matrix())
    T[:3, 3] = xi[3:]
    return T


def estimate_normals_np(points, k=30):
    tree = cKDTree(points)
    _, idx = tree.query(points, k=k)
    nb = points[idx]
    nb = nb - nb.mean(1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", nb, nb)
    _, v = np.linalg.eigh(cov)
    return v[:, :, 0]


def run_se3_icp_np(src, tgt, alpha=3.0, beta=1.0, scale_pre=3.0,
                   overlap=1.0, lrf_k=90, max_iters=150, max_se3=10,
                   mse_thresh=1e-5, switch_thresh=5e-5):
    """run_se3_icp('pt2pl') on CPU; returns (T, iters)."""
    cen_s, cen_t = src.mean(0), tgt.mean(0)
    r = max(np.linalg.norm(src - cen_s, axis=1).max(),
            np.linalg.norm(tgt - cen_t, axis=1).max())
    s = scale_pre / r
    src_c = (src - cen_s) * s
    tgt_c = (tgt - cen_t) * s

    rot_s = toldi_frames_np(src_c, lrf_k) * alpha
    rot_t = toldi_frames_np(tgt_c, lrf_k) * alpha
    tgt_embed = np.concatenate(
        [rot_t.transpose(0, 2, 1).reshape(-1, 9), tgt_c * beta], axis=1)
    tree12 = cKDTree(tgt_embed)
    tree3 = cKDTree(tgt_c)
    normals = estimate_normals_np(tgt_c, 30)

    T = np.eye(4)
    mse_prev = mse_cur = 1e7
    switched = False
    it = 0
    n_keep = int(overlap * len(src_c))
    while True:
        it += 1
        R, tv = T[:3, :3], T[:3, 3]
        moving = src_c @ R.T + tv
        if not switched:
            cur_rot = np.einsum("ij,njk->nik", R, rot_s)
            q = np.concatenate(
                [cur_rot.transpose(0, 2, 1).reshape(-1, 9),
                 (src_c * beta) @ R.T + tv], axis=1)
            _, midx = tree12.query(q, k=1)
            dist = np.linalg.norm(q[:, 9:] - tgt_embed[midx, 9:], axis=1)
        else:
            dist, midx = tree3.query(moving, k=1)
        keep = np.argsort(dist, kind="stable")[:n_keep]
        mse_prev, mse_cur = mse_cur, dist[keep].mean()
        T_i = solve_pt2pl_np(moving[keep], tgt_c[midx[keep]],
                             normals[midx[keep]])
        T_new = T_i @ T
        change = np.linalg.norm(T - T_new)
        T = T_new
        if not switched:
            if it == max_se3 or change < switch_thresh:
                switched = True
        else:
            if it == max_iters or abs(mse_cur - mse_prev) < s * mse_thresh:
                break
    Rp, tp = T[:3, :3], T[:3, 3]
    T[:3, 3] = tp / s - Rp @ cen_s + cen_t
    return T, it


def _timed_pair(_):
    import time
    from se3_icp.datasets import standin
    src, tgt, _ = standin.golden_problem()
    t0 = time.perf_counter()
    run_se3_icp_np(src, tgt)
    return time.perf_counter() - t0


def baseline_rates() -> dict:
    """Serial and all-core pairs/s of this CPU reference on the golden
    stand-in pair.  Run it in a process that has not imported JAX
    (``python -m baselines.numpy_icp``): the pool forks this process."""
    import multiprocessing as mp
    import os
    import time
    dt = _timed_pair(0)
    nproc = os.cpu_count() or 1
    out = {"pairs_per_s": 1.0 / dt, "seconds_per_pair": dt, "nproc": nproc}
    if nproc == 1:
        # fork + pool overhead would only flatter the ratio on 1 core
        out["parallel_pairs_per_s"] = out["pairs_per_s"]
    else:
        t0 = time.perf_counter()
        with mp.get_context("fork").Pool(nproc) as pool:
            pool.map(_timed_pair, range(nproc))
        out["parallel_pairs_per_s"] = nproc / (time.perf_counter() - t0)
    return out


if __name__ == "__main__":
    import json
    import sys
    assert "jax" not in sys.modules
    print(json.dumps(baseline_rates()))
