"""Model-parallel registration: shard ONE registration's point axis.

The reference's only parallelism is OpenMP worksharing over per-point
loops inside one process (SURVEY.md §2.5).  The multi-chip analog here
splits the row-wise work of a single (large) registration across a
``points`` mesh axis while keeping both clouds replicated:

  * setup (the O(N^2) kNN for TOLDI frames / normals / GICP
    covariances) runs on each device's contiguous row slice, and the
    small per-point products (frames [N,3,3], normals [N,3],
    covariances [N,3,3]) are ``all_gather``-ed back — the [N,k]
    neighbor index matrix never leaves its shard;
  * the per-iteration 1-NN correspondence search splits its query rows
    the same way and all_gathers only the int32 match vector
    (4 bytes/point over NVLink);
  * the 6x6 solve and the [4,4] transform accumulation are replicated
    (negligible next to the NN matmuls).

This is throughput-oriented weak scaling for clouds too large for one
card's memory-bandwidth budget; for many small pairs use
``parallel.pairs`` (DP) instead — it needs zero communication.

Composable: a 2-D mesh ('pairs', 'points') shards batches of large
pairs both ways (see ``register_batch_2d``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from se3_icp.models import registration as reg
from se3_icp.utils.config import RegistrationConfig, parse_algorithm


def points_mesh(axis: str = "points", devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


@functools.lru_cache(maxsize=64)
def _compiled_points_sharded(static_cfg, mode, variant, mesh, axis):
    """Cached compiled program (same rationale as pairs._compiled_batch:
    a fresh jit-of-closure per call misses the jit cache every time)."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()), out_specs=(P(), P(), P()),
        check_vma=False)  # outputs are replicated by construction
    def _run(s, ns, t, nt, fl):
        return reg._register_arrays_jit(s, ns, t, nt, fl, cfg=static_cfg,
                                        mode=mode, variant=variant,
                                        points_axis=axis)

    return jax.jit(_run)


def register_arrays_points_sharded(src, n_src, tgt, n_tgt,
                                   cfg: RegistrationConfig,
                                   algorithm: str, mesh: Mesh,
                                   axis: str = "points"):
    """One padded registration, row-sharded over ``mesh[axis]``.

    Cloud paddings must be divisible by the axis size (the 512-point
    bucket quantum guarantees this for power-of-two meshes).  Returns
    (T [4,4], iters, pure_iters), replicated.
    """
    mode, variant = parse_algorithm(algorithm)
    ndev = mesh.shape[axis]
    if src.shape[0] % ndev or tgt.shape[0] % ndev:
        raise ValueError(
            f"padded cloud sizes {src.shape[0]}/{tgt.shape[0]} must be "
            f"divisible by the '{axis}' mesh axis size {ndev}")
    floats, static_cfg = reg.split_cfg(cfg, src.dtype)
    return _compiled_points_sharded(static_cfg, mode, variant, mesh,
                                    axis)(src, n_src, tgt, n_tgt, floats)


def register_pair_model_parallel(source_points, target_points,
                                 algorithm: str = "se3_pt2pl",
                                 cfg: RegistrationConfig | None = None,
                                 mesh: Mesh | None = None,
                                 dtype=jnp.float32):
    """Host-facing single-pair entry point over a points mesh."""
    cfg = cfg or RegistrationConfig()
    mesh = mesh or points_mesh()
    ndev = int(np.prod(list(mesh.shape.values())))
    quantum = max(512, ndev)

    src = np.asarray(source_points, np.float64)
    tgt = np.asarray(target_points, np.float64)
    ns, nt = len(src), len(tgt)
    src_p = np.zeros((reg._bucket(ns, quantum), 3), dtype)
    src_p[:ns] = src
    tgt_p = np.zeros((reg._bucket(nt, quantum), 3), dtype)
    tgt_p[:nt] = tgt
    out = register_arrays_points_sharded(
        jnp.asarray(src_p), jnp.asarray(ns, jnp.int32),
        jnp.asarray(tgt_p), jnp.asarray(nt, jnp.int32), cfg,
        algorithm, mesh)
    T, it, pure = jax.device_get(out)
    return reg.RegistrationResult(np.asarray(T, np.float64), int(it),
                                  int(pure))


@functools.lru_cache(maxsize=64)
def _compiled_batch_2d(static_cfg, mode, variant, mesh, pairs_axis,
                       points_axis):
    def one(s, ns, t, nt, fl):
        return reg._register_arrays_jit(s, ns, t, nt, fl, cfg=static_cfg,
                                        mode=mode, variant=variant,
                                        points_axis=points_axis)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(pairs_axis), P(pairs_axis),
                  P(pairs_axis), P(pairs_axis), P()),
        out_specs=(P(pairs_axis), P(pairs_axis), P(pairs_axis)),
        check_vma=False)
    def _run(s, ns, t, nt, fl):
        return jax.vmap(one, in_axes=(0, 0, 0, 0, None))(s, ns, t, nt, fl)

    return jax.jit(_run)


def register_batch_2d(src, n_src, tgt, n_tgt, cfg: RegistrationConfig,
                      algorithm: str, mesh: Mesh,
                      pairs_axis: str = "pairs",
                      points_axis: str = "points"):
    """Batched pairs over a 2-D ('pairs', 'points') mesh: DP over the
    leading pair axis, model-parallel rows within each pair."""
    mode, variant = parse_algorithm(algorithm)
    floats, static_cfg = reg.split_cfg(cfg, src.dtype)
    return _compiled_batch_2d(static_cfg, mode, variant, mesh,
                              pairs_axis, points_axis)(
        src, n_src, tgt, n_tgt, floats)
