"""Batched multi-start registration: widen the convergence basin by
running the SAME pair from a grid of rotation initializations in one
batched device program and keeping the start with the lowest trimmed
nearest-neighbor RMS.

The reference has no equivalent -- its "difficult" synthetic protocol
(benchmark_synthetic.cpp:139-158, rotations up to +/-pi) is reported
with per-start success rates and the paper's answer is raising alpha.
On the accelerator the start axis is just more batch for the same compiled program
(`parallel/pairs.register_batch`), so covering SO(3) with a few dozen
starts costs one extra serving batch, not a code path: measured on the
difficult protocol the single-start success rate 0.125 rises to ~1.0
with 8-24 starts (tests/test_multistart.py).

Starts are rotations about the source centroid: the engine's
preprocessing already centers both clouds (ref:cpp:569-585), so
translation offsets are absorbed and the basin structure lives on
SO(3).  The grid is the 24-element octahedral rotation group ordered
greedily by geodesic coverage (identity first), extended past 24 by a
super-Fibonacci low-discrepancy SO(3) spiral (Alexa, CVPR 2022).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from se3_icp.models import registration as reg
from se3_icp.ops import knn, trim
from se3_icp.utils.config import RegistrationConfig


def _octahedral_group() -> np.ndarray:
    """The 24 rotation matrices of the cube/octahedron group."""
    mats = []
    seen = set()
    axes = np.eye(3)
    base = [np.eye(3)]
    # generators: quarter turns about x, y, z
    def rot(axis, k):
        c, s = [1, 0, -1, 0][k % 4], [0, 1, 0, -1][k % 4]
        a = axes[axis]
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]],
                      [-a[1], a[0], 0]])
        return np.eye(3) + s * K + (1 - c) * (K @ K)
    frontier = base
    while frontier:
        nxt = []
        for M in frontier:
            key = tuple(np.round(M, 6).ravel())
            if key in seen:
                continue
            seen.add(key)
            mats.append(M)
            for ax in range(3):
                nxt.append(rot(ax, 1) @ M)
        frontier = nxt
    assert len(mats) == 24
    return np.stack(mats)


def _geo_dist(Ra, Rb):
    """Geodesic angle between rotation matrices (broadcasts)."""
    tr = np.einsum("...ij,...ij->...", Ra, Rb)
    return np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))


@functools.lru_cache(maxsize=8)
def _ordered_octahedral() -> np.ndarray:
    """Octahedral group greedily ordered for coverage, identity first:
    each next element maximizes the min geodesic distance to the ones
    already picked, so any prefix is a good SO(3) covering."""
    G = _octahedral_group()
    order = [int(np.argmin([_geo_dist(g, np.eye(3)) for g in G]))]
    rest = [i for i in range(24) if i != order[0]]
    while rest:
        dmin = [min(_geo_dist(G[i], G[j]) for j in order) for i in rest]
        pick = rest[int(np.argmax(dmin))]
        order.append(pick)
        rest.remove(pick)
    return G[np.asarray(order)]


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    """[n,4] unit quaternions (w,x,y,z) -> [n,3,3] rotation matrices."""
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], -2)


def super_fibonacci(n: int) -> np.ndarray:
    """[n,4] super-Fibonacci spiral quaternions (Alexa, CVPR 2022): a
    deterministic low-discrepancy covering of SO(3) -- the double-cover
    analog of the Fibonacci sphere lattice."""
    phi = np.sqrt(2.0)
    psi = 1.533751168755204288118041  # positive root of x^4 = x + 4
    s = np.arange(n, dtype=np.float64) + 0.5
    t = s / n
    d = 2.0 * np.pi * s
    r, R = np.sqrt(t), np.sqrt(1.0 - t)
    a, b = d / phi, d / psi
    return np.stack([r * np.sin(a), r * np.cos(a),
                     R * np.sin(b), R * np.cos(b)], -1)


def so3_grid(n_starts: int, seed: int = 0) -> np.ndarray:
    """[n,3,3] deterministic rotation starts: identity-led greedy
    octahedral prefix; past 24, a super-Fibonacci low-discrepancy
    SO(3) spiral (composed with one seeded random rotation so distinct
    seeds give distinct-but-equally-covering fleets)."""
    G = _ordered_octahedral()
    if n_starts <= 24:
        return np.array(G[:n_starts])
    q = super_fibonacci(n_starts - 24)
    rng = np.random.default_rng(seed)
    q0 = rng.normal(size=4)
    R0 = _quat_to_mat((q0 / np.linalg.norm(q0))[None])[0]
    return np.concatenate([G, _quat_to_mat(q) @ R0], 0)


@functools.partial(jax.jit, static_argnames=("overlap",))
def _score_transforms(T_batch, src, n_src, tgt, n_tgt, overlap: float):
    """Trimmed-mean nearest-neighbor distance of src under each
    candidate transform vs tgt -- the same quantity the engine's stop
    test tracks (quirk #5: mean distance, not squared), computed in the
    ORIGINAL frame so candidates from different starts are comparable."""
    ns = src.shape[0]
    valid = jnp.arange(ns) < n_src

    def one(T):
        moved = src @ T[:3, :3].T + T[:3, 3]
        _, d2 = knn.nn_argmin_xla(moved, tgt, n_tgt)
        d = jnp.sqrt(jnp.maximum(d2, 0.0))
        kept = trim.trim_mask(d, valid, overlap, n_src)
        return trim.masked_mean(d, kept)

    return jax.vmap(one)(T_batch)


@dataclass
class MultistartResult:
    best: reg.RegistrationResult
    start_index: int
    scores: np.ndarray          # [n_starts] trimmed NN mean distance
    rotations: np.ndarray       # [n_starts,3,3] start rotations


def _default_mesh(mesh):
    """Multistart mirrors register_pairs_async's mesh default: on a
    multi-device host the (pair, start) batch shards across all devices
    unless the caller pins a mesh explicitly.  ``mesh=False`` forces a
    single-device (unsharded) run."""
    if mesh is False:
        return None
    if mesh is None and jax.device_count() > 1:
        from se3_icp.parallel import pairs as par
        return par.default_mesh()
    return mesh


def register_pair_multistart(source_points, target_points,
                             algorithm: str = "se3_pt2pl",
                             cfg: RegistrationConfig | None = None,
                             n_starts: int = 8, seed: int = 0,
                             mesh=None,
                             dtype=np.float32) -> MultistartResult:
    """Register one pair from ``n_starts`` rotation initializations in
    a single batched program; return the start with the lowest trimmed
    NN score (plus all scores for diagnostics)."""
    from se3_icp.parallel import pairs as par

    cfg = cfg or RegistrationConfig()
    mesh = _default_mesh(mesh)
    src = reg.sanitize_cloud(source_points)
    tgt = reg.sanitize_cloud(target_points)
    rots = so3_grid(n_starts, seed)
    c = src.mean(0)
    starts = np.einsum("kij,nj->kni", rots, src - c) + c   # [K,Ns,3]

    T, it, pure = par.register_batch(*_pack_starts(starts, tgt, dtype),
                                     cfg, algorithm, mesh)
    # compose with the start: full transform maps the ORIGINAL source
    M = np.zeros((n_starts, 4, 4))
    M[:, :3, :3] = rots
    M[:, :3, 3] = c - rots @ c
    M[:, 3, 3] = 1.0
    T_full = np.asarray(jax.device_get(T), np.float64) @ M

    ns, nt = len(src), len(tgt)
    src_p = np.zeros((reg._bucket(ns), 3), dtype)
    src_p[:ns] = src
    tgt_p = np.zeros((reg._bucket(nt), 3), dtype)
    tgt_p[:nt] = tgt
    scores = np.asarray(jax.device_get(_score_transforms(
        jnp.asarray(T_full, dtype), jnp.asarray(src_p),
        jnp.asarray(ns, jnp.int32), jnp.asarray(tgt_p),
        jnp.asarray(nt, jnp.int32), float(cfg.estimated_overlap))))
    k = int(np.argmin(scores))
    it = np.asarray(jax.device_get(it))
    pure = np.asarray(jax.device_get(pure))
    best = reg.RegistrationResult(transformation=T_full[k],
                                  num_iterations=int(it[k]),
                                  num_pure_se3_iterations=int(pure[k]))
    return MultistartResult(best=best, start_index=k, scores=scores,
                            rotations=rots)


def register_pairs_multistart(pairs, algorithm: str = "se3_pt2pl",
                              cfg: RegistrationConfig | None = None,
                              n_starts: int = 8, seed: int = 0,
                              mesh=None, dtype=np.float32,
                              pair_chunk: int | None = None,
                              verbose: bool = False
                              ) -> list[MultistartResult]:
    """Multi-start registration of MANY pairs: the device batch is
    (pair, start) flattened -- independent registrations of the same
    compiled shape, the batched form of a restart fleet.  Scores
    come from a vmapped trimmed-NN pass; each pair keeps its best start.

    Pairs run in fixed-size chunks so the flattened device batch stays
    at serving scale (~64 registrations) regardless of ``len(pairs)``
    -- one unchunked P*K batch of padded clouds can blow past device memory.
    Every chunk shares one compiled shape (cloud buckets are sized from
    the FULL list; the tail chunk repeats its last pair)."""
    cfg = cfg or RegistrationConfig()
    mesh = _default_mesh(mesh)
    rots = so3_grid(n_starts, seed)
    srcs = [reg.sanitize_cloud(s) for s, _ in pairs]
    tgts = [reg.sanitize_cloud(t) for _, t in pairs]
    p_n = len(pairs)
    ndev = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
    if pair_chunk is None:
        # ~64 flat registrations per dispatch (the scale that saturates
        # a chip in the serving bench), and enough pairs that the
        # FLATTENED axis covers every mesh device (>= ndev/n_starts)
        pair_chunk = max(1, -(-64 // n_starts), -(-ndev // n_starts))
    pair_chunk = max(1, min(pair_chunk, p_n))
    ns_max = reg._bucket(max(len(s) for s in srcs))
    nt_max = reg._bucket(max(len(t) for t in tgts))

    out: list[MultistartResult] = [None] * p_n          # type: ignore
    for lo in range(0, p_n, pair_chunk):
        sel = list(range(lo, min(lo + pair_chunk, p_n)))
        idx = sel + [sel[-1]] * (pair_chunk - len(sel))  # pad tail
        res = _multistart_chunk([srcs[i] for i in idx],
                                [tgts[i] for i in idx], rots, algorithm,
                                cfg, mesh, dtype, ns_max, nt_max)
        for j, i in enumerate(sel):
            out[i] = res[j]
        if verbose:
            print(f"  multistart pairs {sel[0]}..{sel[-1]} "
                  f"({len(sel)} x {n_starts} starts)")
    return out


def _multistart_chunk(srcs, tgts, rots, algorithm, cfg, mesh, dtype,
                      ns_max, nt_max) -> list[MultistartResult]:
    """One fixed-shape (pair, start) chunk: register, score, select."""
    from se3_icp.parallel import pairs as par

    p_n, n_starts = len(srcs), len(rots)
    src_b = np.zeros((p_n, n_starts, ns_max, 3), dtype)
    tgt_b = np.zeros((p_n, nt_max, 3), dtype)
    n_src = np.zeros(p_n, np.int32)
    n_tgt = np.zeros(p_n, np.int32)
    M = np.zeros((p_n, n_starts, 4, 4))
    for i, (s, t) in enumerate(zip(srcs, tgts)):
        c = s.mean(0)
        src_b[i, :, :len(s)] = np.einsum("kij,nj->kni", rots, s - c) + c
        tgt_b[i, :len(t)] = t
        n_src[i], n_tgt[i] = len(s), len(t)
        M[i, :, :3, :3] = rots
        M[i, :, :3, 3] = c - rots @ c
        M[i, :, 3, 3] = 1.0

    flat_src = src_b.reshape(p_n * n_starts, ns_max, 3)
    flat_tgt = np.broadcast_to(tgt_b[:, None], (p_n, n_starts, nt_max, 3)
                               ).reshape(p_n * n_starts, nt_max, 3)
    T, it, pure = par.register_batch(
        jnp.asarray(flat_src), jnp.asarray(np.repeat(n_src, n_starts)),
        jnp.asarray(flat_tgt), jnp.asarray(np.repeat(n_tgt, n_starts)),
        cfg, algorithm, mesh)
    T_full = (np.asarray(jax.device_get(T), np.float64)
              .reshape(p_n, n_starts, 4, 4) @ M)

    src_p = np.zeros((p_n, ns_max, 3), dtype)
    for i, s in enumerate(srcs):
        src_p[i, :len(s)] = s
    scores = np.asarray(jax.device_get(_score_transforms_pairs(
        jnp.asarray(T_full, dtype), jnp.asarray(src_p),
        jnp.asarray(n_src), jnp.asarray(tgt_b), jnp.asarray(n_tgt),
        float(cfg.estimated_overlap))))        # [P,K]
    it = np.asarray(jax.device_get(it)).reshape(p_n, n_starts)
    pure = np.asarray(jax.device_get(pure)).reshape(p_n, n_starts)
    out = []
    for i in range(p_n):
        k = int(np.argmin(scores[i]))
        best = reg.RegistrationResult(
            transformation=T_full[i, k], num_iterations=int(it[i, k]),
            num_pure_se3_iterations=int(pure[i, k]))
        out.append(MultistartResult(best=best, start_index=k,
                                    scores=scores[i], rotations=rots))
    return out


@functools.partial(jax.jit, static_argnames=("overlap",))
def _score_transforms_pairs(T_pk, src, n_src, tgt, n_tgt, overlap: float):
    """[P,K,4,4] candidates x per-pair clouds -> [P,K] trimmed scores."""
    return jax.vmap(_score_transforms.__wrapped__,
                    in_axes=(0, 0, 0, 0, 0, None))(
        T_pk, src, n_src, tgt, n_tgt, overlap)


def _pack_starts(starts: np.ndarray, tgt: np.ndarray, dtype=np.float32):
    """Padded batch arrays for K rotated copies of one source against
    one shared target (no per-copy sanitize: inputs already clean)."""
    k, ns, _ = starts.shape
    nt = len(tgt)
    src_b = np.zeros((k, reg._bucket(ns), 3), dtype)
    src_b[:, :ns] = starts
    tgt_b = np.zeros((k, reg._bucket(nt), 3), dtype)
    tgt_b[:, :nt] = tgt
    return (jnp.asarray(src_b), jnp.full(k, ns, np.int32),
            jnp.asarray(tgt_b), jnp.full(k, nt, np.int32))
