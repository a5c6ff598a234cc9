"""Brute-force nearest-neighbor search.

Replaces every FLANN KD-tree in the reference (ref:hpp:66-68; queries at
ref:cpp:136,253,407,431,458,626): the 3-D euclidean 1-NN correspondence
search (C6), the 12-D SE(3) 1-NN search (C5), the k=90 kNN for TOLDI LRFs
(C3), and normal-estimation neighborhoods.

At the reference's cloud sizes (~4k-15k points) an O(N^2) tiled
distance matrix -- ``d2 = |q|^2 - 2 q.t^T + |t|^2`` -- is dense,
regular work for the accelerator; tree traversal would serialize.  Two
routes compute the batched 1-NN of the engine loop:

  * plain XLA (``nn_argmin_xla``, chunked; every backend, and the
    oracle for tests);
  * on the GPU, the Triton kernel of ``triton_nn`` under ``vmap``, which
    keeps a running (min, argmin) in registers and never writes the
    distance block to device memory.

All functions take an optional traced ``n_targets`` so padded clouds mask
correctly, and break distance ties toward the lowest target index.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_BIG = 3.4e38  # ~f32 max; used instead of inf so masked math stays finite

# Private route pin for the batched 1-NN (``_nn_match``'s vmap rule):
# None picks by platform (the Triton kernel on GPU, XLA elsewhere); a
# callable with ``triton_nn.nn_argmin_batched``'s signature replaces it.
# Read at trace time -- clear jit caches after changing it.  Tests pin
# the interpreted kernel here; the on-chip A/B pins either route.
_BATCHED_NN = None


def _pairwise_d2(q, t):
    """[Cq,D] x [Nt,D] -> [Cq,Nt] squared distances (matmul form).

    The cross term runs at HIGHEST precision: a GPU's default float32
    matmul may round its inputs to TF32 (~3 decimal digits), which can
    flip nearest neighbors between close candidates at fine convergence
    (the reference's FLANN trees are exact f64).
    """
    qn = jnp.sum(q * q, axis=-1, keepdims=True)
    tn = jnp.sum(t * t, axis=-1)
    prod = jax.lax.dot_general(
        q, t, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=q.dtype,
        precision=jax.lax.Precision.HIGHEST)
    return qn - 2.0 * prod + tn[None, :]


def _mask_cols(d2, n_targets):
    if n_targets is None:
        return d2
    col = jax.lax.broadcasted_iota(jnp.int32, d2.shape, d2.ndim - 1)
    return jnp.where(col < n_targets, d2, jnp.asarray(_BIG, d2.dtype))


def _split_chunk(n: int, chunk: int) -> int:
    """``chunk`` is a target: split ``n`` into equal 128-aligned pieces,
    so a 4608-point cloud runs 2x2304 instead of padding to 3x2048."""
    steps = max(1, -(-n // chunk))
    return -(-(-(-n // steps)) // 128) * 128


@functools.partial(jax.jit, static_argnames=("chunk",))
def nn_argmin_xla(queries, targets, n_targets=None, chunk: int = 4096):
    """1-NN: returns (idx [Nq] int32, d2 [Nq]).  Plain-XLA chunked path:
    the unbatched 1-NN on every backend (FGR, multi-start scoring,
    metrics, the row-sharded loop) and the tests' reference."""
    nq = queries.shape[0]
    chunk = _split_chunk(nq, chunk)
    pad = (-nq) % chunk
    qp = jnp.pad(queries, ((0, pad), (0, 0)))
    qc = qp.reshape(-1, chunk, queries.shape[1])

    def one(q):
        d2 = _mask_cols(_pairwise_d2(q, targets), n_targets)
        return jnp.argmin(d2, axis=1).astype(jnp.int32), jnp.min(d2, axis=1)

    idx, d2 = jax.lax.map(one, qc)
    return idx.reshape(-1)[:nq], d2.reshape(-1)[:nq]


def _bcast(x, b, axis_size):
    return x if b else jnp.broadcast_to(x[None],
                                        (axis_size,) + jnp.shape(x))


def batched_nn():
    """The batched 1-NN route for this trace: ``_BATCHED_NN`` if pinned,
    else the Triton kernel on GPU and ``vmap(nn_argmin_xla)``
    elsewhere."""
    if _BATCHED_NN is not None:
        return _BATCHED_NN
    if jax.default_backend() == "gpu":
        from se3_icp.ops import triton_nn
        return triton_nn.nn_argmin_batched
    return jax.vmap(nn_argmin_xla)


@jax.custom_batching.custom_vmap
def _nn_match(queries, targets, payload, n_targets):
    idx, d2 = nn_argmin_xla(queries, targets, n_targets)
    return idx, d2, payload[idx]


@_nn_match.def_vmap
def _nn_match_vmap_rule(axis_size, in_batched, queries, targets, payload,
                        n_targets):
    """Batched matches: one batched 1-NN call (``batched_nn``), then one
    row gather of the matched payload per query."""
    qb, tb, pb, nb = in_batched
    q = _bcast(queries, qb, axis_size)
    t = _bcast(targets, tb, axis_size)
    p = _bcast(payload, pb, axis_size)
    n = _bcast(jnp.asarray(n_targets, jnp.int32), nb, axis_size)
    idx, d2 = batched_nn()(q, t, n)
    out = (idx, d2, jnp.take_along_axis(p, idx[:, :, None], axis=1))
    return out, (True, True, True)


def nn_match(queries, targets, payload, n_targets=None):
    """1-NN + matched-row payload: returns (idx [Nq] int32, d2 [Nq],
    matched [Nq,P]) with matched[i] == payload[idx[i]].

    The registration loop's correspondence search: callers pack every
    per-target quantity they need into ``payload`` columns and receive
    the matched rows with the search."""
    if n_targets is None:
        n_targets = targets.shape[0]
    return _nn_match(queries, targets, payload,
                     jnp.asarray(n_targets, jnp.int32))


def nn_distances(queries, targets, tgt_valid=None, chunk: int = 2048):
    """min_j ||q_i - t_j||^2 per query (Open3D ComputePointCloudDistance
    analog returns sqrt of this)."""
    n_targets = None
    if tgt_valid is not None:
        n_targets = jnp.sum(jnp.asarray(tgt_valid).astype(jnp.int32))
    _, d2 = nn_argmin_xla(queries, targets, n_targets)
    return d2


def _topk_rows(d2, k: int, method: str, recall: float):
    """k smallest of each row of a masked distance block, ascending."""
    if method == "approx_f32":
        mind, idx = jax.lax.approx_min_k(
            d2, k, recall_target=recall, aggregate_to_topk=True)
        return idx.astype(jnp.int32), mind
    neg, idx = jax.lax.top_k(-d2, k)
    return idx.astype(jnp.int32), -neg


@functools.partial(jax.jit,
                   static_argnames=("k", "chunk", "method", "recall"))
def knn_topk(queries, targets, k: int, n_targets=None, chunk: int = 4096,
             method: str = "exact", recall: float = 1.0):
    """k smallest-distance neighbors, ascending: (idx [Nq,k], d2 [Nq,k]).

    Mirrors FLANN ``SearchKNN`` ordering (closest first, ref:cpp:253-256).
    Used for TOLDI (k=90), normal estimation (k=20/30), and FPFH
    (k=100); runs once per registration.  ``method``: 'exact'
    (``lax.top_k``) or 'approx_f32' (``lax.approx_min_k`` over float32
    distances at recall target ``recall``).
    """
    nq = queries.shape[0]
    chunk = _split_chunk(nq, chunk)
    pad = (-nq) % chunk
    qp = jnp.pad(queries, ((0, pad), (0, 0)))
    qc = qp.reshape(-1, chunk, queries.shape[1])

    def one(q):
        d2 = _mask_cols(_pairwise_d2(q, targets), n_targets)
        return _topk_rows(d2, k, method, recall)

    idx, d2 = jax.lax.map(one, qc)
    return (idx.reshape(-1, k)[:nq], d2.reshape(-1, k)[:nq])


# Batched setup-kNN memory budget: the [B, chunk, Nt] float32 distance
# block of one query chunk (see _knn_topk_batched).  On an H100 a 6 GB
# budget ran the FGR batch-64 and 15k batch-8 programs no faster than
# 1.5 GB but raised their peak memory from 4.7 GB to 11.4-11.7 GB
# (docs/PERF.md), so the smaller block stays.
_TOPK_BATCH_BUDGET = 1_500_000_000


def _knn_topk_batched(queries, targets, n_targets, k: int, method: str,
                      recall: float):
    """Batch-aware chunked top-k: queries [B,Nq,D], targets [B,Nt,D].

    A vmap of ``knn_topk`` multiplies its query chunk by B -- the
    [B, chunk, Nt] distance block of the default 4096-row chunk is
    5.4 GB at 64x4608.  Here the chunk shrinks with the batch so the
    block stays inside ``_TOPK_BATCH_BUDGET``; chunking is over QUERIES
    only, so results are identical to the unbatched path.
    """
    bsz, nq, d = queries.shape
    nt = targets.shape[1]
    chunk = max(128, _TOPK_BATCH_BUDGET // max(bsz * nt * 4, 1))
    chunk = _split_chunk(nq, chunk)
    steps = -(-nq // chunk)
    pad = steps * chunk - nq
    qp = jnp.pad(queries, ((0, 0), (0, pad), (0, 0)))
    qt = jnp.moveaxis(qp.reshape(bsz, steps, chunk, d), 1, 0)
    n_arr = jnp.asarray(n_targets, jnp.int32)
    tn = jnp.sum(targets * targets, axis=-1)              # [B, Nt]

    def one(qc):                                          # [B, chunk, D]
        qn = jnp.sum(qc * qc, axis=-1, keepdims=True)
        prod = jax.lax.dot_general(
            qc, targets, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
            preferred_element_type=qc.dtype,
            precision=jax.lax.Precision.HIGHEST)
        d2 = qn - 2.0 * prod + tn[:, None, :]
        col = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 2)
        d2 = jnp.where(col < n_arr[:, None, None], d2,
                       jnp.asarray(_BIG, d2.dtype))
        return _topk_rows(d2, k, method, recall)

    idx, d2 = jax.lax.map(one, qt)                # [steps, B, chunk, k]
    idx = jnp.moveaxis(idx, 0, 1).reshape(bsz, -1, k)[:, :nq]
    d2 = jnp.moveaxis(d2, 0, 1).reshape(bsz, -1, k)[:, :nq]
    return idx, d2


@functools.lru_cache(maxsize=None)
def _topk_vmap_fn(k: int, method: str, recall: float):
    """custom_vmap wrapper factory (cached per static config): unbatched
    calls run ``knn_topk`` unchanged; vmapped calls use the batch-aware
    chunking above."""

    @jax.custom_batching.custom_vmap
    def fn(queries, targets, n_targets):
        return knn_topk(queries, targets, k, n_targets, method=method,
                        recall=recall)

    @fn.def_vmap
    def _rule(axis_size, in_batched, queries, targets, n_targets):
        qb, tb, nb = in_batched
        out = _knn_topk_batched(
            _bcast(queries, qb, axis_size), _bcast(targets, tb, axis_size),
            _bcast(jnp.asarray(n_targets, jnp.int32), nb, axis_size),
            k, method, recall)
        return out, (True, True)

    return fn


def knn_self(points, k: int, n_valid=None, method: str = "exact",
             recall: float = 1.0):
    """kNN of a cloud against itself (self included at rank 0).

    vmap-compatible: batched calls chunk queries with a batch-aware
    memory budget instead of multiplying the unbatched chunk by B."""
    if n_valid is None:
        n_valid = points.shape[0]
    return _topk_vmap_fn(k, method, recall)(
        points, points, jnp.asarray(n_valid, jnp.int32))
