"""Batched exact 1-NN as a Pallas kernel through Triton (GPU).

The engine's per-iteration correspondence search is a batched
``[B,Nq,D] x [B,Nt,D]`` nearest-neighbour query (D = 12 for the SE(3)
embedding, 3 for plain ICP).  XLA's route (``knn.nn_argmin_xla`` under
``vmap``) writes the ``[B,chunk,Nt]`` float32 distance block to device
memory and reads it back for the min/argmin.  This kernel never stores a
distance: one program owns one (pair, query block), loops over target
tiles, and keeps a running (min, argmin) in registers.  Only ``idx`` and
``d2`` (``[B,Nq]`` each) are written.

The distance is folded into one float32 dot per tile: queries are
augmented to ``[-2q, 1, 0...]`` and targets to ``[t, |t|^2, 0...]``
(feature axis padded to 16), so ``qa . ta = |t|^2 - 2 q.t`` and
``d2 = |q|^2 + qa . ta`` -- the same expanded form as
``knn._pairwise_d2``.  The dot runs at IEEE float32 precision (no TF32;
the scaling by -2 is exact).  Target columns at or past ``n_targets``
get ``|t|^2 = _POISON``, so no mask is needed in the loop, and the loop
stops at the last tile holding a valid target.  Ties go to the lower
target index, like ``jnp.argmin``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

_BIG = 3.4e38       # knn._BIG: the d2 of a query with no valid target
_POISON = 1e30      # |t|^2 of padded target columns
FEAT = 16           # padded feature width (a dot operand needs >= 16)
# tile and launch shape: the fastest of 8 block shapes x warps x stages
# timed at 64x4608x12 on an H100 (docs/PERF.md)
BLOCK_Q = 64
BLOCK_T = 128
NUM_WARPS = 4
NUM_STAGES = 2


def _nn_kernel(n_ref, qa_ref, ta_ref, idx_ref, s_ref):
    block_q, block_t = BLOCK_Q, BLOCK_T
    n_valid = n_ref[()]
    qa = qa_ref[...]                                           # [BQ, F]

    def tile(j, carry):
        best, best_j = carry
        j = j.astype(jnp.int32)
        start = pl.multiple_of(j * block_t, block_t)
        ta = ta_ref[:, pl.ds(start, block_t)]                  # [F, BT]
        s = pl.dot(qa, ta, precision=jax.lax.Precision.HIGHEST)  # IEEE
        # strict < keeps the earlier tile (lower index) on ties; the
        # lane reduction runs once, after the loop
        better = s < best
        return jnp.where(better, s, best), jnp.where(better, j, best_j)

    init = (jnp.full((block_q, block_t), _BIG, jnp.float32),
            jnp.zeros((block_q, block_t), jnp.int32))
    best, best_j = jax.lax.fori_loop(
        0, (n_valid + (block_t - 1)) // block_t, tile, init)
    row_min = jnp.min(best, axis=1)                            # [BQ]
    lane = jax.lax.broadcasted_iota(jnp.int32, best_j.shape, 1)
    gidx = best_j * block_t + lane
    idx = jnp.min(jnp.where(best == row_min[:, None], gidx,
                            jnp.iinfo(jnp.int32).max), axis=1)
    idx_ref[...] = idx
    s_ref[...] = row_min


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _augment(queries, targets, n_targets):
    """Kernel operands: qa [B,Nq_p,16] rows [-2q, 1, 0..], ta [B,16,Nt_p]
    columns [t, |t|^2, 0..] with |t|^2 = _POISON at or past n_targets,
    |q|^2 [B,Nq], and n_targets clipped to [0, Nt]."""
    bsz, nq, d = queries.shape
    nt = targets.shape[1]
    if d + 1 > FEAT:
        raise ValueError(f"feature width {d} > {FEAT - 1}")
    q = queries.astype(jnp.float32)
    t = targets.astype(jnp.float32)
    n = jnp.clip(jnp.asarray(n_targets, jnp.int32), 0, nt)
    nq_p, nt_p = _round_up(nq, BLOCK_Q), _round_up(nt, BLOCK_T)
    qn = jnp.sum(q * q, axis=-1)
    t = jnp.pad(t, ((0, 0), (0, nt_p - nt), (0, 0)))
    col = jnp.arange(nt_p)[None, :]
    tn = jnp.where(col < n[:, None], jnp.sum(t * t, axis=-1), _POISON)
    qa = jnp.concatenate([-2.0 * q, jnp.ones((bsz, nq, 1), jnp.float32)],
                         axis=-1)
    qa = jnp.pad(qa, ((0, 0), (0, nq_p - nq), (0, FEAT - d - 1)))
    ta = jnp.concatenate([t, tn[..., None]], axis=-1)
    ta = jnp.pad(ta, ((0, 0), (0, 0), (0, FEAT - d - 1)))
    return qa, jnp.swapaxes(ta, 1, 2), qn, n


@functools.partial(jax.jit, static_argnames=("interpret",))
def nn_argmin_batched(queries, targets, n_targets, *,
                      interpret: bool = False):
    """Batched exact 1-NN: queries [B,Nq,D], targets [B,Nt,D], n_targets
    [B] int32 -> (idx [B,Nq] int32, d2 [B,Nq]).

    Same contract as ``vmap(knn.nn_argmin_xla)`` (a query with no valid
    target gets idx 0, d2 ``_BIG``).  ``interpret=True`` runs the kernel
    in the Pallas interpreter (CPU tests)."""
    bsz, nq, _ = queries.shape
    qa, ta, qn, n = _augment(queries, targets, n_targets)
    idx, s = pl.pallas_call(
        _nn_kernel,
        grid=(bsz, qa.shape[1] // BLOCK_Q),
        in_specs=[
            pl.BlockSpec((None,), lambda b, i: (b,)),
            pl.BlockSpec((None, BLOCK_Q, FEAT), lambda b, i: (b, i, 0)),
            pl.BlockSpec((None, FEAT, ta.shape[2]),
                         lambda b, i: (b, 0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((None, BLOCK_Q), lambda b, i: (b, i)),
            pl.BlockSpec((None, BLOCK_Q), lambda b, i: (b, i)),
        ],
        out_shape=[jax.ShapeDtypeStruct(qa.shape[:2], jnp.int32),
                   jax.ShapeDtypeStruct(qa.shape[:2], jnp.float32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="nn_argmin_batched",
    )(n, qa, ta)
    s = s[:, :nq]
    d2 = jnp.where(n[:, None] > 0, qn + s, _BIG)
    return idx[:, :nq], d2.astype(queries.dtype)
