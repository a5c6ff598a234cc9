"""Trimmed correspondence rejection as a static-shape rank mask.

Replaces PCL's ``CorrespondenceRejectorTrimmed`` (used at ref:cpp:487-510,
634-671, 846-883, 1044-1071): keep the ``floor(overlap_ratio * N)``
correspondences with the smallest stored distance.  Compaction is
impossible under XLA's static shapes, so the kept subset becomes a 0/1
mask fed to the weight-aware estimators -- mathematically identical.

The mask is a stable argsort + rank compare -- bit-identical to PCL's
selection, ties toward the lower source index.  (A sort-free count
bisection took twice the argsort's time on the GPU at 64x4608 and was
removed; see docs/PERF.md.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_BIG = 3.4e38


def trim_mask(distances, valid, overlap_ratio: float, n_valid):
    """0/1 mask keeping the best floor(ratio * n_valid) valid entries.

    ``overlap_ratio`` is static (config); ``n_valid`` may be traced.
    """
    if overlap_ratio >= 1.0:
        return valid
    count = jnp.floor(overlap_ratio * n_valid).astype(jnp.int32)
    d = jnp.where(valid, distances, jnp.asarray(_BIG, distances.dtype))
    order = jnp.argsort(d, stable=True)
    n = distances.shape[0]
    ranks = jnp.zeros(n, jnp.int32).at[order].set(
        jnp.arange(n, dtype=jnp.int32))
    return (ranks < count) & valid


def masked_mean(values, mask):
    """Mean over masked entries (ref ``estimate_current_mse``,
    ref:cpp:379-387: mean of the stored correspondence distances)."""
    m = mask.astype(values.dtype)
    return jnp.sum(values * m) / jnp.maximum(jnp.sum(m), 1.0)
