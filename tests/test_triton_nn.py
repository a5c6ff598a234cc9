"""The batched 1-NN Triton kernel (``ops/triton_nn.py``) on the CPU.

The kernel runs here in the Pallas interpreter (``interpret=True``) and
is checked against ``knn.nn_argmin_xla`` and a float64 oracle; its
lowering for CUDA is checked without a card (the Triton IR is built at
lowering time).  On the card, ``gpu_tests/`` and ``chip_smoke.py``
check the compiled kernel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from se3_icp.ops import knn, triton_nn
from se3_icp.utils.config import RegistrationConfig

interp_nn = functools.partial(triton_nn.nn_argmin_batched, interpret=True)


def _oracle(q, t, n):
    """float64 brute force: (idx, d2) per query, ties to the lower index."""
    d2 = ((q[:, :, None, :].astype(np.float64)
           - t[:, None, :, :].astype(np.float64)) ** 2).sum(-1)
    col = np.arange(t.shape[1])
    d2 = np.where(col[None, None, :] < n[:, None, None], d2, np.inf)
    return d2.argmin(-1), d2.min(-1), d2


def _check(q, t, n, idx, d2):
    """idx is exact up to float32 resolution of the distance: the chosen
    target's float64 distance is within 1e-6 (|q|^2 + max|t|^2) of the
    float64 minimum."""
    ref_i, ref_d, full = _oracle(q, t, n)
    idx = np.asarray(idx)
    chosen = np.take_along_axis(full, idx[..., None], -1)[..., 0]
    scale = (q.astype(np.float64) ** 2).sum(-1) + (
        t.astype(np.float64) ** 2).sum(-1).max(-1, keepdims=True)
    assert (idx < n[:, None]).all()
    assert (chosen - ref_d <= 1e-6 * scale).all()
    np.testing.assert_allclose(np.asarray(d2, np.float64), ref_d,
                               atol=float(2e-6 * scale.max()))


@pytest.mark.parametrize("d", [3, 12])
@pytest.mark.parametrize("nq,nt,n_valid", [(100, 170, (150, 170)),
                                           (64, 64, (64, 1)),
                                           (130, 300, (257, 64))])
def test_kernel_matches_xla_and_oracle(rng, d, nq, nt, n_valid):
    """Ragged (non-block-multiple) sizes, padded ``n_targets`` and the
    tail tile's mask, against XLA and the float64 oracle."""
    q = rng.normal(size=(2, nq, d)).astype(np.float32)
    t = rng.normal(size=(2, nt, d)).astype(np.float32)
    n = np.asarray(n_valid, np.int32)
    idx, d2 = interp_nn(q, t, n)
    assert idx.shape == (2, nq) and idx.dtype == jnp.int32
    assert d2.shape == (2, nq)
    _check(q, t, n, idx, d2)
    xi, xd = jax.vmap(knn.nn_argmin_xla)(q, t, n)
    agree = np.mean(np.asarray(idx) == np.asarray(xi))
    assert agree > 0.999, agree
    np.testing.assert_allclose(np.asarray(d2), np.asarray(xd), atol=1e-4)


def test_kernel_ties_go_to_lower_index():
    """Exact duplicates in different tiles and in the same tile: the
    lowest index wins, like jnp.argmin."""
    t = np.zeros((1, 200, 3), np.float32)
    t[0, :, 0] = np.arange(200, dtype=np.float32) + 10.0
    t[0, 5] = t[0, 70] = t[0, 150] = (1.0, 0.0, 0.0)   # 3 tiles
    t[0, 9] = t[0, 8] = (2.0, 0.0, 0.0)                 # same tile
    q = np.asarray([[[1.0, 0.0, 0.0], [2.0, 0.0, 0.0]]], np.float32)
    idx, d2 = interp_nn(q, t, np.asarray([200], np.int32))
    assert np.asarray(idx).tolist() == [[5, 8]]
    assert np.asarray(d2).tolist() == [[0.0, 0.0]]


def test_kernel_no_valid_targets_matches_xla():
    q = np.ones((1, 8, 3), np.float32)
    t = np.ones((1, 64, 3), np.float32)
    n = np.asarray([0], np.int32)
    idx, d2 = interp_nn(q, t, n)
    xi, xd = jax.vmap(knn.nn_argmin_xla)(q, t, n)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(xi))
    np.testing.assert_array_equal(np.asarray(d2), np.asarray(xd))


@pytest.fixture()
def pinned_kernel(monkeypatch):
    """Route the engine's batched 1-NN through the interpreted kernel."""
    monkeypatch.setattr(knn, "_BATCHED_NN", interp_nn)
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_nn_match_under_vmap_in_jit(rng, pinned_kernel):
    """``nn_match`` under vmap inside jit takes the kernel route and
    returns matched == payload[idx]."""
    q = rng.normal(size=(3, 90, 12)).astype(np.float32)
    t = rng.normal(size=(3, 140, 12)).astype(np.float32)
    p = rng.normal(size=(3, 140, 7)).astype(np.float32)
    n = np.asarray([140, 99, 1], np.int32)
    idx, d2, matched = jax.jit(jax.vmap(knn.nn_match))(q, t, p, n)
    _check(q, t, n, idx, d2)
    np.testing.assert_array_equal(
        np.asarray(matched),
        np.take_along_axis(p, np.asarray(idx)[:, :, None], 1))


def test_kernel_inside_while_loop(rng, pinned_kernel):
    """The kernel traced inside a vmapped lax.while_loop body (the
    engine's loop structure) gives the same matches as XLA."""
    q = rng.normal(size=(2, 70, 3)).astype(np.float32)
    t = rng.normal(size=(2, 100, 3)).astype(np.float32)
    p = t.copy()
    n = np.asarray([100, 80], np.int32)

    def one(qi, ti, pi, ni):
        def body(c):
            k, x, _ = c
            _, _, m = knn.nn_match(x, ti, pi, ni)
            return k + 1, 0.5 * (x + m), m
        return jax.lax.while_loop(lambda c: c[0] < 3, body,
                                  (0, qi, jnp.zeros_like(qi)))[2]

    got = jax.jit(jax.vmap(one))(q, t, p, n)
    knn._BATCHED_NN = jax.vmap(knn.nn_argmin_xla)
    jax.clear_caches()
    ref = jax.jit(jax.vmap(one))(q, t, p, n)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-6)


def test_engine_with_kernel_matches_xla_route(rng, pinned_kernel):
    """A small batched se3_pt2pl registration through the kernel route
    reproduces the XLA route (same iterations, same transforms)."""
    from se3_icp.parallel import pairs as par
    from scipy.spatial.transform import Rotation

    cfg = RegistrationConfig(number_of_nn_for_lrf=12, normals_knn=4,
                             max_num_iterations=8,
                             max_num_se3_iterations=3)
    pairs = []
    for i in range(2):
        src = rng.normal(size=(150, 3))
        R = Rotation.from_euler("xyz", [0.1, -0.05, 0.2 + i]).as_matrix()
        pairs.append((src, src @ R.T + (0.1, 0.0, -0.1)))
    src, ns, tgt, nt = (jnp.asarray(x) for x in par.pack_pairs(pairs))
    got = par.register_batch(src, ns, tgt, nt, cfg, "se3_pt2pl")
    knn._BATCHED_NN = None
    par._compiled_batch.cache_clear()
    jax.clear_caches()
    ref = par.register_batch(src, ns, tgt, nt, cfg, "se3_pt2pl")
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               atol=1e-5)


def test_route_by_platform(monkeypatch):
    """Unpinned, the batched route is chosen by platform: the Triton
    kernel on GPU, vmapped XLA elsewhere; a pin wins on any platform."""
    monkeypatch.setattr(knn, "_BATCHED_NN", None)
    assert knn.batched_nn() is not triton_nn.nn_argmin_batched
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert knn.batched_nn() is triton_nn.nn_argmin_batched
    pin = jax.vmap(knn.nn_argmin_xla)
    monkeypatch.setattr(knn, "_BATCHED_NN", pin)
    assert knn.batched_nn() is pin


@pytest.mark.parametrize("bsz,n,d", [(64, 4608, 12), (8, 15360, 12),
                                     (64, 4608, 3)])
def test_kernel_lowers_for_cuda(bsz, n, d):
    """At the bench's widths the kernel passes Pallas' Triton lowering
    (power-of-two blocks, supported ops) without a card: the jitted
    wrapper lowers to one Triton custom call with the expected grid."""
    spec = jax.ShapeDtypeStruct
    lowered = jax.jit(triton_nn.nn_argmin_batched).trace(
        spec((bsz, n, d), jnp.float32), spec((bsz, n, d), jnp.float32),
        spec((bsz,), jnp.int32)).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert text.count("xla.gpu.triton") == 1
    assert f"grid_x = {bsz} : i32" in text
    assert f"grid_y = {n // triton_nn.BLOCK_Q} : i32" in text
