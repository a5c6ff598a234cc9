import numpy as np
import jax.numpy as jnp
from scipy.spatial import cKDTree

from se3_icp.ops import knn


def test_nn_argmin_matches_kdtree(rng):
    q = rng.normal(size=(700, 3))
    t = rng.normal(size=(900, 3))
    idx, d2 = knn.nn_argmin_xla(jnp.asarray(q), jnp.asarray(t))
    tree = cKDTree(t)
    d_ref, i_ref = tree.query(q, k=1)
    np.testing.assert_array_equal(np.asarray(idx), i_ref)
    np.testing.assert_allclose(np.asarray(d2), d_ref**2, atol=1e-9)


def test_nn_argmin_12d(rng):
    q = rng.normal(size=(300, 12))
    t = rng.normal(size=(450, 12))
    idx, d2 = knn.nn_argmin_xla(jnp.asarray(q), jnp.asarray(t))
    tree = cKDTree(t)
    d_ref, i_ref = tree.query(q, k=1)
    np.testing.assert_array_equal(np.asarray(idx), i_ref)
    np.testing.assert_allclose(np.asarray(d2), d_ref**2, atol=1e-9)


def test_nn_argmin_masked(rng):
    q = rng.normal(size=(100, 3))
    t = rng.normal(size=(200, 3))
    # only the first 120 targets are valid
    idx, d2 = knn.nn_argmin_xla(jnp.asarray(q), jnp.asarray(t),
                                n_targets=120)
    tree = cKDTree(t[:120])
    d_ref, i_ref = tree.query(q, k=1)
    np.testing.assert_array_equal(np.asarray(idx), i_ref)
    np.testing.assert_allclose(np.asarray(d2), d_ref**2, atol=1e-9)


def test_nn_argmin_tie_breaks_low_index():
    t = np.array([[1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0]])  # 0 and 2 equal
    q = np.array([[1.0, 0, 0]])
    idx, _ = knn.nn_argmin_xla(jnp.asarray(q), jnp.asarray(t))
    assert int(idx[0]) == 0


def test_knn_topk_matches_kdtree(rng):
    pts = rng.normal(size=(500, 3))
    k = 90
    idx, d2 = knn.knn_topk(jnp.asarray(pts), jnp.asarray(pts), k)
    tree = cKDTree(pts)
    d_ref, i_ref = tree.query(pts, k=k)
    np.testing.assert_allclose(np.asarray(d2), d_ref**2, atol=1e-9)
    # rank 0 is the point itself
    np.testing.assert_array_equal(np.asarray(idx[:, 0]), np.arange(500))
    # index sets agree (ordering of exact ties may differ)
    assert (np.sort(np.asarray(idx), axis=1)
            == np.sort(i_ref, axis=1)).mean() > 0.999


def test_knn_topk_masked(rng):
    pts = rng.normal(size=(300, 3))
    idx, d2 = knn.knn_topk(jnp.asarray(pts), jnp.asarray(pts), 10,
                           n_targets=150)
    assert int(np.asarray(idx).max()) < 150
    tree = cKDTree(pts[:150])
    d_ref, _ = tree.query(pts, k=10)
    np.testing.assert_allclose(np.asarray(d2), d_ref**2, atol=1e-9)


def test_nn_distances_chamfer(rng):
    from se3_icp.utils import metrics
    a = rng.normal(size=(100, 3))
    b = rng.normal(size=(130, 3))
    cham = float(metrics.chamfer_distance_sq(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = cKDTree(a), cKDTree(b)
    ref = (ta.query(b)[0] ** 2).mean() + (tb.query(a)[0] ** 2).mean()
    np.testing.assert_allclose(cham, ref, atol=1e-9)
