import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from se3_icp.ops import solve, trim
import oracles


def _random_problem(rng, n=200):
    src = rng.normal(size=(n, 3))
    R = Rotation.from_euler("xyz", rng.uniform(-0.2, 0.2, 3)).as_matrix()
    t = rng.uniform(-0.1, 0.1, 3)
    tgt = src @ R.T + t + 0.001 * rng.normal(size=(n, 3))
    return src, tgt, R, t


def test_pt2pt_matches_umeyama(rng):
    src, tgt, R, t = _random_problem(rng)
    w = jnp.ones(len(src))
    T = np.asarray(solve.solve_pt2pt(jnp.asarray(src), jnp.asarray(tgt), w))
    T_ref = oracles.umeyama_oracle(src, tgt)
    np.testing.assert_allclose(T, T_ref, atol=1e-9)


def test_pt2pt_masked_equals_subset(rng):
    src, tgt, _, _ = _random_problem(rng)
    mask = rng.uniform(size=len(src)) > 0.4
    T = np.asarray(solve.solve_pt2pt(jnp.asarray(src), jnp.asarray(tgt),
                                     jnp.asarray(mask)))
    T_ref = oracles.umeyama_oracle(src[mask], tgt[mask])
    np.testing.assert_allclose(T, T_ref, atol=1e-9)


def test_pt2pl_matches_oracle(rng):
    src, tgt, _, _ = _random_problem(rng)
    normals = rng.normal(size=tgt.shape)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    w = jnp.ones(len(src))
    T = np.asarray(solve.solve_pt2pl(jnp.asarray(src), jnp.asarray(tgt),
                                     jnp.asarray(normals), w))
    T_ref = oracles.pt2pl_oracle(src, tgt, normals)
    np.testing.assert_allclose(T, T_ref, atol=1e-9)


def test_gicp_matches_oracle(rng):
    src, tgt, _, _ = _random_problem(rng, 100)
    # random PD covariances
    A = rng.normal(size=(100, 3, 3)) * 0.3
    cov_s = np.einsum("nij,nkj->nik", A, A) + 0.05 * np.eye(3)
    B = rng.normal(size=(100, 3, 3)) * 0.3
    cov_t = np.einsum("nij,nkj->nik", B, B) + 0.05 * np.eye(3)
    w = jnp.ones(100)
    T = np.asarray(solve.solve_gicp(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(cov_s),
        jnp.asarray(cov_t), w))
    T_ref = oracles.gicp_oracle(src, tgt, cov_s, cov_t)
    np.testing.assert_allclose(T, T_ref, atol=1e-8)


def test_gicp_confidence_weights(rng):
    src, tgt, _, _ = _random_problem(rng, 80)
    A = rng.normal(size=(80, 3, 3)) * 0.3
    cov_s = np.einsum("nij,nkj->nik", A, A) + 0.05 * np.eye(3)
    cov_t = np.einsum("nij,nkj->nik", A, A) + 0.07 * np.eye(3)
    conf = rng.uniform(0.2, 1.0, 80)
    T = np.asarray(solve.solve_gicp(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(cov_s),
        jnp.asarray(cov_t), jnp.ones(80), jnp.asarray(conf)))
    T_ref = oracles.gicp_oracle(src, tgt, cov_s, cov_t, conf)
    np.testing.assert_allclose(T, T_ref, atol=1e-8)


def test_solvers_recover_small_motion(rng):
    """All three estimators should nail an exact small rigid motion."""
    src = rng.normal(size=(500, 3))
    R = Rotation.from_euler("xyz", [0.02, -0.015, 0.01]).as_matrix()
    t = np.array([0.01, -0.02, 0.005])
    tgt = src @ R.T + t
    w = jnp.ones(500)
    T_pt = np.asarray(solve.solve_pt2pt(jnp.asarray(src), jnp.asarray(tgt), w))
    np.testing.assert_allclose(T_pt[:3, :3], R, atol=1e-9)
    np.testing.assert_allclose(T_pt[:3, 3], t, atol=1e-9)
    normals = rng.normal(size=(500, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    T_pl = np.asarray(solve.solve_pt2pl(jnp.asarray(src), jnp.asarray(tgt),
                                        jnp.asarray(normals), w))
    # linearized + euler retraction: first-order accurate
    np.testing.assert_allclose(T_pl[:3, :3], R, atol=1e-3)
    np.testing.assert_allclose(T_pl[:3, 3], t, atol=1e-3)


def test_singular_solve_returns_identity():
    src = jnp.zeros((10, 3))
    tgt = jnp.zeros((10, 3))
    normals = jnp.zeros((10, 3))
    T = np.asarray(solve.solve_pt2pl(src, tgt, normals, jnp.ones(10)))
    np.testing.assert_allclose(T, np.eye(4))
    T2 = np.asarray(solve.solve_pt2pt(src, tgt, jnp.zeros(10)))
    np.testing.assert_allclose(T2, np.eye(4))


def test_trim_mask_matches_pcl(rng):
    d = rng.uniform(size=501)
    valid = jnp.ones(501, bool)
    for ratio in [0.3, 0.7, 0.75, 0.999]:
        ours = np.asarray(trim.trim_mask(jnp.asarray(d), valid, ratio, 501))
        ref = oracles.trimmed_mask_oracle(d, ratio)
        np.testing.assert_array_equal(ours, ref)
    # ratio 1.0 keeps everything
    np.testing.assert_array_equal(
        np.asarray(trim.trim_mask(jnp.asarray(d), valid, 1.0, 501)),
        np.ones(501, bool))


def test_trim_mask_respects_padding(rng):
    d = rng.uniform(size=100)
    valid = np.arange(100) < 60
    ours = np.asarray(trim.trim_mask(jnp.asarray(d), jnp.asarray(valid),
                                     0.5, 60))
    assert ours.sum() == 30
    assert not ours[60:].any()
    ref = oracles.trimmed_mask_oracle(d[:60], 0.5)
    np.testing.assert_array_equal(ours[:60], ref)
