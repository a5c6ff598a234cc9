import numpy as np
import jax.numpy as jnp
from scipy.spatial import cKDTree
from scipy.spatial.transform import Rotation

from se3_icp.ops import lrf
from se3_icp.utils import metrics, se3
import oracles


def bunny_sample(n=600, seed=0):
    from se3_icp.datasets import standin
    pts = standin.bunny_standin()
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(pts), n, replace=False)
    return pts[idx] * 50.0  # reference scales bunny by 50


def test_toldi_matches_oracle():
    pts = bunny_sample(500)
    k = 30
    rot, origin = lrf.toldi_frames(jnp.asarray(pts), k)
    rot = np.asarray(rot)
    tree = cKDTree(pts)
    for i in range(0, 500, 37):
        T_ref = oracles.toldi_frame_oracle(pts, pts[i], k, tree)
        np.testing.assert_allclose(rot[i], T_ref[:3, :3], atol=1e-7,
                                   err_msg=f"point {i}")
    np.testing.assert_allclose(np.asarray(origin), pts)


def test_toldi_frames_are_rotations():
    pts = bunny_sample(400, seed=1)
    rot, _ = lrf.toldi_frames(jnp.asarray(pts), 90)
    rot = np.asarray(rot)
    np.testing.assert_allclose(
        np.einsum("nij,nik->njk", rot, rot),
        np.tile(np.eye(3), (400, 1, 1)), atol=1e-9)
    np.testing.assert_allclose(np.linalg.det(rot), 1.0, atol=1e-9)


def test_toldi_rotation_equivariance_fixed_neighborhoods():
    """LRF(R p) == R * LRF(p) with fixed kNN index sets.

    Isolates the frame math from kNN rank swaps.  Pure rotation only:
    the reference's centroid off-by-one makes its TOLDI covariance
    NOT translation-invariant (see lrf.py docstring), so rigid
    equivariance holds only in ``exact_centroid`` mode (next test)."""
    from se3_icp.ops import knn
    pts = bunny_sample(500, seed=2)
    R = Rotation.from_euler("xyz", [0.4, -0.3, 1.1]).as_matrix()
    pts2 = pts @ R.T
    idx, _ = knn.knn_self(jnp.asarray(pts), 60)
    rot1, _ = lrf.toldi_frames_from_neighbors(jnp.asarray(pts), idx)
    rot2, _ = lrf.toldi_frames_from_neighbors(jnp.asarray(pts2), idx)
    err = metrics.angular_error_so3_alt(
        jnp.asarray(R) @ jnp.asarray(rot1), rot2)
    assert float(jnp.max(err)) < 1e-4


def test_toldi_rigid_equivariance_exact_centroid():
    """Full rigid (R, t) equivariance holds with the corrected centroid
    divisor (exact_centroid=True)."""
    from se3_icp.ops import knn
    pts = bunny_sample(500, seed=2)
    R = Rotation.from_euler("xyz", [0.4, -0.3, 1.1]).as_matrix()
    t = np.array([1.0, -2.0, 0.5])
    pts2 = pts @ R.T + t
    idx, _ = knn.knn_self(jnp.asarray(pts), 60)
    rot1, _ = lrf.toldi_frames_from_neighbors(jnp.asarray(pts), idx,
                                              exact_centroid=True)
    rot2, _ = lrf.toldi_frames_from_neighbors(jnp.asarray(pts2), idx,
                                              exact_centroid=True)
    err = metrics.angular_error_so3_alt(
        jnp.asarray(R) @ jnp.asarray(rot1), rot2)
    assert float(jnp.max(err)) < 1e-4


def test_toldi_lrf_quality_between_clouds(golden_problem):
    """LRF quality on the golden pair via the reference's own oracle
    (cc::evaluate_LRF_quality, ref:cc:63-114).  The golden clouds are the
    *same* physical points, so error comes only from kNN rank swaps under
    the GT rotation; the bulk of frames must still agree."""
    src, tgt, T_gt = golden_problem
    rot_s, _ = lrf.toldi_frames(jnp.asarray(src), 90)
    rot_t, _ = lrf.toldi_frames(jnp.asarray(tgt), 90)
    # GT correspondences (cc::compute_corrs_with_gt, ref:cc:116-143)
    src_t = src @ T_gt[:3, :3].T + T_gt[:3, 3]
    _, nn = cKDTree(tgt).query(src_t, k=1)
    err = np.asarray(metrics.angular_error_so3_alt(
        jnp.asarray(T_gt[:3, :3]) @ jnp.asarray(rot_s),
        jnp.asarray(rot_t)[nn]))
    assert np.median(err) < 30.0     # bulk agreement (degrees)
    assert np.median(
        np.abs((np.asarray(rot_s)[:, :, 2] @ T_gt[:3, :3].T
                * np.asarray(rot_t)[nn][:, :, 2]).sum(1))) > 0.97


def test_normals_match_oracle():
    pts = bunny_sample(300, seed=3)
    ours = np.asarray(lrf.estimate_normals(jnp.asarray(pts), 30))
    ref = oracles.normals_oracle(pts, 30)
    dots = np.abs(np.einsum("ni,ni->n", ours, ref))
    assert dots.min() > 1 - 1e-8


def test_rotation_from_e1_to_x():
    for x in [np.array([1.0, 0, 0]), np.array([0, 1.0, 0]),
              np.array([0, 0.6, 0.8]), np.array([-1.0, 1e-3, 0]),
              np.array([-0.999, 0.04, 0.0])]:
        x = x / np.linalg.norm(x)
        ours = np.asarray(lrf.rotation_from_e1_to_x(jnp.asarray(x)))
        ref = oracles.rotation_from_e1_to_x_oracle(x)
        np.testing.assert_allclose(ours, ref, atol=1e-12)


def test_gicp_covariances_match_oracle():
    # sample with no normal near |n_x| = 0.99, where the reference's
    # c < -0.99 quirk makes the result depend on the (arbitrary)
    # eigenvector sign; the quirk itself is pinned by
    # test_rotation_from_e1_to_x
    pts = bunny_sample(200, seed=6)
    ours = np.asarray(lrf.gicp_covariances(jnp.asarray(pts), 20, 1e-3))
    ref = oracles.gicp_cov_oracle(pts, 20, 1e-3)
    np.testing.assert_allclose(ours, ref, atol=1e-7)


def test_shot_frames_basic():
    """SHOT LRF sanity: orthonormal right-handed frames; equivariance."""
    pts = bunny_sample(400, seed=5)
    # use a radius that captures a few dozen neighbors
    tree = cKDTree(pts)
    d, _ = tree.query(pts, k=20)
    radius = float(np.median(d[:, -1]))
    rot, _ = lrf.shot_frames(jnp.asarray(pts), radius, max_k=64)
    rot = np.asarray(rot)
    np.testing.assert_allclose(
        np.einsum("nij,nik->njk", rot, rot),
        np.tile(np.eye(3), (400, 1, 1)), atol=1e-8)
    R = Rotation.from_euler("zxy", [0.7, 0.2, -0.4]).as_matrix()
    rot2, _ = lrf.shot_frames(jnp.asarray(pts @ R.T), radius, max_k=64)
    err = metrics.angular_error_so3_alt(jnp.asarray(R) @ jnp.asarray(rot),
                                        rot2)
    assert float(jnp.median(err)) < 0.5


def test_shot_cap_warns_on_truncation():
    """The capped SHOT emulation (shot_exact=False) must surface its
    top-k cap instead of silently truncating dense neighborhoods
   ."""
    import pytest
    from se3_icp.models import registration as reg
    from se3_icp.utils.config import RegistrationConfig

    pts = bunny_sample(300, seed=6)
    tgt = pts + np.float64([0.01, 0.0, 0.0])
    cfg = RegistrationConfig(lrf_method="shot", lrf_radius=10.0,
                             shot_max_k=8, shot_exact=False,
                             max_num_iterations=1,
                             max_num_se3_iterations=1)
    with pytest.warns(RuntimeWarning, match="shot_max_k"):
        reg.register_pair(pts, tgt, "se3_pt2pt", cfg)
    # count helper: a huge radius covers everything -> all truncated
    assert lrf.shot_truncated_count(pts, 1e3, 8) == 300
    assert lrf.shot_truncated_count(pts, 1e-9, 8) == 0


def test_shot_dense_matches_oracle():
    """shot_frames_dense == the literal reference transcription on a
    moderate-density cloud (radius ~ 30-NN)."""
    pts = bunny_sample(300, seed=7)
    tree = cKDTree(pts)
    d, _ = tree.query(pts, k=30)
    radius = float(np.median(d[:, -1]))
    rot, _ = lrf.shot_frames_dense(jnp.asarray(pts), radius)
    ref = np.stack([oracles.shot_frame_oracle(pts, i, radius)
                    for i in range(len(pts))])
    np.testing.assert_allclose(np.asarray(rot), ref, atol=1e-7)


def test_shot_dense_beyond_cap_matches_oracle():
    """Neighborhoods denser than the old top-k cap: the dense route
    reproduces the reference's exact radius semantics where the capped
    emulation truncates."""
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(400, 3))
    radius = 2.0
    assert lrf.shot_truncated_count(pts, radius, 128) > 0, \
        "fixture drifted: should exceed the 128 cap"
    rot, _ = lrf.shot_frames_dense(jnp.asarray(pts), radius)
    ref = np.stack([oracles.shot_frame_oracle(pts, i, radius)
                    for i in range(len(pts))])
    np.testing.assert_allclose(np.asarray(rot), ref, atol=1e-7)


def test_shot_dense_padded_rows_masked():
    """n_valid masks padded rows out of every neighborhood; frames of
    the valid prefix are unchanged by padding."""
    pts = bunny_sample(200, seed=9)
    tree = cKDTree(pts)
    d, _ = tree.query(pts, k=30)
    radius = float(np.median(d[:, -1]))
    rot_plain, _ = lrf.shot_frames_dense(jnp.asarray(pts), radius)
    padded = np.concatenate([pts, np.zeros((56, 3))], 0)
    rot_pad, _ = lrf.shot_frames_dense(jnp.asarray(padded), radius,
                                       n_valid=200)
    np.testing.assert_allclose(np.asarray(rot_pad)[:200],
                               np.asarray(rot_plain), atol=1e-10)


def test_shot_exact_engine_registers():
    """The default SHOT route (shot_exact=True) drives a successful
    registration end-to-end."""
    from se3_icp.datasets import synthetic
    from se3_icp.models import registration as reg
    from se3_icp.utils import metrics_host
    from se3_icp.utils.config import RegistrationConfig

    prob = synthetic.synthetic_problem("easy", 0.002, seed=21)
    cfg = RegistrationConfig(lrf_method="shot", lrf_radius=0.8)
    res = reg.register_pair(prob.source, prob.target, "se3_pt2pl", cfg)
    assert metrics_host.success(prob.T_gt, res.transformation)


def test_toldi_dense_matches_gather():
    """Gather-free (masked-matmul) TOLDI == gather-based TOLDI on exact
    kNN inputs; frames may only differ at rank-set tie boundaries, which
    random clouds do not produce."""
    import jax.numpy as jnp
    from se3_icp.ops import knn, lrf

    rng = np.random.default_rng(3)
    pts = rng.normal(size=(700, 3))
    pts_j = jnp.asarray(pts)
    k = 30
    idx, d2 = knn.knn_self(pts_j, k, None)
    rot_g, org_g = lrf.toldi_frames_from_neighbors(pts_j, idx)
    rot_d, org_d = lrf.toldi_frames_dense(pts_j, d2, None, chunk=256)
    np.testing.assert_allclose(np.asarray(rot_d), np.asarray(rot_g),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(org_d), np.asarray(org_g),
                               atol=0)
    # padded/masked variant agrees on the valid prefix
    n_valid = jnp.asarray(600, jnp.int32)
    idx2, d22 = knn.knn_self(pts_j, k, n_valid)
    rot_g2, _ = lrf.toldi_frames_from_neighbors(pts_j, idx2)
    rot_d2, _ = lrf.toldi_frames_dense(pts_j, d22, n_valid, chunk=256)
    np.testing.assert_allclose(np.asarray(rot_d2)[:600],
                               np.asarray(rot_g2)[:600], atol=1e-9)


def test_normals_covs_dense_match_gather():
    import jax.numpy as jnp
    from se3_icp.ops import knn, lrf

    rng = np.random.default_rng(4)
    pts = jnp.asarray(rng.normal(size=(600, 3)))
    k = 20
    idx, d2 = knn.knn_self(pts, k + 1, None)
    n_g = lrf.normals_from_neighbors(pts, idx[:, :k])
    n_d = lrf.normals_dense(pts, d2, k, None, chunk=256)
    np.testing.assert_allclose(np.asarray(n_d), np.asarray(n_g),
                               atol=1e-9)
    c_g = lrf.gicp_covariances_from_neighbors(pts, idx[:, :k])
    c_d = lrf.gicp_covariances_dense(pts, d2, k, n_valid=None, chunk=256)
    np.testing.assert_allclose(np.asarray(c_d), np.asarray(c_g),
                               atol=1e-9)


def test_toldi_small_cloud_k_exceeds_n():
    """k > n_valid must not overflow the arrow radius (the masked-kNN
    _BIG sentinel squared exceeds f32 max): frames stay finite and the
    se3 pipeline still registers a mild perturbation."""
    import jax.numpy as jnp
    from se3_icp.models import registration as reg
    from se3_icp.ops import knn, lrf
    from se3_icp.utils import metrics_host
    from se3_icp.utils.config import GOLDEN

    rng = np.random.default_rng(0)
    pts = np.zeros((512, 3), np.float32)
    pts[:50] = rng.normal(size=(50, 3))
    n_valid = jnp.asarray(50, jnp.int32)
    _, d2 = knn.knn_self(jnp.asarray(pts), 90, n_valid)
    rot, _ = lrf.toldi_frames_dense(jnp.asarray(pts), d2, n_valid)
    assert np.isfinite(np.asarray(rot)[:50]).all()

    src = pts[:50].astype(np.float64)
    R = np.array([[0.995, -0.0998, 0], [0.0998, 0.995, 0], [0, 0, 1.0]])
    tgt = src @ R.T + [0.1, 0, 0]
    r = reg.register_pair(src, tgt, "se3_pt2pl", GOLDEN)
    assert metrics_host.angular_error_so3(
        r.transformation[:3, :3], R) < 2.0
