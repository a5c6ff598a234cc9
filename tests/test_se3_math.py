import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from se3_icp.utils import se3, metrics


def random_rotations(rng, n):
    return Rotation.random(n, random_state=np.random.RandomState(
        rng.integers(2**31))).as_matrix()


def test_rot_3d_matches_scipy():
    # cc::rot_3d composes yaw*pitch*roll quaternions about Z/Y/X
    # == extrinsic xyz == Rz @ Ry @ Rx  (ref:cc:22-30)
    roll, pitch, yaw = 0.3, -0.7, 1.9
    R = np.asarray(se3.rot_3d(roll, pitch, yaw))
    R_ref = Rotation.from_euler("xyz", [roll, pitch, yaw]).as_matrix()
    np.testing.assert_allclose(R, R_ref, atol=1e-12)


def test_rot_3d_matches_golden_gt(tmp_path):
    # transformation_gt.txt was produced by rot_3d(pi/9, pi/8, -pi/7)
    from se3_icp.utils import ply
    from se3_icp.datasets import standin
    T = ply.read_transform_txt(
        f"{standin.save_golden_problem(str(tmp_path))}/"
        "transformation_gt.txt")
    R = np.asarray(se3.rot_3d(np.pi / 9, np.pi / 8, -np.pi / 7))
    np.testing.assert_allclose(R, T[:3, :3], atol=1e-6)


def test_so3_exp_log_roundtrip(rng):
    w = rng.normal(size=(64, 3))
    w *= (rng.uniform(0.01, 3.1, size=(64, 1)) /
          np.linalg.norm(w, axis=1, keepdims=True))
    R = se3.so3_exp(jnp.asarray(w))
    w2 = np.asarray(se3.so3_log_vee(R))
    np.testing.assert_allclose(w2, w, atol=1e-8)


def test_so3_log_near_pi(rng):
    axes = rng.normal(size=(16, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    for theta in [np.pi - 1e-5, np.pi - 1e-8, np.pi]:
        R = Rotation.from_rotvec(axes * theta).as_matrix()
        w = np.asarray(se3.so3_log_vee(jnp.asarray(R)))
        np.testing.assert_allclose(np.linalg.norm(w, axis=1), theta,
                                   atol=1e-6)
        # direction parity: R(w) == R
        R2 = np.asarray(se3.so3_exp(jnp.asarray(w)))
        np.testing.assert_allclose(R2, R, atol=1e-5)


def test_angular_error_so3(rng):
    R1 = random_rotations(rng, 32)
    R2 = random_rotations(rng, 32)
    ours = np.asarray(metrics.angular_error_so3(R1, R2))
    # oracle: scipy geodesic angle
    rel = Rotation.from_matrix(
        np.einsum("nji,njk->nik", R1, R2))
    oracle = np.degrees(rel.magnitude())
    np.testing.assert_allclose(ours, oracle, atol=1e-6)
    # alt (trace-acos) formula agrees with the geodesic magnitude
    alt = np.asarray(metrics.angular_error_so3_alt(R1, R2))
    np.testing.assert_allclose(alt, oracle, atol=1e-6)


def test_euler_zyx_retract():
    xi = np.array([0.1, -0.2, 0.3, 1.0, 2.0, 3.0])
    T = np.asarray(se3.euler_zyx_retract(jnp.asarray(xi)))
    R_ref = (Rotation.from_euler("z", 0.3).as_matrix()
             @ Rotation.from_euler("y", -0.2).as_matrix()
             @ Rotation.from_euler("x", 0.1).as_matrix())
    np.testing.assert_allclose(T[:3, :3], R_ref, atol=1e-12)
    np.testing.assert_allclose(T[:3, 3], [1, 2, 3])
    np.testing.assert_allclose(T[3], [0, 0, 0, 1])


def test_transform_points_and_inverse(rng):
    R = random_rotations(rng, 1)[0]
    t = rng.normal(size=3)
    T = np.asarray(se3.rt_to_T(R, t))
    pts = rng.normal(size=(50, 3))
    out = np.asarray(se3.transform_points(jnp.asarray(T), jnp.asarray(pts)))
    np.testing.assert_allclose(out, pts @ R.T + t, atol=1e-12)
    Tinv = np.asarray(se3.T_inverse(jnp.asarray(T)))
    np.testing.assert_allclose(Tinv @ T, np.eye(4), atol=1e-12)


def test_rot2euler_yzx_roundtrip(rng):
    # Construct from known YZX Tait-Bryan angles and recover them.
    for _ in range(20):
        bank, attitude, heading = rng.uniform(-1.2, 1.2, size=3)
        R = (Rotation.from_euler("y", heading).as_matrix()
             @ Rotation.from_euler("z", attitude).as_matrix()
             @ Rotation.from_euler("x", bank).as_matrix())
        e = np.asarray(metrics.rot2euler_yzx(jnp.asarray(R)))
        np.testing.assert_allclose(e, [bank, attitude, heading], atol=1e-9)


def test_success_threshold():
    T_gt = np.eye(4)
    T_ok = np.asarray(se3.rt_to_T(
        Rotation.from_euler("z", np.radians(1.5)).as_matrix(),
        np.array([0.1, 0, 0])))
    T_bad_rot = np.asarray(se3.rt_to_T(
        Rotation.from_euler("z", np.radians(2.5)).as_matrix(),
        np.zeros(3)))
    T_bad_tra = np.asarray(se3.rt_to_T(np.eye(3), np.array([0.3, 0, 0])))
    assert bool(metrics.success(T_gt, T_ok))
    assert not bool(metrics.success(T_gt, T_bad_rot))
    assert not bool(metrics.success(T_gt, T_bad_tra))


def test_error_filterreg(rng):
    pts = rng.normal(size=(100, 3))
    T_gt = np.eye(4)
    T_est = np.asarray(se3.rt_to_T(np.eye(3), np.array([1.0, 0, 0])))
    err = float(metrics.error_filterreg(pts, T_gt, T_est))
    np.testing.assert_allclose(err, 1.0, atol=1e-12)


def test_se3_exp_log_roundtrip():
    import jax.numpy as jnp
    from se3_icp.utils import se3

    rng = np.random.default_rng(5)
    for scale in (1e-9, 1e-4, 0.1, 1.0, 3.0):
        xi = rng.normal(scale=scale, size=(8, 6))
        T = se3.se3_exp(jnp.asarray(xi))
        xi2 = se3.se3_log(T)
        T2 = se3.se3_exp(xi2)
        np.testing.assert_allclose(np.asarray(T2), np.asarray(T),
                                   atol=1e-9)
        # valid rigid transforms
        R = np.asarray(T)[:, :3, :3]
        np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                                   np.tile(np.eye(3), (8, 1, 1)),
                                   atol=1e-12)
