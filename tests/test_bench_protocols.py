"""End-to-end protocol tests for the sequence benchmarks, driven on the
synthetic stand-in fixtures that mirror the reference datasets' exact
on-disk layouts (datasets/fixtures.py)."""

import numpy as np
import pytest

from se3_icp.datasets import fixtures


@pytest.fixture(scope="module")
def lounge_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lounge_fix")
    fixtures.make_lounge_fixture(str(d), n_frames=11, n_points=900)
    return str(d)


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kitti_fix")
    fixtures.make_kitti_fixture(str(d), max_index=6, n_points=900)
    return str(d)


def test_lounge_protocol_with_cf(lounge_dir):
    from se3_icp.bench import lounge_bench
    rep = lounge_bench.benchmark_lounge("se3_gicp_with_cf", lounge_dir,
                                        dtype=np.float64)
    assert rep["num_pairs"] == 2  # frames 1..11 -> pairs (1,6),(6,11)
    assert rep["avg_angular_SO3_error"] < 2.0
    assert rep["avg_tra_error"] < 0.25


def test_lounge_loader_gt_convention(lounge_dir):
    """T12 = inv(T2) @ T1 must map source (frame i) onto target (i+5)."""
    from se3_icp.bench import lounge_bench
    pairs, gts = lounge_bench.load_lounge_pairs(lounge_dir)
    src, tgt = pairs[0]
    T12 = gts[0]
    moved = src @ T12[:3, :3].T + T12[:3, 3]
    # frames resample the same scene: NN distance after GT transform is
    # tiny compared to before
    from scipy.spatial import cKDTree
    tree = cKDTree(tgt)
    after = tree.query(moved)[0].mean()
    before = tree.query(src)[0].mean()
    assert after < before * 0.5
    assert after < 0.05


def test_kitti_protocol(kitti_dir):
    from se3_icp.bench import kitti_bench
    rep = kitti_bench.benchmark_kitti("se3_pt2pl", kitti_dir,
                                      dtype=np.float64, max_index=6)
    assert rep["num_pairs"] == 3
    assert rep["mean_rel_rot"] < 2.0
    assert rep["mean_rel_tra"] < 0.25
    assert rep["last_frame_tra_error"] < 0.5


@pytest.fixture(scope="module")
def kitti_hard_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kitti_hard_fix")
    fixtures.make_kitti_fixture(str(d), max_index=6, n_points=1200,
                                hard=True)
    return str(d)


def test_kitti_protocol_hard(kitti_hard_dir):
    """Adversarial LiDAR fixture: ring-pattern
    scans, ~60-80% inter-frame overlap, range-dependent noise, outlier
    clusters, and a moving object.  The trimmed se3_pt2pl protocol must
    still register every pair within the trajectory-quality rule."""
    from se3_icp.bench import kitti_bench
    rep = kitti_bench.benchmark_kitti("se3_pt2pl", kitti_hard_dir,
                                      dtype=np.float64, max_index=6)
    assert rep["num_pairs"] == 3
    assert rep["success_rate"] == 1.0, rep
    assert rep["mean_rel_rot"] < 2.0, rep
    assert rep["mean_rel_tra"] < 0.25, rep


def test_hard_fixture_is_adversarial(kitti_hard_dir):
    """The hard fixture must actually exhibit the adversarial regime:
    partial overlap between consecutive scans and non-trivial outliers
    (guards against the generator silently degrading to the friendly
    resample)."""
    from scipy.spatial import cKDTree
    from se3_icp.bench import kitti_bench
    clouds, poses = kitti_bench.load_kitti(kitti_hard_dir, max_index=6)
    src, tgt = clouds[1], clouds[0]
    T12 = np.linalg.inv(poses[0]) @ poses[1]
    moved = src @ T12[:3, :3].T + T12[:3, 3]
    d = cKDTree(tgt).query(moved)[0]
    inlier = (d < 0.25).mean()
    # genuine partial overlap + ring-resampled surfaces: well below the
    # friendly fixture's ~1.0 point-identity overlap, but enough shared
    # structure for the 0.7-overlap trim to work (ground rings at
    # different ranges between frames depress this point-NN measure
    # below the true surface overlap)
    assert 0.3 < inlier < 0.9, inlier


def test_lounge_protocol_hard(tmp_path_factory):
    from se3_icp.bench import lounge_bench
    d = str(tmp_path_factory.mktemp("lounge_hard_fix"))
    fixtures.make_lounge_fixture(d, n_frames=11, n_points=900, hard=True)
    rep = lounge_bench.benchmark_lounge("se3_gicp_with_cf", d,
                                        dtype=np.float64)
    assert rep["num_pairs"] == 2
    assert rep["avg_angular_SO3_error"] < 2.0
    assert rep["avg_tra_error"] < 0.25


def test_kitti_every_other_pose_line(kitti_dir):
    """07.txt has one row per raw frame; the loader must keep every
    other row so poses align with the step-2 clouds
    (benchmark_kitti.cpp:79-98)."""
    import os
    from se3_icp.bench import kitti_bench
    from se3_icp.utils import ply
    clouds, poses = kitti_bench.load_kitti(kitti_dir, max_index=6)
    raw = ply.read_trajectory_12col(
        os.path.join(kitti_dir, "Sequence_07", "07.txt"))
    assert len(clouds) == 4
    np.testing.assert_allclose(poses[1], raw[2])


def test_kitti_online_odometry(kitti_dir):
    """Online mode (serial, constant-velocity warm start from the
    previous pair) matches the batched protocol's accuracy and cuts
    iterations on the warm-started frames (plain pt2pl skips the
    SE(3) basin search entirely when warm)."""
    from se3_icp.bench import kitti_bench
    online = kitti_bench.benchmark_kitti("pt2pl", kitti_dir,
                                         dtype=np.float64, max_index=6,
                                         online=True)
    cold = kitti_bench.benchmark_kitti("pt2pl", kitti_dir,
                                       dtype=np.float64, max_index=6)
    assert online["online"] and not cold["online"]
    assert online["num_pairs"] == 3
    assert online["mean_rel_rot"] < 2.0
    assert online["mean_rel_tra"] < 0.25
    assert online["mean_iterations"] <= cold["mean_iterations"]


def test_kitti_analyze(kitti_dir):
    """Dormant KITTI difficulty + Chamfer analyses
    (benchmark_kitti.cpp:395-585): GT alignment must cut the NN
    distance, and the top-70% trim must suppress the non-overlap tail."""
    from se3_icp.bench import kitti_bench
    rep = kitti_bench.analyze_kitti(kitti_dir, max_index=6)
    assert rep["num_pairs"] == 3
    assert (rep["avg_point_cloud_distance"]
            < 0.5 * rep["avg_starting_distance"])
    assert (rep["avg_point_cloud_distance_top70"]
            < rep["avg_point_cloud_distance"])
    assert rep["avg_chamfer_distance"] > 0.0


def test_alpha_sweeps_short_grid(kitti_dir, lounge_dir, monkeypatch):
    """The dormant rot-scale sweeps (kitti_alpha_sweep /
    lounge_alpha_sweep) run the protocol per alpha; a short grid keeps
    CI fast -- the full hybrid grid shares the same compiled program
    (traced float)."""
    from se3_icp.bench import common, kitti_bench, lounge_bench
    monkeypatch.setattr(common, "hybrid_alpha_grid",
                        lambda: [3.0, 100.0])
    reps_k = kitti_bench.kitti_alpha_sweep("se3_pt2pl", kitti_dir,
                                           max_index=6,
                                           dtype=np.float64)
    assert len(reps_k) == 2
    assert all(r["success_rate"] == 1.0 for r in reps_k)
    reps_l = lounge_bench.lounge_alpha_sweep("se3_pt2pl", lounge_dir,
                                             dtype=np.float64)
    assert len(reps_l) == 2
    assert all(r["avg_angular_SO3_error"] < 2.0 for r in reps_l)
