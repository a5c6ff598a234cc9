import numpy as np

from se3_icp.utils import ply


def test_read_golden_fixture(golden_dir):
    src = ply.read_ply(f"{golden_dir}/source.ply").points
    tgt = ply.read_ply(f"{golden_dir}/target.ply").points
    T_gt = ply.read_transform_txt(f"{golden_dir}/transformation_gt.txt")
    assert src.shape == (4167, 3)
    assert tgt.shape == (4167, 3)
    # GT fixture: R = rot_3d(pi/9, pi/8, -pi/7), t = (1,2,3)
    # (examples/create_and_save_reg_problem.cpp:31-35)
    np.testing.assert_allclose(T_gt[:3, 3], [1.0, 2.0, 3.0])
    np.testing.assert_allclose(T_gt[3], [0, 0, 0, 1])
    # target = T_gt * source, through the PLY round trip
    mapped = src @ T_gt[:3, :3].T + T_gt[:3, 3]
    np.testing.assert_allclose(mapped, tgt, atol=1e-5)


def test_read_bunny_with_faces(tmp_path):
    """A binary PLY laid out like stanford_bunny.ply: float vertices
    followed by a variable-stride face list (skipped by the reader)."""
    from se3_icp.datasets import standin
    pts = standin.bunny_standin().astype("<f4")
    faces = np.arange(3 * 1000, dtype="<i4").reshape(-1, 3) % len(pts)
    p = tmp_path / "bunny.ply"
    with open(p, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(pts)}\nproperty float x\n"
                 f"property float y\nproperty float z\n"
                 f"element face {len(faces)}\n"
                 f"property list uchar int vertex_indices\n"
                 f"end_header\n").encode())
        f.write(pts.tobytes())
        for tri in faces:
            f.write(np.uint8(3).tobytes() + tri.tobytes())
    cloud = ply.read_ply(p)
    assert cloud.points.shape == (208353, 3)
    np.testing.assert_array_equal(cloud.points, pts.astype(np.float64))


def test_write_read_roundtrip(tmp_path, rng):
    pts = rng.normal(size=(100, 3))
    nrm = rng.normal(size=(100, 3))
    p = tmp_path / "c.ply"
    ply.write_ply(p, ply.PointCloud(points=pts, normals=nrm))
    back = ply.read_ply(p)
    np.testing.assert_allclose(back.points, pts)
    np.testing.assert_allclose(back.normals, nrm)
    # float roundtrip
    ply.write_ply(p, pts, dtype="float")
    back32 = ply.read_ply(p)
    np.testing.assert_allclose(back32.points, pts.astype(np.float32))


def test_transform_txt_roundtrip(tmp_path, golden_dir):
    T = ply.read_transform_txt(f"{golden_dir}/transformation_gt.txt")
    assert T.shape == (4, 4)
    p = tmp_path / "t.txt"
    np.savetxt(p, T[:3])  # 3x4 form
    T2 = ply.read_transform_txt(p)
    np.testing.assert_allclose(T2, T, atol=1e-12)


def test_trajectory_12col_roundtrip(tmp_path, rng):
    mats = np.tile(np.eye(4), (5, 1, 1))
    mats[:, :3, :4] = rng.normal(size=(5, 3, 4))
    p = tmp_path / "traj.txt"
    ply.write_trajectory_12col(p, mats)
    back = ply.read_trajectory_12col(p)
    np.testing.assert_allclose(back, mats, atol=1e-9)


def test_redwood_log_roundtrip(tmp_path, rng):
    ids = np.array([[0, 1, 2], [1, 2, 3]])
    mats = np.tile(np.eye(4), (2, 1, 1))
    mats[:, :3, 3] = rng.normal(size=(2, 3))
    p = tmp_path / "traj.log"
    ply.write_redwood_log(p, ids, mats)
    ids2, mats2 = ply.read_redwood_log(p)
    np.testing.assert_array_equal(ids2, ids)
    np.testing.assert_allclose(mats2, mats, atol=1e-8)


def test_voxel_downsample():
    from se3_icp.datasets import synthetic

    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, size=(5000, 3))
    out = synthetic.voxel_downsample(pts, 0.25)
    # 4x4x4 grid fully occupied at this density
    assert out.shape == (64, 3)
    # each centroid lies inside its voxel
    idx = np.floor((out - pts.min(axis=0)) / 0.25)
    assert (idx >= 0).all() and (idx <= 3).all()
    # centroid property: mean of all points is preserved under
    # count-weighted recombination
    counts = []
    for v in idx:
        sel = np.all(np.floor((pts - pts.min(axis=0)) / 0.25) == v, axis=1)
        counts.append(sel.sum())
        np.testing.assert_allclose(out[len(counts)-1], pts[sel].mean(axis=0))
    assert sum(counts) == len(pts)
    import pytest
    with pytest.raises(ValueError):
        synthetic.voxel_downsample(pts, 0.0)


def test_native_io_builds_and_matches_fallback(tmp_path, golden_dir):
    """The C++ host-IO library auto-builds on first use (fresh checkouts
    have no .so) and reads byte-identically to the numpy fallback."""
    import subprocess
    import sys

    code = r'''
import sys, os, numpy as np
sys.path.insert(0, sys.argv[1])
from se3_icp.utils import native, ply
assert native.available(), "native lib did not auto-build"
p = sys.argv[2]
a = ply.read_ply(p).points
os.environ["SE3_ICP_NO_NATIVE"] = "1"
import importlib; importlib.reload(native)
b = ply.read_ply(p).points
assert np.array_equal(a, b), "native vs fallback mismatch"
print("NATIVE_OK")
'''
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    so = os.path.join(repo, "native", "libse3io.so")
    # exercise the auto-build: remove the artifact first
    if os.path.exists(so):
        os.remove(so)
    ply_path = os.path.join(golden_dir, "source.ply")
    out = subprocess.run([sys.executable, "-c", code, repo, ply_path],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NATIVE_OK" in out.stdout
    assert os.path.exists(so)


def test_read_velodyne_bin_and_voxel(tmp_path):
    """Raw KITTI velodyne ingestion: .bin rows are
    little-endian float32 (x, y, z, reflectance); voxel downsampling
    returns per-voxel centroids (Open3D VoxelDownSample semantics)."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, size=(500, 3)).astype(np.float32)
    raw = np.concatenate(
        [pts, rng.uniform(0, 1, size=(500, 1)).astype(np.float32)],
        axis=1)
    path = tmp_path / "000000.bin"
    raw.astype("<f4").tofile(path)
    got = ply.read_velodyne_bin(path)
    np.testing.assert_allclose(got, pts.astype(np.float64), atol=0)

    down = ply.voxel_downsample(got, 2.5)
    assert 0 < len(down) < len(got)
    # every centroid equals the mean of its voxel's members
    keys = np.floor((got - got.min(0)) / 2.5).astype(np.int64)
    kd = np.floor((down - got.min(0)) / 2.5).astype(np.int64)
    for i in range(min(20, len(down))):
        members = got[(keys == kd[i]).all(axis=1)]
        np.testing.assert_allclose(down[i], members.mean(0), atol=1e-9)


def test_load_kitti_raw_velodyne_bundle(tmp_path):
    """A raw full-rate odometry bundle (velodyne/%06d.bin + full-rate
    07.txt) runs through load_kitti unmodified: poses pair line-for-
    line with scans (NOT every-other-line, which is the step-2 PLY
    bundle's convention), and step=2 strides scans directly."""
    from scipy.spatial.transform import Rotation

    from se3_icp.bench import kitti_bench

    rng = np.random.default_rng(1)
    vdir = tmp_path / "sequences" / "07" / "velodyne"
    vdir.mkdir(parents=True)
    n_scans, poses = 5, []
    for i in range(n_scans):
        pts = rng.uniform(-5, 5, size=(300, 3)).astype(np.float32)
        pts[0] = (float(i), 0.0, 0.0)  # marker row identifies scan i
        raw = np.concatenate([pts, np.zeros((300, 1), np.float32)], 1)
        raw.astype("<f4").tofile(vdir / f"{i:06d}.bin")
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("z", 0.01 * i).as_matrix()
        T[:3, 3] = (1.0 * i, 0.1 * i, 0.0)
        poses.append(T)
    (tmp_path / "poses").mkdir()
    ply.write_trajectory_12col(tmp_path / "poses" / "07.txt",
                               np.asarray(poses))

    clouds, got_poses = kitti_bench.load_kitti(str(tmp_path),
                                               max_index=10, step=1)
    assert len(clouds) == n_scans and len(got_poses) == n_scans
    for i in range(n_scans):
        assert clouds[i][0][0] == float(i)          # scan i <-> pose i
        np.testing.assert_allclose(got_poses[i], poses[i], atol=1e-8)

    # step=2 over raw scans: scans 0, 2, 4 paired with poses 0, 2, 4
    clouds2, poses2 = kitti_bench.load_kitti(str(tmp_path),
                                             max_index=10, step=2)
    assert len(clouds2) == 3
    assert [c[0][0] for c in clouds2] == [0.0, 2.0, 4.0]
    np.testing.assert_allclose(poses2[1], poses[2], atol=1e-8)

    # voxel path produces smaller clouds
    clouds3, _ = kitti_bench.load_kitti(str(tmp_path), max_index=2,
                                        step=1, voxel=2.0)
    assert len(clouds3[0]) < 300
