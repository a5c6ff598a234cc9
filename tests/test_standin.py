"""The seeded bunny stand-in and golden problem (datasets/standin.py)."""

import numpy as np
import pytest

from se3_icp.datasets import standin, synthetic
from se3_icp.utils import ply


def test_bunny_standin_deterministic_and_sized():
    a = standin.bunny_standin(0)
    b = standin.bunny_standin(0)
    assert a.shape == (208353, 3) and a.dtype == np.float64
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, standin.bunny_standin(1))
    # bunny-like extents once scaled x50 (the protocols' scale)
    ext = np.ptp(a * 50.0, axis=0)
    assert ((ext > 4.0) & (ext < 12.0)).all(), ext
    # the returned array is a copy: callers cannot corrupt the cache
    a[:] = 0.0
    np.testing.assert_array_equal(standin.bunny_standin(0), b)


def test_bunny_standin_has_no_symmetry():
    """No mirror symmetry through the centroid along any axis: the
    surface's odd terms and bumps make TOLDI frames well defined."""
    pts = standin.bunny_standin() * 50.0
    c = pts - pts.mean(0)
    from scipy.spatial import cKDTree
    tree = cKDTree(c)
    for ax in range(3):
        m = c.copy()
        m[:, ax] *= -1
        d, _ = tree.query(m[::500])
        assert np.median(d) > 0.1, ax


def test_golden_problem_sizes_and_ground_truth():
    src, tgt, T = standin.golden_problem()
    assert src.shape == (4167, 3) and tgt.shape == (4167, 3)
    R_ref = synthetic._rot_3d(np.pi / 9, np.pi / 8, -np.pi / 7)
    np.testing.assert_allclose(T[:3, :3], R_ref, atol=1e-15)
    np.testing.assert_array_equal(T[:3, 3], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(T[3], [0.0, 0.0, 0.0, 1.0])
    np.testing.assert_allclose(src @ T[:3, :3].T + T[:3, 3], tgt,
                               atol=1e-12)
    src2, tgt2, T2 = standin.golden_problem()
    np.testing.assert_array_equal(src, src2)
    np.testing.assert_array_equal(T, T2)
    # the seed picks the 2% sample
    assert not np.array_equal(standin.golden_problem(seed=2)[0], src)


@pytest.mark.parametrize("seed", [1, 5])
def test_save_golden_problem_layout(tmp_path, seed):
    """created_example_reg_problem layout, read back through the PLY and
    transform readers."""
    d = standin.save_golden_problem(str(tmp_path / "g"), seed=seed)
    src, tgt, T = standin.golden_problem(seed)
    np.testing.assert_allclose(ply.read_ply(f"{d}/source.ply").points, src)
    np.testing.assert_allclose(ply.read_ply(f"{d}/target.ply").points, tgt)
    np.testing.assert_allclose(
        ply.read_transform_txt(f"{d}/transformation_gt.txt"), T,
        atol=1e-15)


def test_synthetic_protocols_use_the_standin():
    """Every synthetic protocol samples the stand-in: the noisy protocol
    draws a 2% downsample (4167 points) of bunny x50."""
    p = synthetic.synthetic_problem("easy", 0.0, seed=4)
    assert p.source.shape == (4167, 3)
    tree_pts = standin.bunny_standin() * 50.0
    from scipy.spatial import cKDTree
    d, _ = cKDTree(tree_pts).query(p.source[:100])
    assert d.max() < 1e-9
