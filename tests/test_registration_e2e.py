"""End-to-end registration tests.

The reference's own test strategy (SURVEY.md §4): solve committed /
protocol-defined problems and check the <=2 deg / <=0.25 success bounds
(benchmark_synthetic.cpp:410-413)."""

import numpy as np
import jax.numpy as jnp
import pytest

from se3_icp.models import registration as reg
from se3_icp.utils import metrics
from se3_icp.utils.config import GOLDEN, RegistrationConfig
from se3_icp.datasets import synthetic


def _errors(T_est, T_gt):
    so3 = float(metrics.angular_error_so3(T_est[:3, :3], T_gt[:3, :3]))
    tra = float(np.linalg.norm(T_est[:3, 3] - T_gt[:3, 3]))
    return so3, tra


ALL_ALGS = ["pt2pt", "pt2pl", "gicp", "se3_pt2pt", "se3_pt2pl", "se3_gicp"]


@pytest.mark.parametrize("alg", ALL_ALGS)
def test_golden_problem(golden_problem, alg):
    """run_registration_method protocol on the committed fixture
    (examples/run_registration_method.cpp)."""
    src, tgt, T_gt = golden_problem
    res = reg.register_pair(src, tgt, alg, GOLDEN, dtype=jnp.float64)
    so3, tra = _errors(res.transformation, T_gt)
    assert so3 <= 2.0 and tra <= 0.25, (alg, so3, tra)
    # identical point sets: should converge essentially exactly
    assert so3 < 0.01 and tra < 0.01, (alg, so3, tra)


def test_golden_problem_float32(golden_problem):
    """Serving dtype (float32): still well inside the success bounds."""
    src, tgt, T_gt = golden_problem
    res = reg.register_pair(src, tgt, "se3_pt2pl", GOLDEN,
                            dtype=jnp.float32)
    so3, tra = _errors(res.transformation, T_gt)
    assert so3 < 0.05 and tra < 0.01, (so3, tra)


@pytest.mark.parametrize("alg", ["se3_pt2pl", "se3_gicp"])
def test_synthetic_moderate(alg):
    """Noisy moderate-difficulty protocol (benchmark_synthetic.cpp):
    independent downsample + gaussian noise."""
    prob = synthetic.synthetic_problem("moderate", 0.005, seed=3)
    res = reg.register_pair(prob.source, prob.target, alg, GOLDEN,
                            dtype=jnp.float64)
    so3, tra = _errors(res.transformation, prob.T_gt)
    assert so3 <= 2.0 and tra <= 0.25, (alg, so3, tra)


def test_se3_pure_converges():
    """run_se3_pure with small alpha (docstring at ref:cpp:963-971)."""
    prob = synthetic.golden_like_problem(seed=2)
    cfg = GOLDEN.replace(alpha_rot=0.1, max_num_se3_iterations=30)
    res = reg.register_pair(prob.source, prob.target, "se3_pure_pt2pl",
                            cfg, dtype=jnp.float64)
    so3, tra = _errors(res.transformation, prob.T_gt)
    assert so3 <= 2.0 and tra <= 0.25, (so3, tra)
    assert res.num_pure_se3_iterations == res.num_iterations


def test_se3_gicp_with_cf():
    """Confidence-weighted GICP variant: depth-shifted cloud so the
    lounge confidence model (ref:cpp:16-30) yields sane weights."""
    prob = synthetic.golden_like_problem(seed=4)
    # put the cloud into a plausible RGB-D depth range (meters)
    src = prob.source * 0.1
    src[:, 2] += 2.0
    T = prob.T_gt.copy()
    T[:3, 3] *= 0.1
    tgt = src @ T[:3, :3].T + T[:3, 3]
    cfg = GOLDEN.replace(estimated_overlap=0.75)
    res = reg.register_pair(src, tgt, "se3_gicp_with_cf", cfg,
                            dtype=jnp.float64)
    so3, tra = _errors(res.transformation, T)
    assert so3 <= 2.0 and tra <= 0.25, (so3, tra)


def test_iteration_caps_respected():
    prob = synthetic.synthetic_problem("difficult", 0.02, seed=5)
    cfg = RegistrationConfig(max_num_iterations=7, max_num_se3_iterations=3,
                             number_of_nn_for_lrf=30)
    res = reg.register_pair(prob.source, prob.target, "se3_pt2pt", cfg,
                            dtype=jnp.float64)
    assert res.num_iterations <= 7
    assert res.num_pure_se3_iterations <= 3
    res2 = reg.register_pair(prob.source, prob.target, "se3_pure_pt2pt",
                             cfg, dtype=jnp.float64)
    assert res2.num_iterations <= 3


def test_trimmed_overlap_partial_clouds():
    """Partial overlap: crop half the target; trimming should still
    recover the motion."""
    prob = synthetic.golden_like_problem(seed=6)
    src = prob.source
    # target keeps only points with x below the median (≈50% overlap is
    # too harsh; keep 75%)
    tgt_full = prob.target
    thresh = np.quantile(tgt_full[:, 0], 0.75)
    tgt = tgt_full[tgt_full[:, 0] < thresh]
    cfg = GOLDEN.replace(estimated_overlap=0.7)
    res = reg.register_pair(src, tgt, "se3_pt2pl", cfg, dtype=jnp.float64)
    so3, tra = _errors(res.transformation, prob.T_gt)
    assert so3 <= 2.0 and tra <= 0.25, (so3, tra)


def test_invalid_algorithm_name():
    with pytest.raises(ValueError, match="Not a valid algorithm name"):
        reg.register_pair(np.zeros((10, 3)), np.zeros((10, 3)), "nope")


def test_padding_invariance(golden_problem):
    """Result must not depend on the padded bucket size."""
    src, tgt, T_gt = golden_problem
    r1 = reg.register_pair(src, tgt, "se3_pt2pl", GOLDEN,
                           dtype=jnp.float64)
    # force a different bucket by appending far-away dummy rows that are
    # excluded via n_valid (register_pair pads internally; emulate by
    # slicing a prefix so bucket changes: 4167 -> pads 4608; use 4000)
    r2 = reg.register_pair(src[:4000], tgt, "se3_pt2pl", GOLDEN,
                           dtype=jnp.float64)
    # both should solve the problem
    for r in (r1, r2):
        so3, tra = _errors(r.transformation, T_gt)
        assert so3 < 0.05 and tra < 0.05


def test_degenerate_iteration_caps_terminate():
    """max_num_iterations <= max_num_se3_iterations (or 1) must still
    terminate: the on-device while_loop uses >= stop tests, since a
    masked batched loop can step past an == threshold and never
    stop)."""
    import numpy as np
    from se3_icp.models import registration as reg
    from se3_icp.utils.config import GOLDEN

    rng = np.random.default_rng(0)
    src = rng.normal(size=(300, 3)).astype(np.float32)
    for mx, mxse3 in ((1, 1), (3, 5), (2, 10)):
        cfg = GOLDEN.replace(mse=0.0, max_num_iterations=mx,
                             max_num_se3_iterations=mxse3,
                             number_of_nn_for_lrf=12)
        r = reg.register_pair(src, src, "se3_pt2pl", cfg)
        assert r.num_iterations <= max(mx, mxse3) + 1


def test_estimated_history():
    """Per-iteration transform history (the reference's
    estimated_history_, ref:cpp:491,538): last entry == final transform,
    entries change monotonically toward it."""
    import numpy as np
    from se3_icp.datasets import synthetic
    from se3_icp.models import registration as reg
    from se3_icp.utils.config import GOLDEN

    p = synthetic.synthetic_problem("easy", 0.002, seed=123)
    r = reg.register_pair(p.source, p.target, "gicp", GOLDEN,
                          record_history=True)
    assert r.history is not None
    assert r.history.shape == (r.num_iterations, 4, 4)
    np.testing.assert_allclose(r.history[-1], r.transformation, atol=1e-5)
    # history also works for the se3 modes, restored to original coords
    r2 = reg.register_pair(p.source, p.target, "se3_pt2pl", GOLDEN,
                           record_history=True)
    np.testing.assert_allclose(r2.history[-1], r2.transformation,
                               atol=1e-5)


def test_anderson_acceleration_optional():
    """AA-ICP (anderson_m >= 2) is opt-in and experimental: default 0
    preserves reference-parity dynamics; enabled, it must still satisfy
    the success thresholds (iteration-count effects are regime-
    dependent: long R3 refinements can shorten, short runs are ~even)."""
    import numpy as np
    import pytest
    from se3_icp.datasets import synthetic
    from se3_icp.models import registration as reg
    from se3_icp.utils import metrics
    from se3_icp.utils.config import GOLDEN

    p = synthetic.synthetic_problem("moderate", 0.005, seed=11)
    base = reg.register_pair(p.source, p.target, "se3_pt2pl", GOLDEN)
    for m in (3, 5):
        r = reg.register_pair(p.source, p.target, "se3_pt2pl",
                              GOLDEN.replace(anderson_m=m))
        assert bool(metrics.success(p.T_gt, r.transformation))
    assert bool(metrics.success(p.T_gt, base.transformation))
    with pytest.raises(ValueError):
        reg.register_pair(p.source, p.target, "se3_pt2pl",
                          GOLDEN.replace(anderson_m=1))


def test_nonfinite_points_dropped():
    """NaN/inf rows in input clouds are dropped host-side instead of
    poisoning the distance matrices."""
    import numpy as np
    from se3_icp.datasets import synthetic
    from se3_icp.models import registration as reg
    from se3_icp.utils import metrics
    from se3_icp.utils.config import GOLDEN

    p = synthetic.synthetic_problem("easy", 0.002, seed=77)
    src = np.concatenate([p.source, [[np.nan, 0, 0], [np.inf, 1, 1]]])
    tgt = np.concatenate([[[0, np.nan, 0]], p.target])
    r = reg.register_pair(src, tgt, "se3_pt2pl", GOLDEN)
    assert np.isfinite(r.transformation).all()
    assert bool(metrics.success(p.T_gt, r.transformation))


def test_rigid_equivariance_e2e():
    """Rigid pre-transform of the SOURCE composes through the result:
    register(Q(src), tgt) ~= register(src, tgt) . Q^-1 (up to the
    algorithm's own convergence tolerance)."""
    import numpy as np
    from scipy.spatial.transform import Rotation
    from se3_icp.datasets import synthetic
    from se3_icp.models import registration as reg
    from se3_icp.utils import metrics_host
    from se3_icp.utils.config import GOLDEN

    p = synthetic.synthetic_problem("easy", 0.002, seed=88)
    Q = np.eye(4)
    Q[:3, :3] = Rotation.from_euler("xyz", [0.2, -0.1, 0.15]).as_matrix()
    Q[:3, 3] = (0.5, -1.0, 2.0)
    r1 = reg.register_pair(p.source, p.target, "se3_pt2pl", GOLDEN)
    src_q = p.source @ Q[:3, :3].T + Q[:3, 3]
    r2 = reg.register_pair(src_q, p.target, "se3_pt2pl", GOLDEN)
    T_expected = r1.transformation @ np.linalg.inv(Q)
    rot = metrics_host.angular_error_so3(r2.transformation[:3, :3],
                                         T_expected[:3, :3])
    tra = metrics_host.translation_error(r2.transformation[:3, 3],
                                         T_expected[:3, 3])
    assert rot < 0.5 and tra < 0.05, (rot, tra)


def test_engine_fuzz_degenerate_and_random():
    """Robustness net: random and degenerate inputs must never produce
    non-finite or non-rigid transforms, and iteration counts must stay
    within the caps (+1: the hybrid switch can overshoot by one).  One
    static config + 512-point bucket everywhere, so the whole sweep
    shares a handful of compiled programs."""
    import numpy as np
    from se3_icp.models import registration as reg
    from se3_icp.utils.config import RegistrationConfig

    cfg = RegistrationConfig(max_num_iterations=12,
                             max_num_se3_iterations=4)
    rng = np.random.default_rng(0)
    base = rng.normal(size=(200, 3))
    nan_cloud = base.copy()
    nan_cloud[::17] = np.nan
    cases = [
        ("random", base, rng.normal(size=(230, 3))),
        ("identical", base, base.copy()),
        ("tiny", rng.normal(size=(8, 3)), rng.normal(size=(9, 3))),
        ("coincident_tgt", base, np.zeros((50, 3))),
        ("nan_rows", nan_cloud, base + 0.1),
        ("huge_scale", base * 1e6, base * 1e6 + 1e4),
    ]
    for alg in ("se3_pt2pl", "se3_gicp_with_cf", "icp_pt2pt"):
        for name, s, t in cases:
            r = reg.register_pair(s, t, alg.replace("icp_", "")
                                  if alg.startswith("icp_") else alg,
                                  cfg)
            T = r.transformation
            R = T[:3, :3]
            assert np.isfinite(T).all(), (alg, name)
            assert np.abs(R @ R.T - np.eye(3)).max() < 1e-3, (alg, name)
            assert abs(np.linalg.det(R) - 1.0) < 1e-3, (alg, name)
            assert r.num_iterations <= 12 + 4 + 1, (alg, name)
