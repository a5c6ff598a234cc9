"""Warm-start (initial_T) support: the engine can start the iteration
from a given transform in original coordinates (the reference always
starts at identity, ref:cpp:485-489 -- this is a beyond-reference
capability for online odometry and restart strategies)."""

import numpy as np
import pytest

import jax.numpy as jnp

from se3_icp.datasets import synthetic
from se3_icp.models import registration as reg
from se3_icp.parallel import pairs as par
from se3_icp.utils import metrics_host
from se3_icp.utils.config import RegistrationConfig


@pytest.fixture(scope="module")
def prob():
    return synthetic.synthetic_problem("moderate", 0.005, seed=14)


def test_warmstart_at_gt_converges_immediately(prob):
    """Plain ICP from the ground truth: the stop test trips in a few
    iterations (measured 4 vs 21 cold) -- the online-odometry pattern
    (warm start + icp mode) skips both the basin search AND the SE(3)
    phase, whose iteration cap hybrid mode always pays."""
    cfg = RegistrationConfig()
    cold = reg.register_pair(prob.source, prob.target, "pt2pl", cfg)
    warm = reg.register_pair(prob.source, prob.target, "pt2pl", cfg,
                             initial_T=prob.T_gt)
    assert warm.num_iterations <= 6
    assert warm.num_iterations < cold.num_iterations
    assert metrics_host.success(prob.T_gt, warm.transformation)


def test_warmstart_identity_matches_default(prob):
    """initial_T=eye runs a different jit specialization but must
    reproduce the default path bit-for-bit (same arithmetic).  Exact
    equality holds in plain-ICP mode, where there is no preprocessing
    frame: in se3 modes the default start (identity in the CENTERED
    frame) is the centroid-aligning transform in original coordinates,
    not the identity -- see test_warmstart_se3_default_is_centroid_shift."""
    cfg = RegistrationConfig()
    a = reg.register_pair(prob.source, prob.target, "pt2pl", cfg)
    b = reg.register_pair(prob.source, prob.target, "pt2pl", cfg,
                          initial_T=np.eye(4))
    assert a.num_iterations == b.num_iterations
    np.testing.assert_allclose(a.transformation, b.transformation,
                               atol=1e-12)


def test_warmstart_se3_default_is_centroid_shift(prob):
    """In se3 modes the engine centers both clouds before iterating
    (ref:cpp:566-583), so its default start corresponds to the
    centroid-aligning transform in original coordinates.  Warm-starting
    with exactly that transform must land on the default result (up to
    the f64-host vs masked-f32-device centroid rounding in the start
    translation)."""
    cfg = RegistrationConfig()
    t_shift = prob.target.mean(0) - prob.source.mean(0)
    T0 = np.eye(4)
    T0[:3, 3] = t_shift
    a = reg.register_pair(prob.source, prob.target, "se3_pt2pl", cfg)
    b = reg.register_pair(prob.source, prob.target, "se3_pt2pl", cfg,
                          initial_T=T0)
    assert abs(a.num_iterations - b.num_iterations) <= 1
    np.testing.assert_allclose(a.transformation, b.transformation,
                               atol=1e-4)


def test_warmstart_hybrid_no_regression(prob):
    """Hybrid SE(3) mode honors initial_T: same accuracy, no extra
    iterations (the SE(3) phase runs its course either way -- its
    switch is t_change-based, which estimator noise keeps above the
    threshold, so a warm start cannot shortcut the phase cap)."""
    cfg = RegistrationConfig()
    cold = reg.register_pair(prob.source, prob.target, "se3_pt2pl", cfg)
    warm = reg.register_pair(prob.source, prob.target, "se3_pt2pl", cfg,
                             initial_T=prob.T_gt)
    assert warm.num_iterations <= cold.num_iterations
    assert metrics_host.success(prob.T_gt, warm.transformation)
    assert metrics_host.success(prob.T_gt, cold.transformation)


def test_warmstart_batched(prob):
    """register_pairs with per-pair initial_Ts: warm pairs converge in
    fewer iterations than cold pairs inside one batch program."""
    cfg = RegistrationConfig()
    pairs = [(prob.source, prob.target)] * 2
    t0 = np.stack([np.eye(4), prob.T_gt])
    res = par.register_pairs(pairs, "pt2pl", cfg, initial_Ts=t0)
    assert metrics_host.success(prob.T_gt, res[0].transformation)
    assert metrics_host.success(prob.T_gt, res[1].transformation)
    assert res[1].num_iterations < res[0].num_iterations
