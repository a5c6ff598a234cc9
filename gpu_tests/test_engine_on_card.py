"""Accuracy and kernel parity on the card, at the serving dtype (float32).

The CPU suite (``tests/``) runs float64 and the interpreted kernel;
these run the compiled programs: the Triton 1-NN kernel, TF32-capable
matmuls held at full precision, and the batch-64 golden program.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from se3_icp.datasets import standin, synthetic
from se3_icp.models import multistart as ms
from se3_icp.models import registration as reg
from se3_icp.ops import knn, lrf, triton_nn
from se3_icp.parallel import pairs as par
from se3_icp.utils import metrics_host
from se3_icp.utils.config import GOLDEN, RegistrationConfig

pytestmark = pytest.mark.gpu


def _rot_err(T, T_gt):
    return metrics_host.angular_error_so3(T[:3, :3], T_gt[:3, :3])


def test_golden_accuracy_batch64():
    """Every pair of the batch-64 golden program lands < 0.01 deg from
    ground truth (noise-free problem: exact convergence)."""
    src, tgt, T_gt = standin.golden_problem()
    res = par.register_pairs([(src, tgt)] * 64, "se3_pt2pl", GOLDEN)
    errs = [_rot_err(r.transformation, T_gt) for r in res]
    assert max(errs) < 0.01, max(errs)
    for r in res:
        assert metrics_host.success(T_gt, r.transformation)


def test_batched_engine_convergence():
    """Jittered golden pairs through the batched kernel loop converge in
    reference-like iteration counts (a precision loss in the 1-NN would
    send pairs to the 150-iteration cap on MSE oscillation)."""
    src, tgt, T_gt = standin.golden_problem()
    rng = np.random.default_rng(0)
    pairs = [(src + rng.normal(scale=1e-4, size=src.shape), tgt)
             for _ in range(64)]
    res = par.register_pairs(pairs, "se3_pt2pl", GOLDEN)
    for r in res:
        assert r.num_iterations <= 20, r.num_iterations
        assert _rot_err(r.transformation, T_gt) < 0.01


def test_multistart_rescues_difficult():
    """A difficult (+/-pi) case that fails single-start is rescued by an
    8-start fleet at float32."""
    prob = synthetic.synthetic_problem("difficult", 0.005, seed=1)
    cfg = RegistrationConfig()
    r1 = reg.register_pair(prob.source, prob.target, "se3_pt2pl", cfg)
    assert not metrics_host.success(prob.T_gt, r1.transformation), (
        "fixture drifted: seed 1 should fail single-start")
    r8 = ms.register_pair_multistart(prob.source, prob.target,
                                     "se3_pt2pl", cfg, n_starts=8)
    assert metrics_host.success(prob.T_gt, r8.best.transformation)
    # the scoring must separate converged starts from failed ones
    assert r8.scores.min() < 0.5 * float(np.median(r8.scores))


def test_warmstart():
    """Warm start at ground truth: fewer iterations than cold, success."""
    prob = synthetic.synthetic_problem("easy", 0.002, seed=7)
    cfg = RegistrationConfig()
    cold = reg.register_pair(prob.source, prob.target, "pt2pl", cfg)
    warm = reg.register_pair(prob.source, prob.target, "pt2pl", cfg,
                             initial_T=prob.T_gt)
    assert warm.num_iterations < cold.num_iterations
    assert metrics_host.success(prob.T_gt, warm.transformation)


def test_shot_dense_matches_oracle():
    """shot_frames_dense (exact radius semantics) in float32 on the card
    against the literal numpy oracle, on well-conditioned
    neighborhoods (float32 eigenvectors degrade with the eigengap)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tests"))
    import oracles

    rng = np.random.default_rng(11)
    pts = rng.normal(size=(400, 3))
    radius = 2.0
    rot, _ = lrf.shot_frames_dense(jnp.asarray(pts, jnp.float32), radius)
    rot = np.asarray(jax.device_get(rot))
    ref = np.stack([oracles.shot_frame_oracle(pts, i, radius)
                    for i in range(len(pts))])
    err = np.abs(rot - ref).max(axis=(1, 2))
    gaps = np.empty(len(pts))
    for i in range(len(pts)):
        d2 = ((pts - pts[i]) ** 2).sum(1)
        sel = (d2 <= radius * radius) & (np.arange(len(pts)) != i)
        diffs = pts[sel] - pts[i]
        w = radius - np.sqrt(d2[sel])
        cov = (w[:, None, None] * diffs[:, :, None]
               * diffs[:, None, :]).sum(0) / w.sum()
        ev = np.linalg.eigvalsh(cov)
        gaps[i] = min(ev[1] - ev[0], ev[2] - ev[1]) / max(ev[2], 1e-30)
    well = gaps > 0.1
    assert well.sum() > 100
    assert err[well].max() < 2e-2, err[well].max()
    assert np.median(err) < 5e-3, np.median(err)


@pytest.mark.parametrize("d", [3, 12])
def test_kernel_parity_golden_width(d):
    """The compiled Triton kernel against XLA at 64x4608: indices agree
    wherever the float64 best/second-best gap exceeds float32
    resolution, distances agree to float32 rounding."""
    rng = np.random.default_rng(d)
    q = rng.normal(size=(64, 4608, d)).astype(np.float32)
    t = rng.normal(size=(64, 4608, d)).astype(np.float32)
    n = np.full(64, 4167, np.int32)
    ki, kd = jax.device_get(triton_nn.nn_argmin_batched(q, t, n))
    xi, xd = jax.device_get(jax.jit(jax.vmap(knn.nn_argmin_xla))(q, t, n))
    assert (ki < 4167).all()
    np.testing.assert_allclose(kd, xd, atol=1e-4)
    for b in range(2):
        q64 = q[b].astype(np.float64)
        t64 = t[b, :4167].astype(np.float64)
        d2 = ((q64 * q64).sum(1)[:, None] - 2.0 * q64 @ t64.T
              + (t64 * t64).sum(1)[None, :])
        two = np.partition(d2, 1, axis=1)[:, :2]
        tol = 1e-6 * ((q64 ** 2).sum(1) + (t64 ** 2).sum(1).max())
        chosen = np.take_along_axis(d2, ki[b][:, None], 1)[:, 0]
        assert (chosen - two[:, 0] <= tol).all()
        sep = (two[:, 1] - two[:, 0]) > tol
        assert (ki[b][sep] == xi[b][sep]).all()
    assert np.mean(ki == xi) > 0.999


def test_engine_uses_kernel_on_gpu():
    """Unpinned, the engine's batched 1-NN route on the card is the
    Triton kernel."""
    assert knn._BATCHED_NN is None
    assert knn.batched_nn() is triton_nn.nn_argmin_batched
