"""Multi-start restart fleet (models/multistart.py).

The reference has no multi-start; its difficult protocol
(benchmark_synthetic.cpp:139-158) is single-start.  These tests pin the
SO(3) grid's invariants, the start/transform composition, and the
headline capability: difficult cases that fail single-start succeed
with a small start fleet.
"""

import numpy as np
import pytest

from se3_icp.datasets import synthetic
from se3_icp.models import multistart as ms
from se3_icp.models import registration as reg
from se3_icp.utils import metrics_host
from se3_icp.utils.config import RegistrationConfig


def test_so3_grid_valid_rotations():
    G = ms.so3_grid(30, seed=5)
    assert G.shape == (30, 3, 3)
    eye = np.eye(3)
    for R in G:
        np.testing.assert_allclose(R @ R.T, eye, atol=1e-9)
        assert np.linalg.det(R) == pytest.approx(1.0, abs=1e-9)
    # identity leads; the 24-prefix is the octahedral group (all
    # distinct), so every prefix is a spread covering
    np.testing.assert_allclose(G[0], eye, atol=1e-12)
    flat = {tuple(np.round(R, 6).ravel()) for R in G[:24]}
    assert len(flat) == 24


def test_so3_grid_prefix_coverage():
    """Greedy ordering: the min pairwise geodesic distance of the
    8-element prefix must be large (a spread subset, not a cluster)."""
    G = ms.so3_grid(8)
    dmin = np.pi
    for i in range(8):
        for j in range(i + 1, 8):
            tr = np.trace(G[i] @ G[j].T)
            dmin = min(dmin, np.arccos(np.clip((tr - 1) / 2, -1, 1)))
    assert dmin > np.radians(85.0)


def test_single_start_matches_register_pair():
    """n_starts=1 is the identity start: bit-level identical to the
    batched engine program it wraps (pins the M-composition to be a
    true identity), and within ICP-trajectory tolerance of the
    unbatched engine (vmap changes reduction order, so the stop test
    can trigger one iteration apart -- NOT bit-comparable)."""
    import jax.numpy as jnp
    from se3_icp.parallel import pairs as par

    prob = synthetic.synthetic_problem("moderate", 0.005, seed=11)
    cfg = RegistrationConfig()
    r_ms = ms.register_pair_multistart(prob.source, prob.target,
                                       "se3_pt2pl", cfg, n_starts=1,
                                       mesh=False)
    assert r_ms.start_index == 0

    src = reg.sanitize_cloud(prob.source)
    tgt = reg.sanitize_cloud(prob.target)
    src_p = np.zeros((1, reg._bucket(len(src)), 3), np.float32)
    src_p[0, :len(src)] = src
    tgt_p = np.zeros((1, reg._bucket(len(tgt)), 3), np.float32)
    tgt_p[0, :len(tgt)] = tgt
    T, _, _ = par.register_batch(
        jnp.asarray(src_p), jnp.asarray([len(src)], np.int32),
        jnp.asarray(tgt_p), jnp.asarray([len(tgt)], np.int32),
        cfg, "se3_pt2pl")
    np.testing.assert_allclose(r_ms.best.transformation,
                               np.asarray(T[0], np.float64), atol=1e-12)

    r_ref = reg.register_pair(prob.source, prob.target, "se3_pt2pl", cfg)
    assert metrics_host.angular_error_so3(
        r_ms.best.transformation[:3, :3],
        r_ref.transformation[:3, :3]) < 0.5


def test_multistart_rescues_difficult():
    """A difficult (+/-pi) case that fails single-start succeeds with
    an 8-start fleet (measured: 8 starts rescue every tested seed)."""
    prob = synthetic.synthetic_problem("difficult", 0.005, seed=1)
    cfg = RegistrationConfig()
    r1 = reg.register_pair(prob.source, prob.target, "se3_pt2pl", cfg)
    assert not metrics_host.success(prob.T_gt, r1.transformation), \
        "fixture drifted: seed 1 should fail single-start"
    r8 = ms.register_pair_multistart(prob.source, prob.target,
                                     "se3_pt2pl", cfg, n_starts=8)
    assert metrics_host.success(prob.T_gt, r8.best.transformation)
    # the scoring must separate converged starts from failed ones
    # (several starts may share the correct basin, so compare the best
    # against the median, not the runner-up)
    assert r8.scores.min() < 0.5 * float(np.median(r8.scores))


def test_multistart_sharded_over_mesh():
    """The (pair, start) flattened batch shards over a pairs mesh like
    any other batch: same selections and transforms as unsharded."""
    from se3_icp.parallel import pairs as par

    prob = synthetic.synthetic_problem("difficult", 0.005, seed=1)
    cfg = RegistrationConfig()
    mesh = par.default_mesh()
    r_m = ms.register_pair_multistart(prob.source, prob.target,
                                      "se3_pt2pl", cfg, n_starts=8,
                                      mesh=mesh)
    r_u = ms.register_pair_multistart(prob.source, prob.target,
                                      "se3_pt2pl", cfg, n_starts=8,
                                      mesh=False)
    assert r_m.start_index == r_u.start_index
    # sharded vs unsharded compile to different programs whose ULP
    # differences amplify over a difficult pair's long trajectory;
    # assert agreement at ICP-trajectory tolerance, not bit level
    assert metrics_host.angular_error_so3(
        r_m.best.transformation[:3, :3],
        r_u.best.transformation[:3, :3]) < 0.5
    assert metrics_host.success(prob.T_gt, r_m.best.transformation)


def test_pairs_multistart_batched():
    """register_pairs_multistart == per-pair register_pair_multistart
    (same flattened batch program, same selections)."""
    probs = [synthetic.synthetic_problem("difficult", 0.005, seed=s)
             for s in (1, 2)]
    cfg = RegistrationConfig()
    batched = ms.register_pairs_multistart(
        [(p.source, p.target) for p in probs], "se3_pt2pl", cfg,
        n_starts=4)
    assert len(batched) == 2
    for p, r in zip(probs, batched):
        single = ms.register_pair_multistart(p.source, p.target,
                                             "se3_pt2pl", cfg,
                                             n_starts=4)
        assert r.start_index == single.start_index
        np.testing.assert_allclose(r.best.transformation,
                                   single.best.transformation, atol=1e-5)


def test_pairs_multistart_chunked_matches_unchunked():
    """Chunking the (pair, start) fleet (the HBM guard: a big problem
    list must not flatten into one unbounded device batch) must not
    change selections or transforms, including the padded tail chunk.
    Easy problems at GOLDEN: the winning start converges, so scores are
    well-separated and the comparison is stable across the two compiled
    batch shapes (non-converging junk solutions would be ULP-unstable
    between programs)."""
    from se3_icp.utils.config import GOLDEN

    probs = [synthetic.synthetic_problem("easy", 0.002, seed=s)
             for s in (3, 4, 5)]
    pl = [(p.source, p.target) for p in probs]
    full = ms.register_pairs_multistart(pl, "se3_pt2pl", GOLDEN,
                                        n_starts=3, pair_chunk=3)
    chunked = ms.register_pairs_multistart(pl, "se3_pt2pl", GOLDEN,
                                           n_starts=3, pair_chunk=2)
    for p, a, b in zip(probs, full, chunked):
        assert a.start_index == b.start_index
        assert metrics_host.success(p.T_gt, b.best.transformation)
        # the two chunk sizes are different compiled/shard shapes whose
        # ULP differences amplify over the trajectory (~1e-4 observed);
        # selections must be identical, transforms trajectory-close
        np.testing.assert_allclose(a.best.transformation,
                                   b.best.transformation, atol=1e-3)


def test_multistart_dtype_float64():
    """The dtype knob reaches the engine (was silently float32)."""
    from se3_icp.utils.config import GOLDEN

    prob = synthetic.synthetic_problem("easy", 0.002, seed=3)
    r = ms.register_pair_multistart(prob.source, prob.target,
                                    "se3_pt2pl", GOLDEN, n_starts=2,
                                    dtype=np.float64)
    assert r.start_index == 0
    assert metrics_host.success(prob.T_gt, r.best.transformation)
