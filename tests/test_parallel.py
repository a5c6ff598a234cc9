"""Multi-device tests on the 8-virtual-device CPU mesh (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np

from se3_icp.datasets import synthetic
from se3_icp.models import registration as reg
from se3_icp.parallel import pairs as par
from se3_icp.utils import metrics
from se3_icp.utils.config import GOLDEN


def _problems(n, seed0=10):
    return [synthetic.synthetic_problem("easy", 0.002, seed=seed0 + i)
            for i in range(n)]


def test_register_batch_vmapped_matches_single():
    probs = _problems(3)
    pair_list = [(p.source, p.target) for p in probs]
    results = par.register_pairs(pair_list, "se3_pt2pl", GOLDEN,
                                 mesh=None, dtype=np.float64)
    for p, r in zip(probs, results):
        single = reg.register_pair(p.source, p.target, "se3_pt2pl",
                                   GOLDEN, dtype=jnp.float64)
        # batched while_loop runs extra masked iterations for pairs that
        # converge early; converged transforms must agree tightly
        np.testing.assert_allclose(r.transformation, single.transformation,
                                   atol=1e-6)
        assert bool(metrics.success(p.T_gt, r.transformation))


def test_register_batch_sharded_over_mesh():
    assert jax.device_count() == 8
    mesh = par.default_mesh()
    probs = _problems(8, seed0=30)
    pair_list = [(p.source, p.target) for p in probs]
    results = par.register_pairs(pair_list, "se3_pt2pl", GOLDEN,
                                 mesh=mesh, dtype=np.float64)
    ok = [bool(metrics.success(p.T_gt, r.transformation))
          for p, r in zip(probs, results)]
    assert np.mean(ok) >= 7 / 8, ok


def test_sharded_matches_unsharded():
    mesh = par.default_mesh()
    probs = _problems(4, seed0=50)
    pair_list = [(p.source, p.target) for p in probs]
    r_mesh = par.register_pairs(pair_list, "se3_pt2pt", GOLDEN,
                                mesh=mesh, dtype=np.float64)
    r_none = par.register_pairs(pair_list, "se3_pt2pt", GOLDEN,
                                mesh=None, dtype=np.float64)
    for a, b in zip(r_mesh, r_none):
        np.testing.assert_allclose(a.transformation, b.transformation,
                                   atol=1e-9)
        assert a.num_iterations == b.num_iterations


def test_pad_to_mesh_size():
    """Pair counts not divisible by the mesh are padded and unpadded."""
    mesh = par.default_mesh()
    probs = _problems(3, seed0=70)
    pair_list = [(p.source, p.target) for p in probs]
    results = par.register_pairs(pair_list, "pt2pt", GOLDEN,
                                 mesh=mesh, dtype=np.float64)
    assert len(results) == 3


def test_points_sharded_matches_unsharded():
    """Model-parallel (points-axis) registration == single-device result
    (setup kNN, LRF gathers, and the sharded per-iteration NN combine
    must be bit-compatible with the replicated path)."""
    from se3_icp.parallel import points as mp
    mesh = mp.points_mesh()
    p = _problems(1, seed0=90)[0]
    r_mp = mp.register_pair_model_parallel(
        p.source, p.target, "se3_pt2pl", GOLDEN, mesh=mesh,
        dtype=jnp.float64)
    r_1 = reg.register_pair(p.source, p.target, "se3_pt2pl", GOLDEN,
                            dtype=jnp.float64)
    np.testing.assert_allclose(r_mp.transformation, r_1.transformation,
                               atol=1e-8)
    assert r_mp.num_iterations == r_1.num_iterations
    assert bool(metrics.success(p.T_gt, r_mp.transformation))


def test_points_sharded_gicp():
    """Covariance/normal gathers also hold for the gicp variant."""
    from se3_icp.parallel import points as mp
    mesh = mp.points_mesh()
    p = _problems(1, seed0=91)[0]
    r_mp = mp.register_pair_model_parallel(
        p.source, p.target, "se3_gicp", GOLDEN, mesh=mesh,
        dtype=jnp.float64)
    r_1 = reg.register_pair(p.source, p.target, "se3_gicp", GOLDEN,
                            dtype=jnp.float64)
    np.testing.assert_allclose(r_mp.transformation, r_1.transformation,
                               atol=1e-8)


def test_batch_2d_mesh():
    """2-D ('pairs','points') mesh: 4-way DP x 2-way model parallel."""
    from jax.sharding import Mesh
    from se3_icp.parallel import points as mp
    devs = np.asarray(jax.devices()).reshape(4, 2)
    mesh = Mesh(devs, ("pairs", "points"))
    probs = _problems(4, seed0=92)
    pair_list = [(p.source, p.target) for p in probs]
    src, n_src, tgt, n_tgt = par.pack_pairs(pair_list, np.float64)
    T, it, pure = mp.register_batch_2d(
        jnp.asarray(src), jnp.asarray(n_src), jnp.asarray(tgt),
        jnp.asarray(n_tgt), GOLDEN, "se3_pt2pl", mesh)
    T = np.asarray(T)
    for p, Ti in zip(probs, T):
        assert bool(metrics.success(p.T_gt, Ti))


def test_setup_checksum_sharded_matches_unsharded():
    """The phase-timing setup program (bench.py BENCH_PHASES) must run
    the same math sharded and unsharded -- including a pair count that
    needs mesh padding (5 pairs on 8 devices)."""
    mesh = par.default_mesh()
    probs = _problems(5, seed0=50)
    src, n_src, tgt, n_tgt = par.pack_pairs(
        [(p.source, p.target) for p in probs])
    args = (jnp.asarray(src), jnp.asarray(n_src), jnp.asarray(tgt),
            jnp.asarray(n_tgt))
    chk_m = np.asarray(par.setup_checksum_batch(*args, GOLDEN,
                                                "se3_pt2pl", mesh))
    chk_u = np.asarray(par.setup_checksum_batch(*args, GOLDEN,
                                                "se3_pt2pl", None))
    assert chk_m.shape == (5,) and chk_u.shape == (5,)
    np.testing.assert_allclose(chk_m, chk_u, rtol=1e-6)


def test_scaling_bench_mechanics():
    """bench-scaling sweeps the device ladder and reports positive
    rates + normalized efficiency (mechanics only on CPU: virtual
    devices share the physical cores)."""
    from se3_icp.bench import scaling_bench

    assert scaling_bench.device_ladder(1) == [1]
    assert scaling_bench.device_ladder(6) == [1, 2, 4, 6]
    assert scaling_bench.device_ladder(8) == [1, 2, 4, 8]
    rep = scaling_bench.run_scaling(per_device=1, reps=1, cloud="easy",
                                    verbose=False)
    assert rep["device_counts"] == [1, 2, 4, 8]
    assert all(r > 0 for r in rep["pairs_per_s"])
    assert rep["efficiency"][0] == 1.0
    assert rep["platform"] == "cpu"


def test_device_cloud_cache_reuses_uploads():
    """register_pairs_async memoizes each side's device upload by array
    identity: a repeated target side (scan-to-model serving, the bench
    protocol) must reuse the SAME device buffers, and fresh source
    arrays must miss.  Results stay correct either way."""
    probs = _problems(2, seed0=70)
    tgts = [p.target for p in probs]
    srcs1 = [p.source for p in probs]
    srcs2 = [p.source + 1e-5 for p in probs]

    d_t1, _ = par._device_clouds(tgts, np.float32)
    d_s1, _ = par._device_clouds(srcs1, np.float32)
    d_t2, _ = par._device_clouds(tgts, np.float32)
    d_s2, _ = par._device_clouds(srcs2, np.float32)
    assert d_t2 is d_t1          # identical side -> cache hit
    assert d_s2 is not d_s1      # fresh arrays -> miss

    r1 = par.register_pairs(list(zip(srcs1, tgts)), "se3_pt2pl", GOLDEN,
                            mesh=None)
    r2 = par.register_pairs(list(zip(srcs1, tgts)), "se3_pt2pl", GOLDEN,
                            mesh=None)
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(a.transformation, b.transformation)
    for p, r in zip(probs, r1):
        assert bool(metrics.success(p.T_gt, r.transformation))


def test_pad_max_upload_matches_bucket_packed():
    """The pad='max' upload + on-device bucket padding must register
    identically to host bucket packing (the engine sees the same padded
    arrays either way)."""
    probs = _problems(3, seed0=77)
    pair_list = [(p.source, p.target) for p in probs]
    src_m, ns_m, tgt_m, nt_m = par.pack_pairs(pair_list, pad="max")
    src_b, ns_b, tgt_b, nt_b = par.pack_pairs(pair_list, pad="bucket")
    assert src_m.shape[1] <= src_b.shape[1]
    np.testing.assert_array_equal(ns_m, ns_b)
    out_m = par.register_batch(jnp.asarray(src_m), jnp.asarray(ns_m),
                               jnp.asarray(tgt_m), jnp.asarray(nt_m),
                               GOLDEN, "se3_pt2pl")
    out_b = par.register_batch(jnp.asarray(src_b), jnp.asarray(ns_b),
                               jnp.asarray(tgt_b), jnp.asarray(nt_b),
                               GOLDEN, "se3_pt2pl")
    np.testing.assert_allclose(np.asarray(out_m[0]),
                               np.asarray(out_b[0]), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(out_m[1]),
                                  np.asarray(out_b[1]))
