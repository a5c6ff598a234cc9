"""Command-line surface mirroring the reference's nine example binaries
(CMakeLists.txt:42-76) as subcommands:

  run                 <- run_registration_method
  example             <- registration_example
  example-fgr         <- registration_example_fgr
  create-problem      <- create_and_save_reg_problem
  bench-synthetic     <- benchmark_synthetic
  bench-lounge        <- benchmark_lounge
  bench-kitti         <- benchmark_kitti
  bench-extreme-noise <- benchmark_extreme_noise_bunny
  test-se3-pure       <- test_se3_pure
  eval-traj           <- cc::evaluate_trajectory_quality

Usage: ``python -m se3_icp <subcommand> ...``
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from se3_icp.utils.cache import enable_persistent_cache
from se3_icp.utils.config import (ALGORITHMS, GOLDEN, LOUNGE,
                                      RegistrationConfig)


def _add_common(p):
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32")
    p.add_argument("--checkpoint", default=None,
                   help="JSONL per-pair checkpoint file (resumable)")
    p.add_argument("--json", action="store_true",
                   help="print a final machine-readable JSON report")


def cmd_run(args):
    """run_registration_method (examples/run_registration_method.cpp)."""
    import jax.numpy as jnp
    from se3_icp.models import registration as reg
    from se3_icp.utils import ply
    src = ply.read_ply(args.source)
    tgt = ply.read_ply(args.target)
    print(f"source point cloud size = {len(src)}")
    print(f"target point cloud size = {len(tgt)}")
    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32
    multi = getattr(args, "multi_start", 0) or 0
    if multi > 1 and args.algorithm == "fgr":
        sys.exit("error: --multi-start is not supported with fgr (a "
                 "global method; it does not use an initialization)")
    if multi > 1 and getattr(args, "initial_transform", None):
        sys.exit("error: --multi-start and --initial-transform are "
                 "mutually exclusive (the restart fleet defines its own "
                 "starts)")
    if args.algorithm == "fgr":
        from se3_icp.models import fgr
        res = fgr.fgr_register(src.points, tgt.points, dtype=dtype)
    elif multi > 1:
        from se3_icp.models import multistart
        ms = multistart.register_pair_multistart(
            src.points, tgt.points, args.algorithm, GOLDEN,
            n_starts=args.multi_start, dtype=np.dtype(args.dtype))
        res = ms.best
        print(f"multi-start: kept start {ms.start_index} of "
              f"{args.multi_start} (trimmed NN score "
              f"{ms.scores[ms.start_index]:.6g})")
    else:
        T0 = None
        if getattr(args, "initial_transform", None):
            T0 = np.loadtxt(args.initial_transform).reshape(4, 4)
        res = reg.register_pair(src.points, tgt.points, args.algorithm,
                                GOLDEN, dtype=dtype, initial_T=T0)
    print("Estimated transformation = ")
    np.savetxt(sys.stdout, res.transformation, fmt="%10.6f")
    if args.json:
        print(json.dumps({"T": res.transformation.tolist(),
                          "num_iterations": res.num_iterations}))


def cmd_example(args):
    """registration_example (self-contained bunny demo)."""
    import jax.numpy as jnp
    from se3_icp.datasets import synthetic
    from se3_icp.models import registration as reg
    from se3_icp.utils import metrics_host
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(1)
    bunny = synthetic.load_bunny(scale=1.0)
    src = synthetic.random_downsample(bunny, 0.02, rng)
    T_gt = np.eye(4)
    T_gt[:3, :3] = Rotation.from_euler(
        "xyz", [np.pi / 5, np.pi / 4, np.pi / 6]).as_matrix()
    T_gt[:3, 3] = (2.5, 3.5, 1.2)
    tgt = synthetic.random_downsample(
        bunny @ T_gt[:3, :3].T + T_gt[:3, 3], 0.02, rng)
    res = reg.register_pair(src, tgt, "se3_pt2pl", GOLDEN,
                            dtype=jnp.float32)
    print("Estimated transformation = ")
    np.savetxt(sys.stdout, res.transformation, fmt="%10.6f")
    print("Ground truth transformation = ")
    np.savetxt(sys.stdout, T_gt, fmt="%10.6f")
    print(f"SO3 error = "
          f"{metrics_host.angular_error_so3(res.transformation[:3, :3], T_gt[:3, :3]):.4f} deg")


def cmd_example_fgr(args):
    """registration_example_fgr (FGR baseline on the bunny demo problem).

    The reference draws the aligned geometries in an Open3D window
    (registration_example_fgr.cpp:56-61); headless here, so
    ``--save-aligned DIR`` preserves the capability by writing
    source/target/aligned-source PLY artifacts for any viewer."""
    from se3_icp.datasets import synthetic
    from se3_icp.models import fgr
    from se3_icp.utils import metrics_host, ply
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(1)
    bunny = synthetic.load_bunny(scale=1.0)
    src = synthetic.random_downsample(bunny, 0.02, rng)
    T_gt = np.eye(4)
    T_gt[:3, :3] = Rotation.from_euler(
        "xyz", [np.pi / 5, np.pi / 4, np.pi / 6]).as_matrix()
    T_gt[:3, 3] = (2.5, 3.5, 1.2)
    tgt = synthetic.random_downsample(
        bunny @ T_gt[:3, :3].T + T_gt[:3, 3], 0.02, rng)
    res = fgr.fgr_register(src, tgt)
    print("Estimated transformation = ")
    np.savetxt(sys.stdout, res.transformation, fmt="%10.6f")
    print("Ground truth transformation = ")
    np.savetxt(sys.stdout, T_gt, fmt="%10.6f")
    print(f"SO3 error = "
          f"{metrics_host.angular_error_so3(res.transformation[:3, :3], T_gt[:3, :3]):.4f} deg")
    if getattr(args, "save_aligned", None):
        import os
        d = args.save_aligned
        os.makedirs(d, exist_ok=True)
        T = res.transformation
        ply.write_ply(os.path.join(d, "source.ply"), src)
        ply.write_ply(os.path.join(d, "target.ply"), tgt)
        ply.write_ply(os.path.join(d, "source_aligned.ply"),
                      src @ T[:3, :3].T + T[:3, 3])
        print(f"Wrote source/target/source_aligned PLYs to {d}")


def cmd_create_problem(args):
    """create_and_save_reg_problem."""
    from se3_icp.datasets import synthetic
    from se3_icp.utils import ply
    import os
    prob = synthetic.golden_like_problem(seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    ply.write_ply(os.path.join(args.out, "source.ply"), prob.source)
    ply.write_ply(os.path.join(args.out, "target.ply"), prob.target)
    np.savetxt(os.path.join(args.out, "transformation_gt.txt"),
               prob.T_gt, fmt="%9.6f")
    print(f"Registration problem data written to {args.out}")
    print("Gt transformation = ")
    np.savetxt(sys.stdout, prob.T_gt, fmt="%10.6f")


def cmd_bench_synthetic(args):
    from se3_icp.bench import synthetic_bench
    if args.generate:
        synthetic_bench.generate_dataset(args.folder, args.num_cases,
                                         args.difficulty, args.noise)
        print(f"dataset written to {args.folder}")
        return
    if args.alpha_sweep:
        rep = synthetic_bench.alpha_sweep(args.algorithm, args.folder,
                                          args.out_file)
    else:
        rep = synthetic_bench.benchmark_on_saved_data(
            args.algorithm, args.folder, rot_alpha=args.rot_alpha,
            checkpoint=args.checkpoint, dtype=np.dtype(args.dtype),
            multi_start=getattr(args, "multi_start", 0))
    if args.json:
        print(json.dumps(rep))


def cmd_bench_lounge(args):
    from se3_icp.bench import lounge_bench
    if args.generate:
        from se3_icp.datasets import fixtures
        fixtures.make_lounge_fixture(args.folder)
        print(f"synthetic lounge-layout fixture written to {args.folder}")
        return
    if args.analyze:
        rep = lounge_bench.analyze_lounge(args.folder)
        if args.json:
            print(json.dumps(rep))
        return
    if args.alpha_sweep:
        reps = lounge_bench.lounge_alpha_sweep(
            args.algorithm, args.folder, dtype=np.dtype(args.dtype))
        if args.json:
            print(json.dumps(reps))
        return
    rep = lounge_bench.benchmark_lounge(
        args.algorithm, args.folder, rot_alpha=args.rot_alpha,
        checkpoint=args.checkpoint, dtype=np.dtype(args.dtype))
    if args.json:
        print(json.dumps(rep))


def cmd_bench_kitti(args):
    from se3_icp.bench import kitti_bench
    if args.generate:
        from se3_icp.datasets import fixtures
        fixtures.make_kitti_fixture(args.folder,
                                    max_index=args.max_index)
        print(f"synthetic KITTI-layout fixture written to {args.folder}")
        return
    if args.analyze:
        rep = kitti_bench.analyze_kitti(args.folder,
                                        max_index=args.max_index)
        if args.json:
            print(json.dumps(rep))
        return
    if args.alpha_sweep:
        reps = kitti_bench.kitti_alpha_sweep(
            args.algorithm, args.folder, max_index=args.max_index,
            dtype=np.dtype(args.dtype))
        if args.json:
            print(json.dumps(reps))
        return
    rep = kitti_bench.benchmark_kitti(
        args.algorithm, args.folder, rot_alpha=args.rot_alpha,
        checkpoint=args.checkpoint, dtype=np.dtype(args.dtype),
        max_index=args.max_index, save_traj=args.save_traj,
        online=args.online, voxel=args.voxel)
    if args.json:
        print(json.dumps(rep))


def cmd_bench_extreme_noise(args):
    from se3_icp.bench import extreme_noise_bench
    if args.generate:
        extreme_noise_bench.generate_dataset(args.folder)
        print(f"dataset written to {args.folder}")
        return
    errors = extreme_noise_bench.benchmark_extreme_noise(
        args.algorithm, args.folder, dtype=np.dtype(args.dtype))
    if args.json:
        print(json.dumps({"errors": errors}))


def cmd_test_se3_pure(args):
    """test_se3_pure: alpha sweep of run_se3_pure variants on lounge
    (examples/test_se3_pure.cpp: max_se3=30)."""
    from se3_icp.bench import common, lounge_bench
    from se3_icp.utils import metrics_host
    pairs, gts = lounge_bench.load_lounge_pairs(args.folder)
    for alpha in common.hybrid_alpha_grid():
        cfg = LOUNGE.replace(alpha_rot=alpha, max_num_se3_iterations=30)
        outcomes = common.run_pairs(pairs, args.algorithm, cfg,
                                    dtype=np.dtype(args.dtype),
                                    verbose=False)
        eul = np.mean([metrics_host.avg_euler_error(
            outcomes[i].T_est[:3, :3], gts[i][:3, :3])
            for i in range(len(pairs))])
        print(f"{args.algorithm} | rot_alpha = {alpha} | "
              f"avg_eul_angle_error = {eul}")


def cmd_lrf_quality(args):
    """cc::evaluate_LRF_quality as a diagnostic command: TOLDI frames
    on both clouds, GT correspondences, mean SO(3) error between
    GT-rotated source LRFs and matched target LRFs (ref:cc:63-114);
    --dump writes per-pair errors like the reference's file output."""
    import jax.numpy as jnp
    from se3_icp.ops import lrf
    from se3_icp.utils import metrics, ply
    src = ply.read_ply(args.source).points
    tgt = ply.read_ply(args.target).points
    T_gt = ply.read_transform_txt(args.gt)
    k = args.lrf_k
    rot_s, _ = lrf.toldi_frames(jnp.asarray(src), k)
    rot_t, _ = lrf.toldi_frames(jnp.asarray(tgt), k)
    corr = metrics.compute_corrs_with_gt(src, tgt, T_gt)
    src_R = jnp.asarray(T_gt[:3, :3]) @ rot_s[corr[:, 0]]
    tgt_R = rot_t[corr[:, 1]]
    errs = np.asarray(metrics.angular_error_so3_alt(src_R, tgt_R))
    print(f"num correspondences = {len(errs)}")
    print(f"mean LRF SO3 error  = {errs.mean():.6f} deg")
    print(f"median LRF SO3 error = {np.median(errs):.6f} deg")
    if args.dump:
        np.savetxt(args.dump, errs, fmt="%.8f")
        print(f"per-correspondence errors written to {args.dump}")
    if args.json:
        print(json.dumps({"mean_lrf_so3_error": float(errs.mean()),
                          "median_lrf_so3_error": float(np.median(errs)),
                          "num_corrs": int(len(errs))}))


def cmd_bench_scaling(args):
    """Data-parallel weak-scaling sweep over the device ladder
    (bench/scaling_bench.py; BASELINE.md's >=80% efficiency target)."""
    from se3_icp.bench import scaling_bench
    rep = scaling_bench.run_scaling(
        algorithm=args.algorithm, per_device=args.per_device,
        reps=args.reps, cloud=args.cloud)
    print(f"devices {rep['device_counts']} -> pairs/s "
          f"{rep['pairs_per_s']} (efficiency {rep['efficiency']})")
    if args.json:
        print(json.dumps(rep))


def cmd_eval_traj(args):
    from se3_icp.utils import metrics, ply
    gt = ply.read_trajectory_12col(args.gt)
    est = ply.read_trajectory_12col(args.est)
    rep = metrics.evaluate_trajectory_quality(gt, est)
    print(f"Average translation error = {rep['avg_translation_error']}")
    print(f"Average rotation    error = {rep['avg_rotation_error']}")
    print(f"Success rate              = {rep['success_rate']}")
    if args.json:
        print(json.dumps(rep))


def build_parser():
    ap = argparse.ArgumentParser(
        prog="se3_icp",
        description="SE(3)-ICP point-cloud registration engine")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="register two PLY files")
    p.add_argument("algorithm", choices=[a for a in ALGORITHMS
                                         if not a.startswith("se3_pure")]
                   + ["fgr"])
    p.add_argument("source")
    p.add_argument("target")
    p.add_argument("--initial-transform", default=None,
                   help="4x4 warm-start transform file (original "
                        "coordinates; whitespace text like "
                        "transformation_gt.txt). The reference always "
                        "starts at identity -- this enables online-"
                        "odometry warm starts (icp modes skip the "
                        "basin search entirely).")
    p.add_argument("--multi-start", type=int, default=0,
                   help="N rotation starts in one batch, keep the best")
    _add_common(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("example", help="self-contained bunny demo")
    _add_common(p)
    p.set_defaults(fn=cmd_example)

    p = sub.add_parser("example-fgr",
                       help="FGR baseline on the bunny demo problem")
    _add_common(p)
    p.add_argument("--save-aligned", default=None,
                   help="write source/target/aligned-source PLYs here "
                        "(headless stand-in for the reference's Open3D "
                        "visualization)")
    p.set_defaults(fn=cmd_example_fgr)

    p = sub.add_parser("create-problem")
    p.add_argument("--out", default="created_example_reg_problem")
    p.add_argument("--seed", type=int, default=1)
    p.set_defaults(fn=cmd_create_problem)

    for name, fn in [("bench-synthetic", cmd_bench_synthetic),
                     ("bench-lounge", cmd_bench_lounge),
                     ("bench-kitti", cmd_bench_kitti),
                     ("bench-extreme-noise", cmd_bench_extreme_noise)]:
        p = sub.add_parser(name)
        p.add_argument("algorithm", choices=ALGORITHMS + ("fgr",))
        p.add_argument("folder")
        p.add_argument("--rot-alpha", type=float, default=3.0)
        _add_common(p)
        if name == "bench-synthetic":
            p.add_argument("--alpha-sweep", action="store_true")
            p.add_argument("--multi-start", type=int, default=0,
                           help="run each problem from N rotation "
                                "starts in one batch and keep the best "
                                "(widens the basin; 0/1 = off)")
            p.add_argument("--out-file", default=None)
            p.add_argument("--num-cases", type=int, default=30)
            p.add_argument("--difficulty", default="moderate",
                           choices=["easy", "moderate", "difficult"])
            p.add_argument("--noise", type=float, default=0.005)
        if name == "bench-kitti":
            p.add_argument("--max-index", type=int, default=1100)
            p.add_argument("--save-traj", default=None,
                           help="write the estimated absolute "
                                "trajectory (12-col rows; feed to "
                                "eval-traj)")
            p.add_argument("--online", action="store_true",
                           help="serial frame-at-a-time odometry with "
                                "a constant-velocity warm start from "
                                "the previous pair (latency mode; "
                                "pt2pl converges in a few iterations)")
            p.add_argument("--analyze", action="store_true",
                           help="run the reference's dormant KITTI "
                                "difficulty + Chamfer analyses instead "
                                "of registering")
            p.add_argument("--voxel", type=float, default=0.0,
                           help="voxel-centroid downsampling size for "
                                "RAW velodyne .bin bundles (full-rate "
                                "07.txt + velodyne/%%06d.bin run "
                                "unmodified; ~0.3 reproduces the "
                                "reference bundle's density)")
            p.add_argument("--alpha-sweep", action="store_true",
                           help="full hybrid alpha grid over the KITTI "
                                "protocol (benchmark_different_rot_"
                                "scales)")
        # every benchmark can generate its own (synthetic stand-in)
        # dataset in the reference's on-disk layout
        p.add_argument("--generate", action="store_true")
        if name == "bench-lounge":
            p.add_argument("--analyze", action="store_true",
                           help="dataset difficulty + Chamfer analyses "
                                "(benchmark_lounge.cpp:404-515)")
            p.add_argument("--alpha-sweep", action="store_true",
                           help="full hybrid alpha grid over the "
                                "lounge protocol (benchmark_different_"
                                "rot_scales)")
        p.set_defaults(fn=fn)

    p = sub.add_parser("test-se3-pure")
    p.add_argument("algorithm",
                   choices=[a for a in ALGORITHMS
                            if a.startswith("se3_pure")])
    p.add_argument("folder")
    _add_common(p)
    p.set_defaults(fn=cmd_test_se3_pure)

    p = sub.add_parser("eval-traj")
    p.add_argument("gt")
    p.add_argument("est")
    _add_common(p)
    p.set_defaults(fn=cmd_eval_traj)

    p = sub.add_parser("bench-scaling",
                       help="data-parallel weak-scaling sweep over the "
                            "device ladder (pairs/s + efficiency)")
    p.add_argument("--algorithm", default="se3_pt2pl",
                   choices=ALGORITHMS + ("fgr",))
    p.add_argument("--per-device", type=int, default=8,
                   help="pairs per device (weak scaling)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--cloud", default="golden",
                   choices=["golden", "easy"],
                   help="golden: 4167-pt protocol clouds; easy: small "
                        "synthetic clouds (fast mechanics check)")
    _add_common(p)
    p.set_defaults(fn=cmd_bench_scaling)

    p = sub.add_parser("lrf-quality",
                       help="LRF rotational-consistency diagnostic "
                            "(cc::evaluate_LRF_quality)")
    p.add_argument("source")
    p.add_argument("target")
    p.add_argument("gt", help="4x4 ground-truth transform file")
    p.add_argument("--lrf-k", type=int, default=90)
    p.add_argument("--dump", default=None,
                   help="write per-correspondence errors to a file")
    _add_common(p)
    p.set_defaults(fn=cmd_lrf_quality)
    return ap


def main(argv=None):
    enable_persistent_cache()
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
