"""CLI-surface smoke tests: the argparse layer and the in-process
subcommand paths (the reference's binary surface, cli.py).

The CLI is the user surface and has its own failure modes the library
tests never touch (flag registration/conflicts, file round-trips,
stdout/JSON contracts) -- two review rounds found bugs exactly here.
Heavy subcommands (example, example-fgr, bench-scaling, the full
sequence protocols) are covered by the library-level protocol tests and
the verify recipe; this module keeps to fast paths.
"""

import json

import numpy as np
import pytest

from se3_icp import cli
from se3_icp.utils import metrics_host, ply


def _last_json(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1]), out


def _tiny_problem(tmp_path, n=300, seed=0, translate=True):
    """Small source/target PLY pair + GT transform file.

    ``translate=False`` keeps the GT a pure rotation: TOLDI frames are
    exactly rotation-equivariant, but the reference's centroid
    off-by-one (quirk #2, replicated deliberately) breaks exact
    TRANSLATION equivariance, so translated copies show a few degrees
    of LRF error by design."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n, 3)).astype(np.float64)
    ang = np.deg2rad(9.0)
    R = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                  [np.sin(ang), np.cos(ang), 0.0],
                  [0.0, 0.0, 1.0]])
    t = (np.array([0.2, -0.1, 0.05]) if translate else np.zeros(3))
    T_gt = np.eye(4)
    T_gt[:3, :3], T_gt[:3, 3] = R, t
    tgt = src @ R.T + t
    sp, tp, gp = (tmp_path / "s.ply", tmp_path / "t.ply",
                  tmp_path / "gt.txt")
    ply.write_ply(sp, src)
    ply.write_ply(tp, tgt)
    np.savetxt(gp, T_gt)
    return str(sp), str(tp), str(gp), T_gt


def test_parser_covers_reference_surface():
    """Every reference binary's subcommand parses with its flags
    (regression net for flag registration/conflict bugs)."""
    ap = cli.build_parser()
    for argv in (
            ["run", "se3_pt2pl", "s.ply", "t.ply", "--json"],
            ["run", "pt2pt", "s.ply", "t.ply",
             "--initial-transform", "T.txt"],
            ["run", "se3_gicp", "s.ply", "t.ply", "--multi-start", "8"],
            ["example"],
            ["example-fgr", "--save-aligned", "/tmp/x"],
            ["create-problem", "--out", "/tmp/x", "--seed", "2"],
            ["bench-synthetic", "se3_pt2pl", "/tmp/ds", "--generate",
             "--num-cases", "4", "--difficulty", "easy"],
            ["bench-synthetic", "se3_pt2pl", "/tmp/ds", "--alpha-sweep",
             "--out-file", "/tmp/o.txt"],
            ["bench-synthetic", "se3_pt2pl", "/tmp/ds",
             "--multi-start", "8", "--json"],
            ["bench-lounge", "se3_gicp_with_cf", "/tmp/ds", "--analyze"],
            ["bench-lounge", "se3_pt2pl", "/tmp/ds", "--alpha-sweep"],
            ["bench-kitti", "se3_pt2pl", "/tmp/ds", "--max-index", "48",
             "--save-traj", "/tmp/traj.txt"],
            ["bench-kitti", "se3_pt2pl", "/tmp/ds", "--online"],
            ["bench-kitti", "se3_pt2pl", "/tmp/ds", "--analyze"],
            ["bench-extreme-noise", "pt2pt", "/tmp/ds", "--generate"],
            ["test-se3-pure", "se3_pure_pt2pl", "/tmp/ds"],
            ["eval-traj", "gt.txt", "est.txt", "--json"],
            ["bench-scaling", "--per-device", "1", "--cloud", "easy"],
            ["lrf-quality", "s.ply", "t.ply", "gt.txt", "--lrf-k", "30",
             "--dump", "/tmp/d.txt"],
    ):
        args = ap.parse_args(argv)
        assert callable(args.fn), argv


def test_run_rejects_conflicting_flags(tmp_path):
    """--multi-start vs fgr / --initial-transform conflicts exit with
    an error instead of silently picking one (review finding)."""
    sp, tp, gp, _ = _tiny_problem(tmp_path)
    with pytest.raises(SystemExit):
        cli.main(["run", "fgr", sp, tp, "--multi-start", "4"])
    with pytest.raises(SystemExit):
        cli.main(["run", "se3_pt2pl", sp, tp, "--multi-start", "4",
                  "--initial-transform", gp])


def test_run_golden_json(golden_dir, capsys):
    """run se3_pt2pl on the golden problem: printed 4x4 + --json record
    land inside the reference's 2 deg / 0.25 success bounds."""
    cli.main(["run", "se3_pt2pl", f"{golden_dir}/source.ply",
              f"{golden_dir}/target.ply", "--json"])
    rep, out = _last_json(capsys)
    T_gt = ply.read_transform_txt(f"{golden_dir}/transformation_gt.txt")
    T = np.array(rep["T"])
    assert T.shape == (4, 4)
    assert rep["num_iterations"] >= 1
    assert metrics_host.success(T_gt, T)
    assert any("Estimated transformation" in ln for ln in out)


def test_eval_traj_identical_trajectories(tmp_path, capsys):
    """eval-traj on identical 12-col trajectories reports zero error
    and success rate 1.0 (cc::evaluate_trajectory_quality)."""
    rng = np.random.default_rng(3)
    rows = []
    for _ in range(4):
        T = np.eye(4)
        T[:3, 3] = rng.normal(size=3)
        rows.append(T[:3, :4].reshape(-1))
    path = tmp_path / "traj.txt"
    np.savetxt(path, np.stack(rows))
    cli.main(["eval-traj", str(path), str(path), "--json"])
    rep, _ = _last_json(capsys)
    assert rep["success_rate"] == 1.0
    assert rep["avg_rotation_error"] < 1e-6
    assert rep["avg_translation_error"] < 1e-9


def test_create_problem_roundtrip(tmp_path, capsys):
    """create-problem writes a loadable problem folder whose GT matches
    the reference generator's transform (rot_3d(pi/9,pi/8,-pi/7),
    t=(1,2,3); create_and_save_reg_problem.cpp:31-35)."""
    out = tmp_path / "prob"
    cli.main(["create-problem", "--out", str(out), "--seed", "1"])
    src = ply.read_ply(out / "source.ply")
    tgt = ply.read_ply(out / "target.ply")
    T_gt = ply.read_transform_txt(out / "transformation_gt.txt")
    assert len(src) > 1000 and len(tgt) > 1000
    assert T_gt.shape == (4, 4)
    np.testing.assert_allclose(T_gt[:3, 3], [1.0, 2.0, 3.0], atol=1e-5)
    np.testing.assert_allclose(T_gt[3], [0, 0, 0, 1], atol=0)
    from se3_icp.datasets import standin
    np.testing.assert_allclose(T_gt, standin.golden_problem()[2], atol=1e-5)


def test_bench_synthetic_generate_then_benchmark(tmp_path, capsys):
    """bench-synthetic --generate then the saved-data protocol: two
    easy problems register at success rate 1.0 through the CLI."""
    ds = tmp_path / "ds"
    cli.main(["bench-synthetic", "se3_pt2pl", str(ds), "--generate",
              "--num-cases", "2", "--difficulty", "easy"])
    capsys.readouterr()
    cli.main(["bench-synthetic", "se3_pt2pl", str(ds), "--json"])
    rep, _ = _last_json(capsys)
    assert rep["num_problems"] == 2
    assert rep["success_rate"] == 1.0
    assert rep["avg_time_ms"] > 0


def test_lrf_quality_on_exact_problem(tmp_path, capsys):
    """lrf-quality on an exactly-rotated copy: GT correspondences are
    identities and TOLDI is rotation-equivariant, so the mean LRF SO(3)
    error is ~0 (the property cc::evaluate_LRF_quality measures).
    Translation is excluded: the reference's centroid off-by-one
    (quirk #2) breaks exact translation equivariance by design."""
    sp, tp, gp, _ = _tiny_problem(tmp_path, translate=False)
    dump = tmp_path / "errs.txt"
    cli.main(["lrf-quality", sp, tp, gp, "--lrf-k", "30",
              "--dump", str(dump), "--json"])
    rep, _ = _last_json(capsys)
    assert rep["num_corrs"] == 300
    assert rep["mean_lrf_so3_error"] < 0.05
    assert rep["median_lrf_so3_error"] < 0.01
    errs = np.loadtxt(dump)
    assert errs.shape == (300,)
