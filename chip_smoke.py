#!/usr/bin/env python
"""On-card smoke test: the registration engine's main path on one GPU.

    python chip_smoke.py                 # every phase, one card
    python chip_smoke.py --phases compile,kernel
    python chip_smoke.py --four-cards    # only the 4-card paths

Phases (each fails the run on any miss; none is skipped over):

  compile   build the batch-64 ``se3_pt2pl`` program on the golden
            stand-in (4167-point clouds, 4608 bucket, TOLDI k=90); print
            compile seconds, ``memory_analysis()`` and peak bytes.
  golden    ``register_pairs`` at batch 64: every pair passes 2 deg /
            0.25 and is < 0.01 deg from ground truth; 2 pairs agree with
            the plain numpy reference (``baselines/numpy_icp``) within
            ``REF_ROT_DEG`` / ``REF_TRA``; wall time and pairs/s of one
            steady window.
  variants  batch 8 at the golden width: pt2pt, pt2pl, gicp, se3_pt2pt,
            se3_gicp, se3_gicp_with_cf, fgr, se3_pt2pl at overlap 0.75,
            and the 15k-point KITTI-scale pair (15360 bucket); each
            gated by 2 deg / 0.25.
  kernel    the Triton 1-NN kernel and ``nn_argmin_xla`` against a
            float64 oracle at 64x4608x12 and 8x15360x12; standalone and
            whole-program (A B B A) timings of both routes.
  tests     ``pytest gpu_tests`` in this process.

``--four-cards`` runs only pair-data-parallel over 4 cards and the 2-D
('pairs', 'points') mesh, each against the 1-card result.

Needs a GPU: with no GPU (or outside a checkout of this repository) it
exits non-zero before printing a result.  The last line of standard
output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from se3_icp.utils.cache import enable_persistent_cache  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

GOLDEN_BATCH = 64
VARIANT_BATCH = 8
VARIANTS = ("pt2pt", "pt2pl", "gicp", "se3_pt2pt", "se3_gicp",
            "se3_gicp_with_cf", "fgr")
KERNEL_SHAPES = ((64, 4608, 12), (8, 15360, 12))
GOLDEN_MAX_DEG = 0.01
# engine (float32) vs the float64 numpy reference on the same pair: both
# converge to the exact solution of a noise-free problem, so they agree
# to float32 resolution of the transform (clouds span ~8 units)
REF_ROT_DEG = 0.01
REF_TRA = 1e-3
PHASES = ("compile", "golden", "variants", "kernel", "tests")


def say(*args):
    print(*args, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the card, from nvidia-smi (no JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi rc={out.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def _block(x):
    return jax.block_until_ready(x)


def _median_time(fn, reps: int) -> float:
    """Median wall seconds of ``fn()`` (which must block) over reps."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def golden_pairs(batch: int, points: int | None = None):
    """``batch`` copies of the golden stand-in pair; ``points`` keeps a
    seeded subset of that many points (CPU rehearsals)."""
    from se3_icp.datasets import standin
    src, tgt, T = standin.golden_problem()
    if points is not None:
        keep = np.random.default_rng(0).permutation(len(src))[:points]
        src, tgt = src[keep], tgt[keep]
    return [(src, tgt)] * batch, T


def _memory_line(ma) -> str:
    if ma is None:
        return "memory_analysis: none"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes",
              "alias_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{f}={getattr(ma, f, 'n/a')}" for f in fields)


def peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def compile_program(pairs, algorithm: str, cfg):
    """AOT-compile the engine's batch program for ``pairs``; returns
    (compiled, device args, compile seconds)."""
    from se3_icp.models import registration as reg
    from se3_icp.parallel import pairs as par
    from se3_icp.utils.config import parse_algorithm
    src, ns, tgt, nt = (jnp.asarray(x) for x in par.pack_pairs(pairs))
    mode, variant = parse_algorithm(algorithm)
    floats, static_cfg = reg.split_cfg(cfg, src.dtype)
    fn = par._compiled_batch(static_cfg, mode, variant, None, "pairs")
    t0 = time.perf_counter()
    compiled = fn.lower(src, ns, tgt, nt, floats).compile()
    return compiled, (src, ns, tgt, nt, floats), time.perf_counter() - t0


def phase_compile(pairs, cfg):
    compiled, args, secs = compile_program(pairs, "se3_pt2pl", cfg)
    say(f"compile: batch {len(pairs)} se3_pt2pl, bucket "
        f"{args[0].shape[1]}: {secs:.2f} s")
    say(_memory_line(compiled.memory_analysis()))
    T, it, _ = _block(compiled(*args))
    assert np.isfinite(np.asarray(T)).all(), "non-finite transforms"
    say(f"compile: one run ok, iterations {np.asarray(it).tolist()[:8]}"
        f"..., peak_bytes_in_use={peak_bytes()}")


def check_pairs(results, T_gt, label: str, max_deg: float | None = None):
    """2 deg / 0.25 gate on every result; optionally a rotation bound."""
    from se3_icp.utils import metrics_host
    gts = T_gt if np.asarray(T_gt).ndim == 3 else [T_gt] * len(results)
    worst = 0.0
    for i, (g, r) in enumerate(zip(gts, results)):
        T = r.transformation
        assert np.isfinite(T).all(), f"{label}: pair {i} non-finite"
        assert metrics_host.success(g, T), f"{label}: pair {i} failed gate"
        worst = max(worst, metrics_host.angular_error_so3(
            T[:3, :3], np.asarray(g)[:3, :3]))
    if max_deg is not None:
        assert worst < max_deg, f"{label}: {worst:.5f} deg >= {max_deg}"
    return worst


def phase_golden(pairs, T_gt, cfg, n_ref: int = 2, reps: int = 5,
                 card: str = ""):
    from baselines import numpy_icp
    from se3_icp.parallel import pairs as par
    from se3_icp.utils import metrics_host
    res = par.register_pairs(pairs, "se3_pt2pl", cfg)
    worst = check_pairs(res, T_gt, "golden", GOLDEN_MAX_DEG)
    say(f"golden: {len(res)} pairs pass, max rotation error "
        f"{worst:.6f} deg, iterations "
        f"{sorted({r.num_iterations for r in res})}")
    for i in range(n_ref):
        src, tgt = pairs[i]
        T_np, it_np = numpy_icp.run_se3_icp_np(
            src, tgt, overlap=cfg.estimated_overlap,
            lrf_k=cfg.number_of_nn_for_lrf,
            max_se3=cfg.max_num_se3_iterations, mse_thresh=cfg.mse,
            switch_thresh=cfg.mse_switch_error)
        T = res[i].transformation
        d_rot = metrics_host.angular_error_so3(T[:3, :3], T_np[:3, :3])
        d_tra = metrics_host.translation_error(T[:3, 3], T_np[:3, 3])
        assert d_rot < REF_ROT_DEG and d_tra < REF_TRA, (
            f"golden pair {i} vs numpy reference: {d_rot} deg, {d_tra}")
        say(f"golden: pair {i} vs numpy reference: {d_rot:.2e} deg, "
            f"{d_tra:.2e} translation (tolerance {REF_ROT_DEG} deg, "
            f"{REF_TRA}); iterations {res[i].num_iterations} vs {it_np}")
    wall = _median_time(
        lambda: par.register_pairs(pairs, "se3_pt2pl", cfg), reps)
    say(f"golden: steady window {reps} calls, median wall {wall:.4f} s "
        f"per batch of {len(pairs)}, {len(pairs) / wall:.2f} pairs/s "
        f"[{card}]")


def variant_cases(pairs, T_gt, cfg, kitti=None):
    """(label, pairs, algorithm, cfg, T_gt) of the variants phase."""
    cases = [(a, pairs, a, cfg, T_gt) for a in VARIANTS]
    cases.append(("se3_pt2pl overlap 0.75", pairs, "se3_pt2pl",
                  cfg.replace(estimated_overlap=0.75), T_gt))
    if kitti is not None:
        k_pairs, k_gt = kitti
        cases.append(("se3_pt2pl kitti15k overlap 0.7", k_pairs,
                      "se3_pt2pl", cfg.replace(estimated_overlap=0.7),
                      k_gt))
    return cases


def phase_variants(cases):
    from se3_icp.parallel import pairs as par
    for label, p, alg, cfg, T_gt in cases:
        t0 = time.perf_counter()
        res = par.register_pairs(p, alg, cfg)
        secs = time.perf_counter() - t0
        worst = check_pairs(res, T_gt, label)
        say(f"variants: {label}: {len(res)} pairs pass, max rotation "
            f"error {worst:.4f} deg, first call {secs:.1f} s "
            f"(incl. compile)")


def nn_oracle_check(q, t, n, idx, label: str):
    """Float64 check of a batched 1-NN result (see module docstring):
    the chosen target is within tol of the float64 minimum, where
    tol = 1e-6 (|q|^2 + max|t|^2).  Returns (idx64, gap_ok) for the
    cross-route agreement test."""
    q64 = np.asarray(q, np.float64)
    t64 = np.asarray(t, np.float64)
    idx = np.asarray(idx)
    out_i, out_gap = [], []
    for b in range(q64.shape[0]):
        tb = t64[b, :n[b]]
        tn = (tb * tb).sum(1)
        scale = (q64[b] ** 2).sum(1) + tn.max()
        best = np.empty(len(q64[b]), np.int64)
        gap = np.empty(len(q64[b]))
        chosen = np.empty(len(q64[b]))
        for s in range(0, len(q64[b]), 1024):
            qb = q64[b, s:s + 1024]
            # float64 expanded form: cancellation is ~1e-16 relative
            d2 = (qb * qb).sum(1)[:, None] - 2.0 * qb @ tb.T + tn[None, :]
            two = np.partition(d2, 1, axis=1)[:, :2]
            best[s:s + 1024] = d2.argmin(1)
            gap[s:s + 1024] = two[:, 1] - two[:, 0]
            chosen[s:s + 1024] = np.take_along_axis(
                d2, idx[b, s:s + 1024, None], 1)[:, 0] - two[:, 0]
        tol = 1e-6 * scale
        assert (idx[b] < n[b]).all(), f"{label}: index past n_targets"
        bad = int((chosen > tol).sum())
        assert bad == 0, f"{label}: pair {b}: {bad} matches beyond tol"
        out_i.append(best)
        out_gap.append(gap > tol)
    return out_i, out_gap


def kernel_inputs(bsz: int, n: int, d: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bsz, n, d)).astype(np.float32)
    t = rng.normal(size=(bsz, n, d)).astype(np.float32)
    nv = np.full(bsz, n - 7, np.int32)
    return q, t, nv


def phase_kernel(shapes=KERNEL_SHAPES, n_check: int = 2, reps: int = 10,
                 ab_pairs=None, ab_cfg=None, interpret: bool = False,
                 card: str = ""):
    import functools
    from se3_icp.ops import knn, triton_nn
    kern = jax.jit(functools.partial(triton_nn.nn_argmin_batched,
                                     interpret=interpret))
    xla = jax.jit(jax.vmap(knn.nn_argmin_xla))
    for bsz, n, d in shapes:
        q, t, nv = kernel_inputs(bsz, n, d)
        qd, td, nd = jnp.asarray(q), jnp.asarray(t), jnp.asarray(nv)
        ki, kd = _block(kern(qd, td, nd))
        xi, xd = _block(xla(qd, td, nd))
        ki, xi = np.asarray(ki), np.asarray(xi)
        m = min(n_check, bsz)
        best, sep = nn_oracle_check(q[:m], t[:m], nv[:m], ki[:m],
                                    f"triton {bsz}x{n}x{d}")
        nn_oracle_check(q[:m], t[:m], nv[:m], xi[:m], f"xla {bsz}x{n}x{d}")
        for b in range(m):
            dis = int(((ki[b] != xi[b]) & sep[b]).sum())
            assert dis == 0, f"{bsz}x{n}x{d} pair {b}: {dis} separated " \
                             "queries disagree with XLA"
        say(f"kernel: {bsz}x{n}x{d}: float64 check ok on {m} pairs; "
            f"index agreement with XLA {np.mean(ki == xi):.6f} overall, "
            f"max |d2 - d2_xla| {float(np.abs(np.asarray(kd) - np.asarray(xd)).max()):.3e}")
        tk = _median_time(lambda: _block(kern(qd, td, nd)), reps)
        tx = _median_time(lambda: _block(xla(qd, td, nd)), reps)
        say(f"kernel: {bsz}x{n}x{d} standalone median of {reps}: triton "
            f"{1e3 * tk:.3f} ms, xla {1e3 * tx:.3f} ms [{card}]")
    if ab_pairs is not None:
        program_ab(ab_pairs, ab_cfg, interpret, card)


def program_ab(pairs, cfg, interpret: bool = False, card: str = "",
               reps: int = 5):
    """Whole batch ``se3_pt2pl`` program with each 1-NN route, timed in
    one process in the order A B B A (A = XLA, B = Triton)."""
    import functools
    from se3_icp.ops import knn, triton_nn
    from se3_icp.parallel import pairs as par
    routes = {"xla": jax.vmap(knn.nn_argmin_xla),
              "triton": functools.partial(triton_nn.nn_argmin_batched,
                                          interpret=interpret)}
    progs = {}
    saved = knn._BATCHED_NN
    try:
        for name, route in routes.items():
            knn._BATCHED_NN = route
            par._compiled_batch.cache_clear()
            jax.clear_caches()
            progs[name] = compile_program(pairs, "se3_pt2pl", cfg)[:2]
    finally:
        knn._BATCHED_NN = saved
        par._compiled_batch.cache_clear()
        jax.clear_caches()
    outs = {name: _block(c(*a)) for name, (c, a) in progs.items()}
    its = {name: np.asarray(o[1]) for name, o in outs.items()}
    dT = float(np.abs(np.asarray(outs["xla"][0])
                      - np.asarray(outs["triton"][0])).max())
    say(f"kernel: program A/B: mean iterations xla "
        f"{its['xla'].mean():.2f}, triton {its['triton'].mean():.2f}, "
        f"max |T_xla - T_triton| {dT:.2e}")
    times = {"xla": [], "triton": []}
    for name in ("xla", "triton", "triton", "xla"):
        c, a = progs[name]
        times[name].append(_median_time(lambda: _block(c(*a)), reps))
    say("kernel: program A/B (A B B A, median of "
        f"{reps} each) batch {len(pairs)} se3_pt2pl: xla "
        f"{[round(1e3 * x, 3) for x in times['xla']]} ms, triton "
        f"{[round(1e3 * x, 3) for x in times['triton']]} ms [{card}]")


def phase_tests(args=()):
    import pytest
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-p", "no:cacheprovider",
                      os.path.join(here, "gpu_tests"), *args])
    assert rc == 0, f"gpu_tests failed (pytest exit code {rc})"
    say("tests: gpu_tests passed")


def four_cards(pairs, cfg, devices):
    """Pair-DP over 4 cards and the 2x2 ('pairs','points') mesh, each
    against the 1-card program on the same pairs."""
    from jax.sharding import Mesh
    from se3_icp.parallel import pairs as par
    from se3_icp.parallel import points as mp
    assert len(devices) >= 4, f"need 4 devices, have {len(devices)}"
    src, ns, tgt, nt = (jnp.asarray(x) for x in par.pack_pairs(pairs))
    one = jax.device_put((src, ns, tgt, nt), devices[0])
    T1, it1, _ = jax.device_get(par.register_batch(*one, cfg, "se3_pt2pl"))
    mesh = Mesh(np.asarray(devices[:4]), ("pairs",))
    T4, it4, _ = jax.device_get(par.register_batch(src, ns, tgt, nt, cfg,
                                                   "se3_pt2pl", mesh))
    err = float(np.abs(T4 - T1).max())
    assert (it4 == it1).all(), (it4, it1)
    assert err < 1e-5, f"4-card DP vs 1 card: {err}"
    say(f"four-cards: pair-DP {len(pairs)} pairs over 4 cards: equal "
        f"iterations {it4.tolist()}, max |T_4 - T_1| = {err:.3e} "
        "(bound 1e-5)")
    mesh2 = Mesh(np.asarray(devices[:4]).reshape(2, 2),
                 ("pairs", "points"))
    b2 = 2 * (len(pairs) // 2)
    T2, it2, _ = jax.device_get(mp.register_batch_2d(
        src[:b2], ns[:b2], tgt[:b2], nt[:b2], cfg, "se3_pt2pl", mesh2))
    err2 = float(np.abs(np.asarray(T2) - T1[:b2]).max())
    assert err2 < 1e-4, f"2-D mesh vs 1 card: {err2}"
    say(f"four-cards: 2-D mesh (2 pairs x 2 points) {b2} pairs: max "
        f"|T_2d - T_1| = {err2:.3e} (bound 1e-4), iterations "
        f"{np.asarray(it2).tolist()} vs {it1[:b2].tolist()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {PHASES}")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card paths")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    kind = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    say(f"device: platform {dev.platform}, kind {dev.device_kind}, "
        f"count {kind['count']}")
    if dev.platform != "gpu":
        say("chip_smoke: no GPU found (JAX platform "
            f"'{dev.platform}'); this check runs only on a GPU")
        return 2
    card = card_line()
    say(f"card: {card}")
    say(f"jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
        f"cache {enable_persistent_cache()}")

    from se3_icp.utils.config import GOLDEN
    t_start = time.perf_counter()
    if args.four_cards:
        pairs, _ = golden_pairs(VARIANT_BATCH)
        four_cards(pairs, GOLDEN, jax.devices())
        kind["count"] = 4
    else:
        phases = [p for p in args.phases.split(",") if p]
        unknown = set(phases) - set(PHASES)
        assert not unknown, f"unknown phases {unknown}"
        pairs, T_gt = golden_pairs(GOLDEN_BATCH)
        for ph in phases:
            t0 = time.perf_counter()
            say(f"--- phase {ph}")
            if ph == "compile":
                phase_compile(pairs, GOLDEN)
            elif ph == "golden":
                phase_golden(pairs, T_gt, GOLDEN, card=card)
            elif ph == "variants":
                import bench
                ks, kt, k_gt = bench.kitti_scale_problem()
                phase_variants(variant_cases(
                    pairs[:VARIANT_BATCH], T_gt, GOLDEN,
                    kitti=([(ks, kt)] * VARIANT_BATCH, k_gt)))
            elif ph == "kernel":
                phase_kernel(ab_pairs=pairs, ab_cfg=GOLDEN, card=card)
            elif ph == "tests":
                phase_tests()
            say(f"--- phase {ph} passed in {time.perf_counter() - t0:.1f} s")
    say(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps({"ok": True, "device": kind}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
