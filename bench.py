#!/usr/bin/env python
"""Headline benchmark: se3_pt2pl registration throughput on the golden
problem (the created_example_reg_problem protocol on the seeded bunny
stand-in, 4167-point clouds, the reference's primary entry-point
protocol), plus secondary per-variant metrics.  Runs on a GPU only: with
no GPU it exits non-zero before measuring anything.

Prints ONE JSON line:
  {"metric": "se3_pt2pl_golden_pairs_per_s", "value": N,
   "unit": "pairs/s", "vs_baseline": R, "extras": {...}, ...}

``extras`` carries the secondary metrics (se3_pt2pt / se3_gicp /
se3_gicp_with_cf / fgr / trimmed-overlap / KITTI-scale pairs/s), each
behind the same 2 deg / 0.25 correctness gate.  BENCH_FAST=1 skips them.

vs_baseline methodology: the reference C++ stack (Open3D/PCL/FLANN) is
not buildable in this image, so the baseline is the measured CPU
reference-proxy in ``baselines/numpy_icp.py`` -- the identical algorithm
with C-compiled cKDTree nearest-neighbor search and numpy-vectorized
per-point math.  Two baseline rates are measured and cached in
``.bench_cpu_baseline.json``:
  * serial: one process, one pair at a time;
  * parallel: pairs-parallel across all visible cores, the honest analog
    of the reference's OpenMP build.
Both run in a child process (``python -m baselines.numpy_icp``) that
never imports JAX, so its fork pool never touches the device.
``vs_baseline`` is computed against the PARALLEL rate (the stricter,
defensible ratio); both rates and both ratios are reported.

A per-phase breakdown (setup vs iteration loop) is recorded in the
JSON by DEFAULT -- the analog of the reference's time_before_pure_icp_
/ time_se3_correspondence_search_ counters (ref:cpp:754,866-878): the
full serving path is re-timed with the iteration caps clamped to 1 and
the slope/intercept give iter_ms / setup_ms with the fixed dispatch+
fetch overhead cancelled (see ``phase_breakdown``).  BENCH_NO_PHASES=1
skips it; BENCH_PHASE_REPS tunes its rep count (default 5).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from se3_icp.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from se3_icp.utils import metrics_host  # noqa: E402
from se3_icp.utils.config import GOLDEN  # noqa: E402
from se3_icp.parallel import pairs as par  # noqa: E402

BASELINE_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              ".bench_cpu_baseline.json")
# pairs per batch program; the batch has not been swept on the GPU
BATCH = int(os.environ.get("BENCH_BATCH", "64"))
REPS = int(os.environ.get("BENCH_REPS", "10"))
SUB_REPS = int(os.environ.get("BENCH_SUB_REPS", "3"))


def load_problem():
    from se3_icp.datasets import standin
    return standin.golden_problem()


def cpu_baseline_rates():
    """{'serial': pairs/s, 'parallel': pairs/s, 'nproc': N}, cached.

    Measured by ``python -m baselines.numpy_icp`` in a child process
    that never imports JAX (its pool forks from a JAX-free parent)."""
    if os.path.exists(BASELINE_CACHE):
        with open(BASELINE_CACHE) as f:
            cache = json.load(f)
        if "parallel_pairs_per_s" in cache:
            return {"serial": cache["pairs_per_s"],
                    "parallel": cache["parallel_pairs_per_s"],
                    "nproc": cache["nproc"]}
    import subprocess
    out = subprocess.run(
        [sys.executable, "-m", "baselines.numpy_icp"], check=True,
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    cache = json.loads(out.stdout.strip().splitlines()[-1])
    with open(BASELINE_CACHE, "w") as f:
        json.dump(cache, f)
    return {"serial": cache["pairs_per_s"],
            "parallel": cache["parallel_pairs_per_s"],
            "nproc": cache["nproc"]}


def make_rep_lists(src, tgt, n_reps, batch, rng):
    """Distinct pair list per rep: fresh source arrays, so every rep
    pays its upload (the device-cloud cache of parallel/pairs.py keys on
    array identity and would skip it for a repeated list)."""
    rep_lists = []
    for _ in range(n_reps + 1):
        pair_list = []
        for _ in range(batch):
            j = rng.normal(scale=1e-4, size=src.shape)
            pair_list.append((src + j, tgt))
        rep_lists.append(pair_list)
    return rep_lists


def timed_variant(rep_lists, algorithm, cfg, T_gt, mesh, n_reps,
                  gate=True, depth=None):
    """Median per-rep pairs/s through the pipelined serving loop: keep
    ``BENCH_DEPTH`` batches in flight (pack/dispatch ahead while the
    device runs; one fused fetch per rep inside the timed region).
    Depth 1 is the classic double buffer; deeper queues hide more host
    work, and the result gate checks every returned transform either
    way."""
    from collections import deque

    if depth is None:
        depth = max(1, int(os.environ.get("BENCH_DEPTH", "1")))
    batch = len(rep_lists[0])

    def check(results):
        # T_gt [4,4] gates every pair against one transform; [B,4,4]
        # gates pair i against T_gt[i] (mixed heterogeneous batches)
        gts = (T_gt if np.asarray(T_gt).ndim == 3
               else [T_gt] * len(results))
        for g, r in zip(gts, results):
            assert metrics_host.success(g, r.transformation), (
                f"{algorithm}: benchmark result failed the 2deg/0.25 "
                "success bound")

    results = par.register_pairs(rep_lists[-1], algorithm, cfg, mesh=mesh)
    if gate:
        check(results)

    def fetch(pending):
        got = pending.result()
        if gate:
            check(got)
        return got

    rep_times = []
    inflight = deque()
    last = None
    t_prev = time.time()
    for rep in range(n_reps):
        inflight.append(par.register_pairs_async(rep_lists[rep],
                                                 algorithm, cfg,
                                                 mesh=mesh))
        if len(inflight) > depth:
            last = fetch(inflight.popleft())
            now = time.time()
            rep_times.append(now - t_prev)
            t_prev = now
    while inflight:
        last = fetch(inflight.popleft())
        now = time.time()
        rep_times.append(now - t_prev)
        t_prev = now
    mean_iters = float(np.mean([r.num_iterations for r in last]))
    mean_pure = float(np.mean([r.num_pure_se3_iterations for r in last]))
    # per-rep rate spread (min/median/max over the timed reps).
    # The FIRST recorded rep pays the pipeline fill (two dispatch
    # packs before its fetch), so it is excluded from the steady-state
    # spread when enough reps exist.
    st = rep_times[1:] if len(rep_times) > 2 else rep_times
    stats = {"min_pairs_per_s": batch / float(np.max(st)),
             "median_pairs_per_s": batch / float(np.median(st)),
             "max_pairs_per_s": batch / float(np.min(st)),
             "n_reps": len(st)}
    return (batch / float(np.median(st)),
            float(np.median(st)), mean_iters, mean_pure, stats)


def phase_breakdown(rep_lists, algorithm, cfg, mesh, n_reps):
    """Setup-vs-loop attribution: time the SAME full-program serving
    path twice -- once at the real iteration caps, once with the caps
    clamped to 1 (same trace, same dispatch/fetch pattern, so the fixed
    round trip and host packing cancel in the subtraction), then

        iter_ms  = (full_ms - capped_ms) / (full_iters - capped_iters)
        setup_ms = capped_ms - capped_iters * iter_ms   [incl. the fixed
                                                         dispatch/fetch
                                                         overhead]

    Both timings run at pipeline depth 1 with the accuracy gate off
    (the additive cancellation assumes neither run overlaps its RTT
    with compute, and the gate's host-side checks must not be timed in
    one leg only).  If the full run converged within ~1 iteration of
    the capped run the split is unmeasurable and iter_ms is None."""
    _, rep_s_f, full_iters, full_pure, _ = timed_variant(
        rep_lists, algorithm, cfg, None, mesh, n_reps, gate=False,
        depth=1)
    full_ms = 1000.0 * rep_s_f
    capped = cfg.replace(max_num_iterations=1, max_num_se3_iterations=1,
                         mse=0.0)
    _, rep_s_c, iters_c, _, _ = timed_variant(
        rep_lists, algorithm, capped, None, mesh, n_reps, gate=False,
        depth=1)
    capped_ms = 1000.0 * rep_s_c
    d_iters = full_iters - iters_c
    if d_iters < 1.0:
        return full_ms, full_iters, full_pure, None, None
    iter_ms = max(full_ms - capped_ms, 0.0) / d_iters
    setup_ms = max(capped_ms - iters_c * iter_ms, 0.0)
    return full_ms, full_iters, full_pure, setup_ms, iter_ms


def kitti_scale_problem(seed=3):
    """A 15k-point LiDAR-like partial-overlap pair (the KITTI protocol's
    scale regime: examples/benchmark_kitti.cpp:102-148) built from the
    fixture generator's road scene."""
    from se3_icp.datasets import fixtures

    rng = np.random.default_rng(seed)
    scene = fixtures._scene(rng, 17000, "road")
    pose_a = fixtures._pose("z", 0.00, (0.0, 0.0, 0.0))
    pose_b = fixtures._pose("z", 0.02, (1.2, 0.05, 0.0))
    src = fixtures._frame_cloud(scene, pose_b, rng, keep=0.88)
    tgt = fixtures._frame_cloud(scene, pose_a, rng, keep=0.88)
    # GT maps src (frame b) onto tgt (frame a): T = A^-1 B
    T_gt = np.linalg.inv(pose_a) @ pose_b
    return src, tgt, T_gt


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform '{dev.platform}'); the "
              "benchmark measures the card only", file=sys.stderr)
        sys.exit(2)
    from chip_smoke import card_line
    batch, reps, sub_reps = BATCH, REPS, SUB_REPS
    src, tgt, T_gt = load_problem()
    rng = np.random.default_rng(0)
    mesh = par.default_mesh() if jax.device_count() > 1 else None

    rep_lists = make_rep_lists(src, tgt, reps, batch, rng)

    profile_dir = os.environ.get("BENCH_PROFILE")
    import contextlib
    prof_ctx = (jax.profiler.trace(profile_dir) if profile_dir
                else contextlib.nullcontext())
    with prof_ctx:
        headline, rep_s, mean_iters, mean_pure, h_stats = timed_variant(
            rep_lists, "se3_pt2pl", GOLDEN, T_gt, mesh, reps)

    out = {
        "metric": "se3_pt2pl_golden_pairs_per_s",
        "value": round(headline, 3),
        "unit": "pairs/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": jax.device_count(),
        "card": card_line(),
        # measured spread over this run's own reps
        "range": {k: (round(v, 3) if isinstance(v, float) else v)
                  for k, v in h_stats.items()},
    }
    # Phase attribution is recorded by default, at the same
    # configuration as the headline.  BENCH_NO_PHASES=1 skips it (the
    # split re-times the serving path twice at depth 1).
    if not os.environ.get("BENCH_NO_PHASES"):
        phase_reps = min(reps, int(os.environ.get("BENCH_PHASE_REPS",
                                                  "5")))
        p_full_ms, p_iters, p_pure, setup_ms, iter_ms = phase_breakdown(
            rep_lists[:phase_reps + 1], "se3_pt2pl", GOLDEN, mesh,
            phase_reps)
        out["phases"] = {
            "batch": batch,
            # depth-1, gate-off re-timing (phase_breakdown's additive
            # cancellation needs both legs un-pipelined and identically
            # gated), so this can differ from the headline's rep time
            "full_ms_per_batch": round(p_full_ms, 2),
            "mean_iterations": round(p_iters, 2),
            # share of loop iterations spent in the SE(3) phase (the
            # analog of time_before_pure_icp_)
            "se3_phase_share": round(p_pure / max(p_iters, 1.0), 3),
        }
        if iter_ms is None:
            out["phases"]["split"] = ("unmeasurable: full run converged "
                                      "within ~1 iteration of the "
                                      "capped run")
        else:
            out["phases"].update({
                # incl. the fixed per-rep dispatch/fetch overhead --
                # see phase_breakdown
                "setup_plus_overhead_ms_per_batch": round(setup_ms, 2),
                "loop_ms_per_batch": round(iter_ms * p_iters, 2),
                "iter_ms": round(iter_ms, 3),
            })

    if not os.environ.get("BENCH_FAST"):
        extras = {}
        sub_lists = rep_lists[:sub_reps + 1]

        def extra(key, fn):
            # Fault-isolate each secondary metric: one variant running
            # out of memory must not take down the headline JSON line.
            # A failed 2deg/0.25 accuracy gate is an accuracy
            # regression, not a transient fault -- label it distinctly
            # and flag it at top level.
            try:
                extras[key] = round(fn(), 3)
            except AssertionError as e:
                msg = str(e).splitlines()[0][:160] if str(e) else "gate"
                extras[key] = f"gate_failed: {msg}"
                out["accuracy_regression"] = True
                print(f"bench: extra {key} FAILED THE ACCURACY GATE: "
                      f"{msg}", file=sys.stderr)
            except Exception as e:  # noqa: BLE001
                msg = str(e).splitlines()[0][:160] if str(e) else repr(e)
                extras[key] = f"error: {type(e).__name__}: {msg}"
                print(f"bench: extra {key} failed: {msg}",
                      file=sys.stderr)

        for alg in ("se3_pt2pt", "se3_gicp", "se3_gicp_with_cf"):
            extra(f"{alg}_golden_pairs_per_s",
                  lambda alg=alg: timed_variant(sub_lists, alg, GOLDEN,
                                                T_gt, mesh, sub_reps)[0])
        # FGR's setup kNN chunks queries with a batch-aware budget
        # (knn._knn_topk_batched), so it runs at the full serving
        # batch; BENCH_FGR_BATCH caps it if needed.
        fgr_batch = min(batch, int(os.environ.get("BENCH_FGR_BATCH",
                                                  str(batch))))
        fgr_lists = ([pl[:fgr_batch] for pl in sub_lists]
                     if fgr_batch < batch else sub_lists)
        # throughput is not batch-linear; record the effective batch so
        # FGR numbers across runs are compared at like-for-like batch
        extras["fgr_batch"] = fgr_batch
        extra("fgr_golden_pairs_per_s",
              lambda: timed_variant(fgr_lists, "fgr", GOLDEN, T_gt,
                                    mesh, sub_reps)[0])
        # trimmed overlap: exercises the per-iteration trim path the
        # overlap-1.0 headline short-circuits
        trim_cfg = GOLDEN.replace(estimated_overlap=0.75)
        extra("se3_pt2pl_trim075_pairs_per_s",
              lambda: timed_variant(sub_lists, "se3_pt2pl", trim_cfg,
                                    T_gt, mesh, sub_reps)[0])
        # depth-4 pipelined serving: deeper queues hide more host work;
        # the depth-1 headline stays the comparable serving number
        extra("se3_pt2pl_golden_depth4_pairs_per_s",
              lambda: timed_variant(rep_lists, "se3_pt2pl", GOLDEN,
                                    T_gt, mesh, reps, depth=4)[0])

        # heterogeneous batch: half golden pairs
        # (~9 iterations) + half easy-synthetic pairs (~18), one shared
        # 4608 bucket -- the converged-pair skip's refund shows up as a
        # smaller effective iter cost than a homogeneous batch at the
        # same mean iteration count.  (moderate/difficult cases are
        # excluded: their single-start basin failures are BY-DESIGN
        # parity behavior -- measured 5/64 moderate fails -- and cannot
        # sit behind the per-pair gate.)
        def mixed_rate():
            from se3_icp.datasets import synthetic

            base_pairs, gts = [], []
            for i in range(batch):
                if i < batch // 2:
                    base_pairs.append((src, tgt))
                    gts.append(T_gt)
                else:
                    p = synthetic.synthetic_problem(
                        "easy", 0.005, seed=100 + i)
                    base_pairs.append((p.source, p.target))
                    gts.append(p.T_gt)
            m_gts = np.asarray(gts)
            # per-rep source jitter: fresh arrays per rep (see
            # make_rep_lists)
            m_lists = [[(s + rng.normal(scale=1e-4, size=s.shape), t)
                        for s, t in base_pairs]
                       for _ in range(sub_reps + 1)]
            rate, _, m_iters, _, _ = timed_variant(
                m_lists, "se3_pt2pl", GOLDEN, m_gts, mesh, sub_reps)
            extras["mixed_mean_iterations"] = round(m_iters, 2)
            return rate
        extra("se3_pt2pl_mixed_pairs_per_s", mixed_rate)
        # KITTI-scale: 15k-point partial-overlap clouds, overlap 0.7
        def kitti_rate():
            ks, kt, k_gt = kitti_scale_problem()
            k_lists = make_rep_lists(ks, kt, sub_reps, 8, rng)
            k_cfg = GOLDEN.replace(estimated_overlap=0.7)
            rate = timed_variant(k_lists, "se3_pt2pl", k_cfg,
                                 k_gt, mesh, sub_reps)[0]
            if not os.environ.get("BENCH_NO_PHASES"):
                # setup/loop attribution at the 15k regime
                (kf_ms, ki, kp, ks_ms, kit_ms) = phase_breakdown(
                    k_lists, "se3_pt2pl", k_cfg, mesh, sub_reps)
                ph = {"batch": 8,
                      "full_ms_per_batch": round(kf_ms, 2),
                      "mean_iterations": round(ki, 2)}
                if kit_ms is not None:
                    ph.update({
                        "setup_plus_overhead_ms_per_batch":
                            round(ks_ms, 2),
                        "loop_ms_per_batch": round(kit_ms * ki, 2),
                        "iter_ms": round(kit_ms, 3)})
                out["kitti15k_phases"] = ph
            return rate
        extra("se3_pt2pl_kitti15k_pairs_per_s", kitti_rate)
        out["extras"] = extras

    base = cpu_baseline_rates()
    out["vs_baseline"] = round(headline / base["parallel"], 3)
    out["baseline"] = {
        "serial_pairs_per_s": round(base["serial"], 3),
        "parallel_pairs_per_s": round(base["parallel"], 3),
        "nproc": base["nproc"],
        "vs_serial": round(headline / base["serial"], 3),
        "vs_parallel": round(headline / base["parallel"], 3),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
