"""Data-parallel scaling benchmark (BASELINE.md north star: frames/s
at 1 chip / 1 host / N hosts with >=80% scaling efficiency).

Weak scaling over the ``pairs`` mesh axis: the per-device batch stays
fixed while the device count sweeps a 1,2,4,...,all ladder, so

    efficiency(n) = rate(n) / (n * rate(1))

measures how well the embarrassingly-parallel pair program rides the
mesh (shard_map with zero cross-device communication -- anything below
~1.0 on real chips is dispatch/runtime overhead, not collectives).  On
real multi-chip hardware this is the north-star measurement.  On a CPU
host with virtual devices (``xla_force_host_platform_device_count``)
the devices share the physical cores, so efficiency numbers are
meaningless -- the report carries ``platform`` so consumers can tell;
the CPU run still validates the mechanics end-to-end.

Multi-host measurement runs the same weak-scaling sweep with one
process per host (``jax.distributed.initialize`` +
``parallel/multihost.py``); the mesh then spans every process's
devices and the ladder's top rung is the full pod slice.
"""

from __future__ import annotations

import time

import numpy as np


def device_ladder(n_devices: int) -> list[int]:
    """1, 2, 4, ... doubling ladder, always ending at n_devices."""
    out, c = [], 1
    while c < n_devices:
        out.append(c)
        c *= 2
    out.append(n_devices)
    return sorted(set(out))


def _jittered_lists(prob, n_pairs: int, n_reps: int, rng):
    """Distinct pair list per rep (each rep uploads fresh clouds, so
    the device-cloud cache never short-circuits the upload)."""
    lists = []
    for _ in range(n_reps + 1):
        lists.append([(prob.source
                       + rng.normal(scale=1e-4, size=prob.source.shape),
                       prob.target) for _ in range(n_pairs)])
    return lists


def run_scaling(algorithm: str = "se3_pt2pl", cfg=None,
                per_device: int = 8, reps: int = 3, seed: int = 0,
                cloud: str = "golden", verbose: bool = True) -> dict:
    """Sweep the device ladder; returns the scaling report dict."""
    import jax

    from se3_icp.datasets import synthetic
    from se3_icp.parallel import pairs as par
    from se3_icp.utils.config import GOLDEN

    cfg = cfg or GOLDEN
    devs = jax.devices()
    if cloud == "golden":
        prob = synthetic.golden_like_problem(seed + 1)
    else:
        prob = synthetic.synthetic_problem("easy", 0.002, seed=seed + 1)
    rng = np.random.default_rng(seed)

    counts, rates = [], []
    for n in device_ladder(len(devs)):
        # ALWAYS pin an explicit n-device mesh: mesh=None would be
        # auto-upgraded to all devices by register_pairs_async on a
        # multi-device host, inflating the 1-device base rate and
        # corrupting every efficiency number
        mesh = par.default_mesh(devices=devs[:n])
        batch = per_device * n
        rep_lists = _jittered_lists(prob, batch, reps, rng)
        par.register_pairs(rep_lists[-1], algorithm, cfg, mesh=mesh)
        rep_times = []
        pending = None
        t_prev = time.time()
        for rep in range(reps):
            nxt = par.register_pairs_async(rep_lists[rep], algorithm,
                                           cfg, mesh=mesh)
            if pending is not None:
                pending.result()
                now = time.time()
                rep_times.append(now - t_prev)
                t_prev = now
            pending = nxt
        pending.result()
        rep_times.append(time.time() - t_prev)
        rate = batch / float(np.median(rep_times))
        counts.append(n)
        rates.append(rate)
        if verbose:
            print(f"  devices={n}: {rate:.1f} pairs/s "
                  f"({batch} pairs/rep, median of {reps})")

    base = rates[0]
    report = {
        "metric": "dp_weak_scaling",
        "platform": devs[0].platform,
        "algorithm": algorithm,
        "cloud": cloud,
        "per_device_batch": per_device,
        "device_counts": counts,
        "pairs_per_s": [round(r, 3) for r in rates],
        "efficiency": [round(r / (n * base), 4)
                       for n, r in zip(counts, rates)],
    }
    if devs[0].platform == "cpu":
        report["note"] = ("virtual CPU devices share physical cores; "
                          "efficiency is mechanics-only here")
    return report
