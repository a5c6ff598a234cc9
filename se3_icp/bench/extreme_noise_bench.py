"""Extreme-noise bunny benchmark (examples/benchmark_extreme_noise_bunny
.cpp).

Protocol: 11 noise levels 0.0..0.1 (x cloud diameter std) in folders
``noise_0_0`` .. ``noise_0_1``, 30 saved runs each (:268-333, 390-401);
config overlap=1.0, max_iter=100, mse=1e-9 (+ LRF k=90, switch 5e-5,
max_se3 10 for se3 variants, :289-296); metric: 1000x FilterReg point
error averaged over the 30 runs (:332)."""

from __future__ import annotations

import os

import numpy as np

from se3_icp.bench import common
from se3_icp.datasets import synthetic
from se3_icp.utils import metrics_host, ply
from se3_icp.utils.config import EXTREME_NOISE

LEVEL_FOLDERS = ["noise_0_0"] + [f"noise_0_0{i}" for i in range(1, 10)] \
    + ["noise_0_1"]
LEVELS = [0.0] + [i / 100 for i in range(1, 10)] + [0.1]


def _read_gt(folder: str) -> np.ndarray:
    return ply.read_transform_txt(os.path.join(folder, "gt_transform"))


def benchmark_level_folder(algorithm: str, folder: str, mesh=None,
                           dtype=np.float32) -> float:
    """One noise-level folder: 30 problems vs a shared gt_transform."""
    T_gt = _read_gt(folder)
    pairs = []
    for i in range(30):
        src = ply.read_ply(os.path.join(folder, f"source{i}.ply")).points
        tgt = ply.read_ply(os.path.join(folder, f"target{i}.ply")).points
        pairs.append((src, tgt))
    outcomes = common.run_pairs(pairs, algorithm, EXTREME_NOISE,
                                mesh=mesh, dtype=dtype, verbose=False)
    err = np.mean([metrics_host.error_filterreg(pairs[i][0], T_gt,
                                                outcomes[i].T_est)
                   for i in range(30)])
    return 1000.0 * float(err)


def benchmark_extreme_noise(algorithm: str, folder: str, mesh=None,
                            dtype=np.float32):
    errors = []
    for sub in LEVEL_FOLDERS:
        e = benchmark_level_folder(algorithm, os.path.join(folder, sub),
                                   mesh=mesh, dtype=dtype)
        errors.append(e)
        print(f"{sub}: error = {e}")
    print("Errors for different noise levels (saved data):")
    for e in errors:
        print(f"error = {e}")
    return errors


def generate_dataset(folder: str, runs_per_level=30, seed0=1):
    """Create the noise-level folders from the bunny (protocol of
    benchmark_algorithm_at_noise_level, :372-382: 50 deg z-rotation)."""
    for sub, level in zip(LEVEL_FOLDERS, LEVELS):
        path = os.path.join(folder, sub)
        os.makedirs(path, exist_ok=True)
        T_ref = None
        for i in range(runs_per_level):
            prob = synthetic.extreme_noise_problem(level,
                                                   seed=seed0 + i)
            ply.write_ply(os.path.join(path, f"source{i}.ply"),
                          prob.source)
            ply.write_ply(os.path.join(path, f"target{i}.ply"),
                          prob.target)
            T_ref = prob.T_gt
        np.savetxt(os.path.join(path, "gt_transform"), T_ref[:3, :4])
