"""Synthetic registration-problem generation (bunny protocol).

Host-side numpy port of the reference's generators:
  * ``create_and_save_reg_problem`` (examples/create_and_save_reg_problem
    .cpp:14-62): bunny x50, seeded 2% random downsample, fixed GT.
  * ``syntetic_experiment_noisy_over_common_cases``
    (examples/benchmark_synthetic.cpp:91-182): per-case random rigid GT
    drawn from easy/moderate/difficult ranges, independent target
    downsample, isotropic gaussian noise.
  * extreme-noise bunny levels (examples/benchmark_extreme_noise_bunny
    .cpp:372-401): noise std as a fraction of cloud diameter.

Seeds give determinism but not bitwise parity with Open3D's RNG --
the protocol (distributions, parameters) is what's preserved.  The
bunny is the seeded stand-in of ``datasets.standin`` (the real scan is
not shipped).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from se3_icp.utils import ply

# perturbation ranges (benchmark_synthetic.cpp:106-116)
DIFFICULTY = {
    "easy": (5.0, np.pi / 4),
    "moderate": (10.0, np.pi / 2),
    "difficult": (15.0, np.pi),
}


@dataclass
class RegistrationProblem:
    source: np.ndarray
    target: np.ndarray
    T_gt: np.ndarray


def _rot_3d(roll, pitch, yaw):
    from scipy.spatial.transform import Rotation
    return Rotation.from_euler("xyz", [roll, pitch, yaw]).as_matrix()


def load_bunny(scale: float = 50.0) -> np.ndarray:
    from se3_icp.datasets import standin
    return standin.bunny_standin() * scale


def random_downsample(points: np.ndarray, ratio: float,
                      rng: np.random.Generator) -> np.ndarray:
    """Open3D RandomDownSample analog: uniform sample without
    replacement of floor(ratio*N) points."""
    n = int(len(points) * ratio)
    idx = rng.permutation(len(points))[:n]
    return points[idx]


def add_noise(points: np.ndarray, diag_cov: float,
              rng: np.random.Generator) -> np.ndarray:
    """Isotropic gaussian noise N(0, diag_cov * I)
    (benchmark_synthetic.cpp:13-56: covariance = noise * I)."""
    return points + rng.normal(scale=np.sqrt(diag_cov), size=points.shape)


def golden_like_problem(seed: int = 1) -> RegistrationProblem:
    """The create_and_save_reg_problem protocol: same downsample for both
    clouds, GT = (rot_3d(pi/9, pi/8, -pi/7), t=(1,2,3))."""
    rng = np.random.default_rng(seed)
    src = random_downsample(load_bunny(), 0.02, rng)
    T = np.eye(4)
    T[:3, :3] = _rot_3d(np.pi / 9, np.pi / 8, -np.pi / 7)
    T[:3, 3] = (1.0, 2.0, 3.0)
    tgt = src @ T[:3, :3].T + T[:3, 3]
    return RegistrationProblem(src, tgt, T)


def synthetic_problem(difficulty: str = "moderate",
                      diag_cov_noise: float = 0.005,
                      seed: int = 1) -> RegistrationProblem:
    """One case of the noisy synthetic protocol
    (benchmark_synthetic.cpp:139-158): source = seeded 2% downsample of
    bunny x50; target = independently downsampled GT-transformed bunny;
    both noised."""
    rng = np.random.default_rng(seed)
    bunny = load_bunny()
    t_range, r_range = DIFFICULTY[difficulty]
    t = rng.uniform(-t_range, t_range, 3)
    R = _rot_3d(*rng.uniform(-r_range, r_range, 3))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    src = random_downsample(bunny, 0.02, rng)
    tgt = random_downsample(bunny @ R.T + t, 0.02, rng)
    src = add_noise(src, diag_cov_noise, rng)
    tgt = add_noise(tgt, diag_cov_noise, rng)
    return RegistrationProblem(src, tgt, T)


def extreme_noise_problem(noise_level: float, rot_deg: float = 50.0,
                          seed: int = 1) -> RegistrationProblem:
    """Extreme-noise protocol (benchmark_extreme_noise_bunny.cpp:372-382):
    z-axis rotation of ``rot_deg``, noise std = noise_level * diameter."""
    rng = np.random.default_rng(seed)
    src = random_downsample(load_bunny(), 0.02, rng)
    diameter = np.linalg.norm(src.max(0) - src.min(0))
    theta = np.radians(rot_deg)
    T = np.eye(4)
    T[:3, :3] = _rot_3d(0.0, 0.0, theta)
    tgt = src @ T[:3, :3].T
    std = noise_level * diameter
    if std > 0:
        src = src + rng.normal(scale=std, size=src.shape)
        tgt = tgt + rng.normal(scale=std, size=tgt.shape)
    return RegistrationProblem(src, tgt, T)


def save_problem_folder(folder: str, problems: list[RegistrationProblem]):
    """Write source{i}.ply / target{i}.ply / gt_data like the reference's
    saved-data layout (benchmark_synthetic.cpp:162-182, 300-339)."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "gt_data"), "w") as f:
        for i, p in enumerate(problems):
            ply.write_ply(os.path.join(folder, f"source{i}.ply"), p.source)
            ply.write_ply(os.path.join(folder, f"target{i}.ply"), p.target)
            f.write(" ".join(f"{v:.8f}" for v in p.T_gt[:3, :4].ravel())
                    + "\n")


def load_problem_folder(folder: str) -> list[RegistrationProblem]:
    """Read the reference's saved-data layout."""
    gt = ply.read_trajectory_12col(os.path.join(folder, "gt_data"))
    out = []
    i = 0
    while True:
        sp = os.path.join(folder, f"source{i}.ply")
        tp = os.path.join(folder, f"target{i}.ply")
        if not (os.path.exists(sp) and os.path.exists(tp) and i < len(gt)):
            break
        out.append(RegistrationProblem(
            ply.read_ply(sp).points, ply.read_ply(tp).points, gt[i]))
        i += 1
    return out


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Open3D ``VoxelDownSample`` semantics (dormant in the reference:
    commented out at registration_example.cpp:18): bucket points into a
    regular grid anchored at the min bound, return per-voxel centroids.
    Host-side preprocessing (like all dataset construction here)."""
    pts = np.asarray(points, dtype=np.float64)
    if voxel_size <= 0:
        raise ValueError("voxel_size must be positive")
    idx = np.floor((pts - pts.min(axis=0)) / voxel_size).astype(np.int64)
    # linearize 3-D voxel coordinates for grouping
    dims = idx.max(axis=0) + 1
    lin = (idx[:, 0] * dims[1] + idx[:, 1]) * dims[2] + idx[:, 2]
    order = np.argsort(lin, kind="stable")
    lin_sorted = lin[order]
    starts = np.flatnonzero(np.r_[True, lin_sorted[1:] != lin_sorted[:-1]])
    sums = np.add.reduceat(pts[order], starts, axis=0)
    counts = np.diff(np.r_[starts, len(lin_sorted)])
    return sums / counts[:, None]
