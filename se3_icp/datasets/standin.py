"""Seeded procedural stand-in for the Stanford bunny and the golden problem.

The reference's inputs (``stanford_bunny.ply`` and the committed
``created_example_reg_problem``) are not shipped with this repository.
This module generates data with the same shapes and the same protocol
so every protocol, test and benchmark runs from a seed:

  * ``bunny_standin``: a STAND-IN for the bunny, not the bunny.  A closed
    star-shaped surface, 208,353 points (the bunny's count, so the
    protocol's 2% downsample gives 4167) at the bunny's native scale
    (~0.15 across; the protocols multiply by 50).  The radius is a fixed
    sum of low-order asymmetric terms, Gaussian bumps, three large lobes
    (two "ears" and a "head", so that a wrongly rotated copy overlaps
    the surface badly, as with the bunny) and 200 plane waves of random
    direction, so the surface has no symmetry and its curvature varies
    at the scale of a k=90 neighborhood -- TOLDI frames are well
    defined almost everywhere.
  * ``golden_problem``: the ``create_and_save_reg_problem`` protocol on
    the stand-in (examples/create_and_save_reg_problem.cpp:14-62): one
    seeded 2% downsample, target = T_gt * source with
    T_gt = (rot_3d(pi/9, pi/8, -pi/7), t = (1, 2, 3)).
"""

from __future__ import annotations

import functools
import os

import numpy as np

BUNNY_POINTS = 208_353
GOLDEN_POINTS = 4167
GOLDEN_SEED = 1

# fixed surface parameters (part of the stand-in's definition, not of a
# run): bumps (direction, width, height) from seed 7, plane waves
# (wave vector, phase, amplitude) from seed 3
_SHAPE = np.random.default_rng(7)
_BUMP_DIRS = _SHAPE.normal(size=(9, 3))
_BUMP_DIRS /= np.linalg.norm(_BUMP_DIRS, axis=1, keepdims=True)
_BUMP_WIDTH = _SHAPE.uniform(0.25, 0.6, 9)
_BUMP_HEIGHT = _SHAPE.uniform(-0.18, 0.35, 9)
_WAVES = np.random.default_rng(3)
_WAVE_K = _WAVES.normal(size=(200, 3))
_WAVE_K *= (_WAVES.uniform(12.0, 25.0, (200, 1))
            / np.linalg.norm(_WAVE_K, axis=1, keepdims=True))
_WAVE_PHASE = _WAVES.uniform(0.0, 2 * np.pi, 200)
_WAVE_AMP = 0.14 * _WAVES.uniform(0.5, 1.0, 200) / np.sqrt(200)
# large lobes: (direction, height, angular width)
_LOBES = ((np.array([0.3, 0.25, 0.92]), 1.2, 0.18),
          (np.array([-0.25, 0.35, 0.9]), 1.1, 0.18),
          (np.array([0.9, -0.3, 0.1]), 0.5, 0.35))
_AXES = np.array([0.06, 0.048, 0.04])        # bunny-like extents


def _radius(u: np.ndarray) -> np.ndarray:
    """Radius factor of the surface along unit directions u [N,3]."""
    x, y, z = u[:, 0], u[:, 1], u[:, 2]
    r = 1.0 + 0.12 * x * y + 0.08 * z ** 3 - 0.1 * x * z * z + 0.06 * y
    cos = u @ _BUMP_DIRS.T                                  # [N, 9]
    r = r + np.sum(_BUMP_HEIGHT * np.exp(
        -(1.0 - cos) / (_BUMP_WIDTH ** 2)), axis=1)
    for d, h, w in _LOBES:
        r = r + h * np.exp(-(1.0 - u @ (d / np.linalg.norm(d))) / w ** 2)
    return r + np.sin(u @ _WAVE_K.T + _WAVE_PHASE) @ _WAVE_AMP


@functools.lru_cache(maxsize=4)
def _bunny_cached(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(BUNNY_POINTS, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = u * _radius(u)[:, None] * _AXES
    pts.setflags(write=False)
    return pts


def bunny_standin(seed: int = 0) -> np.ndarray:
    """[208353, 3] float64 points of the bunny stand-in (native scale).

    Deterministic for a seed; the seed picks the sample points, the
    surface itself is fixed."""
    return np.array(_bunny_cached(int(seed)))


def golden_problem(seed: int = GOLDEN_SEED):
    """(source [4167,3], target [4167,3], T_gt [4,4]) on the stand-in:
    bunny x50, seeded 2% random downsample, target = T_gt * source with
    T_gt = (rot_3d(pi/9, pi/8, -pi/7), t = (1, 2, 3)); the engine runs
    it with ``utils.config.GOLDEN``."""
    from se3_icp.datasets import synthetic
    p = synthetic.golden_like_problem(seed)
    return p.source, p.target, p.T_gt


def save_golden_problem(folder: str, seed: int = GOLDEN_SEED) -> str:
    """Write source.ply / target.ply / transformation_gt.txt (the
    reference's created_example_reg_problem layout); returns folder."""
    from se3_icp.utils import ply
    src, tgt, T = golden_problem(seed)
    os.makedirs(folder, exist_ok=True)
    ply.write_ply(os.path.join(folder, "source.ply"), src)
    ply.write_ply(os.path.join(folder, "target.ply"), tgt)
    np.savetxt(os.path.join(folder, "transformation_gt.txt"), T)
    return folder
