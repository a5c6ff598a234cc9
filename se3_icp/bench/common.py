"""Shared benchmark-harness machinery.

Adds two capabilities on top of the reference protocols:
  * frame pairs run data-parallel over the device mesh
    (``parallel.pairs``) instead of serially;
  * per-pair results checkpoint to a JSONL file so long multi-host
    sequence runs are resumable (new capability, SURVEY.md §5).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np

from se3_icp.parallel import pairs as par
from se3_icp.utils.config import RegistrationConfig


@dataclass
class PairOutcome:
    index: int
    T_est: np.ndarray
    num_iterations: int
    num_pure_se3_iterations: int
    wall_ms: float


def hybrid_alpha_grid():
    """makeHybridLGrid (benchmark_synthetic.cpp:59-89 /
    benchmark_lounge.cpp:363-393)."""
    grid = [0.0]
    grid += [i * 0.01 for i in range(1, 11)]
    grid += [i * 0.1 for i in range(2, 11)]
    grid += [1.0 + i * 0.5 for i in range(0, 9)]
    grid += [5, 7, 10, 15, 25, 50, 60, 70, 80, 90, 100,
             200, 300, 400, 500, 600, 700, 800, 900, 1000]
    return sorted(set(round(g, 10) for g in grid))


class Checkpoint:
    """Append-only JSONL of per-pair results; resumable."""

    def __init__(self, path: str | None):
        self.path = path
        self.done: dict[int, PairOutcome] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        # a run killed mid-write leaves a truncated
                        # final line; the whole point of the checkpoint
                        # is surviving that -- skip and recompute it
                        continue
                    self.done[rec["index"]] = PairOutcome(
                        rec["index"], np.asarray(rec["T_est"]),
                        rec["num_iterations"],
                        rec["num_pure_se3_iterations"], rec["wall_ms"])

    def add(self, outcome: PairOutcome):
        self.done[outcome.index] = outcome
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps({
                    "index": outcome.index,
                    "T_est": np.asarray(outcome.T_est).tolist(),
                    "num_iterations": outcome.num_iterations,
                    "num_pure_se3_iterations":
                        outcome.num_pure_se3_iterations,
                    "wall_ms": outcome.wall_ms,
                }) + "\n")


def run_pairs(pair_list, algorithm: str, cfg: RegistrationConfig,
              mesh=None, chunk: int | None = None,
              checkpoint: str | None = None, dtype=np.float32,
              verbose: bool = True):
    """Register an indexed list of (src, tgt) pairs, DP-sharded, chunked,
    resumable.  Returns {index: PairOutcome}."""
    ck = Checkpoint(checkpoint)
    todo = [i for i in range(len(pair_list)) if i not in ck.done]
    if not todo:
        return ck.done
    import jax
    if mesh is None and jax.device_count() > 1:
        mesh = par.default_mesh()
    ndev = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
    # size batches from the FULL pair list (not the resume remainder):
    # a checkpoint resume with 3 leftover pairs should reuse the
    # full-run batch shape, not compile a fresh 3-pair program
    chunk = chunk or max(ndev, min(32, len(pair_list)))
    chunk = -(-chunk // ndev) * ndev
    for lo in range(0, len(todo), chunk):
        sel = todo[lo:lo + chunk]
        batch = [pair_list[i] for i in sel]
        # pad the tail batch to the chunk size (repeat the last pair):
        # a smaller final batch is a new shape and recompiles the whole
        # program for a few stragglers
        n_real = len(batch)
        batch = batch + [batch[-1]] * (chunk - n_real)
        t0 = time.time()
        results = par.register_pairs(batch, algorithm, cfg, mesh=mesh,
                                     dtype=dtype)[:n_real]
        wall = (time.time() - t0) * 1e3 / n_real
        for i, r in zip(sel, results):
            ck.add(PairOutcome(i, r.transformation, r.num_iterations,
                               r.num_pure_se3_iterations, wall))
        if verbose:
            print(f"  pairs {sel[0]}..{sel[-1]}: {wall:.1f} ms/pair "
                  f"(batch of {len(sel)} on {ndev} device(s))")
    return ck.done


def alignment_difficulty(src, tgt, gt, nn_d):
    """Per-pair dataset-difficulty metrics shared by the lounge/KITTI
    analyzers (the reference's dormant evaluate_*_registration_
    difficulty / Chamfer analyses): returns (starting NN mean, after-GT
    NN mean, top-70% trimmed mean, Chamfer squared-form sum).
    ``nn_d(queries, targets)`` -> per-query NN distances."""
    start = float(nn_d(src, tgt).mean())
    moved = src @ gt[:3, :3].T + gt[:3, 3]
    d_lr = nn_d(moved, tgt)
    d_rl = nn_d(tgt, moved)
    after = float(d_lr.mean())
    k70 = max(1, int(0.7 * len(d_lr)))
    top70 = float(np.sort(d_lr)[:k70].mean())
    chamfer = float((d_lr ** 2).mean() + (d_rl ** 2).mean())
    return start, after, top70, chamfer
