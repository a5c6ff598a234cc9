"""Multi-host data parallelism: frame pairs sharded across processes.

The reference is single-process (SURVEY.md §2.5); here the sequence
benchmarks scale past one host with the standard JAX SPMD recipe:

  1. every process calls :func:`initialize` (coordinator rendezvous);
  2. each process loads only ITS slice of the pair list (per-host IO);
  3. :func:`register_pairs_multihost` builds one global mesh over all
     devices, assembles the globally-sharded batch from per-process
     local shards (``jax.make_array_from_process_local_data``), runs
     the same cached compiled program as the single-host path (zero
     cross-pair communication -- the collectives are only the implicit
     result resharding), and returns ALL results to every host via
     ``multihost_utils.process_allgather``.

Tested in CI with 2 CPU processes x 2 virtual devices over the Gloo
backend (tests/test_multihost.py), which exercises exactly the
cross-process code path a multi-host GPU cluster uses.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, cpu_devices_per_process: int | None = None):
    """Process-group rendezvous.  For CPU testing pass
    ``cpu_devices_per_process`` to force a virtual device count (must
    run before any backend use)."""
    import os
    if cpu_devices_per_process:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count="
              f"{cpu_devices_per_process}")
        jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_pairs_mesh(axis: str = "pairs") -> Mesh:
    return Mesh(np.asarray(jax.devices()), (axis,))


def register_pairs_multihost(local_pairs, algorithm: str, cfg,
                             axis: str = "pairs", dtype=np.float32,
                             bucket: int = 512):
    """Register pairs distributed over all processes.

    ``local_pairs``: THIS process's list of (src, tgt) numpy clouds.
    Every process must call this collectively.  Cloud padding and
    per-process pair counts are agreed globally (max over processes;
    short processes pad by repeating their last pair).  Returns the
    full result list, ordered process-major, identical on every host.
    """
    from jax.experimental import multihost_utils

    from se3_icp.models import registration as reg
    from se3_icp.parallel import pairs as par

    nproc = jax.process_count()
    # a process MAY hold zero pairs (short global lists): it still has
    # to participate in every collective, so it pads with a dummy pair
    local_max_pts = (max(max(len(s), len(t)) for s, t in local_pairs)
                     if local_pairs else 1)
    agreed = multihost_utils.process_allgather(
        np.asarray([local_max_pts, len(local_pairs)], np.int64))
    n_pad = reg._bucket(int(agreed[:, 0].max()), bucket)
    per_proc = int(agreed[:, 1].max())
    if per_proc == 0:
        return []
    # pad the local list to the agreed per-process count
    n_real_local = len(local_pairs)
    filler = (local_pairs[-1] if local_pairs
              else (np.zeros((1, 3)), np.zeros((1, 3))))
    pairs_padded = list(local_pairs) + [filler] * (
        per_proc - n_real_local)

    src = np.zeros((per_proc, n_pad, 3), dtype)
    tgt = np.zeros((per_proc, n_pad, 3), dtype)
    n_src = np.zeros(per_proc, np.int32)
    n_tgt = np.zeros(per_proc, np.int32)
    for i, (s, t) in enumerate(pairs_padded):
        src[i, :len(s)] = s
        tgt[i, :len(t)] = t
        n_src[i], n_tgt[i] = len(s), len(t)

    mesh = global_pairs_mesh(axis)
    ndev = jax.device_count()
    total = per_proc * nproc
    if total % ndev:
        # register_batch would pad the global pair axis, which breaks
        # the process-local assembly below; repeat-pad per process so
        # the global count divides the mesh
        extra = (-total) % ndev
        per_extra = -(-extra // nproc)
        src = np.concatenate([src, np.repeat(src[-1:], per_extra, 0)], 0)
        tgt = np.concatenate([tgt, np.repeat(tgt[-1:], per_extra, 0)], 0)
        n_src = np.concatenate([n_src, np.repeat(n_src[-1:], per_extra)])
        n_tgt = np.concatenate([n_tgt, np.repeat(n_tgt[-1:], per_extra)])
        per_proc += per_extra

    shard = NamedSharding(mesh, P(axis))

    def globalize(x):
        return jax.make_array_from_process_local_data(shard, x)

    if algorithm == "fgr":
        from se3_icp.models import fgr
        fcfg = cfg if isinstance(cfg, fgr.FGRConfig) else fgr.FGRConfig()
        prog = par._compiled_batch_fgr(fcfg, mesh, axis)
        out = prog(globalize(src), globalize(n_src), globalize(tgt),
                   globalize(n_tgt))
    else:
        from se3_icp.utils.config import parse_algorithm
        mode, variant = parse_algorithm(algorithm)
        floats, static_cfg = reg.split_cfg(cfg, src.dtype)
        prog = par._compiled_batch(static_cfg, mode, variant, mesh, axis)
        out = prog(globalize(src), globalize(n_src), globalize(tgt),
                   globalize(n_tgt), floats)

    T, it, pure = (np.asarray(x) for x in
                   multihost_utils.process_allgather(out, tiled=True))
    results = []
    for p in range(nproc):
        real = int(agreed[p, 1])
        base = p * per_proc
        for i in range(real):
            results.append(reg.RegistrationResult(
                np.asarray(T[base + i], np.float64),
                int(it[base + i]), int(pure[base + i])))
    return results
