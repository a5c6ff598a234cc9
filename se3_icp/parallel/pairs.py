"""Data-parallel registration: shard independent frame pairs over chips.

The reference processes sequence benchmarks serially
(benchmark_kitti.cpp:120, benchmark_lounge.cpp:154); here the pair axis
becomes a ``jax.sharding.Mesh`` axis: every chip runs the full on-device
ICP while-loop on its shard of pairs via ``shard_map`` + an inner
``vmap``, with zero cross-chip communication (embarrassingly parallel --
SURVEY.md §2.5).  The vmapped while_loop runs until every pair in the
local shard converges; per-pair ``done`` masking keeps finished pairs
idle and results exact.

For multi-host: call ``jax.distributed.initialize()`` first; each host
feeds its local pairs (jax.make_array_from_process_local_data) and the
same program runs over every host's devices.
"""

from __future__ import annotations

import collections
import functools
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from se3_icp.models import registration as reg
from se3_icp.utils.config import RegistrationConfig, parse_algorithm


def default_mesh(axis: str = "pairs", devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


# Compiled batch programs are cached by (static config, mesh, axis):
# a fresh jit-of-closure per call would miss the jit cache every time,
# and a jit with the FULL config static would recompile for every value
# of a hyperparameter sweep (the alpha grid).  Float hyperparameters
# travel as one traced vector (registration.split_cfg).

def _pad_to_bucket(x):
    """Pad a [N,3] cloud to the 512-point bucket ON DEVICE: uploads can
    carry the exact max point count of the batch (pack_pairs pad='max'),
    keeping the pad bytes off the host link.  A no-op for
    already-aligned inputs."""
    b = reg._bucket(x.shape[0])
    if b == x.shape[0]:
        return x
    return jnp.pad(x, ((0, b - x.shape[0]), (0, 0)))


@functools.lru_cache(maxsize=128)
def _compiled_batch(static_cfg, mode, variant, mesh, axis,
                    with_t0: bool = False, setup_only: bool = False):
    if with_t0:
        def one(s, ns, t, nt, fl, t0):
            return reg._register_arrays_jit(_pad_to_bucket(s), ns,
                                            _pad_to_bucket(t), nt, fl,
                                            cfg=static_cfg, mode=mode,
                                            variant=variant, T0=t0,
                                            setup_only=setup_only)
        batched = jax.vmap(one, in_axes=(0, 0, 0, 0, None, 0))
        specs = (P(axis), P(axis), P(axis), P(axis), P(), P(axis))
    else:
        def one(s, ns, t, nt, fl):
            return reg._register_arrays_jit(_pad_to_bucket(s), ns,
                                            _pad_to_bucket(t), nt, fl,
                                            cfg=static_cfg, mode=mode,
                                            variant=variant,
                                            setup_only=setup_only)
        batched = jax.vmap(one, in_axes=(0, 0, 0, 0, None))
        specs = (P(axis), P(axis), P(axis), P(axis), P())
    if mesh is None:
        return jax.jit(batched)

    @functools.partial(jax.shard_map, mesh=mesh, check_vma=False, in_specs=specs,
                       out_specs=P(axis))
    def _sharded(*args):
        return batched(*args)

    return jax.jit(_sharded)


@functools.lru_cache(maxsize=32)
def _compiled_batch_fgr(fgr_cfg, mesh, axis):
    from se3_icp.models import fgr

    def one(s, ns, t, nt):
        return fgr.fgr_register_arrays(_pad_to_bucket(s), ns,
                                       _pad_to_bucket(t), nt, fgr_cfg)

    batched = jax.vmap(one)
    if mesh is None:
        return jax.jit(batched)

    @functools.partial(jax.shard_map, mesh=mesh, check_vma=False,
                       in_specs=(P(axis), P(axis), P(axis), P(axis)),
                       out_specs=P(axis))
    def _sharded(s, ns, t, nt):
        return batched(s, ns, t, nt)

    return jax.jit(_sharded)


def register_batch(src, n_src, tgt, n_tgt, cfg: RegistrationConfig,
                   algorithm: str, mesh: Mesh | None = None,
                   axis: str = "pairs", initial_T=None):
    """Register a batch of padded pairs.

    src [P,Ns,3], n_src [P], tgt [P,Nt,3], n_tgt [P].  With ``mesh``,
    the leading pair axis is sharded across it.  ``initial_T`` [P,4,4]
    optionally warm-starts each pair (original coordinates; not
    supported for fgr).  Returns (T [P,4,4], iters [P], pure_iters [P]).
    """
    if initial_T is not None and algorithm == "fgr":
        raise ValueError("initial_T is not supported for fgr (a global "
                         "method: it estimates from scratch by design)")
    if mesh is not None:
        ndev = mesh.shape[axis]
        p = src.shape[0]
        pad = (-p) % ndev
        if pad:
            def padp(x):
                return jnp.concatenate([x, jnp.repeat(x[-1:], pad, 0)], 0)
            src, tgt = padp(src), padp(tgt)
            n_src, n_tgt = padp(n_src), padp(n_tgt)
            if initial_T is not None:
                initial_T = padp(initial_T)
        shard = NamedSharding(mesh, P(axis))
        src = jax.device_put(src, shard)
        tgt = jax.device_put(tgt, shard)
        n_src = jax.device_put(n_src, shard)
        n_tgt = jax.device_put(n_tgt, shard)
        if initial_T is not None:
            initial_T = jax.device_put(initial_T, shard)
    else:
        pad = 0
        p = src.shape[0]

    if algorithm == "fgr":
        from se3_icp.models import fgr
        fcfg = cfg if isinstance(cfg, fgr.FGRConfig) else fgr.FGRConfig()
        out = _compiled_batch_fgr(fcfg, mesh, axis)(src, n_src, tgt,
                                                    n_tgt)
    else:
        mode, variant = parse_algorithm(algorithm)
        floats, static_cfg = reg.split_cfg(cfg, src.dtype)
        if initial_T is None:
            out = _compiled_batch(static_cfg, mode, variant, mesh, axis)(
                src, n_src, tgt, n_tgt, floats)
        else:
            out = _compiled_batch(static_cfg, mode, variant, mesh, axis,
                                  with_t0=True)(
                src, n_src, tgt, n_tgt, floats,
                jnp.asarray(initial_T, src.dtype))
    if pad:
        out = tuple(x[:p] for x in out)
    return out


def setup_checksum_batch(src, n_src, tgt, n_tgt,
                         cfg: RegistrationConfig, algorithm: str,
                         mesh: Mesh | None = None, axis: str = "pairs"):
    """Dispatch the engine's setup-only program (everything before the
    iteration loop) over the SAME mesh/shard layout as register_batch,
    returning a [P] per-pair checksum.  This is a sharding-consistency
    oracle: tests/test_parallel.py checks the sharded checksum matches
    the single-device one bitwise, pinning every pre-loop tensor."""
    mode, variant = parse_algorithm(algorithm)
    floats, static_cfg = reg.split_cfg(cfg, src.dtype)
    p = src.shape[0]
    if mesh is not None:
        ndev = mesh.shape[axis]
        pad = (-p) % ndev
        if pad:
            def padp(x):
                return jnp.concatenate([x, jnp.repeat(x[-1:], pad, 0)], 0)
            src, tgt = padp(src), padp(tgt)
            n_src, n_tgt = padp(n_src), padp(n_tgt)
        shard = NamedSharding(mesh, P(axis))
        src, tgt = jax.device_put(src, shard), jax.device_put(tgt, shard)
        n_src = jax.device_put(n_src, shard)
        n_tgt = jax.device_put(n_tgt, shard)
    out = _compiled_batch(static_cfg, mode, variant, mesh, axis,
                          setup_only=True)(src, n_src, tgt, n_tgt, floats)
    return out[:p]


def pack_clouds(clouds, dtype=np.float32, bucket: int = 512,
                pad: str = "bucket"):
    """Host-side packing of one cloud list -> ([P,N,3], counts [P]).
    Non-finite points are dropped (see registration.sanitize_cloud).

    ``pad``: 'bucket' pads N to the 512-point bucket (device-ready);
    'max' pads only to the batch's max count -- callers then pad to the
    bucket ON DEVICE (``_pad_to_bucket``), which keeps the pad bytes off
    the host link.

    Fast path: the native library packs (sanitize + pad + f64->f32)
    OpenMP-parallel across clouds -- the serial numpy loop was ~half
    the host time of a 64-pair serving batch."""
    raw = [np.asarray(c, np.float64).reshape(-1, 3) for c in clouds]
    n_max = max(len(c) for c in raw)
    width = n_max if pad == "max" else reg._bucket(n_max, bucket)
    if dtype == np.float32:
        from se3_icp.utils import native
        got = native.pack_pairs_f32(raw, width)
        if got is not None:
            return got

    raw = [reg.sanitize_cloud(c) for c in raw]
    p = len(raw)
    out = np.zeros((p, width, 3), dtype)
    counts = np.zeros(p, np.int32)
    for i, c in enumerate(raw):
        out[i, :len(c)] = c
        counts[i] = len(c)
    return out, counts


def pack_pairs(pairs, dtype=np.float32, bucket: int = 512,
               pad: str = "bucket"):
    """Host-side packing: list of (src_pts, tgt_pts) -> padded batch
    arrays (src [P,Ns,3], n_src [P], tgt [P,Nt,3], n_tgt [P])."""
    src, n_src = pack_clouds([s for s, _ in pairs], dtype, bucket, pad)
    tgt, n_tgt = pack_clouds([t for _, t in pairs], dtype, bucket, pad)
    return src, n_src, tgt, n_tgt


# --- device-resident cloud-batch cache -------------------------------
#
# A 64-pair golden batch uploads 7 MB of clouds per call.  Real serving
# patterns repeat clouds across calls -- scan-to-model registration reuses one
# target for every source; sequence odometry reuses each scan as the
# source of one pair and the target of the next -- so
# ``register_pairs_async`` memoizes the device upload of each cloud
# BATCH side, keyed by the identity of the caller's arrays (plus a
# sampled-value fingerprint), and skips re-uploading a side whose
# arrays are unchanged.  Entries are invalidated when any referenced
# array is garbage collected (weakrefs).  Clouds passed to
# register_pairs are treated as immutable, like jax inputs generally;
# disable with SE3_ICP_NO_CLOUD_CACHE=1.

_CLOUD_CACHE_MAX = 8
_cloud_cache: collections.OrderedDict = collections.OrderedDict()


def _cloud_cache_key(clouds, dtype, shard):
    if os.environ.get("SE3_ICP_NO_CLOUD_CACHE"):
        return None
    parts = []
    for a in clouds:
        if not (isinstance(a, np.ndarray) and a.size >= 3):
            return None
        f = a.reshape(-1)
        parts.append((id(a), a.shape, a.dtype.str, float(f[0]),
                      float(f[f.size // 2]), float(f[-1])))
    return (np.dtype(dtype).str, shard, tuple(parts))


def _device_clouds(clouds, dtype, shard=None):
    """Upload one side of a pair batch, memoized (see above).  Returns
    (dev [P,N,3], counts [P]) with N = the batch's max point count
    (bucket padding happens on device).  ``shard``: optional
    NamedSharding for a direct sharded upload."""
    key = _cloud_cache_key(clouds, dtype, shard)
    if key is not None:
        hit = _cloud_cache.get(key)
        if hit is not None:
            refs, dev, counts = hit
            if all(r() is not None for r in refs):
                _cloud_cache.move_to_end(key)
                return dev, counts
            del _cloud_cache[key]
    packed, counts = pack_clouds(clouds, dtype, pad="max")
    counts = np.asarray(counts, np.int32)
    if shard is not None:
        dev = jax.device_put(packed, shard)
        counts = jax.device_put(counts, shard)
    else:
        dev = jnp.asarray(packed)
        counts = jnp.asarray(counts)
    if key is not None:
        _cloud_cache[key] = ([weakref.ref(a) for a in clouds], dev,
                             counts)
        while len(_cloud_cache) > _CLOUD_CACHE_MAX:
            _cloud_cache.popitem(last=False)
    return dev, counts


class PendingBatch:
    """In-flight batch registration (async dispatch).

    Holds the device arrays of a dispatched batch program; ``result()``
    blocks on ONE fused device->host fetch and builds the
    RegistrationResult list.  Lets a serving loop pack/dispatch batch
    N+1 while the device still runs batch N (the device queue executes
    in order), hiding host packing and the fetch round trip behind
    compute -- see examples/streaming_registration.py and bench.py.
    """

    def __init__(self, out, n_pairs):
        self._out = out
        self._n = n_pairs

    def result(self):
        T, it, pure = jax.device_get(self._out)  # one host round trip
        T = np.asarray(T, np.float64)
        return [reg.RegistrationResult(T[i], int(it[i]), int(pure[i]))
                for i in range(self._n)]


def register_pairs_async(pairs, algorithm: str, cfg: RegistrationConfig,
                         mesh: Mesh | None = None,
                         dtype=np.float32,
                         initial_Ts=None) -> PendingBatch:
    """Pack + dispatch a batch without blocking on the results.

    ``initial_Ts``: optional [P,4,4] (or list of [4,4]) warm starts."""
    if mesh is None and jax.device_count() > 1:
        mesh = default_mesh()
    shard = None
    if mesh is not None and len(pairs) % mesh.shape["pairs"] == 0:
        shard = NamedSharding(mesh, P("pairs"))
    src, n_src = _device_clouds([s for s, _ in pairs], dtype, shard)
    tgt, n_tgt = _device_clouds([t for _, t in pairs], dtype, shard)
    t0 = (None if initial_Ts is None
          else jnp.asarray(np.asarray(initial_Ts, dtype)))
    out = register_batch(src, n_src, tgt, n_tgt,
                         cfg, algorithm, mesh, initial_T=t0)
    return PendingBatch(out, len(pairs))


def register_pairs(pairs, algorithm: str, cfg: RegistrationConfig,
                   mesh: Mesh | None = None, dtype=np.float32,
                   initial_Ts=None):
    """High-level: list of (src, tgt) numpy clouds -> list of
    RegistrationResult, sharded over ``mesh`` (default: all devices)."""
    return register_pairs_async(pairs, algorithm, cfg, mesh,
                                dtype, initial_Ts).result()
