"""Production-style streaming registration pipeline.

Demonstrates the intended serving pattern: a host-side producer stages
incoming frame pairs (sensor stream, file queue, RPC ingest) into
fixed-size batches while the device registers the previous batch -- the
cached compiled program (parallel.pairs) means steady-state throughput
after the first batch, and JAX's async dispatch overlaps the host
staging with device execution.

Run:  python examples/streaming_registration.py [n_batches] [batch]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from se3_icp.utils.cache import enable_persistent_cache

enable_persistent_cache()

import numpy as np  # noqa: E402

from se3_icp.datasets import synthetic  # noqa: E402
from se3_icp.parallel import pairs as par  # noqa: E402
from se3_icp.utils import metrics_host  # noqa: E402
from se3_icp.utils.config import GOLDEN  # noqa: E402


def frame_pair_stream(rng, n):
    """Stand-in for a sensor/odometry stream: yields (src, tgt, T_gt)."""
    for i in range(n):
        p = synthetic.synthetic_problem("easy", 0.003,
                                        seed=int(rng.integers(1 << 30)))
        yield p.source, p.target, p.T_gt


def main():
    n_batches = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    rng = np.random.default_rng(0)
    stream = frame_pair_stream(rng, n_batches * batch)

    done = 0
    ok = 0
    t_start = None
    for b in range(n_batches):
        staged = [next(stream) for _ in range(batch)]
        pair_list = [(s, t) for s, t, _ in staged]
        t0 = time.time()
        results = par.register_pairs(pair_list, "se3_pt2pl", GOLDEN)
        wall = time.time() - t0
        if b == 0:
            print(f"batch 0 (compile): {wall:.1f}s")
            t_start = time.time()
        else:
            print(f"batch {b}: {wall*1e3:.0f} ms "
                  f"({batch/wall:.1f} pairs/s)")
        for (s, t, T_gt), r in zip(staged, results):
            ok += bool(metrics_host.success(T_gt, r.transformation))
            done += 1
    if n_batches > 1:
        steady = (n_batches - 1) * batch / (time.time() - t_start)
        print(f"steady state: {steady:.1f} pairs/s; "
              f"success {ok}/{done}")


if __name__ == "__main__":
    main()
