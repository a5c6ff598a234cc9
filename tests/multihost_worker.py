"""Worker process for the multi-host test: registers its shard of a
deterministic synthetic pair list over a 2-process global mesh and
prints the per-pair SO(3)/translation errors as JSON."""

import json
import sys


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]

    sys.path.insert(0, sys.argv[4])
    from se3_icp.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", nproc, pid,
                         cpu_devices_per_process=2)

    import jax
    import numpy as np

    jax.config.update("jax_enable_x64", True)
    from se3_icp.datasets import synthetic
    from se3_icp.utils import metrics_host
    from se3_icp.utils.config import GOLDEN

    # deterministic global problem list; each process takes its slice
    all_probs = [synthetic.synthetic_problem("easy", 0.002, seed=200 + i)
                 for i in range(4 * nproc)]
    local = all_probs[pid * 4:(pid + 1) * 4]
    cfg = GOLDEN.replace(number_of_nn_for_lrf=30)

    results = multihost.register_pairs_multihost(
        [(p.source, p.target) for p in local], "se3_pt2pl", cfg,
        dtype=np.float64)

    assert len(results) == len(all_probs), (len(results), len(all_probs))
    errs = []
    for p, r in zip(all_probs, results):
        errs.append([
            metrics_host.angular_error_so3(r.transformation[:3, :3],
                                           p.T_gt[:3, :3]),
            metrics_host.translation_error(r.transformation[:3, 3],
                                           p.T_gt[:3, 3])])
    print("RESULT" + str(pid) + ":" + json.dumps(errs), flush=True)


if __name__ == "__main__":
    main()
