"""se3-icp: a batched SE(3)-ICP point-cloud registration engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the C++
reference implementation of "A Generalization of Iterative Closest Point
Registration Algorithms using a Local Reference Frame based SE(3)
Augmentation" (kenahm/se3-icp, IEEE Access 2026).  It runs on an NVIDIA
GPU; the CPU backend runs the same programs for tests.

Design stance (batched accelerator programs, not a port):
  * KD-trees (FLANN) are replaced by brute-force tiled distance search,
    for both the 12-D SE(3) chordal metric and the 3-D euclidean
    metric; the batched correspondence search is a Triton kernel on the
    GPU (``ops/triton_nn.py``) and plain XLA elsewhere.
  * The whole ICP iteration (correspondence search, trimmed rejection,
    transform estimation, frame update, convergence logic) runs on-device
    inside a single ``lax.while_loop`` -- zero host sync per iteration.
  * Clouds are padded to static bucket sizes with validity masks; the
    "trim to best overlap fraction" step becomes a static-shape rank mask.
  * Scale-out is data-parallel over frame pairs and/or sharded over the
    target-point axis via ``jax.sharding`` / ``shard_map`` with XLA
    collectives -- not threads.

Reference parity citations throughout the code point at the reference's
``src/iterative_SE3_registration.cpp`` (abbreviated ``ref:cpp``),
``include/iterative_SE3_registration.hpp`` (``ref:hpp``),
``src/cc.cpp`` (``ref:cc``) and its ``examples/*.cpp`` binaries.
"""

from se3_icp.utils.config import RegistrationConfig

__version__ = "0.1.0"


def __getattr__(name):
    # late imports so that utils/ops stay importable standalone
    if name in ("RegistrationResult", "register_pair", "register_arrays",
                "sanitize_cloud"):
        from se3_icp.models import registration
        return getattr(registration, name)
    if name in ("register_pairs", "register_pairs_async", "default_mesh",
                "PendingBatch"):
        from se3_icp.parallel import pairs
        return getattr(pairs, name)
    if name in ("register_pair_multistart", "register_pairs_multistart"):
        from se3_icp.models import multistart
        return getattr(multistart, name)
    if name == "fgr_register":
        from se3_icp.models import fgr
        return fgr.fgr_register
    if name == "GOLDEN":
        from se3_icp.utils.config import GOLDEN
        return GOLDEN
    if name in ("read_ply", "write_ply"):
        from se3_icp.utils import ply
        return getattr(ply, name)
    raise AttributeError(name)

__all__ = [
    # config
    "RegistrationConfig", "GOLDEN",
    # single pair
    "RegistrationResult", "register_pair", "register_arrays",
    "sanitize_cloud",
    # batched / sharded serving
    "register_pairs", "register_pairs_async", "PendingBatch",
    "default_mesh",
    # restart fleets + global baseline
    "register_pair_multistart", "register_pairs_multistart",
    "fgr_register",
    # IO
    "read_ply", "write_ply",
    "__version__",
]
