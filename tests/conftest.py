"""Test harness: force an 8-virtual-device CPU platform so multi-device
sharding logic is exercised without accelerator hardware, and enable
x64 so numpy float64 oracles can be compared at full precision."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
assert jax.device_count() == 8, "expected 8 virtual CPU devices"

from se3_icp.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def golden_problem():
    """The golden problem (created_example_reg_problem protocol,
    SURVEY.md §4) on the seeded bunny stand-in."""
    from se3_icp.datasets import standin

    return standin.golden_problem()


@pytest.fixture(scope="session")
def golden_dir(tmp_path_factory):
    """The golden problem written in the reference's folder layout
    (source.ply / target.ply / transformation_gt.txt)."""
    from se3_icp.datasets import standin

    return standin.save_golden_problem(str(tmp_path_factory.mktemp("golden")))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
