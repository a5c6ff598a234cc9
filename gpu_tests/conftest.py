"""Tests that need an NVIDIA GPU.

Run on a machine with a card: ``python -m pytest gpu_tests -q`` (or
``python chip_smoke.py``, whose ``tests`` phase runs them in its own
process).  Every test here carries the ``gpu`` marker; the fixture below
skips it, with a reason, when JAX's default backend is not a GPU.  The
decision is taken per test, never at import or collection time, and no
platform is forced here.
"""

import jax
import pytest

from se3_icp.utils.cache import enable_persistent_cache

enable_persistent_cache()


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (JAX backend is "
                    f"'{jax.default_backend()}')")
