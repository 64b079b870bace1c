"""Test configuration: fp64 numerics + an 8-device virtual CPU mesh.

The tests run on the CPU (``JAX_PLATFORMS=cpu``).  Sharding tests build
their mesh from ``jax.devices("cpu")``; the XLA flag below forces 8 virtual
host devices so multi-device paths compile and execute without 8 cards.
The flag must be set before the first jax import.  GPU kernels run here in
Pallas interpret mode; tests that need the card itself carry the ``gpu``
marker and skip (decided in a fixture, never at import) elsewhere.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)

from svdsolver_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu)")


@pytest.fixture
def rng():
    return np.random.default_rng(586)
