"""Test configuration: run everything on a fake 8-device CPU mesh.

Multi-device sharding tests exercise halo exchange / psum-CG on virtual CPU
devices (SURVEY.md §4 point 3) — no multi-GPU host needed.  Tests that need
a GPU take the ``gpu`` fixture and skip here.
"""

import os

# Must be set before jax initializes.
# CPU unless the caller picked a platform (``JAX_PLATFORMS=cuda pytest -m gpu``
# runs the card-only tests on a GPU)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none.  Decided
    when the test runs, never at import, so every worker collects the same
    tests."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs these phases on one")
    return devs[0]
