import os

# Eight virtual CPU devices so the sharding tests can build meshes on a host
# without accelerators; JAX_PLATFORMS picks the backend (the CPU runs set
# JAX_PLATFORMS=cpu). The flag only affects the CPU backend.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

import vc2tpu  # noqa: E402,F401  (enables x64 before any jax use)


@pytest.fixture(autouse=True)
def _card_only(request):
    """Tests marked ``card`` need an NVIDIA GPU: decided here, per test, so
    every worker collects the same tests whatever its backend."""
    if request.node.get_closest_marker("card") is None:
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX found platform {platform!r}")
