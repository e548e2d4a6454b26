import os

# The tests run on the CPU in f64 (verification digit-matching needs double
# precision), with 8 virtual devices for the sharding tests. The GPU path
# is exercised by chip_smoke.py.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

REFERENCE_DIR = "/root/reference"


def reference_exp(name: str) -> str:
    return os.path.join(REFERENCE_DIR, "verification", name)
