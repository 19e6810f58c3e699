import os

# keep tests on the single default CPU device (the dry-run sets its own
# device count in its own process); cap compilation parallelism noise
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "mesh: sharded-path tests (subprocesses force an 8-device host "
        "platform; tools/ci.sh runs these as a second, sharded pass)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the PyTorch port's hand-written kernels); "
        "skips without one")
