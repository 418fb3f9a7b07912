import os
import sys

# Tests run on the single real CPU device (the 512-device override is
# dry-run-only, set inside repro.launch.dryrun before jax init).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Property tests use hypothesis; fall back to the bundled minimal shim when
# the real package is absent (containers without network access).
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "_shims"))

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (CUDA); skipped without one")
