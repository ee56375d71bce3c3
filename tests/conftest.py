"""Test config: run the tests on a virtual 8-device CPU mesh with x64.

``JAX_PLATFORMS`` defaults to ``cpu`` here; tests marked ``gpu`` need the
card and skip elsewhere.  On a machine with a GPU run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.  The multi-device
path is also dry-run by ``dryrun_multichip`` in ``__graft_entry__.py``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Read by the CPU backend when it is first initialized.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX computes on a GPU (decided when the test runs)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/")
