"""Test configuration: x64 for oracle parity, 8 virtual CPU devices, and
the `gpu` fixture for tests that need the card.

The platform comes from JAX_PLATFORMS: the CPU suite runs with
JAX_PLATFORMS=cpu, where the 8 virtual CPU devices
(xla_force_host_platform_device_count) are the fake-backend analog for
multi-device tests (SURVEY §4) — halo-exchange and agglomeration logic runs
on a real 8-device mesh without accelerator hardware.  On a GPU machine,
`pytest -m gpu tests/` runs the card-only tests (chip_smoke.py does).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# keep the suite hermetic: no persistent compile cache written by entry
# points the tests drive (cli.main enables it)
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise.

    Decided here, at run time, never at import or collection: every xdist
    worker must collect the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev


@pytest.fixture(scope="session")
def default_problem():
    """Reference default-problem fields at a given n (numpy, float64)."""

    def make(n):
        h = 1.0 / n
        idx = np.arange(n + 1) * h
        x = idx[:, None] * np.ones((1, n + 1))
        y = np.ones((n + 1, 1)) * idx[None, :]
        u0 = np.exp(-100.0 * ((x - 0.2) ** 2 + (y - 0.4) ** 2))
        u0[0, :] = 0.0
        u0[-1, :] = 0.0
        u0[:, 0] = 0.0
        u0[:, -1] = 0.0
        v1 = -np.pi * np.sin(np.pi * x) * np.cos(np.pi * y)
        v2 = np.pi * np.cos(np.pi * x) * np.sin(np.pi * y)
        return u0, v1, v2

    return make
