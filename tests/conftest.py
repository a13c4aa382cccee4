"""Test configuration.

Tests run on a virtual 8-device CPU mesh, so multi-device sharding paths
are exercised without accelerators.  The one ``gpu``-marked test needs a
card: ``WEBGRAPH_TEST_GPU=1 python -m pytest -m gpu tests/`` keeps JAX's
default platform and runs it there.
"""

import os
import sys

# Must be set before jax is imported anywhere.
if not os.environ.get("WEBGRAPH_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not os.environ.get("WEBGRAPH_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")

from webgraph_tpu.utils.runtime import setup_compile_cache  # noqa: E402

# XLA CPU compilation dominates suite wall-time; the persistent cache makes
# repeat runs compile-free.
setup_compile_cache(min_compile_secs=0.5)

import pathlib  # noqa: E402

import pytest  # noqa: E402

REFERENCE = pathlib.Path("/root/reference")
CNR2000 = REFERENCE / "slow/it/unimi/dsi/big/webgraph/cnr-2000"


@pytest.fixture(scope="session")
def cnr2000_basename():
    if not CNR2000.with_suffix(".graph").exists():
        pytest.skip("cnr-2000 fixture not available")
    return str(CNR2000)


@pytest.fixture(scope="session")
def gpu():
    """The first JAX device when it is a GPU; skips otherwise (decided
    here, not at import, so every test worker collects the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (compiled Triton kernel)")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _jax_cache_reset_per_module():
    """Free per-module jit/program caches: the full suite otherwise
    accumulates enough XLA:CPU client state to crash late modules
    (observed as a segfault inside backend_compile around the 80% mark).
    Recompiles are cheap — programs reload from the persistent cache."""
    yield
    jax.clear_caches()
