"""Process set-up shared by the command line, the benchmarks and the tests:
the persistent compile cache and the accelerator check."""

from __future__ import annotations

import os
import subprocess
import sys

#: fixed cache path inside the checkout (listed in .gitignore); the path is
#: part of the cache key, so it must not move between runs
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def setup_compile_cache(min_compile_secs: float = 1.0) -> None:
    """Use JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it itself);
    otherwise keep the persistent compile cache at CACHE_DIR."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)


def require_gpu():
    """The first JAX device, which must be a GPU; exits non-zero otherwise
    (measurements never fall back to the CPU)."""
    import jax

    try:
        dev = jax.devices()[0]
    except RuntimeError as e:
        sys.exit(f"no GPU found: {e}")
    if dev.platform != "gpu":
        sys.exit(f"no GPU found: JAX's first device is {dev.platform!r}")
    return dev


def gpu_name_power() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
