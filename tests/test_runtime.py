"""Process set-up helpers and the kernel-route choice."""

import jax
import pytest

from webgraph_tpu.ops import kdecode as K
from webgraph_tpu.utils import runtime


@pytest.mark.parametrize("platform,interpret", [("cpu", True),
                                                ("gpu", False),
                                                ("metal", None),
                                                ("rocm", None)])
def test_kernel_mode(monkeypatch, platform, interpret):
    """Compiled Triton on a GPU, the interpreter on the CPU, and an error
    on any platform without a kernel route."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if interpret is None:
        with pytest.raises(RuntimeError, match="no decode-kernel route"):
            K.kernel_mode()
    else:
        assert K.kernel_mode() is interpret


@pytest.mark.parametrize("env_dir", [None, "/some/cache"])
def test_setup_compile_cache(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed path
    inside the checkout."""
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    runtime.setup_compile_cache()
    if env_dir is None:
        assert seen["jax_compilation_cache_dir"] == runtime.CACHE_DIR
        assert runtime.CACHE_DIR.endswith(".jax_cache")
    else:
        assert "jax_compilation_cache_dir" not in seen


def test_require_gpu_exits_without_a_gpu():
    with pytest.raises(SystemExit, match="no GPU found"):
        runtime.require_gpu()
