"""Device guard and persistent compilation cache for the entry points.

Every entry point (scripts, bench, chip smoke test, test suite) calls
`enable_compile_cache()` before its first jit. A deployment that sets
`JAX_COMPILATION_CACHE_DIR` owns the location: JAX reads that variable
itself, and nothing here overrides it. Otherwise the cache lives at a fixed
path inside the checkout, so repeated runs of the same checkout hit it.

Measurement entry points call `require_gpu()`: a timing taken on the CPU
backend is not a device number, so they stop instead of falling back.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


class NoGPUError(RuntimeError):
    """JAX's default backend is not a GPU."""


def compile_cache_dir() -> str:
    """Where compiled programs are cached: the env var if set, else DEFAULT_DIR."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at `compile_cache_dir()`; returns it.

    Touches `jax.config` only when the env var is unset."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_info() -> dict:
    """The device as JAX reports it: platform, device_kind, device count."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}


def require_gpu() -> dict:
    """device_info() of the GPU backend; raises NoGPUError on any other."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise NoGPUError(
            f"no GPU found: JAX's default backend is {backend!r} "
            f"({jax.devices()[0].device_kind}); this runs only on an NVIDIA GPU"
        )
    return device_info()
