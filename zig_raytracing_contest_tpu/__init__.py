"""zig_raytracing_contest_tpu — a glTF path tracer in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of the
``tigrazone/zig_raytracing_contest`` reference (a Zig CPU path tracer):
glTF 2.0/GLB scene loading, uniform-grid acceleration (SAT binning +
3D-DDA traversal) or brute force over a BVH-ordered triangle bank,
multi-bounce diffuse path tracing with textures and stochastic alpha,
gamma-2.2 PNG output — re-architected as a batched wavefront renderer that
runs on an NVIDIA GPU (or the CPU backend) and shards over several devices.
"""

import os

__version__ = "0.1.0"

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compilation_cache_dir(environ=os.environ) -> str:
    """Where compiled programs persist: ``JAX_COMPILATION_CACHE_DIR`` when
    set, else the fixed in-checkout ``.jax_cache/`` (a fixed path, because
    the path is part of the cache key)."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def _enable_compilation_cache():
    """Persistent XLA compilation cache.  It is keyed on HLO, compile
    options and backend, so it never changes numerics; a warm process
    skips straight to execution."""
    import jax

    path = compilation_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compilation_cache()
