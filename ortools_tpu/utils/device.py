"""What the device can do, decided in one place.

The package asks this module, never ``jax.default_backend()`` directly,
whether it computes on an accelerator, and where JAX keeps its persistent
compilation cache.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

# <checkout>/.jax_cache: a fixed path, because the path is part of the
# cache key — a directory that moves never hits.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def is_accelerator(backend: Optional[str] = None) -> bool:
    """True when JAX computes on a GPU, False on the CPU.

    Device-only work engages exactly when this holds: the Triton SpMV
    kernel, and the multi-seed feasibility jump under its "auto" setting.
    """
    return (backend or jax.default_backend()) == "gpu"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX, which reads it
    itself; otherwise the cache goes to ``<checkout>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
