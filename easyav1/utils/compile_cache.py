"""JAX persistent compilation cache location.

One rule for every process of this repository that compiles for the
device (the library's device pipes, `chip_smoke.py`, `bench.py`,
`tools/device_trace.py`, the tests): the directory named by
`JAX_COMPILATION_CACHE_DIR` when it is set, otherwise `.jax_cache` at
the root of the checkout.  A fixed path matters because the cache key
includes nothing that moves with it, so every process finds what the
others compiled.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def cache_dir() -> str:
    """The compile-cache directory this checkout uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT / ".jax_cache")


@functools.cache
def enable() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()` (once
    per process) and return the directory."""
    import jax

    d = cache_dir()
    jax.config.update("jax_compilation_cache_dir", d)
    return d
