"""JAX's persistent compilation cache at a fixed place.

A full-frame encode program takes minutes to compile cold, so entry points
(the CLI, ``bench.py``, ``chip_smoke.py``) keep compiled programs across
processes.  Library imports never call this: where a program's cache lives
is the application's choice.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself) and nothing else is set.  Otherwise the cache is the checkout's
    ``.jax_cache/``: a fixed path, because the path is part of what makes
    a later process find the entries again.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
