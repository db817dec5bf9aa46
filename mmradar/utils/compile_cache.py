"""JAX persistent compilation cache placement.

Called by the entry points (``cli.main``, ``chip_smoke.py``, ``bench.py``),
never at package import, so importing the package changes nothing.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; this module
  sets nothing and reports that directory.
* unset: the cache lives at one fixed, git-ignored path inside the
  checkout (``<checkout>/.jax_cache``).  The path is part of the cache's
  key, so it is never built from a temporary name, a process id or the
  time.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(environ=None) -> str:
    """The directory the compile cache uses under ``environ``."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`;
    returns the directory."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
