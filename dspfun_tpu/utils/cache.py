"""Persistent compilation cache — the FFTW-wisdom analogue.

The reference persists FFTW plans via wisdom files
(motion/motion.c:518-519,556-557 --fftw-wisdom-file).  The counterpart
here is XLA's persistent compilation cache, so repeat runs with the
same shapes skip recompilation.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set
(JAX reads it itself and nothing here overrides it); otherwise the
directory a caller names (motion's ``--fftw-wisdom-file``), or the
fixed ``<repo>/.dspfun-xla-cache``.  A fixed path matters: the path is
part of what makes a later run find the entries.
"""

from __future__ import annotations

import os

__all__ = ["cache_dir", "enable_compilation_cache"]

REPO_CACHE = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", ".dspfun-xla-cache"))

_enabled: str | None = None


def cache_dir(path: str | None = None) -> str | None:
    """The directory :func:`enable_compilation_cache` would point JAX
    at, or None when ``JAX_COMPILATION_CACHE_DIR`` governs.  ``path`` is
    a directory, or a (wisdom) file path whose directory gets a
    ``.dspfun-xla-cache`` beside it."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if path is None:
        return REPO_CACHE
    if os.path.isdir(path):
        return path
    if path.endswith("cache") and not os.path.exists(path):
        return path  # treat a cache-suffixed non-file as a dir name
    return os.path.join(os.path.dirname(path) or ".", ".dspfun-xla-cache")


def enable_compilation_cache(path: str | None = None) -> str:
    """Turn on JAX's persistent compilation cache (see the module
    docstring for where it lives) and return its directory."""
    global _enabled
    import jax  # noqa: PLC0415

    target = cache_dir(path)
    if target is None:
        target = os.environ["JAX_COMPILATION_CACHE_DIR"]
    else:
        os.makedirs(target, exist_ok=True)
        if _enabled != target:
            jax.config.update("jax_compilation_cache_dir", target)
    if _enabled != target:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        _enabled = target
    return target
