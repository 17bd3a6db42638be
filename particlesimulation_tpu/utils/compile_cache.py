"""Persistent XLA compilation cache.

The reference pays zero compile cost (ahead-of-time C++); this framework
pays it per process. JAX's persistent compilation cache amortizes that
across processes: identical (program, compile options, backend) re-runs
load the serialized executable from disk instead of recompiling.

Wired into ``Engine`` at construction (any entry point that builds a
step program passes through there). Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR``, when set, and no other;
* otherwise one fixed directory inside the checkout, ``<repo>/.jax_cache``
  (listed in ``.gitignore``). The path is part of what makes a later run
  hit, so it never depends on the process, the user or the time.

Opt out with ``PSIM_COMPILE_CACHE=0``. ``min_compile_time_secs=1`` skips
caching trivial programs (the hundreds of tiny host-side jits in the test
suite would otherwise churn the directory).
"""

from __future__ import annotations

import os

from particlesimulation_tpu.utils.runtime import repo_root

_done = False


def cache_dir() -> str:
    """The directory the cache uses (see the module docstring)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(repo_root(), ".jax_cache"))


def enable() -> bool:
    """Idempotently enable the persistent compilation cache.

    Returns True when the cache is (already) enabled, False when opted
    out. Must run before the first compilation it should capture —
    Engine.__init__ is early enough for every framework entry point.
    """
    global _done
    if os.environ.get("PSIM_COMPILE_CACHE", "1") == "0":
        return False
    if _done:
        return True
    import jax

    try:
        path = cache_dir()
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        # Cache everything that took >= the threshold, including backends
        # that need non-default serialization support probing.
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except Exception:
        # An older jax without one of the knobs, or an unwritable
        # checkout: the cache stays off and the framework works as before.
        return False
    _done = True
    return True
