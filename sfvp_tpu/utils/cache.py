"""Persistent XLA compilation cache (SURVEY.md §2 #10 toolchain line).

The reference compiles its shaders offline once and commits the SPIR-V
binaries (ref shaders/compile.bat:1-3, loaded at main.cpp:541-543), so a
process restart never recompiles. The equivalent here is XLA's persistent
compilation cache: ``enable_compilation_cache()`` is called by every entry
point (CLI, Renderer, bench, tests) so a compile is paid once per
(program, config) and machine.

Where the cache lives:
  - ``$JAX_COMPILATION_CACHE_DIR`` when it is set, and nowhere else;
  - otherwise ``<checkout>/.jax_cache`` (git-ignored). The path is part of
    the cache key, so it is fixed rather than per user or per run.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Point jax's persistent compilation cache at ``cache_dir()``
    (idempotent). Returns the directory."""
    import jax

    path = cache_dir()
    if path == DEFAULT_DIR:
        os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # cache even fast compiles: the test suite's many small jits add up
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
