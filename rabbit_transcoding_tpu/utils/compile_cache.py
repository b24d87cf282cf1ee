"""JAX's persistent compilation cache, kept at one fixed directory.

A process that finds a compiled program in the cache skips its compilation,
so a second run starts with warm executables.  The directory is part of
what makes a hit possible, so it never moves: ``JAX_COMPILATION_CACHE_DIR``
when the environment sets it (JAX reads that variable itself), otherwise
``<repo>/.jax_cache`` beside the package.

A cached program must compute exactly what a freshly compiled one does.
XLA's GPU autotuner picks each GEMM's algorithm by timing candidates, so
two processes can pick differently, and the codec's closed loop (encoder
reconstruction == decoder output) then breaks between an encoder program
loaded from the cache and a decoder program compiled in this process: on
an H100 the dense-scene loop failed with a warm cache and passed with an
empty one or with autotuning off.  So autotuning is off
(``--xla_gpu_autotune_level=0``: XLA's heuristic choice, the same in every
process) unless ``XLA_FLAGS`` already sets a level.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)
AUTOTUNE_FLAG = "--xla_gpu_autotune_level=0"


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's compilation cache at ``cache_dir()`` and fix the GEMM
    algorithm choice; returns the cache directory.

    Call once at start-up, before JAX first uses a device: XLA reads
    ``XLA_FLAGS`` when it starts a backend, and JAX fixes the cache when
    it first compiles."""
    import jax

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_gpu_autotune_level" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} {AUTOTUNE_FLAG}".strip()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
