"""Build the port's host libraries with g++ (counterpart of the JAX
package's ``native/build.py``): thin names over ``kernels/_build.py
build_host``, which compiles each source into ``build/tod_tpu_torch/``
under a name that carries a hash of the source and the flags.

``python -m tod_tpu_torch.native.build`` builds both libraries now rather
than at first use.  Where g++ cannot build them, the host planner falls
back to NumPy (``loader.py`` logs why) and a ring source raises.
"""

from __future__ import annotations

import logging
import pathlib

from tod_tpu_torch.kernels import _build
from tod_tpu_torch.native import loader, ring

SOURCES = (loader.SOURCE, ring.SOURCE)  # the planner, the frame ring


def lib_path(source: pathlib.Path = loader.SOURCE) -> pathlib.Path:
    """The library a source builds into (the planner's by default)."""
    return _build.host_library_path(source)


def needs_build() -> bool:
    """Whether a library of this checkout's sources is missing."""
    return any(not lib_path(src).exists() for src in SOURCES)


def build(verbose: bool = False) -> pathlib.Path:
    """Build every library that is missing; raises with g++'s output if a
    compile fails.  Returns the planner's library."""
    for src in SOURCES:
        out = _build.build_host(src)
        if verbose:
            print(f"built {out}")
    return lib_path()


def ensure_built() -> pathlib.Path | None:
    """``build()``, or None (logged) where the toolchain cannot build."""
    try:
        return build()
    except (RuntimeError, FileNotFoundError) as e:
        logging.getLogger(__name__).warning(
            "native library unavailable (the host planner falls back to NumPy): %s", e)
        return None


if __name__ == "__main__":
    build(verbose=True)
