"""ctypes bindings for the native planner, built from ``csrc/planner.cpp``
with g++ at first use into ``build/tod_tpu_torch/`` (``kernels/_build.py``
``build_host``: a source hash in the file name, write-then-rename)."""

from __future__ import annotations

import ctypes
import functools
import logging
import pathlib

import numpy as np

from tod_tpu_torch.kernels import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "planner.cpp"

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_int = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL | None:
    try:
        lib = ctypes.CDLL(str(_build.build_host(SOURCE)))
    except (RuntimeError, OSError) as e:
        # "auto" then plans with NumPy, 10-50x slower: leave a trail
        logging.getLogger(__name__).warning(
            "native planner unavailable (the host planner falls back to NumPy): %s", e)
        return None
    lib.tod_dijkstra.argtypes = [_f32p, _f32p, _int, _int, _i32p, _int, _f64p, _i64p]
    lib.tod_dijkstra.restype = _int
    height_args = [_f32p, _int, _int, _i32p, _int, _int, _int, _f64p, _i64p]
    for fn in (lib.tod_dijkstra_height, lib.tod_dijkstra_height_bidir):
        fn.argtypes = height_args
        fn.restype = _int
    return lib


def available() -> bool:
    return _lib() is not None


def get() -> ctypes.CDLL:
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native planner library is unavailable (no g++ toolchain?)")
    return lib
