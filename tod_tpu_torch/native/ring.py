"""ctypes bindings for the frame ring, built from ``csrc/framesource.cpp``
with g++ at first use into ``build/tod_tpu_torch/`` (``kernels/_build.py``
``build_host``, as ``loader.py`` builds the planner)."""

from __future__ import annotations

import ctypes
import functools
import pathlib

import numpy as np

from tod_tpu_torch.kernels import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "framesource.cpp"

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_int, _ptr, _u64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64


@functools.cache
def get() -> ctypes.CDLL:
    """The loaded library; raises if g++ cannot build it (a ring source has
    no other implementation)."""
    lib = ctypes.CDLL(str(_build.build_host(SOURCE)))
    signatures = {
        "tod_ring_create": ([_int, _int, _int], _ptr),
        "tod_ring_destroy": ([_ptr], None),
        "tod_ring_start_producer": ([_ptr, ctypes.c_double, _u64, ctypes.c_char_p], _int),
        "tod_ring_push": ([_ptr, _u8p, _u16p], _int),
        "tod_ring_pop": ([_ptr, _u8p, _u16p, _int], _int),
        "tod_ring_stat_pushed": ([_ptr], _u64),
        "tod_ring_stat_dropped": ([_ptr], _u64),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
