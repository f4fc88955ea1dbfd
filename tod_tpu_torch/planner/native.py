"""C++ Dijkstra backend (counterpart of the JAX package's
``planner/native.py``): ``native/csrc/planner.cpp`` through ctypes."""

from __future__ import annotations

import numpy as np

from tod_tpu_torch.native import loader


def dijkstra_native(height: np.ndarray, connections: np.ndarray, seeds):
    """Same contract as ``planner.dijkstra.dijkstra_grid``, in C++."""
    lib = loader.get()
    h, w = height.shape
    height = np.ascontiguousarray(height, np.float32)
    connections = np.ascontiguousarray(connections, np.float32)
    seed_arr = np.ascontiguousarray(np.array(seeds, np.int32).reshape(-1, 2))
    dist = np.empty((h, w), np.float64)
    parent = np.empty((h, w), np.int64)
    rc = lib.tod_dijkstra(height.reshape(-1), connections.reshape(-1), h, w,
                          seed_arr.reshape(-1), len(seeds), dist.reshape(-1), parent.reshape(-1))
    if rc != 0:
        raise RuntimeError(f"tod_dijkstra failed with code {rc}")
    return dist, parent
