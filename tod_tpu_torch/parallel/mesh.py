"""The device mesh (counterpart of the JAX package's ``parallel/mesh.py``).

A :class:`Mesh` lays devices out ``(dp, tp)``, named ``"dp"`` and ``"tp"``,
as ``jax.sharding.Mesh`` does.  The serving paths (``DPBatchServer``,
``TwoStagePipeline``, ``spatial_sharded_forward``) use it in one process,
as the JAX package's single controller does: a replica or a stage on each
device, the host dispatching to all of them.  Training over a mesh of more
than one slot runs one process a slot under ``torch.distributed``
(:func:`join`, :func:`launch`): gloo on the CPU, NCCL on cards, the group
made from a ``FileStore`` (no network), and
``torch.distributed.device_mesh.init_device_mesh`` giving the ``dp`` and
``tp`` groups.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class Mesh:
    """Devices laid out ``(dp, tp)``.  ``devices`` is the ``(dp, tp)``
    object array of ``torch.device``; after :func:`join` in a slot's
    process, ``device_mesh`` is torch's ``DeviceMesh`` over the same
    layout and ``rank`` this process's slot."""

    axis_names = ("dp", "tp")

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.device_mesh = None
        self.rank: int | None = None

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": int(self.devices.shape[0]), "tp": int(self.devices.shape[1])}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> list[torch.device]:
        """The devices in slot (rank) order: ``rank = dp_index * tp + tp_index``."""
        return list(self.devices.reshape(-1))

    @property
    def joined(self) -> bool:
        return self.device_mesh is not None

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.flat]})"


def visible_devices() -> list[torch.device]:
    """The visible cards, in torch's order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """A ``(dp, tp)`` mesh over the first ``n_devices`` of ``devices``.

    ``devices`` defaults to the visible cards (the CPU is never taken in
    their place: the caller passes a list of CPU devices for that).  ``tp``
    must divide the device count; ``dp = n_devices // tp``.
    """
    devices = [torch.device(d) for d in (visible_devices() if devices is None else devices)]
    if not devices:
        raise ValueError("no CUDA device is visible: pass devices=[...] to lay a mesh over "
                         "other devices (the tests pass CPU devices)")
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if n % tp:
        raise ValueError(f"tp={tp} does not divide n_devices={n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(n // tp, tp))


def join(mesh: Mesh, rank: int, store_path: str) -> Mesh:
    """Join slot ``rank`` of ``mesh`` from this process: the default group
    over ``mesh.size`` processes, made from a ``FileStore`` at
    ``store_path`` (every slot passes the same path), and the ``dp`` and
    ``tp`` groups from ``init_device_mesh``.  Sets this process's card for a
    mesh of cards.  Returns the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = mesh.flat[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        store = dist.FileStore(store_path, mesh.size)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=store,
                                rank=rank, world_size=mesh.size)
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, the mesh "
                         f"{mesh.size} slots")
    mesh.device_mesh = init_device_mesh(device.type, (mesh.shape["dp"], mesh.shape["tp"]),
                                        mesh_dim_names=Mesh.axis_names)
    mesh.rank = rank
    return mesh


def leave(mesh: Mesh) -> None:
    """Tear the slot's process group down."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    mesh.device_mesh = None
    mesh.rank = None


def _slot_main(rank: int, mesh: Mesh, store_path: str, fn, args) -> None:
    join(mesh, rank, store_path)
    try:
        fn(mesh, *args)
    finally:
        leave(mesh)


def launch(mesh: Mesh, fn, *args, store_path: str, timeout: float | None = None) -> None:
    """Run ``fn(mesh, *args)`` in one spawned process a slot of ``mesh``,
    each joined to the mesh (:func:`join`); waits for all of them and
    raises if one fails, or, with ``timeout``, if they have not all ended
    within that many seconds (the slots are then terminated: a slot that
    waits on a collective another never reaches would wait forever).
    ``fn`` must be a module-level function (spawn pickles it)."""
    import time

    import torch.multiprocessing as mp

    if os.path.exists(store_path):
        os.unlink(store_path)
    ctx = mp.start_processes(_slot_main, args=(mesh, store_path, fn, args), nprocs=mesh.size,
                             join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(timeout=10)
            raise TimeoutError(f"the {mesh.size} slots did not end within {timeout} s")
