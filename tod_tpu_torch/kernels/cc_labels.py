"""Connected-component root labels of a mask: each masked pixel gets the
smallest linear index of its 4-connected component, every other pixel
``SENTINEL`` (int32 max).

Counterpart of the label propagation inside the JAX package's
``ops/cc_labels.py`` (``connected_components``), an XLA ``while_loop`` to a
fixpoint.  On a CUDA tensor the wrapper launches ``csrc/cc_labels.cu``
(union-find in three kernels: unions inside ``TILE`` x ``TILE`` tiles in
shared memory, then the edges across tile borders, then a flatten; a fixed
launch count, nothing read back); on a CPU tensor it runs the plain version
below, the propagation loop itself (``torch.export`` traces the custom op
``tod::root_labels``, the same two).  Both give the fixpoint bit for bit:
with union by minimum every root is its component's smallest index.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tod_tpu_torch.kernels import _build

SOURCE = "cc_labels"
SIGNATURES = {
    "tod_cc_labels": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p], ctypes.c_int),
}
SENTINEL = torch.iinfo(torch.int32).max
TILE = 32  # csrc/cc_labels.cu kTile: a block's tile is TILE x TILE pixels, a row one warp's bits
MAX_TILE_ROWS = 65535  # a launch grid's y extent


def plain_root_labels(mask: torch.Tensor) -> torch.Tensor:
    """The JAX package's loop: start from each masked pixel's linear index,
    take the min over the pixel and its 4 masked neighbours until nothing
    changes, at most H*W sweeps (which always reach the fixpoint: a
    component's graph diameter is below H*W).  One host read of the
    ``changed`` flag a sweep."""
    h, w = mask.shape
    mask = mask.to(torch.bool)
    lin = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(h, w)
    labels = torch.where(mask, lin, SENTINEL)
    max_iters = h * w
    it = 0
    while it < max_iters:
        padded = F.pad(labels[None], (1, 1, 1, 1), value=SENTINEL)[0]
        n = torch.minimum(
            torch.minimum(padded[:-2, 1:-1], padded[2:, 1:-1]),
            torch.minimum(padded[1:-1, :-2], padded[1:-1, 2:]),
        )
        new = torch.where(mask, torch.minimum(labels, n), SENTINEL)
        it += 1
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels


def root_labels(mask: torch.Tensor) -> torch.Tensor:
    """(H, W) bool or uint8 mask -> (H, W) int32 root labels on its device."""
    if mask.dim() != 2:
        raise ValueError(f"expected an (H, W) mask, got shape {tuple(mask.shape)}")
    if torch.compiler.is_exporting():
        return _op(mask)
    if mask.device.type == "cpu":
        return plain_root_labels(mask)
    return _launch(mask)


def _launch(mask: torch.Tensor) -> torch.Tensor:
    h, w = mask.shape
    if mask.device.type != "cuda":
        raise ValueError(f"unsupported device {mask.device}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"mask must be bool or uint8, got {mask.dtype}")
    if h * w >= SENTINEL or -(-h // TILE) > MAX_TILE_ROWS:
        raise ValueError(f"a ({h}, {w}) mask: the kernel takes H*W < {SENTINEL} and "
                         f"H <= {TILE * MAX_TILE_ROWS}")
    m = mask.contiguous()
    if h * w == 0:
        return torch.empty((h, w), dtype=torch.int32, device=mask.device)
    # the labels, then one int a tile (set when the tile has a masked pixel):
    # one allocation
    tiles = -(-h // TILE) * -(-w // TILE)
    buf = torch.empty(h * w + tiles, dtype=torch.int32, device=mask.device)
    labels = buf[: h * w].view(h, w)
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(mask.device):
        err = lib.tod_cc_labels(m.data_ptr(), buf.data_ptr(), buf.data_ptr() + 4 * h * w, h, w,
                                torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "cc_labels launch")
    root_labels.launches += 1
    return labels


root_labels.launches = 0

_op = torch.library.custom_op("tod::root_labels", plain_root_labels, mutates_args=(),
                              device_types="cpu")
_op.register_kernel("cuda")(_launch)


@_op.register_fake
def _(mask):
    return mask.new_empty(mask.shape, dtype=torch.int32)
