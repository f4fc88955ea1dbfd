"""Connected-component instance ids (counterpart of the JAX package's
``ops/cc_labels.py``).

The reference flood-fills each ball from a stack in row-major scan order.
Here every masked pixel first gets its component's smallest linear index
(``kernels/cc_labels.root_labels``: the union-find kernel on the card, the
propagation loop on the CPU), then the labels are compacted to dense ids by
the rank of that index, which is the reference's id order.  The compaction
is plain torch on the labels' device, with nothing read back.
"""

from __future__ import annotations

import torch

from tod_tpu_torch.kernels.cc_labels import SENTINEL, root_labels


def compact_labels(labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    """Root labels -> dense int32 ids: the rank, in row-major order, of each
    component's root, clamped to ``max_labels - 1``; -1 off the mask."""
    h, w = labels.shape
    flat = labels.reshape(-1)
    rep = (flat == torch.arange(h * w, dtype=torch.int32, device=labels.device)).to(torch.int32)
    rank = torch.cumsum(rep, dim=0, dtype=torch.int32) - rep  # exclusive prefix sum
    ids = rank[flat.clamp(0, max(h * w - 1, 0)).long()]
    ids = torch.where(flat == SENTINEL, -1, torch.clamp_max(ids, max_labels - 1))
    return ids.to(torch.int32).reshape(h, w)


def connected_components(mask: torch.Tensor, max_labels: int = 100) -> torch.Tensor:
    """4-connected components of an (H, W) mask -> (H, W) int32 ids.

    Unmasked pixels get -1.  Ids are dense, in row-major order of each
    component's first pixel, clamped to ``max_labels - 1`` (the reference's
    ball buffer holds 100 slots)."""
    return compact_labels(root_labels(mask), max_labels)
