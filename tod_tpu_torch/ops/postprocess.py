"""Semantic postprocessing: logits -> class map -> instance ids -> packed
words (counterpart of the JAX package's ``ops/postprocess.py``).

The reference argmaxes the first four channels of its semantic logits into
{0 bg, 1 red robot, 2 blue robot, 3 ball}, flood-fills the ball ids, then
upsamples 8x and packs ``cls<<24 | id<<16``.
"""

from __future__ import annotations

import torch

from tod_tpu_torch.ops.cc_labels import connected_components
from tod_tpu_torch.ops.packing import pack_class_id


def semantic_argmax(logits: torch.Tensor, meaningful_classes: int = 4) -> torch.Tensor:
    """(..., Hc, Wc, C) logits -> (..., Hc, Wc) uint8 class map: the argmax
    over the first ``meaningful_classes`` channels.  Ties go to the first
    maximum, as ``jnp.argmax`` breaks them."""
    return torch.argmax(logits[..., :meaningful_classes], dim=-1).to(torch.uint8)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor nearest upsample of the last two axes (a broadcast and
    a reshape: nothing is read back on the card)."""
    *lead, h, w = x.shape
    y = x[..., :, None, :, None].expand(*lead, h, factor, w, factor)
    return y.reshape(*lead, h * factor, w * factor)


def semantic_postprocess(logits: torch.Tensor, ball_class: int = 3, upsample: int = 8,
                         max_labels: int = 100, meaningful_classes: int = 4):
    """One tile or frame: logits (Hc, Wc, C) -> (class map (Hc*u, Wc*u)
    uint8, id map int32, packed uint32 words), ids from the 4-connected
    components of the ball class on the coarse grid."""
    cls = semantic_argmax(logits, meaningful_classes)
    ids = connected_components(cls == ball_class, max_labels=max_labels)
    cls_up = upsample_nearest(cls, upsample)
    ids_up = upsample_nearest(ids, upsample)
    return cls_up, ids_up, pack_class_id(cls_up, ids_up)
