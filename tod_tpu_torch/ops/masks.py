"""Mask assembly, crop and class maps (counterpart of the JAX package's ``ops/masks.py``).

``assemble_masks`` + ``crop_masks`` are the plain version of kernel K1
(``kernels/mask_assembly.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tod_tpu_torch.ops.ieee import div


def assemble_masks(prototypes: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """prototypes (..., Hm, Wm, K) x coeffs (..., N, K) -> (..., N, Hm, Wm)."""
    *lead, hm, wm, k = prototypes.shape
    p = prototypes.reshape(*lead, hm * wm, k)
    m = torch.matmul(coeffs, p.transpose(-1, -2))  # (..., N, Hm*Wm)
    return torch.sigmoid(m).reshape(*lead, coeffs.shape[-2], hm, wm)


def crop_masks(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero mask values whose pixel centre lies outside the box (inclusive).
    masks (..., N, Hm, Wm), boxes (..., N, 4) y1x1y2x2 normalised."""
    hm, wm = masks.shape[-2:]
    ys = div(torch.arange(hm, dtype=torch.float32, device=masks.device) + 0.5, float(hm))
    xs = div(torch.arange(wm, dtype=torch.float32, device=masks.device) + 0.5, float(wm))
    yy = ys[:, None]
    xx = xs[None, :]
    bx = boxes[..., None, None]
    inside = (
        (yy >= bx[..., 0, :, :])
        & (yy <= bx[..., 2, :, :])
        & (xx >= bx[..., 1, :, :])
        & (xx <= bx[..., 3, :, :])
    )
    return torch.where(inside, masks, torch.zeros((), dtype=masks.dtype, device=masks.device))


def threshold_masks(masks: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Binary masks, 1 where a mask is above ``threshold``, as uint8."""
    return (masks > threshold).to(torch.uint8)


def masks_to_class_map(masks, classes, valid, out_hw: tuple[int, int], threshold=0.5):
    """Instance masks (N, Hm, Wm) -> (class_map uint8 (H, W), id_map int32
    (H, W), -1 where none).  The lowest slot covering a pixel wins."""
    masks_up = F.interpolate(masks[None], size=tuple(out_hw), mode="bilinear",
                             align_corners=False)[0]
    on = (masks_up > threshold) & valid[:, None, None]
    any_on = on.any(dim=0)
    first = on.to(torch.uint8).argmax(dim=0)
    class_map = torch.where(any_on, classes[first], 0).to(torch.uint8)
    id_map = torch.where(any_on, first, -1).to(torch.int32)
    return class_map, id_map
