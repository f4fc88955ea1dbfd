"""Anchors and box coding (counterpart of the JAX package's ``ops/anchors.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from tod_tpu_torch.core.config import ModelConfig

BOX_VARIANCES = (0.1, 0.2)


def feature_shapes(input_hw: tuple[int, int], strides) -> list[tuple[int, int]]:
    return [(math.ceil(input_hw[0] / s), math.ceil(input_hw[1] / s)) for s in strides]


def generate_anchors(cfg: ModelConfig) -> np.ndarray:
    """(A, 4) float32 anchors (cy, cx, h, w) normalised, position-major:
    anchor index ``(y*fw + x)*A + m*R + j``, matching the head reshape."""
    ih, iw = cfg.input_size
    out = []
    for (fh, fw), scale in zip(feature_shapes(cfg.input_size, cfg.strides), cfg.anchor_scales):
        ys = (np.arange(fh) + 0.5) / fh
        xs = (np.arange(fw) + 0.5) / fw
        cy, cx = np.meshgrid(ys, xs, indexing="ij")
        per_anchor = []
        for mult in cfg.anchor_scale_mults:
            s = scale * mult
            for r in cfg.anchor_aspect_ratios:
                w = s * math.sqrt(r) / iw
                h = s / math.sqrt(r) / ih
                per_anchor.append(
                    np.stack([cy, cx, np.full_like(cy, h), np.full_like(cx, w)], axis=-1)
                )
        out.append(np.stack(per_anchor, axis=2).reshape(-1, 4))
    return np.concatenate(out, axis=0).astype(np.float32)


def decode_boxes(loc: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """SSD decode of (A, 4) offsets against cycxhw anchors -> y1x1y2x2."""
    vc, vs = BOX_VARIANCES
    cy = anchors[:, 0] + loc[:, 0] * vc * anchors[:, 2]
    cx = anchors[:, 1] + loc[:, 1] * vc * anchors[:, 3]
    h = anchors[:, 2] * torch.exp(loc[:, 2] * vs)
    w = anchors[:, 3] * torch.exp(loc[:, 3] * vs)
    return torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], dim=-1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) x (..., M, 4) y1x1y2x2 boxes -> (..., N, M)."""
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0) * (a[..., 3] - a[..., 1]).clamp_min(0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0) * (b[..., 3] - b[..., 1]).clamp_min(0)
    y1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    x1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    y2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    x2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (y2 - y1).clamp_min(0) * (x2 - x1).clamp_min(0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp_min(1e-8)
