"""Class-wise Fast-NMS with static output shapes (counterpart of
the JAX package's ``ops/nms.py``)."""

from __future__ import annotations

import torch

from tod_tpu_torch.ops.anchors import box_iou


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def fast_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.5,
    top_k_per_class: int = 64,
    max_detections: int = 32,
    score_threshold: float = 0.05,
):
    """boxes (A, 4), scores (A, C) with class 0 background ->
    (boxes (N, 4), scores (N,), classes (N,) int32, keep_idx (N,) int64,
    valid (N,) bool), N = max_detections, classes 1-based."""
    num_classes = scores.shape[1]
    fg = scores[:, 1:].T  # (C-1, A)
    s, idx = top_k(fg, top_k_per_class)  # (C-1, k)
    b = boxes[idx]  # (C-1, k, 4)
    iou = torch.triu(box_iou(b, b), diagonal=1)
    max_iou = iou.max(dim=1).values  # over the higher-scored box i
    keep = (max_iou <= iou_threshold) & (s > score_threshold)
    s = torch.where(keep, s, torch.zeros_like(s))
    cls_ids = torch.arange(1, num_classes, device=scores.device, dtype=torch.int32)
    flat_cls = cls_ids[:, None].expand_as(s).reshape(-1)
    top_scores, order = top_k(s.reshape(-1), max_detections)
    return (
        b.reshape(-1, 4)[order],
        top_scores,
        flat_cls[order],
        idx.reshape(-1)[order],
        top_scores > score_threshold,
    )


def greedy_nms_reference(boxes, scores, iou_threshold: float) -> list[int]:
    """Sequential greedy NMS in float64 numpy, the oracle that Fast-NMS is
    tested against: ``boxes`` (A, 4) ``(y1, x1, y2, x2)`` and ``scores``
    (A,) of one class, already thresholded -> the kept indices in
    descending-score order."""
    import numpy as np

    boxes = np.asarray(boxes, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores)
    kept = []
    while order.size:
        i = order[0]
        kept.append(int(i))
        rest = order[1:]
        y1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        x1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        y2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        x2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(y2 - y1, 0) * np.maximum(x2 - x1, 0)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(area_i + area_r - inter, 1e-12)
        order = rest[iou <= iou_threshold]
    return kept
