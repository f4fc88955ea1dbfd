"""Anchor to ground-truth matching, the SSD/YOLACT scheme (counterpart of
the JAX package's ``train/matcher.py``).

Per anchor, the best-overlapping gt box; positives at or above the high
threshold, negatives below the low one, an ignore band between; and each
valid gt force-matched to its best anchor so no object goes unsupervised.
gt boxes arrive padded to M slots with class 0, masked by ``gt_valid``.
Every tensor may carry a leading batch axis.
"""

from __future__ import annotations

import torch

from tod_tpu_torch.ops.anchors import box_iou, encode_boxes

POS_IOU = 0.5
NEG_IOU = 0.4


def anchor_corners(anchors: torch.Tensor) -> torch.Tensor:
    """(A, 4) cycxhw anchors -> (A, 4) y1x1y2x2."""
    return torch.stack([anchors[:, 0] - anchors[:, 2] / 2, anchors[:, 1] - anchors[:, 3] / 2,
                        anchors[:, 0] + anchors[:, 2] / 2, anchors[:, 1] + anchors[:, 3] / 2],
                       dim=-1)


def match_anchors(anchors, gt_boxes, gt_classes, gt_valid) -> dict[str, torch.Tensor]:
    """anchors (A, 4) cycxhw; gt_boxes (..., M, 4) y1x1y2x2; gt_classes
    (..., M) int; gt_valid (..., M) bool.

    -> dict with
      ``cls_target`` (..., A) int32: 0 background, >= 1 class id, -1 ignore;
      ``box_target`` (..., A, 4) f32: encoded offsets (meaningful where positive);
      ``matched_gt`` (..., A) int32: the matched gt's slot (-1 if none);
      ``pos_mask`` (..., A) bool;
      ``best_iou`` (..., A) f32: each anchor's best gt overlap.

    Ties go to the lowest index, as ``jnp.argmax``'s do.  The forced
    matches are written gt by gt in slot order, so a later gt whose best
    anchor an earlier one also claimed takes it over, as in the JAX loop.
    """
    lead = gt_boxes.shape[:-2]
    m = gt_boxes.shape[-2]
    boxes = gt_boxes.reshape(-1, m, 4)
    classes = gt_classes.reshape(-1, m)
    valid = gt_valid.reshape(-1, m).bool()
    n, a = boxes.shape[0], anchors.shape[0]
    iou = box_iou(anchor_corners(anchors).expand(n, a, 4), boxes)  # (N, A, M)
    iou = torch.where(valid[:, None, :], iou, torch.full((), -1.0, device=iou.device))

    best_iou = iou.amax(dim=2)
    best_gt = torch.argmax(iou, dim=2)  # the first maximum, as jnp.argmax
    best_anchor = torch.argmax(iou, dim=1)  # (N, M)

    forced = torch.zeros((n, a), dtype=torch.bool, device=iou.device)
    forced_gt = torch.full((n, a), -1, dtype=torch.int64, device=iou.device)
    rows = torch.arange(n, device=iou.device)
    for j in range(m):  # slot order: a later gt overwrites an earlier one
        idx, take = best_anchor[:, j], valid[:, j]
        forced[rows, idx] = forced[rows, idx] | take
        forced_gt[rows, idx] = torch.where(take, j, forced_gt[rows, idx])

    pos = (best_iou >= POS_IOU) | forced
    neg = (best_iou < NEG_IOU) & ~forced
    matched = torch.where(forced, forced_gt, best_gt)
    matched = torch.where(pos, matched, -1)

    sel = matched.clamp(0, m - 1)
    cls_from_gt = torch.gather(classes.long(), 1, sel)
    cls_target = torch.where(pos, cls_from_gt, torch.where(neg, 0, -1))
    gt_for_anchor = torch.gather(boxes, 1, sel[..., None].expand(n, a, 4))
    box_target = encode_boxes(gt_for_anchor, anchors)
    out = {
        "cls_target": cls_target.to(torch.int32),
        "box_target": box_target,
        "matched_gt": matched.to(torch.int32),
        "pos_mask": pos,
        "best_iou": best_iou,
    }
    return {k: v.reshape(*lead, *v.shape[1:]) for k, v in out.items()}
