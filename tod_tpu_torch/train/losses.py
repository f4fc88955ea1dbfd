"""YOLACT training losses (counterpart of the JAX package's
``train/losses.py``): softmax cross-entropy with 3:1 online hard-negative
mining (or the focal loss), smooth-L1 on encoded box offsets, per-instance
BCE on assembled prototype masks normalized by gt box area, and a
per-pixel semantic loss on the P3 head.

Each loss takes a batch and returns one value per example; ``yolact_loss``
averages them over the batch, as the JAX package's ``vmap`` and mean do.
Masks are supervised for the ``max_masks`` positive anchors of best match
quality (a fixed-size top-k), so every shape is static.
"""

from __future__ import annotations

import torch

from tod_tpu_torch.ops.ieee import clip
from tod_tpu_torch.ops.masks import assemble_masks, crop_masks

NEG_POS_RATIO = 3


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _integer_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy with integer labels over the last axis."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def _n_pos(pos: torch.Tensor) -> torch.Tensor:
    return pos.sum(dim=-1).clamp_min(1)


def classification_loss(conf: torch.Tensor, cls_target: torch.Tensor) -> torch.Tensor:
    """OHEM softmax CE.  conf (B, A, C); cls_target (B, A) with -1 = ignore
    -> (B,).  The negatives kept are those whose loss is strictly above the
    k-th largest negative loss, k = min(3 n_pos, A - 1): ties at that
    threshold are dropped, as in the JAX loss."""
    a, c = conf.shape[-2:]
    valid = cls_target >= 0
    ce = _integer_ce(conf, cls_target.clamp(0, c - 1))
    pos = cls_target > 0
    n_pos = _n_pos(pos)
    neg_losses = torch.where(valid & ~pos, ce, torch.full((), -float("inf"), device=ce.device))
    sorted_neg = torch.sort(neg_losses.detach(), dim=-1, descending=True).values
    k = torch.clamp_max(NEG_POS_RATIO * n_pos, a - 1)
    threshold = torch.gather(sorted_neg, -1, k[..., None])
    keep = pos | (neg_losses > threshold)
    return torch.where(keep, ce, torch.zeros((), device=ce.device)).sum(dim=-1) / n_pos


def focal_classification_loss(conf: torch.Tensor, cls_target: torch.Tensor,
                              alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Focal loss (RetinaNet), the alternative to OHEM -> (B,)."""
    c = conf.shape[-1]
    valid = cls_target >= 0
    ce = _integer_ce(conf, cls_target.clamp(0, c - 1))
    pt = torch.exp(-ce)
    pos = cls_target > 0
    alpha_t = torch.where(pos, alpha, 1.0 - alpha)
    fl = alpha_t * (1.0 - pt) ** gamma * ce
    return torch.where(valid, fl, torch.zeros((), device=fl.device)).sum(dim=-1) / _n_pos(pos)


def box_loss(loc: torch.Tensor, box_target: torch.Tensor, pos_mask: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 over the positives' offsets, per positive -> (B,)."""
    per_anchor = _smooth_l1(loc - box_target).sum(dim=-1)
    zero = torch.zeros((), device=per_anchor.device)
    return torch.where(pos_mask, per_anchor, zero).sum(dim=-1) / _n_pos(pos_mask)


def top_positives(pos_mask: torch.Tensor, quality: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` best positives by match quality (B, k):
    ``lax.top_k`` over ``where(pos, quality, -1)``, whose ties go to the
    lower index, as a stable descending sort's do."""
    score = torch.where(pos_mask, quality, torch.full((), -1.0, device=quality.device))
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def mask_loss(prototypes, coeff, matched_gt, pos_mask, iou_quality, gt_masks, gt_boxes,
              max_masks: int = 16) -> torch.Tensor:
    """BCE between assembled masks and gt instance masks for the top
    positives -> (B,).

    prototypes (B, Hm, Wm, K); coeff (B, A, K) raw logits; matched_gt
    (B, A); gt_masks (B, M, Hm, Wm) in {0, 1}; gt_boxes (B, M, 4).  Each
    instance's loss is cropped to its gt box and normalized by the box's
    area (YOLACT's small-object reweighting).
    """
    b, hm, wm, _ = prototypes.shape
    m = gt_masks.shape[1]
    idx = top_positives(pos_mask, iou_quality, max_masks)  # (B, k)
    sel_valid = torch.gather(pos_mask, 1, idx)
    sel_gt = torch.gather(matched_gt.long(), 1, idx).clamp(0, m - 1)
    picked = torch.gather(coeff, 1, idx[..., None].expand(-1, -1, coeff.shape[-1]))
    # tanh after the gather, in f32: max_masks anchors, not the whole map
    masks = assemble_masks(prototypes, torch.tanh(picked.float()))  # (B, k, Hm, Wm)
    rows = torch.arange(b, device=idx.device)[:, None]
    targets = gt_masks[rows, sel_gt]
    bce = -(targets * torch.log(clip(masks, 1e-6, 1.0))
            + (1.0 - targets) * torch.log(clip(1.0 - masks, 1e-6, 1.0)))
    boxes = gt_boxes[rows, sel_gt]  # (B, k, 4)
    area = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])).clamp_min(1e-4)
    per_inst = crop_masks(bce, boxes).sum(dim=(-2, -1)) / (area * hm * wm)
    n_sel = sel_valid.sum(dim=-1).clamp_min(1)
    return torch.where(sel_valid, per_inst, torch.zeros((), device=per_inst.device)).sum(-1) / n_sel


def semantic_loss(sem_logits: torch.Tensor, sem_target: torch.Tensor) -> torch.Tensor:
    """Per-pixel softmax CE.  sem_logits (B, Hs, Ws, C); sem_target
    (B, Hs, Ws) -> (B,)."""
    return _integer_ce(sem_logits, sem_target).mean(dim=(-2, -1))


def yolact_loss(outputs, anchors: torch.Tensor, batch: dict,
                loss_weights=(1.0, 1.5, 6.125, 1.0), max_masks: int = 16,
                cls_loss: str = "ohem") -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total loss over a batch.

    outputs: ``YolactOutputs``; batch: tensors ``gt_boxes`` (B, M, 4),
    ``gt_classes`` (B, M), ``gt_valid`` (B, M), ``gt_masks`` (B, M, Hm, Wm),
    ``sem_target`` (B, Hs, Ws).  Returns (total, components), each a 0-dim
    tensor on the outputs' device.
    """
    from tod_tpu_torch.train.matcher import match_anchors

    m = match_anchors(anchors, batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"])
    if cls_loss == "focal":
        l_cls = focal_classification_loss(outputs.conf, m["cls_target"])
    elif cls_loss == "ohem":
        l_cls = classification_loss(outputs.conf, m["cls_target"])
    else:
        raise ValueError(f"unknown cls_loss {cls_loss!r}")
    l_box = box_loss(outputs.loc, m["box_target"], m["pos_mask"])
    l_mask = mask_loss(outputs.prototypes, outputs.coeff, m["matched_gt"], m["pos_mask"],
                       m["best_iou"], batch["gt_masks"], batch["gt_boxes"], max_masks)
    l_sem = semantic_loss(outputs.sem_logits, batch["sem_target"])
    comps = {"cls": l_cls.mean(), "box": l_box.mean(), "mask": l_mask.mean(),
             "sem": l_sem.mean()}
    w = loss_weights
    total = w[0] * comps["cls"] + w[1] * comps["box"] + w[2] * comps["mask"] + w[3] * comps["sem"]
    return total, comps
