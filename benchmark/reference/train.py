"""The plain reference of a YOLACT training step.

SSD/YOLACT anchor matching (positives at IoU 0.5, negatives below 0.4,
each valid gt forced onto its best anchor, later slots winning), softmax
cross-entropy with 3:1 online hard-negative mining, smooth-L1 box offsets,
box-cropped mask BCE over the 16 best positives normalised by gt area, the
per-pixel semantic loss, weights (1, 1.5, 6.125, 1) (Bolya et al. 2019);
then optax's ``chain(clip_by_global_norm(10), adamw(warmup_cosine_decay))``
step for step.  The loss and the optimiser compute in float32, the graph
in the type the configuration states (``reference/model.py``).  Imports
nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.model import forward

NEG_POS_RATIO = 3
CLIP_NORM = 10.0
B1, B2, EPS = 0.9, 0.999, 1e-8
BOX_VARIANCES = (0.1, 0.2)


def anchors(mcfg: dict) -> torch.Tensor:
    """(A, 4) f32 anchors (cy, cx, h, w), position-major."""
    ih, iw = mcfg["input_size"]
    out = []
    for i, scale in enumerate(mcfg["anchor_scales"]):
        stride = 8 * 2 ** i
        fh, fw = math.ceil(ih / stride), math.ceil(iw / stride)
        cy, cx = np.meshgrid((np.arange(fh) + 0.5) / fh, (np.arange(fw) + 0.5) / fw,
                             indexing="ij")
        per = []
        for mult in mcfg["anchor_scale_mults"]:
            s = scale * mult
            for r in mcfg["anchor_aspect_ratios"]:
                per.append(np.stack([cy, cx, np.full_like(cy, s / math.sqrt(r) / ih),
                                     np.full_like(cx, s * math.sqrt(r) / iw)], axis=-1))
        out.append(np.stack(per, axis=2).reshape(-1, 4))
    return torch.from_numpy(np.concatenate(out).astype(np.float32))


def box_iou(a, b):
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0) * (a[..., 3] - a[..., 1]).clamp_min(0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0) * (b[..., 3] - b[..., 1]).clamp_min(0)
    y1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    x1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    y2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    x2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (y2 - y1).clamp_min(0) * (x2 - x1).clamp_min(0)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter).clamp_min(1e-8)


def encode(boxes, anc):
    vc, vs = BOX_VARIANCES
    gh = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-8)
    gw = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-8)
    gcy, gcx = (boxes[..., 0] + boxes[..., 2]) / 2, (boxes[..., 1] + boxes[..., 3]) / 2
    return torch.stack([(gcy - anc[:, 0]) / (vc * anc[:, 2]), (gcx - anc[:, 1]) / (vc * anc[:, 3]),
                        torch.log(gh / anc[:, 2]) / vs, torch.log(gw / anc[:, 3]) / vs], dim=-1)


def match(anc, gt_boxes, gt_classes, gt_valid):
    n, m = gt_boxes.shape[:2]
    a = anc.shape[0]
    corners = torch.stack([anc[:, 0] - anc[:, 2] / 2, anc[:, 1] - anc[:, 3] / 2,
                           anc[:, 0] + anc[:, 2] / 2, anc[:, 1] + anc[:, 3] / 2], dim=-1)
    valid = gt_valid.bool()
    iou = torch.where(valid[:, None, :], box_iou(corners.expand(n, a, 4), gt_boxes), -1.0)
    best_iou = iou.amax(dim=2)
    best_gt = torch.argmax(iou, dim=2)
    best_anchor = torch.argmax(iou, dim=1)
    forced = torch.zeros((n, a), dtype=torch.bool, device=anc.device)
    forced_gt = torch.full((n, a), -1, dtype=torch.int64, device=anc.device)
    rows = torch.arange(n, device=anc.device)
    for j in range(m):
        idx, take = best_anchor[:, j], valid[:, j]
        forced[rows, idx] = forced[rows, idx] | take
        forced_gt[rows, idx] = torch.where(take, j, forced_gt[rows, idx])
    pos = (best_iou >= 0.5) | forced
    neg = (best_iou < 0.4) & ~forced
    matched = torch.where(pos, torch.where(forced, forced_gt, best_gt), -1)
    sel = matched.clamp(0, m - 1)
    cls = torch.where(pos, torch.gather(gt_classes.long(), 1, sel), torch.where(neg, 0, -1))
    target = encode(torch.gather(gt_boxes, 1, sel[..., None].expand(n, a, 4)), anc)
    return cls, target, matched, pos, best_iou


def ce(logits, labels):
    return -torch.gather(torch.log_softmax(logits, dim=-1), -1, labels.long()[..., None])[..., 0]


def clip(x, lo: float, hi: float):
    """``jnp.clip``: a maximum and a minimum, whose gradients split at ties."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def loss(out: dict, anc, batch: dict, weights=(1.0, 1.5, 6.125, 1.0), max_masks: int = 16):
    cls_t, box_t, matched, pos, best_iou = match(anc, batch["gt_boxes"], batch["gt_classes"],
                                                  batch["gt_valid"])
    a, c = out["conf"].shape[-2:]
    n_pos = pos.sum(-1).clamp_min(1)
    l_ce = ce(out["conf"], cls_t.clamp(0, c - 1))
    neg = torch.where((cls_t >= 0) & ~pos, l_ce, -float("inf"))
    thr = torch.gather(torch.sort(neg.detach(), dim=-1, descending=True).values, -1,
                       torch.clamp_max(NEG_POS_RATIO * n_pos, a - 1)[..., None])
    l_cls = torch.where(pos | (neg > thr), l_ce, 0.0).sum(-1) / n_pos
    d = out["loc"] - box_t
    sl1 = torch.where(d.abs() < 1.0, 0.5 * d * d, d.abs() - 0.5).sum(-1)
    l_box = torch.where(pos, sl1, 0.0).sum(-1) / n_pos
    protos, b = out["prototypes"], pos.shape[0]
    hm, wm = protos.shape[1:3]
    m = batch["gt_masks"].shape[1]
    idx = torch.sort(torch.where(pos, best_iou, -1.0), dim=-1, descending=True,
                     stable=True).indices[..., :max_masks]
    sel_valid = torch.gather(pos, 1, idx)
    sel_gt = torch.gather(matched, 1, idx).clamp(0, m - 1)
    coeff = torch.tanh(torch.gather(out["coeff"], 1, idx[..., None].expand(
        -1, -1, out["coeff"].shape[-1])).float())
    masks = torch.sigmoid(coeff @ protos.reshape(b, hm * wm, -1).transpose(1, 2)).reshape(
        b, -1, hm, wm)
    rows = torch.arange(b, device=idx.device)[:, None]
    tgt = batch["gt_masks"][rows, sel_gt]
    bce = -(tgt * torch.log(clip(masks, 1e-6, 1.0)) + (1 - tgt) * torch.log(clip(1 - masks, 1e-6,
                                                                                1.0)))
    boxes = batch["gt_boxes"][rows, sel_gt]
    area = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])).clamp_min(1e-4)
    ys = ((torch.arange(hm, device=idx.device, dtype=torch.float32) + 0.5) / hm)[:, None]
    xs = ((torch.arange(wm, device=idx.device, dtype=torch.float32) + 0.5) / wm)[None, :]
    bx = boxes[..., None, None]
    inside = ((ys >= bx[..., 0, :, :]) & (ys <= bx[..., 2, :, :]) & (xs >= bx[..., 1, :, :])
              & (xs <= bx[..., 3, :, :]))
    per = torch.where(inside, bce, 0.0).sum((-2, -1)) / (area * hm * wm)
    l_mask = torch.where(sel_valid, per, 0.0).sum(-1) / sel_valid.sum(-1).clamp_min(1)
    l_sem = ce(out["sem_logits"], batch["sem_target"]).mean((-2, -1))
    w = weights
    return (w[0] * l_cls.mean() + w[1] * l_box.mean() + w[2] * l_mask.mean()
            + w[3] * l_sem.mean())


def learning_rate(tcfg: dict, count: int) -> float:
    f32 = np.float32
    peak, warm = f32(tcfg["learning_rate"]), tcfg["warmup_steps"]
    decay = max(tcfg["total_steps"], warm + 1) - warm
    if count < warm:
        return float((f32(0) - peak) * (f32(1) - f32(max(count, 0)) / f32(warm)) + peak)
    c = f32(min(count - warm, decay))
    return float(peak * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay))))


def images(batch: dict) -> torch.Tensor:
    return batch["image"].float() / 127.5 - 1.0


def train_steps(params: dict, batches: list, anc, mcfg: dict, tcfg: dict,
                dtype: torch.dtype = torch.float32, start: int = 0):
    """Clipped AdamW from ``params`` and zero moments at count ``start``
    over ``batches`` -> (the losses, the first step's clipped gradient by
    leaf, the parameters after the last step)."""
    p = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for count, batch in enumerate(batches):
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        out = forward(leaves, images(batch), mcfg, dtype=dtype)
        total = loss(out, anc, batch, tuple(tcfg["loss_weights"]))
        grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
        losses.append(float(total.detach()))
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
            scale = 1.0 if float(norm) < CLIP_NORM else CLIP_NORM / norm
            grads = {k: g * scale for k, g in grads.items()}
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            lr = learning_rate(tcfg, start + count)
            n = start + count + 1
            bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(n))
            bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(n))
            for k, g in grads.items():
                mu[k] = B1 * mu[k] + (1 - B1) * g
                nu[k] = B2 * nu[k] + (1 - B2) * g * g
                upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS) + tcfg["weight_decay"] * p[k]
                p[k] = (p[k].detach() - lr * upd)
    return losses, first, {k: v.detach() for k, v in p.items()}
