"""Checkpoint evaluation (counterpart of the JAX package's
``train/evaluate.py``): ``python -m tod_tpu_torch.train.evaluate --ckpt X.npz``.

Held-out procedural scenes with exact ground truth -> per-class semantic
mask IoU, detection box quality (best IoU per gt object), COCO-style mAP
(AP@0.5 per class, mAP@0.5, mAP@[.5:.95] with greedy score-ordered
matching), score calibration and duplicate-slot rate.  The scenes go through
a detect-mode and a semantic-mode port ``Engine`` (on the card: the
mask-assembly, terrain, connection and connected-components kernels), and
with ``plan`` each detect-mode scene is also planned on the device (the
relaxation and path-walk kernels), which adds ``plans_found``.

``--sim`` scores against scenes of the sim renderer (``sim/camera.py``), a
generator the trainer never saw, and ``--report-domains`` scores the same
checkpoint on the held-out procedural scenes, the sim scenes and, where
their images are present, the hand-labelled real fixtures
(``tests/fixtures/real``), side by side.
"""

from __future__ import annotations

import argparse
import json
import pathlib

REAL_FIXTURES = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "real"


def box_iou(a, b) -> float:
    """IoU of two [y1, x1, y2, x2] boxes (normalized or absolute alike)."""
    y1 = max(a[0], b[0])
    x1 = max(a[1], b[1])
    y2 = min(a[2], b[2])
    x2 = min(a[3], b[3])
    inter = max(y2 - y1, 0.0) * max(x2 - x1, 0.0)
    area_a = max(a[2] - a[0], 0.0) * max(a[3] - a[1], 0.0)
    area_b = max(b[2] - b[0], 0.0) * max(b[3] - b[1], 0.0)
    union = area_a + area_b - inter
    return float(inter / union) if union > 0 else 0.0


def average_precision(scores, tp_flags, n_gt: int):
    """All-point interpolated AP (area under the precision envelope).

    ``scores``/``tp_flags`` are per-detection over the whole eval set (any
    order); ``n_gt`` is the total ground-truth count for the class.  Returns
    None when the class has no ground truth (undefined, not zero).
    """
    import numpy as np

    if n_gt <= 0:
        return None
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores, dtype=np.float64), kind="stable")
    tp = np.asarray(tp_flags, dtype=np.float64)[order]
    ctp = np.cumsum(tp)
    recall = ctp / n_gt
    precision = ctp / np.arange(1, len(tp) + 1)
    # precision envelope: p(r) = max precision at recall >= r
    env = np.maximum.accumulate(precision[::-1])[::-1]
    # sum p(r)·Δr over the recall steps where a TP lands
    prev_r = 0.0
    ap = 0.0
    for r, p, t in zip(recall, env, tp):
        if t:
            ap += p * (r - prev_r)
            prev_r = r
    return float(ap)


def _greedy_match(iou_mat, scores, thr: float):
    """Score-ordered greedy detection↔GT matching at one IoU threshold.

    ``iou_mat``: (n_det, n_gt) same-class IoUs for ONE scene.  Each GT matches
    at most one detection (the highest-scoring one that clears ``thr``) —
    duplicates on the same object are false positives, exactly the behavior
    mAP is chosen to penalize (detections_per_gt alone can't).
    Returns a (n_det,) bool TP array in the original detection order.
    """
    import numpy as np

    n_det, n_gt = iou_mat.shape
    tp = np.zeros(n_det, dtype=bool)
    taken = np.zeros(n_gt, dtype=bool)
    for i in np.argsort(-np.asarray(scores), kind="stable"):
        ious = np.where(taken, -1.0, iou_mat[i])
        j = int(np.argmax(ious)) if n_gt else -1
        if j >= 0 and ious[j] >= thr:
            tp[i] = True
            taken[j] = True
    return tp


def make_eval_engines(hw=(240, 320), mcfg=None, params=None, device=None):
    """The two evaluation pipelines over the same weights: a detect-mode and
    a semantic-mode ``Engine`` on ``device`` (the card by default), with a
    camera of ``hw``.  ``params`` is a serving state dict (the pinned
    weights when None).  Built once and reused: :func:`swap_weights` loads
    new weights into them."""
    from tod_tpu_torch.core.config import CameraConfig, ModelConfig, PipelineConfig
    from tod_tpu_torch.runtime.engine import Engine

    cam = CameraConfig(width=hw[1], height=hw[0])
    cfg = PipelineConfig(camera=cam, model=mcfg or ModelConfig(input_size=hw))
    eng = Engine(cfg, params=params, mode="detect", device=device)
    eng_sem = Engine(cfg, params=params, mode="semantic", device=device)
    return eng, eng_sem


def swap_weights(eng, state) -> None:
    """Load a serving state dict into an engine's model in place (an int8
    engine calibrates and quantizes it again)."""
    from tod_tpu_torch.core.weights import check_state
    from tod_tpu_torch.runtime.engine import serving_model

    if eng.cfg.model.quantized:
        eng.model, eng.dtype, eng.anchors = serving_model(eng.cfg, state, eng.device)
        return
    check_state(eng.model, state)
    eng.model.load_state_dict(state)


def evaluate(ckpt: str, n_scenes: int = 16, seed: int = 9999, hw=(240, 320), mcfg=None,
             device=None) -> dict:
    """Score the checkpoint ``.npz`` ``ckpt`` on ``n_scenes`` held-out
    procedural scenes."""
    from tod_tpu_torch.core.weights import load_checkpoint

    params = load_checkpoint(ckpt, mcfg)
    eng, eng_sem = make_eval_engines(hw, mcfg, params=params, device=device)
    out = evaluate_engines(eng, eng_sem, n_scenes=n_scenes, seed=seed, hw=hw)
    out["checkpoint"] = ckpt
    return out


def disk_eval_scenes(root, hw, n_scenes: int):
    """Scene tuples (img, boxes, classes, valid, inst_fullres, sem_fullres)
    from an on-disk dataset (train/dataset.py layout) — lets the evaluator
    score a checkpoint against REAL annotated frames, in annotation order."""
    import numpy as np

    from tod_tpu_torch.train.dataset import DiskDetectionData

    data = DiskDetectionData(root, hw, batch_size=1, shuffle=False)
    for i in range(min(n_scenes, len(data))):
        yield data._load_example(data.images[i])


def sim_eval_scenes(hw, n_scenes: int, seed: int = 0):
    """Cross-domain scenes from the sim renderer (``sim/camera.py``):
    perspective geometry, flat shading and floor-plane depth, where the
    trainer saw the 2-D procedural painter.  Yields the evaluator's scene
    tuples; the instance masks are the connected components
    (``scipy.ndimage.label``) of each class of the renderer's class map
    (the worlds space their objects widely, so same-class merges are rare,
    and one only makes the score stricter)."""
    import numpy as np
    from scipy import ndimage

    from tod_tpu_torch.core.config import CameraConfig
    from tod_tpu_torch.sim.camera import render
    from tod_tpu_torch.sim.world import Ball, Obstacle, SimWorld
    from tod_tpu_torch.train.synthetic_data import MAX_OBJECTS

    h, w = hw
    cam = CameraConfig(width=w, height=h)
    rng = np.random.default_rng(seed)
    for i in range(n_scenes):
        balls = [
            Ball(x=float(rng.uniform(-1400, 1400)), z=float(rng.uniform(700, 3200)))
            for _ in range(int(rng.integers(1, 4)))
        ]
        obstacles = [
            Obstacle(
                x=float(rng.uniform(-1600, 1600)),
                z=float(rng.uniform(900, 3600)),
                team=("red" if rng.random() < 0.5 else "blue"),
            )
            for _ in range(int(rng.integers(0, 3)))
        ]
        world = SimWorld(balls=balls, obstacles=obstacles)
        frame, cls_map, _ids = render(world, cam, seed=seed * 1000 + i, annotate=True)

        boxes = np.zeros((MAX_OBJECTS, 4), np.float32)
        classes = np.zeros((MAX_OBJECTS,), np.int32)
        valid = np.zeros((MAX_OBJECTS,), bool)
        inst = np.zeros((MAX_OBJECTS, h, w), np.float32)
        k = 0
        for c in (1, 2, 3):
            lab, n = ndimage.label(cls_map == c)
            for j in range(1, n + 1):
                m = lab == j
                if m.sum() < 30 or k >= MAX_OBJECTS:
                    continue
                ys, xs = np.nonzero(m)
                boxes[k] = [
                    ys.min() / h, xs.min() / w, (ys.max() + 1) / h, (xs.max() + 1) / w,
                ]
                classes[k] = c
                valid[k] = True
                inst[k] = m.astype(np.float32)
                k += 1
        yield frame.rgb, boxes, classes, valid, inst, cls_map.astype(np.int32)


def fixture_images_present(root=REAL_FIXTURES) -> bool:
    """Whether an annotated dataset's annotations and every image they name
    (absolute, or relative to ``root``) are on disk."""
    root = pathlib.Path(root)
    ann = root / "annotations.json"
    if not ann.is_file():
        return False
    images = json.loads(ann.read_text())["images"]
    return all((root / rec["file"]).is_file() for rec in images)


def hard_eval_scenes(hw, n_scenes: int, seed: int = 0):
    """Held-out scenes from the hard evaluation distribution
    (``train/domainrand.py`` ``HardEvalData``: small, occluded, crowded
    objects on busy backgrounds), bench config 15's quality axis."""
    from tod_tpu_torch.train.domainrand import HardEvalData

    data = HardEvalData(hw, batch_size=1, seed=seed)
    for _ in range(n_scenes):
        yield data._scene()


PERTURBATIONS = (
    "gamma_down", "gamma_up", "contrast_down", "wb_warm",
    "noise", "hflip", "zoom_in", "zoom_out",
)


def perturbed_fixture_scenes(root, hw, variants=PERTURBATIONS):
    """Perturbation-robustness variants of the first two annotated scenes
    of an on-disk dataset (``root``, the ``train/dataset.py`` layout):
    deterministic photometric and geometric transforms that no training
    iteration optimized against, with the ground-truth boxes and masks
    transformed alongside.

    Photometric variants leave the GT untouched; geometric variants (hflip,
    zoom_in = center-crop 0.8 + resize back, zoom_out = shrink to 0.8 on a
    gray canvas) transform boxes, instance masks, and the semantic map through
    the same nearest-neighbor resampler as the dataset loader.  Yields the
    evaluator's scene tuples, one per (fixture, variant).
    """
    import numpy as np

    from tod_tpu_torch.train.dataset import _nearest_resize

    h, w = hw
    base = list(disk_eval_scenes(root, hw, 2))

    def photometric(img, name, rng):
        f = img.astype(np.float32)
        if name == "gamma_down":
            out = (f / 255.0) ** 0.6 * 255.0
        elif name == "gamma_up":
            out = (f / 255.0) ** 1.6 * 255.0
        elif name == "contrast_down":
            out = (f - 128.0) * 0.65 + 128.0
        elif name == "wb_warm":
            out = f * np.array([1.15, 1.0, 0.85], np.float32)
        elif name == "noise":
            out = f + rng.normal(0.0, 12.0, f.shape)
        else:
            raise ValueError(name)
        return np.clip(out, 0, 255).astype(np.uint8)

    for img, boxes, classes, valid, inst, sem in base:
        for vi, name in enumerate(variants):
            rng = np.random.default_rng(1000 + vi)  # deterministic per variant
            b, v = boxes.copy(), valid.copy()
            if name == "hflip":
                im = img[:, ::-1].copy()
                b[:, 1], b[:, 3] = 1.0 - boxes[:, 3], 1.0 - boxes[:, 1]
                ins, sm = inst[:, :, ::-1].copy(), sem[:, ::-1].copy()
            elif name == "zoom_in":  # center-crop 0.8, resize back (1.25x)
                f = 0.8
                y0, x0 = int(h * (1 - f) / 2), int(w * (1 - f) / 2)
                ch, cw = int(h * f), int(w * f)
                im = _nearest_resize(img[y0:y0 + ch, x0:x0 + cw], hw)
                b = np.clip((boxes - (1 - f) / 2) / f, 0.0, 1.0)
                v = valid & ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) > 0.003)
                ins = np.stack(
                    [_nearest_resize(m[y0:y0 + ch, x0:x0 + cw], hw) for m in inst]
                )
                sm = _nearest_resize(sem[y0:y0 + ch, x0:x0 + cw], hw)
            elif name == "zoom_out":  # shrink to 0.8 on a gray canvas
                f = 0.8
                sh, sw = int(h * f), int(w * f)
                y0, x0 = (h - sh) // 2, (w - sw) // 2
                im = np.full((h, w, 3), 114, np.uint8)
                im[y0:y0 + sh, x0:x0 + sw] = _nearest_resize(img, (sh, sw))
                b = (1 - f) / 2 + boxes * f
                ins = np.zeros_like(inst)
                ins[:, y0:y0 + sh, x0:x0 + sw] = np.stack(
                    [_nearest_resize(m, (sh, sw)) for m in inst]
                )
                sm = np.zeros_like(sem)
                sm[y0:y0 + sh, x0:x0 + sw] = _nearest_resize(sem, (sh, sw))
            else:
                im = photometric(img, name, rng)
                ins, sm = inst, sem
            yield im, b, classes, v, ins, sm


def evaluate_engines(eng, eng_sem, n_scenes: int = 16, seed: int = 9999, hw=(240, 320),
                     scenes=None, plan: bool = False) -> dict:
    """Run the held-out metric sweep through prebuilt eval engines.

    ``scenes`` overrides the scene supply (an iterable of full-resolution
    scene tuples, e.g. :func:`disk_eval_scenes`); the default is fresh
    held-out procedural scenes.  With ``plan`` each detect-mode scene is
    planned by ``eng.plan_scene`` and ``plans_found`` is the share of
    scenes whose plan reaches a ball."""
    import numpy as np

    from tod_tpu_torch.core.types import Frame
    from tod_tpu_torch.train.synthetic_data import SyntheticDetectionData

    def host(x):
        return x.cpu().numpy()

    data = SyntheticDetectionData(hw, batch_size=1, seed=seed)
    if scenes is None:
        scenes = (data._scene() for _ in range(n_scenes))
    ramp = np.linspace(3500, 600, hw[0]).astype(np.uint16)
    depth = np.broadcast_to(ramp[:, None], hw).copy()

    sem_i = {1: 0.0, 2: 0.0, 3: 0.0}
    sem_u = {1: 0.0, 2: 0.0, 3: 0.0}
    best_ious, scores, inst_mask_ious, n_gt, n_det = [], [], [], 0, 0
    # per-class AP accumulators: detection (score, iou-row) pairs per scene
    ap_scores = {c: [] for c in sem_i}  # flat per-detection scores
    ap_mats = {c: [] for c in sem_i}  # per-scene (n_det_c, n_gt_c) IoU mats
    ap_ngt = {c: 0 for c in sem_i}
    n_scenes = plans_found = 0
    for img, gboxes, gclasses, gvalid, ginst, sem in scenes:
        n_scenes += 1
        frame = Frame(rgb=img, depth=depth)
        scene, dets = eng.process(frame)
        _, dets_sem = eng_sem.process(frame)
        if plan:
            plans_found += int(host(eng.plan_scene(scene.height, scene.balls))[0, 0] > 0)
        pred_map = host(dets_sem.class_map)
        for c in sem_i:
            gt = sem == c
            pc = pred_map == c
            sem_i[c] += float((gt & pc).sum())
            sem_u[c] += float((gt | pc).sum())
        valid = host(dets.valid)
        boxes = host(dets.boxes)[valid]
        classes = host(dets.classes)[valid]
        det_masks = host(dets.masks)[valid]  # (N, H/4, W/4) soft
        det_scores = host(dets.scores)[valid]
        scores.extend(det_scores.tolist())
        n_det += int(valid.sum())
        # per-class score/IoU records for mAP (greedy matching happens after
        # the scene loop, once per IoU threshold)
        gv = np.asarray(gvalid, dtype=bool)
        for c in ap_scores:
            di = classes == c
            gb_c = np.asarray(gboxes)[gv & (np.asarray(gclasses) == c)]
            ap_ngt[c] += len(gb_c)
            mat = np.array(
                [[box_iou(b, g) for g in gb_c] for b in boxes[di]], dtype=np.float64
            ).reshape(int(di.sum()), len(gb_c))
            ap_scores[c].append(det_scores[di])
            ap_mats[c].append(mat)
        # GT instance masks at the prototype resolution (the masks' native res)
        ginst_p = data._downsample_mask(ginst, 4) > 0.5
        for j, (gb, gc, gv) in enumerate(zip(gboxes, gclasses, gvalid)):
            if not gv:
                continue
            n_gt += 1
            same = classes == gc
            # GT objects with no same-class detection count as IoU 0 so the
            # recall metrics are over ALL ground truth, not just matched GT.
            if not same.any():
                best_ious.append(0.0)
                inst_mask_ious.append(0.0)
                continue
            ious = [box_iou(gb, b) for b in boxes[same]]
            best_ious.append(max(ious))
            # instance-mask IoU of the best-box detection vs the GT instance
            # (the YOLACT capability: per-instance binary masks, not just
            # the semantic map)
            bm = det_masks[same][int(np.argmax(ious))] > 0.5
            gm = ginst_p[j]
            union = (bm | gm).sum()
            inst_mask_ious.append(float((bm & gm).sum() / union) if union else 0.0)

    # COCO-style mAP: AP per class at IoU .5 and averaged over [.5:.95:.05]
    thresholds = [0.5 + 0.05 * t for t in range(10)]
    ap_by_thr: dict[float, dict[int, float | None]] = {}
    for thr in thresholds:
        per_class = {}
        for c in ap_scores:
            flat_scores, flat_tp = [], []
            for sc, mat in zip(ap_scores[c], ap_mats[c]):
                flat_scores.extend(sc.tolist())
                flat_tp.extend(_greedy_match(mat, sc, thr).tolist())
            per_class[c] = average_precision(flat_scores, flat_tp, ap_ngt[c])
        ap_by_thr[thr] = per_class

    def _mean_ap(per_class):
        vals = [v for v in per_class.values() if v is not None]
        return round(float(np.mean(vals)), 4) if vals else None

    map50 = _mean_ap(ap_by_thr[0.5])
    map_all = [_mean_ap(ap_by_thr[t]) for t in thresholds]
    map5095 = (
        round(float(np.mean([m for m in map_all if m is not None])), 4)
        if any(m is not None for m in map_all)
        else None
    )

    out = {
        "n_scenes": n_scenes,
        "ap50_per_class": {
            c: (round(v, 4) if v is not None else None)
            for c, v in ap_by_thr[0.5].items()
        },
        "map50": map50,
        "map50_95": map5095,
        "sem_iou": {
            c: round(sem_i[c] / sem_u[c], 4) if sem_u[c] else None for c in sem_i
        },
        "det_best_box_iou_mean": round(float(np.mean(best_ious)), 4) if best_ious else 0.0,
        "det_recall_iou30": round(
            float(np.mean([i > 0.3 for i in best_ious])), 4
        ) if best_ious else 0.0,
        "det_recall_iou50": round(
            float(np.mean([i > 0.5 for i in best_ious])), 4
        ) if best_ious else 0.0,
        "mean_score": round(float(np.mean(scores)), 4) if scores else 0.0,
        "detections_per_gt": round(n_det / max(n_gt, 1), 3),
        "inst_mask_iou_mean": round(
            float(np.mean(inst_mask_ious)), 4
        ) if inst_mask_ious else 0.0,
    }
    if plan:
        out["plans_found"] = round(plans_found / max(n_scenes, 1), 4)
    return out


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True, help="a checkpoint .npz (the pinned file's layout)")
    p.add_argument("--scenes", type=int, default=16)
    p.add_argument("--seed", type=int, default=9999)
    p.add_argument("--int8", action="store_true",
                   help="evaluate through the static int8 serving graph (BatchNorm folded, "
                   "calibrated, quantized at load): PTQ and QAT checkpoints alike")
    p.add_argument("--data", default=None,
                   help="evaluate against an on-disk annotated dataset (train/dataset.py "
                   "layout) instead of held-out procedural scenes")
    p.add_argument("--hard", action="store_true",
                   help="evaluate against the hard held-out distribution "
                   "(domainrand.HardEvalData: small, occluded, crowded objects)")
    p.add_argument("--hw", default=None, help="eval input resolution as HxW (default 240x320)")
    p.add_argument("--backbone", default=None,
                   help="model family member of the checkpoint (ModelConfig.backbone)")
    p.add_argument("--sim", action="store_true",
                   help="evaluate against sim-renderer scenes (sim/camera.py): a cross-domain "
                   "generator the trainer never saw")
    p.add_argument("--report-domains", action="store_true",
                   help="one JSON with the same checkpoint scored on held-out procedural "
                   "scenes, sim-renderer scenes and, where their images are present, the "
                   "hand-labelled real fixtures (tests/fixtures/real)")
    args = p.parse_args(argv)
    hw_cli = None
    if args.hw:
        hh, ww = args.hw.lower().split("x")
        hw_cli = (int(hh), int(ww))
    mcfg = None
    if args.int8 or hw_cli or args.backbone:
        from tod_tpu_torch.core.config import ModelConfig

        mcfg = ModelConfig(input_size=hw_cli or (240, 320), quantized=args.int8,
                           backbone=args.backbone or "mobilenetv2")
    if args.report_domains:
        from tod_tpu_torch.core.weights import load_checkpoint

        hw = mcfg.input_size if mcfg else (240, 320)
        eng, eng_sem = make_eval_engines(hw, mcfg, params=load_checkpoint(args.ckpt, mcfg),
                                         device=device)
        out = {
            "checkpoint": args.ckpt,
            "procedural_held_out": evaluate_engines(eng, eng_sem, n_scenes=args.scenes,
                                                    seed=args.seed, hw=hw),
            "sim_cross_domain": evaluate_engines(
                eng, eng_sem, hw=hw, scenes=sim_eval_scenes(hw, args.scenes, seed=args.seed)),
        }
        if fixture_images_present():
            out["real_fixtures"] = evaluate_engines(
                eng, eng_sem, hw=hw, scenes=disk_eval_scenes(str(REAL_FIXTURES), hw, 2))
        print(json.dumps(out))
        return 0
    if args.data or args.sim or args.hard:
        from tod_tpu_torch.core.weights import load_checkpoint

        hw = mcfg.input_size if mcfg else (240, 320)
        eng, eng_sem = make_eval_engines(hw, mcfg, params=load_checkpoint(args.ckpt, mcfg),
                                         device=device)
        if args.data:
            scenes = disk_eval_scenes(args.data, hw, args.scenes)
        elif args.hard:
            scenes = hard_eval_scenes(hw, args.scenes, seed=args.seed)
        else:
            scenes = sim_eval_scenes(hw, args.scenes, seed=args.seed)
        out = evaluate_engines(eng, eng_sem, hw=hw, scenes=scenes)
        out["checkpoint"] = args.ckpt
        out["data"] = args.data if args.data else ("hard" if args.hard else "sim")
    else:
        out = evaluate(args.ckpt, n_scenes=args.scenes, seed=args.seed,
                       hw=hw_cli or (240, 320), mcfg=mcfg, device=device)
    out["mode"] = "static-int8" if args.int8 else "float"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
