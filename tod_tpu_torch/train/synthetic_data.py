"""Synthetic FRC-scene detection dataset (the port's copy of the JAX
package's ``train/synthetic_data.py``, numpy for numpy: the same seed gives
the same batch bit for bit).

Floor-gradient scenes with yellow balls (class 3) and red/blue robot boxes
(classes 1/2), with exact instance masks, boxes and a semantic map: enough
to train the full YOLACT loss stack.  Pure numpy on the host; the trainer
copies each batch to its device.
"""

from __future__ import annotations

import numpy as np

MAX_OBJECTS = 6
BALL = 3
RED_ROBOT = 1
BLUE_ROBOT = 2


class SyntheticDetectionData:
    def __init__(
        self,
        input_hw: tuple[int, int],
        batch_size: int = 8,
        seed: int = 0,
        proto_downsample: int = 4,
        sem_downsample: int = 8,
    ):
        self.h, self.w = input_hw
        self.batch = batch_size
        self.rng = np.random.default_rng(seed)
        self.proto_ds = proto_downsample
        self.sem_ds = sem_downsample

    def _scene(self):
        h, w = self.h, self.w
        rng = self.rng
        img = np.zeros((h, w, 3), np.float32)
        ramp = np.linspace(0, 1, h, dtype=np.float32)[:, None]
        img[..., 0] = 30 + 40 * ramp
        img[..., 1] = 60 + 80 * ramp
        img[..., 2] = 20 + 30 * ramp
        img += rng.normal(0, 6, img.shape).astype(np.float32)

        inst_mask = np.zeros((MAX_OBJECTS, h, w), np.float32)
        boxes = np.zeros((MAX_OBJECTS, 4), np.float32)
        classes = np.zeros((MAX_OBJECTS,), np.int32)
        valid = np.zeros((MAX_OBJECTS,), bool)
        sem = np.zeros((h, w), np.int32)

        yy, xx = np.mgrid[0:h, 0:w]
        n_obj = rng.integers(1, MAX_OBJECTS + 1)
        k = 0
        for _ in range(n_obj):
            kind = rng.choice([BALL, BALL, RED_ROBOT, BLUE_ROBOT])  # balls 2× likely
            cy = rng.uniform(0.15, 0.9) * h
            cx = rng.uniform(0.1, 0.9) * w
            if kind == BALL:
                r = rng.uniform(0.04, 0.1) * min(h, w)
                m = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r
                color = np.array([235, 215, 40], np.float32)
                y1, x1, y2, x2 = cy - r, cx - r, cy + r, cx + r
            else:
                hh = rng.uniform(0.06, 0.14) * h
                hw2 = rng.uniform(0.05, 0.12) * w
                m = (np.abs(yy - cy) <= hh) & (np.abs(xx - cx) <= hw2)
                color = (
                    np.array([220, 45, 45], np.float32)
                    if kind == RED_ROBOT
                    else np.array([45, 65, 225], np.float32)
                )
                y1, x1, y2, x2 = cy - hh, cx - hw2, cy + hh, cx + hw2
            if not m.any():
                continue
            img[m] = color + rng.normal(0, 5, 3).astype(np.float32)
            inst_mask[k] = m.astype(np.float32)
            boxes[k] = [
                max(y1, 0) / h, max(x1, 0) / w, min(y2, h) / h, min(x2, w) / w,
            ]
            classes[k] = kind
            valid[k] = True
            sem[m] = kind
            k += 1
            if k >= MAX_OBJECTS:
                break

        img = np.clip(img, 0, 255).astype(np.uint8)
        return img, boxes, classes, valid, inst_mask, sem

    def _downsample_mask(self, m, ds):
        h2, w2 = self.h // ds, self.w // ds
        return m.reshape(m.shape[0], h2, ds, w2, ds).max(axis=(2, 4))

    def _downsample_sem(self, sem, ds):
        h2, w2 = self.h // ds, self.w // ds
        # majority-ish: take the max class in each cell (objects beat floor)
        return sem.reshape(h2, ds, w2, ds).max(axis=(1, 3))

    def next_batch(self) -> dict:
        imgs, boxes, classes, valids, masks, sems = [], [], [], [], [], []
        for _ in range(self.batch):
            img, b, c, v, m, s = self._scene()
            imgs.append(img)
            boxes.append(b)
            classes.append(c)
            valids.append(v)
            masks.append(self._downsample_mask(m, self.proto_ds))
            sems.append(self._downsample_sem(s, self.sem_ds))
        return {
            "image": np.stack(imgs),
            "gt_boxes": np.stack(boxes),
            "gt_classes": np.stack(classes),
            "gt_valid": np.stack(valids),
            "gt_masks": np.stack(masks).astype(np.float32),
            "sem_target": np.stack(sems).astype(np.int32),
        }
