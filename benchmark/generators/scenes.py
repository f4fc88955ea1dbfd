"""Synthetic FRC training scenes: floor-gradient images with yellow balls
(class 3) and red and blue robot boxes (classes 1, 2), their exact instance
masks, boxes and semantic map, from a seed (after the program's synthetic
detection data: the same seed gives the same batches).

Each shape's pixels are tested inside its bounding box only, widened to
the mask grid's cells, and its instance mask is pooled to the prototypes'
resolution right there: no full-size mask is made."""

from __future__ import annotations

import numpy as np

MAX_OBJECTS = 6
BALL, RED_ROBOT, BLUE_ROBOT = 3, 1, 2
COLORS = {BALL: (235, 215, 40), RED_ROBOT: (220, 45, 45), BLUE_ROBOT: (45, 65, 225)}


class Scenes:
    def __init__(self, input_hw, batch_size: int, seed: int, proto_downsample: int = 4,
                 sem_downsample: int = 8):
        self.h, self.w = input_hw
        self.batch = batch_size
        self.rng = np.random.default_rng(seed)
        self.proto_ds, self.sem_ds = proto_downsample, sem_downsample
        ramp = np.linspace(0, 1, self.h, dtype=np.float32)[:, None, None]
        self.floor = np.array([30, 60, 20], np.float32) + np.array([40, 80, 30], np.float32) * ramp

    def _scene(self, i: int, out: dict) -> None:
        """Scene ``i`` of ``out``'s arrays, drawn in place."""
        h, w, rng, d = self.h, self.w, self.rng, self.proto_ds
        img = self.floor + 6 * rng.standard_normal((h, w, 3), dtype=np.float32)
        sem = np.zeros((h, w), np.int32)
        n_obj = rng.integers(1, MAX_OBJECTS + 1)
        k = 0
        for _ in range(n_obj):
            kind = rng.choice([BALL, BALL, RED_ROBOT, BLUE_ROBOT])  # balls 2x likely
            cy = rng.uniform(0.15, 0.9) * h
            cx = rng.uniform(0.1, 0.9) * w
            if kind == BALL:
                r = rng.uniform(0.04, 0.1) * min(h, w)
                y1, x1, y2, x2 = cy - r, cx - r, cy + r, cx + r
            else:
                hh = rng.uniform(0.06, 0.14) * h
                hw2 = rng.uniform(0.05, 0.12) * w
                y1, x1, y2, x2 = cy - hh, cx - hw2, cy + hh, cx + hw2
            # the box's pixels, widened to whole cells of the mask grid
            r0, r1 = max(int(np.floor(y1)), 0) // d * d, -(-min(int(np.ceil(y2)) + 1, h) // d) * d
            c0, c1 = max(int(np.floor(x1)), 0) // d * d, -(-min(int(np.ceil(x2)) + 1, w) // d) * d
            if r0 >= r1 or c0 >= c1:
                continue
            yy = np.arange(r0, r1, dtype=np.float64)[:, None]
            xx = np.arange(c0, c1, dtype=np.float64)[None, :]
            m = (((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r if kind == BALL
                 else (np.abs(yy - cy) <= hh) & (np.abs(xx - cx) <= hw2))
            if not m.any():
                continue
            img[r0:r1, c0:c1][m] = np.array(COLORS[kind], np.float32) + rng.normal(0, 5, 3).astype(
                np.float32)
            sem[r0:r1, c0:c1][m] = kind
            out["gt_masks"][i, k, r0 // d:r1 // d, c0 // d:c1 // d] = _pool_max(m[None], d)[0]
            out["gt_boxes"][i, k] = [max(y1, 0) / h, max(x1, 0) / w, min(y2, h) / h, min(x2, w) / w]
            out["gt_classes"][i, k] = kind
            out["gt_valid"][i, k] = True
            k += 1
            if k >= MAX_OBJECTS:
                break
        np.clip(img, 0, 255, out=img)
        out["image"][i] = img
        out["sem_target"][i] = _pool_max(sem[None], self.sem_ds)[0]

    def batches(self, n: int) -> list[dict]:
        """``n`` batches of ``batch_size`` scenes, each a dict of numpy arrays
        (``image`` uint8 (B, H, W, 3), ``gt_boxes``, ``gt_classes``,
        ``gt_valid``, ``gt_masks`` at H/4 x W/4, ``sem_target`` at H/8 x W/8)."""
        b, h, w, d, s = self.batch, self.h, self.w, self.proto_ds, self.sem_ds
        out = []
        for _ in range(n):
            arrays = {"image": np.empty((b, h, w, 3), np.uint8),
                      "gt_boxes": np.zeros((b, MAX_OBJECTS, 4), np.float32),
                      "gt_classes": np.zeros((b, MAX_OBJECTS), np.int32),
                      "gt_valid": np.zeros((b, MAX_OBJECTS), bool),
                      "gt_masks": np.zeros((b, MAX_OBJECTS, h // d, w // d), np.float32),
                      "sem_target": np.empty((b, h // s, w // s), np.int32)}
            for i in range(b):
                self._scene(i, arrays)
            out.append(arrays)
        return out


def _pool_max(x: np.ndarray, d: int) -> np.ndarray:
    """(M, H, W) -> (M, H/d, W/d), the max of each d x d cell."""
    m, h, w = x.shape
    return x.reshape(m, h, w // d, d).max(axis=3).reshape(m, h // d, d, w // d).max(axis=2)
