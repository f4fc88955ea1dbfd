"""On-disk detection dataset: train on collected, annotated frames (the
port's copy of the JAX package's ``train/dataset.py``, reading and writing
images through the port's own ``utils/image_io.py``).

A directory of annotated frames becomes the batch contract
``SyntheticDetectionData`` feeds the trainer::

    image      (B, H, W, 3) uint8
    gt_boxes   (B, M, 4)  float32, normalized [y1, x1, y2, x2]
    gt_classes (B, M)     int32
    gt_valid   (B, M)     bool
    gt_masks   (B, M, H/proto_ds, W/proto_ds) float32 in {0, 1}
    sem_target (B, H/sem_ds, W/sem_ds) int32

Dataset layout (one directory)::

    root/
      annotations.json      {"images": [{"file": "imgs/0000.png",
                                         "objects": [{"bbox": [y1,x1,y2,x2],
                                                      "class": 3,
                                                      "mask": "masks/0000_0.png"}]}]}
      imgs/..., masks/...   referenced paths, relative to root

``bbox`` is in pixels of the stored image; ``mask`` (optional) is a binary
instance-mask image the size of the stored image; without one the box
interior is the mask.  Images are nearest-resized to the training
``input_hw``.  ``export_dataset`` writes the procedural generator's scenes
in this layout.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from tod_tpu_torch.train.synthetic_data import MAX_OBJECTS


def _nearest_resize(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """(H, W, ...) → (h, w, ...) nearest-neighbor (pure numpy)."""
    h, w = hw
    ys = (np.arange(h) * img.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * img.shape[1] / w).astype(np.int64)
    return img[ys][:, xs]


class DiskDetectionData:
    """Batches from an annotated image directory (layout in module doc).

    Same constructor surface as ``SyntheticDetectionData`` plus ``root``;
    epochs reshuffle with the seeded rng (``shuffle=False`` keeps
    annotation order, which makes runs byte-reproducible)."""

    def __init__(
        self,
        root: str | pathlib.Path,
        input_hw: tuple[int, int],
        batch_size: int = 8,
        seed: int = 0,
        proto_downsample: int = 4,
        sem_downsample: int = 8,
        shuffle: bool = True,
    ):
        self.root = pathlib.Path(root)
        self.h, self.w = input_hw
        self.batch = batch_size
        self.proto_ds = proto_downsample
        self.sem_ds = sem_downsample
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        spec = json.loads((self.root / "annotations.json").read_text())
        self.images = spec["images"]
        if not self.images:
            raise ValueError(f"{self.root}/annotations.json lists no images")
        self._order: list[int] = []

    def __len__(self) -> int:
        return len(self.images)

    def _next_index(self) -> int:
        if not self._order:
            idx = np.arange(len(self.images))
            if self.shuffle:
                self.rng.shuffle(idx)
            self._order = idx[::-1].tolist()  # pop() → annotation order
        return self._order.pop()

    def _load_example(self, rec: dict):
        from tod_tpu_torch.utils.image_io import load_image

        raw = load_image(self.root / rec["file"])
        ih, iw = raw.shape[:2]
        img = _nearest_resize(raw, (self.h, self.w))

        boxes = np.zeros((MAX_OBJECTS, 4), np.float32)
        classes = np.zeros((MAX_OBJECTS,), np.int32)
        valid = np.zeros((MAX_OBJECTS,), bool)
        inst = np.zeros((MAX_OBJECTS, self.h, self.w), np.float32)
        sem = np.zeros((self.h, self.w), np.int32)

        for k, obj in enumerate(rec.get("objects", [])[:MAX_OBJECTS]):
            y1, x1, y2, x2 = (float(v) for v in obj["bbox"])
            boxes[k] = [
                max(y1, 0) / ih, max(x1, 0) / iw, min(y2, ih) / ih, min(x2, iw) / iw,
            ]
            classes[k] = int(obj["class"])
            valid[k] = True
            if obj.get("mask"):
                m = load_image(self.root / obj["mask"])[..., 0] > 127
                m = _nearest_resize(m.astype(np.float32), (self.h, self.w))
            else:  # box-supervised fallback: mask = box interior
                m = np.zeros((self.h, self.w), np.float32)
                yy1 = int(round(boxes[k, 0] * self.h))
                xx1 = int(round(boxes[k, 1] * self.w))
                yy2 = max(int(round(boxes[k, 2] * self.h)), yy1 + 1)
                xx2 = max(int(round(boxes[k, 3] * self.w)), xx1 + 1)
                m[yy1:yy2, xx1:xx2] = 1.0
            inst[k] = m
            sem[m > 0.5] = classes[k]
        return img, boxes, classes, valid, inst, sem

    # same cell reductions as the synthetic generator (objects beat floor)
    def _down_mask(self, m):
        ds = self.proto_ds
        h2, w2 = self.h // ds, self.w // ds
        return m.reshape(m.shape[0], h2, ds, w2, ds).max(axis=(2, 4))

    def _down_sem(self, sem):
        ds = self.sem_ds
        h2, w2 = self.h // ds, self.w // ds
        return sem.reshape(h2, ds, w2, ds).max(axis=(1, 3))

    def next_batch(self) -> dict:
        imgs, boxes, classes, valids, masks, sems = [], [], [], [], [], []
        for _ in range(self.batch):
            rec = self.images[self._next_index()]
            img, b, c, v, m, s = self._load_example(rec)
            imgs.append(img)
            boxes.append(b)
            classes.append(c)
            valids.append(v)
            masks.append(self._down_mask(m))
            sems.append(self._down_sem(s))
        return {
            "image": np.stack(imgs),
            "gt_boxes": np.stack(boxes),
            "gt_classes": np.stack(classes),
            "gt_valid": np.stack(valids),
            "gt_masks": np.stack(masks).astype(np.float32),
            "sem_target": np.stack(sems).astype(np.int32),
        }


def export_dataset(data, root: str | pathlib.Path, n_scenes: int) -> pathlib.Path:
    """Write ``n_scenes`` scenes from a ``SyntheticDetectionData`` generator
    in the on-disk layout (full-resolution instance masks included) — a
    working template for real annotated data and the round-trip fixture for
    tests."""
    from tod_tpu_torch.utils.image_io import save_rgb

    root = pathlib.Path(root)
    (root / "imgs").mkdir(parents=True, exist_ok=True)
    (root / "masks").mkdir(parents=True, exist_ok=True)
    records = []
    h, w = data.h, data.w
    for i in range(n_scenes):
        img, boxes, classes, valid, inst, _sem = data._scene()
        fname = f"imgs/{i:04d}.png"
        save_rgb(root / fname, img)
        objects = []
        for k in range(len(valid)):
            if not valid[k]:
                continue
            mname = f"masks/{i:04d}_{k}.png"
            save_rgb(root / mname, np.repeat(
                (inst[k] > 0.5).astype(np.uint8)[..., None] * 255, 3, axis=-1
            ))
            y1, x1, y2, x2 = (float(v) for v in boxes[k])
            objects.append({
                "bbox": [y1 * h, x1 * w, y2 * h, x2 * w],
                "class": int(classes[k]),
                "mask": mname,
            })
        records.append({"file": fname, "objects": objects})
    (root / "annotations.json").write_text(json.dumps({"images": records}))
    return root
