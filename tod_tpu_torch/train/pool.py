"""Scene pool: pre-generated training scenes served at device rate (the
port's copy of the JAX package's ``train/pool.py``).

The domain-randomized generator costs ~20 ms of host time a scene.
``ScenePool`` generates ``n_scenes`` unique scenes once (optionally kept in
an ``.npz`` cache so reruns and resumes skip the regeneration); then
``next_batch()`` is seeded index sampling, microseconds of host time.
Per-step variety (flip, photometric jitter, sensor noise) is the device's
job: ``TrainConfig.device_augment`` applies it inside the train step
(``train/augment.py``).  Storage is compact (u8 images, u8 downsampled
masks).
"""

from __future__ import annotations

import pathlib
import time

import numpy as np


class ScenePool:
    """Pre-generates scenes from any ``next_batch``-contract source and
    serves batches by seeded random index sampling (with replacement —
    every batch is an iid draw from the pool distribution).

    ``cache``: optional ``.npz`` path; loaded when present (shape/meta
    checked), written after generation otherwise.  The cache is keyed by
    the caller's choice of path — a pool built from a different generator
    config belongs in a different file.
    """

    def __init__(
        self,
        data,
        n_scenes: int,
        seed: int = 0,
        cache: str | pathlib.Path | None = None,
        log_every_s: float = 30.0,
        log_fn=print,
    ):
        self.batch = data.batch
        self.rng = np.random.default_rng(seed)
        cache = pathlib.Path(cache) if cache else None
        if cache is not None and cache.exists():
            z = np.load(cache)
            if int(z["n"]) != n_scenes:
                raise ValueError(
                    f"pool cache {cache} holds {int(z['n'])} scenes, "
                    f"wanted {n_scenes} — delete it or change --pool"
                )
            self._store = {k: z[k] for k in _KEYS}
            return
        self._store = self._generate(data, n_scenes, log_every_s, log_fn)
        if cache is not None:
            cache.parent.mkdir(parents=True, exist_ok=True)
            tmp = cache.with_suffix(".tmp.npz")
            np.savez(tmp, n=n_scenes, **self._store)
            tmp.replace(cache)

    @staticmethod
    def _generate(data, n_scenes: int, log_every_s: float, log_fn) -> dict:
        store: dict[str, list] = {k: [] for k in _KEYS}
        t0 = last = time.perf_counter()
        done = 0
        while done < n_scenes:
            b = data.next_batch()
            take = min(data.batch, n_scenes - done)
            store["image"].append(b["image"][:take])
            store["gt_boxes"].append(b["gt_boxes"][:take])
            store["gt_classes"].append(b["gt_classes"][:take].astype(np.int8))
            store["gt_valid"].append(b["gt_valid"][:take])
            store["gt_masks"].append((b["gt_masks"][:take] > 0.5).astype(np.uint8))
            store["sem_target"].append(b["sem_target"][:take].astype(np.uint8))
            done += take
            now = time.perf_counter()
            if now - last > log_every_s:
                rate = done / (now - t0)
                log_fn(
                    f"pool: {done}/{n_scenes} scenes "
                    f"({rate:.0f}/s, ~{(n_scenes - done) / rate:.0f}s left)"
                )
                last = now
        return {k: np.concatenate(v) for k, v in store.items()}

    def __len__(self) -> int:
        return self._store["image"].shape[0]

    def next_batch(self) -> dict:
        idx = self.rng.integers(0, len(self), size=self.batch)
        s = self._store
        return {
            "image": s["image"][idx],
            "gt_boxes": s["gt_boxes"][idx],
            "gt_classes": s["gt_classes"][idx].astype(np.int32),
            "gt_valid": s["gt_valid"][idx],
            "gt_masks": s["gt_masks"][idx].astype(np.float32),
            "sem_target": s["sem_target"][idx].astype(np.int32),
        }


_KEYS = ("image", "gt_boxes", "gt_classes", "gt_valid", "gt_masks", "sem_target")
