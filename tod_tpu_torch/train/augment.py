"""Training-time data augmentation (counterpart of the JAX package's
``train/augment.py``).

``Augmented(source)`` has the same ``next_batch()`` surface as
``SyntheticDetectionData`` / ``DiskDetectionData`` and applies
label-consistent transforms per sample on the host (numpy, before staging):

- horizontal flip (p=0.5): image, instance masks and the semantic target
  mirror on the W axis; boxes remap ``[y1, x1, y2, x2] -> [y1, 1-x2, y2,
  1-x1]`` (normalized coordinates);
- photometric jitter: brightness (multiplicative) and contrast (about the
  per-image mean), both label-free.

Seeded independently of the wrapped source, so the same scene stream can be
replayed with different augmentation draws.

The device-side counterpart (``TrainConfig.device_augment``) is split in
two: :func:`draw_augment` draws a step's flips, white balance, brightness,
gamma, noise level and noise from a ``torch.Generator`` on the device
(:func:`step_generator`: seeded from ``TrainConfig.seed + 0x5EED`` and the
step, so the chunked loop replays the per-step draws), and
:func:`apply_augment` is the pure transform of the JAX ``device_augment``
given those draws.
"""

from __future__ import annotations

import numpy as np
import torch

AUGMENT_SEED = 0x5EED


class Augmented:
    def __init__(
        self,
        data,
        seed: int = 0,
        hflip: bool = True,
        brightness: float = 0.15,
        contrast: float = 0.15,
    ):
        self.data = data
        self.rng = np.random.default_rng(seed)
        self.hflip = hflip
        self.brightness = brightness
        self.contrast = contrast

    def next_batch(self) -> dict:
        b = {k: np.array(v, copy=True) for k, v in self.data.next_batch().items()}
        n = b["image"].shape[0]
        for i in range(n):
            if self.hflip and self.rng.random() < 0.5:
                self._flip(b, i)
            img = b["image"][i].astype(np.float32)
            if self.brightness:
                img = img * (1.0 + self.rng.uniform(-self.brightness, self.brightness))
            if self.contrast:
                m = img.mean()
                img = (img - m) * (
                    1.0 + self.rng.uniform(-self.contrast, self.contrast)
                ) + m
            b["image"][i] = np.clip(img, 0, 255).astype(b["image"].dtype)
        return b

    @staticmethod
    def _flip(b: dict, i: int) -> None:
        b["image"][i] = b["image"][i][:, ::-1]
        b["gt_masks"][i] = b["gt_masks"][i][:, :, ::-1]
        b["sem_target"][i] = b["sem_target"][i][:, ::-1]
        boxes = b["gt_boxes"][i]
        flipped = boxes.copy()
        flipped[:, 1] = 1.0 - boxes[:, 3]
        flipped[:, 3] = 1.0 - boxes[:, 1]
        # keep padded (invalid) rows at zero so masks/validity stay aligned
        flipped[~b["gt_valid"][i]] = 0.0
        b["gt_boxes"][i] = flipped



def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s draws: seeded from ``seed +
    0x5EED`` and the step, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed + AUGMENT_SEED) << 32) + step)
    return gen


def draw_augment(generator: torch.Generator, batch_size: int, hw: tuple[int, int],
                 noise_max: float = 7.0) -> dict[str, torch.Tensor]:
    """One step's draws, on the generator's device, with the JAX
    ``device_augment``'s distributions: ``flip`` (B,) bool (p = 0.5), ``wb``
    (B, 1, 1, 3) in [0.9, 1.1), ``bright`` and ``gamma`` (B, 1, 1, 1) in
    [0.8, 1.25), ``sigma`` (B, 1, 1, 1) in [0, noise_max), ``noise``
    (B, H, W, 3) standard normal."""
    dev = generator.device
    b = batch_size

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    return {
        "flip": torch.rand((b,), generator=generator, device=dev) < 0.5,
        "wb": uniform((b, 1, 1, 3), 0.9, 1.1),
        "bright": uniform((b, 1, 1, 1), 0.8, 1.25),
        "gamma": uniform((b, 1, 1, 1), 0.8, 1.25),
        "sigma": uniform((b, 1, 1, 1), 0.0, noise_max),
        "noise": torch.randn((b, *hw, 3), generator=generator, device=dev),
    }


def apply_augment(batch: dict, draws: dict) -> dict:
    """The JAX ``device_augment`` given its draws: per sample a horizontal
    flip (image, masks and semantic target mirror on W; valid boxes remap
    ``x -> 1 - x``, padded rows stay zero), then white balance x brightness,
    clipped, gamma, gaussian noise, clipped.  Returns a new batch whose
    ``image`` is float32 in [0, 255].  The power is taken in float64 and
    rounded once: the correctly rounded float32 power."""
    flip = draws["flip"]
    img = batch["image"].float()  # (B, H, W, 3)
    img = torch.where(flip[:, None, None, None], img.flip(2), img)
    masks = batch["gt_masks"]
    masks = torch.where(flip[:, None, None, None], masks.flip(3), masks)
    sem = batch["sem_target"]
    sem = torch.where(flip[:, None, None], sem.flip(2), sem)
    boxes = batch["gt_boxes"]
    fb = torch.stack([boxes[..., 0], 1.0 - boxes[..., 3], boxes[..., 2], 1.0 - boxes[..., 1]],
                     dim=-1)
    fb = torch.where(batch["gt_valid"][..., None], fb, torch.zeros((), device=fb.device))
    boxes = torch.where(flip[:, None, None], fb, boxes)

    x = torch.clamp(img * draws["wb"] * draws["bright"], 0.0, 255.0)
    x = 255.0 * torch.pow((x * (1.0 / 255.0)).double(), draws["gamma"].double()).float()
    x = x + draws["sigma"] * draws["noise"]
    x = torch.clamp(x, 0.0, 255.0)
    return {**batch, "image": x, "gt_boxes": boxes, "gt_masks": masks, "sem_target": sem}
