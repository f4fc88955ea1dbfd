"""The wire-parity classify API (counterpart of the JAX package's
``runtime/classify.py``): a packed u32 frame (``r<<24 | g<<16 | b<<8``) in,
packed ``cls<<24 | id<<16`` words out, the reference's ``classify``.

Two modes:

- full frame (default): one forward at the model's input size, the semantic
  argmax upsampled 8x and then to the frame, and the ball ids from the
  connected components of the frame-size ball mask;
- ``tile_parity=True``: the reference's pipeline, a resize to 224x448 cut
  into two 224x224 tiles that run as one batch of two, the ids per tile on
  the 28x28 grid, then the tiles stitched and upscaled to the frame.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from tod_tpu_torch.core.config import PipelineConfig
from tod_tpu_torch.core.device import resolve_device
from tod_tpu_torch.core.weights import check_state
from tod_tpu_torch.models.yolact import Yolact
from tod_tpu_torch.ops.cc_labels import connected_components
from tod_tpu_torch.ops.packing import pack_class_id, unpack_rgb_u32
from tod_tpu_torch.ops.postprocess import semantic_argmax, upsample_nearest
from tod_tpu_torch.ops.preprocess import (
    normalize,
    preprocess_frame,
    stitch_tiles,
    tile_448x224,
    upscale_to_frame,
)


def seeded_state(model: Yolact, seed: int) -> dict[str, torch.Tensor]:
    """A random state for ``model`` from a ``torch.Generator``: He-normal
    conv weights, zero biases.  Not the JAX package's init values (its
    random numbers differ); the tests pass carried-across JAX params."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, t in model.state_dict().items():
        if name.endswith(".weight"):
            fan_in = math.prod(t.shape[1:])
            state[name] = torch.randn(t.shape, generator=gen) * math.sqrt(2.0 / fan_in)
        else:
            state[name] = torch.zeros(t.shape)
    return state


class Classifier:
    """``params`` is the port's state dict (``seeded_state`` of ``seed``
    when None); ``device`` defaults to ``cuda``."""

    def __init__(self, cfg: PipelineConfig | None = None,
                 params: Mapping[str, torch.Tensor] | None = None, tile_parity: bool = False,
                 seed: int = 0, device=None):
        self.cfg = cfg or PipelineConfig()
        self.tile_parity = tile_parity
        mcfg = self.cfg.model
        if tile_parity and mcfg.input_size != (224, 224):
            mcfg = dataclasses.replace(mcfg, input_size=(224, 224))
        self.mcfg = mcfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, mcfg.dtype)
        self.model = Yolact(mcfg)
        state = seeded_state(self.model, seed) if params is None else params
        check_state(self.model, state)
        self.model.load_state_dict(state)
        self.model.to(device=self.device, dtype=self.dtype).eval()
        self.cam_hw = (self.cfg.camera.height, self.cfg.camera.width)

    def _ids(self, cls: torch.Tensor) -> torch.Tensor:
        return connected_components(cls == 3, max_labels=self.cfg.geometry.max_balls)

    @torch.inference_mode()
    def _classify(self, words: torch.Tensor) -> torch.Tensor:
        """(H, W) uint32 packed frame on the device -> (H, W) uint32 words."""
        rgb = unpack_rgb_u32(words)
        meaningful = self.mcfg.meaningful_classes
        if self.tile_parity:
            out = self.model(normalize(tile_448x224(rgb), self.dtype))
            cls = semantic_argmax(out.sem_logits, meaningful)  # (2, 28, 28)
            ids = torch.stack([self._ids(cls[0]), self._ids(cls[1])])
            cls_full = upscale_to_frame(stitch_tiles(upsample_nearest(cls, 8)), self.cam_hw)
            ids_full = upscale_to_frame(stitch_tiles(upsample_nearest(ids, 8)), self.cam_hw)
            return pack_class_id(cls_full, ids_full)
        out = self.model(preprocess_frame(rgb, self.mcfg.input_size, self.dtype))
        cls_small = semantic_argmax(out.sem_logits[0], meaningful)
        cls_full = upscale_to_frame(upsample_nearest(cls_small, 8), self.cam_hw)
        return pack_class_id(cls_full, self._ids(cls_full))

    def classify(self, frame_words: np.ndarray) -> np.ndarray:
        """(H, W) or flat (H*W,) uint32 packed frame -> packed class/id words
        of the same shape (the reference overwrites its buffer; this
        returns a new one)."""
        h, w = self.cam_hw
        shape = np.asarray(frame_words).shape
        words = torch.from_numpy(np.array(frame_words, np.uint32).reshape(h, w))
        out = self._classify(words.to(self.device))
        return out.cpu().numpy().reshape(shape)
