"""K1: fused prototype-coefficient mask assembly with the box crop.

Counterpart of the JAX package's ``kernels/mask_assembly.py`` (``assemble_crop_masks``).
On a CUDA tensor the wrapper launches ``csrc/mask_assembly.cu``; on a CPU
tensor it runs the plain version, ``crop_masks(assemble_masks(...))``.
While ``torch.export`` traces it, it calls the custom op
``tod::assemble_crop_masks`` (the same launch and plain version), which an
exported graph keeps.  ``mask_tiling`` chooses the kernel's pixel tile and
detection groups from the shapes and the SM count.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tod_tpu_torch.core.device import sm_count
from tod_tpu_torch.kernels import _build
from tod_tpu_torch.kernels._build import SMEM_LIMIT
from tod_tpu_torch.ops.masks import assemble_masks, crop_masks

SOURCE = "mask_assembly"
SIGNATURES = {
    "tod_mask_assembly": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p], ctypes.c_int),
}
MAX_K = 32  # a thread holds its pixel's K prototype values in registers
DETS = 4  # detections a thread forms at once, csrc/mask_assembly.cu's kDets
MAX_THREADS = 512  # the kernel's __launch_bounds__
MAX_PIXELS = 256  # the largest pixel tile mask_tiling takes


def plain_assemble_crop_masks(prototypes, coeffs, boxes) -> torch.Tensor:
    """The plain torch version of the kernel (same shapes and layout)."""
    return crop_masks(assemble_masks(prototypes.float(), coeffs.float()), boxes.float())


def smem_bytes(pixels: int, n: int, k: int) -> int:
    """A block's shared memory: its barrier, then the pixel tile's and the
    detections' rows of K padded to whole float4s, then the boxes."""
    kp = 4 * -(-k // 4)
    return 16 + 4 * (kp * (pixels + n) + 4 * n)


class MaskTiling(NamedTuple):
    """How ``csrc/mask_assembly.cu`` cuts the work: ``blocks`` blocks of
    ``pixels`` consecutive pixels of one image (a multiple of 32, one warp a
    32-pixel slice) and every detection, the detections dealt round-robin to
    ``groups`` warps a slice; ``threads`` = pixels x groups."""

    pixels: int
    groups: int
    threads: int
    blocks: int
    smem_bytes: int


@functools.lru_cache(maxsize=64)
def mask_tiling(b: int, hw: int, n: int, k: int, sms: int) -> MaskTiling:
    """The tiling of ``b`` images of ``hw`` pixels, ``n`` detections and
    ``k`` prototypes for a card with ``sms`` SMs.

    The pixel tile is the largest multiple of 32 (at most ``MAX_PIXELS``)
    that still gives every SM a block and fits ``SMEM_LIMIT``; the detection
    groups give each thread at most ``DETS`` detections, within
    ``MAX_THREADS`` threads a block.  Raises if ``k`` exceeds ``MAX_K`` or
    even a 32-pixel tile's shared memory exceeds ``SMEM_LIMIT``.
    """
    if min(b, hw, n, sms) < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"mask_tiling needs b, hw, n, sms >= 1 and 1 <= K <= MAX_K = {MAX_K}, "
                         f"got {(b, hw, n, k, sms)}")
    pixels = 32
    while (pixels + 32 <= MAX_PIXELS and b * -(-hw // (pixels + 32)) >= sms
           and smem_bytes(pixels + 32, n, k) <= SMEM_LIMIT):
        pixels += 32
    groups = max(1, min(-(-n // DETS), MAX_THREADS // pixels))
    t = MaskTiling(pixels, groups, pixels * groups, b * -(-hw // pixels), smem_bytes(pixels, n, k))
    if t.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"N={n}, K={k} need {t.smem_bytes} bytes of shared memory a block "
                         f"(limit {SMEM_LIMIT})")
    return t


def assemble_crop_masks(prototypes: torch.Tensor, coeffs: torch.Tensor,
                        boxes: torch.Tensor) -> torch.Tensor:
    """prototypes (B, Hm, Wm, K), coeffs (B, N, K), boxes (B, N, 4) y1x1y2x2,
    all contiguous float32 with K <= ``MAX_K`` -> masks (B, N, Hm, Wm) f32.
    ``masks = sigmoid(coeffs . protos)`` inside each box (pixel centres,
    inclusive), 0 outside."""
    if prototypes.dim() != 4 or coeffs.dim() != 3 or boxes.dim() != 3:
        raise ValueError("expected batched prototypes (B,Hm,Wm,K), coeffs (B,N,K), boxes (B,N,4)")
    b, hm, wm, k = prototypes.shape
    if coeffs.shape[0] != b or coeffs.shape[2] != k or boxes.shape != (b, coeffs.shape[1], 4):
        raise ValueError(
            f"shape mismatch: prototypes {tuple(prototypes.shape)}, "
            f"coeffs {tuple(coeffs.shape)}, boxes {tuple(boxes.shape)}"
        )
    for name, t in (("prototypes", prototypes), ("coeffs", coeffs), ("boxes", boxes)):
        if t.device != prototypes.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {prototypes.device}")
    if k > MAX_K:
        raise ValueError(f"K={k} prototypes: the kernel takes at most MAX_K = {MAX_K}")
    if torch.compiler.is_exporting():
        return _op(prototypes, coeffs, boxes)
    if prototypes.device.type == "cpu":
        return plain_assemble_crop_masks(prototypes, coeffs, boxes)
    if prototypes.device.type != "cuda":
        raise ValueError(f"unsupported device {prototypes.device}")
    return _launch(prototypes, coeffs, boxes)


def _launch(prototypes: torch.Tensor, coeffs: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    b, hm, wm, k = prototypes.shape
    n = coeffs.shape[1]
    out = torch.empty((b, n, hm, wm), dtype=torch.float32, device=prototypes.device)
    if out.numel() == 0:
        return out
    t = mask_tiling(b, hm * wm, n, k, sm_count(prototypes.device))
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(prototypes.device):
        err = lib.tod_mask_assembly(
            prototypes.data_ptr(), coeffs.data_ptr(), boxes.data_ptr(), out.data_ptr(),
            b, n, hm, wm, k, t.pixels, t.groups, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "mask_assembly launch")
    assemble_crop_masks.launches += 1
    return out


assemble_crop_masks.launches = 0


@torch.library.custom_op("tod::assemble_crop_masks", mutates_args=(), device_types="cpu")
def _op(prototypes: torch.Tensor, coeffs: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    return plain_assemble_crop_masks(prototypes, coeffs, boxes)


_op.register_kernel("cuda")(_launch)


@_op.register_fake
def _(prototypes, coeffs, boxes):
    b, hm, wm, _ = prototypes.shape
    return prototypes.new_empty((b, coeffs.shape[1], hm, wm))
