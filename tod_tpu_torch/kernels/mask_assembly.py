"""K1: fused prototype-coefficient mask assembly with the box crop.

Counterpart of the JAX package's ``kernels/mask_assembly.py`` (``assemble_crop_masks``).
On a CUDA tensor the wrapper launches ``csrc/mask_assembly.cu``; on a CPU
tensor it runs the plain version, ``crop_masks(assemble_masks(...))``.
"""

from __future__ import annotations

import ctypes

import torch

from tod_tpu_torch.kernels import _build
from tod_tpu_torch.ops.masks import assemble_masks, crop_masks

SOURCE = "mask_assembly"


def plain_assemble_crop_masks(prototypes, coeffs, boxes) -> torch.Tensor:
    """The plain torch version of the kernel (same shapes and layout)."""
    return crop_masks(assemble_masks(prototypes.float(), coeffs.float()), boxes.float())


SIGNATURES = {
    "tod_mask_assembly": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p], ctypes.c_int),
    "tod_mask_assembly_smem_bytes": ([ctypes.c_int], ctypes.c_int),
}


def assemble_crop_masks(prototypes: torch.Tensor, coeffs: torch.Tensor,
                        boxes: torch.Tensor) -> torch.Tensor:
    """prototypes (B, Hm, Wm, K), coeffs (B, N, K), boxes (B, N, 4) y1x1y2x2
    -> masks (B, N, Hm, Wm) f32.  ``masks = sigmoid(coeffs . protos)`` inside
    each box (pixel centres, inclusive), 0 outside."""
    if prototypes.dim() != 4 or coeffs.dim() != 3 or boxes.dim() != 3:
        raise ValueError("expected batched prototypes (B,Hm,Wm,K), coeffs (B,N,K), boxes (B,N,4)")
    b, hm, wm, k = prototypes.shape
    if coeffs.shape[0] != b or coeffs.shape[2] != k or boxes.shape != (b, coeffs.shape[1], 4):
        raise ValueError(
            f"shape mismatch: prototypes {tuple(prototypes.shape)}, "
            f"coeffs {tuple(coeffs.shape)}, boxes {tuple(boxes.shape)}"
        )
    if prototypes.device.type == "cpu":
        return plain_assemble_crop_masks(prototypes, coeffs, boxes)
    if prototypes.device.type != "cuda":
        raise ValueError(f"unsupported device {prototypes.device}")
    for name, t in (("prototypes", prototypes), ("coeffs", coeffs), ("boxes", boxes)):
        if t.device != prototypes.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {prototypes.device}")
    n = coeffs.shape[1]
    out = torch.empty((b, n, hm, wm), dtype=torch.float32, device=prototypes.device)
    if out.numel() == 0:
        return out
    lib = _build.load(SOURCE, SIGNATURES)
    if b * -(-n // 8) > 65535 or lib.tod_mask_assembly_smem_bytes(k) > 48 * 1024:
        raise ValueError(f"B={b}, N={n}, K={k} beyond the kernel's launch limits")
    with torch.cuda.device(prototypes.device):
        err = lib.tod_mask_assembly(
            prototypes.data_ptr(), coeffs.data_ptr(), boxes.data_ptr(), out.data_ptr(),
            b, n, hm, wm, k, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "mask_assembly launch")
    assemble_crop_masks.launches += 1
    return out


assemble_crop_masks.launches = 0
