"""Int8 weight-only quantization (PTQ) and kernel K5, the stochastic
quantizer (counterpart of the JAX package's ``ops/quantize.py``).

Per-column symmetric int8 for every conv kernel of a checkpoint tree (last
axis = output channels), scales in float32, dequantized before serving.  The
tree is the flat Flax tree of ``core.weights.read_tree``: paths as keys,
kernels still in HWIO, so the dequantized tree goes through
``core.weights.carry_across`` (batch-norm folding) as the f32 one does.

Stochastic rounding takes its uniform numbers from Philox4x32-10, key
``(seed, 0)``, counter ``(i // 4, 0, 0, 0)`` and word ``i % 4`` for the
element of flat index ``i``: ``u = (word >> 8) * 2^-24``.  The TPU kernel drew
them from the TPU's own generator, which the card does not have; both
versions here (the CUDA kernel and the plain one) give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Any, Mapping

import numpy as np
import torch

from tod_tpu_torch.core.device import resolve_device, sm_count
from tod_tpu_torch.kernels import _build
from tod_tpu_torch.ops.ieee import div

SOURCE = "quantize"
SIGNATURES = {
    "tod_quantize": (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint] + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}
_MASK = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of ``a * b`` for a 32-bit constant ``a`` and
    int64 ``b`` holding 32-bit values, without overflowing int64: ``b`` is
    split into 16-bit halves."""
    p_hi = a * (b >> 16)
    t = a * (b & 0xFFFF) + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox4x32(counter: torch.Tensor, seed: int) -> torch.Tensor:
    """Philox4x32-10 of the counters ``(counter, 0, 0, 0)`` under the key
    ``(seed, 0)`` -> (len(counter), 4) int64 holding the 32-bit words."""
    c0 = counter.to(torch.int64)
    c1 = c2 = c3 = torch.zeros_like(c0)
    k0, k1 = seed & _MASK, 0
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK, (k1 + _PHILOX_W[1]) & _MASK
    return torch.stack([c0, c1, c2, c3], dim=-1)


def uniforms(numel: int, seed: int, device=None) -> torch.Tensor:
    """The float32 uniforms in [0, 1) of flat indices 0..numel-1."""
    words = philox4x32(torch.arange((numel + 3) // 4, device=device), seed).reshape(-1)[:numel]
    return (words >> 8).to(torch.float32) * 2.0**-24


def _scales(x2d: torch.Tensor) -> torch.Tensor:
    """Per-column ``max(amax / 127, 1e-12)``, (1, C) f32, IEEE division."""
    return div(x2d.abs().amax(dim=0, keepdim=True), 127.0).clamp_min(1e-12)


def plain_quantize_tensor_stochastic(x2d: torch.Tensor, seed: int = 0):
    """The plain version of K5: (N, C) f32 -> (int8 (N, C), scales (1, C) f32)."""
    x2d = x2d.to(torch.float32)
    scale = _scales(x2d)
    u = uniforms(x2d.numel(), seed, x2d.device).reshape(x2d.shape)
    q = torch.clamp(torch.floor(x2d / scale + u), -127, 127).to(torch.int8)
    return q, scale


def quantize_tensor_pallas(x2d: torch.Tensor, seed: int = 0):
    """K5: (N, C) f32 -> (int8 values (N, C), scales (1, C) f32) with
    stochastic rounding (the name is the JAX package's)."""
    if x2d.dim() != 2:
        raise ValueError(f"expected an (N, C) matrix, got {tuple(x2d.shape)}")
    if x2d.device.type == "cpu":
        return plain_quantize_tensor_stochastic(x2d, seed)
    if x2d.device.type != "cuda":
        raise ValueError(f"unsupported device {x2d.device}")
    if x2d.dtype != torch.float32 or not x2d.is_contiguous():
        raise ValueError("x2d must be contiguous float32")
    n, c = x2d.shape
    if x2d.numel() >= 2**31:
        raise ValueError(f"{x2d.numel()} elements: flat indices must fit in 31 bits")
    q = torch.empty((n, c), dtype=torch.int8, device=x2d.device)
    scale = torch.empty((1, c), dtype=torch.float32, device=x2d.device)
    if n * c == 0:
        return q, scale
    lib = _build.load(SOURCE, SIGNATURES)
    amax_bits = torch.empty(c, dtype=torch.int32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        err = lib.tod_quantize(x2d.data_ptr(), n, c, seed & _MASK, q.data_ptr(),
                               scale.data_ptr(), amax_bits.data_ptr(), sm_count(x2d.device),
                               torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "quantize launch")
    quantize_tensor_pallas.launches += 1
    return q, scale


quantize_tensor_pallas.launches = 0


def quantize_tensor(x2d: torch.Tensor, stochastic: bool = False, seed: int = 0):
    """Round-to-nearest (ties to even) or stochastic per-column int8."""
    if stochastic:
        return quantize_tensor_pallas(x2d, seed)
    scale = _scales(x2d)
    q = torch.clamp(torch.round(x2d / scale), -127, 127).to(torch.int8)
    return q, scale


def _is_kernel(key: str, leaf) -> bool:
    return key.rsplit("/", 1)[-1] == "kernel" and np.ndim(leaf) >= 2


def quantize_params(tree: Mapping[str, Any], stochastic: bool = False, seed: int = 0,
                    device=None) -> dict[str, Any]:
    """Quantize every conv kernel of a flat checkpoint tree on ``device``
    (default ``cuda``).

    Each kernel leaf becomes ``{"q": int8, "scale": f32, "shape": shape}``
    (tensors on the device); other leaves pass through.  Leaves are taken in
    the order of the nested tree's flattening (path components sorted) and
    leaf ``i`` is seeded ``seed + i``, as in the JAX package.
    """
    dev = resolve_device(device)
    out: dict[str, Any] = {}
    for i, key in enumerate(sorted(tree, key=lambda k: tuple(k.split("/")))):
        leaf = tree[key]
        if _is_kernel(key, leaf):
            shape = tuple(np.shape(leaf))
            x2d = torch.as_tensor(np.asarray(leaf, np.float32)).to(dev).reshape(-1, shape[-1])
            q, scale = quantize_tensor(x2d.contiguous(), stochastic=stochastic, seed=seed + i)
            out[key] = {"q": q, "scale": scale, "shape": shape}
        else:
            out[key] = leaf
    return out


def _is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "scale", "shape"}


def dequantize_params(qtree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Inverse of :func:`quantize_params`: a flat tree of float32 numpy
    arrays, kernels rebuilt as ``q * scale`` in their original shape."""
    out = {}
    for key, leaf in qtree.items():
        if _is_quantized(leaf):
            w = leaf["q"].to(torch.float32) * leaf["scale"]
            out[key] = w.reshape(leaf["shape"]).cpu().numpy()
        else:
            out[key] = np.asarray(leaf)
    return out


def quantized_size_bytes(qtree: Mapping[str, Any]) -> int:
    """Bytes of every leaf, counted as the JAX package counts its pytree
    leaves: int8 values, f32 scales and 8 bytes per shape entry."""
    total = 0
    for leaf in qtree.values():
        if _is_quantized(leaf):
            total += leaf["q"].numel() + 4 * leaf["scale"].numel() + 8 * len(leaf["shape"])
        else:
            total += np.asarray(leaf).nbytes
    return total
