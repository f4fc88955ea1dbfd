"""The int8 convolution of a conv site: quantize, s8 x s8 -> s32, rescale.

Counterpart of the JAX package's ``models/qconv.py`` ``Conv8`` static and
dynamic branches (lines 149-179 and 240-267), whose s8 convolution XLA
computes on the TPU.  On a CUDA tensor ``qconv`` launches ``csrc/qconv.cu``
(one launch a site: the activation quantize fused into the load, the int32
sum on the tensor cores, the rescale and the bias); on a CPU tensor it runs
``plain_qconv``, the same function in float64 over the integer values.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tod_tpu_torch.kernels import _build
from tod_tpu_torch.models.conv import same_pads
from tod_tpu_torch.ops.ieee import fma, rdiv

SOURCE = "qconv"
SIGNATURES = {
    "tod_qconv": ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                  + [ctypes.c_int] * 15 + [ctypes.c_void_p], ctypes.c_int),
}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_activations(x: torch.Tensor, sx: torch.Tensor, divide: bool) -> torch.Tensor:
    """``clip(round(x * (1 / sx)), -127, 127)`` in f32 (``x / sx`` when
    ``divide``, the dynamic branch), rounding half to even, with ``sx`` of
    shape (B,): integer values in f32."""
    xf = x.float()
    s = sx.view(-1, 1, 1, 1)
    v = xf / s if divide else xf * rdiv(1.0, s)
    return torch.clamp(torch.round(v), -127.0, 127.0)


def epilogue(acc: torch.Tensor, sx: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
             dtype: torch.dtype, bn: bool) -> torch.Tensor:
    """The int32 sums ``acc`` (exact integers, any float type) rescaled by
    ``sx[b] * w_scale[n]`` (that product first, in f32) and biased: a plain
    site ``cast(fma(acc, s, bias))``; a ConvBN site (``bn``), whose folded
    BatchNorm adds its bias after the conv's cast, ``cast(cast(acc * s) +
    bias)``."""
    a = acc.float()
    s = sx.view(-1, 1, 1, 1) * w_scale.view(1, -1, 1, 1)
    if bn:
        v = (a * s).to(dtype).float() + bias.view(1, -1, 1, 1)
    else:
        v = fma(a, s, bias.view(1, -1, 1, 1))
    return v.to(dtype)


def _pads(x: torch.Tensor, k: int, stride: int) -> tuple[tuple[int, int], tuple[int, int]]:
    return same_pads(x.shape[-2], k, stride), same_pads(x.shape[-1], k, stride)


def plain_qconv(x: torch.Tensor, kernel_q: torch.Tensor, w_scale: torch.Tensor,
                sx: torch.Tensor, bias: torch.Tensor, stride: int = 1, groups: int = 1,
                bn: bool = False, divide: bool = False) -> torch.Tensor:
    """The plain version: the quantized activations padded with zeros
    (SAME), the convolution in float64 over the integer values (exact below
    2^53), then ``epilogue``."""
    k = kernel_q.shape[-1]
    (pt, pb), (pl, pr) = _pads(x, k, stride)
    xq = F.pad(quantize_activations(x, sx, divide), (pl, pr, pt, pb))
    acc = F.conv2d(xq.double(), kernel_q.double(), None, stride, 0, 1, groups)
    return epilogue(acc, sx, w_scale, bias, x.dtype, bn)


def qconv(x: torch.Tensor, kernel_q: torch.Tensor, w_scale: torch.Tensor, sx: torch.Tensor,
          bias: torch.Tensor, stride: int = 1, groups: int = 1, bn: bool = False,
          divide: bool = False) -> torch.Tensor:
    """The int8 convolution of ``x`` (B, Cin, H, W), f32 or bf16 contiguous,
    with ``kernel_q`` (Cout, Cin / groups, k, k) s8 (k 1 or 3; ``groups`` 1
    or Cin == Cout), ``w_scale`` (Cout,) f32, ``sx`` the activation scale,
    () or (B,) f32, and ``bias`` (Cout,) f32 -> (B, Cout, Ho, Wo) in
    ``x``'s dtype, SAME padding.  ``bn``: a ConvBN site (see ``epilogue``);
    ``divide``: quantize by ``x / sx`` (the dynamic branch) in place of
    ``x * (1 / sx)``.  Raises on what the kernel does not take, before any
    launch."""
    if x.dim() != 4 or kernel_q.dim() != 4 or x.dtype not in DTYPES:
        raise ValueError(f"expected x (B, C, H, W) f32 or bf16 and an OIHW kernel, got "
                         f"{tuple(x.shape)} {x.dtype} and {tuple(kernel_q.shape)}")
    b, cin, h, w = x.shape
    cout, cpg, k, k2 = kernel_q.shape
    if k != k2 or k not in (1, 3) or stride < 1:
        raise ValueError(f"the kernel takes 1x1 and 3x3 kernels and a stride >= 1, got "
                         f"{k}x{k2} stride {stride}")
    if groups == 1:
        if cpg != cin:
            raise ValueError(f"kernel {tuple(kernel_q.shape)} does not fit {cin} channels")
    elif groups != cin or cout != cin or cpg != 1:
        raise ValueError(f"groups={groups}: only dense (1) or depthwise (Cin == Cout) sites")
    if sx.dim() == 0:
        sx = sx.reshape(1).expand(b)
    tensors = {"kernel_q": (kernel_q, torch.int8), "w_scale": (w_scale, torch.float32),
               "sx": (sx, torch.float32), "bias": (bias, torch.float32)}
    for name, (t, dt) in tensors.items():
        if t.device != x.device or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} on {x.device}, got {t.dtype} on {t.device}")
    if w_scale.shape != (cout,) or bias.shape != (cout,) or sx.shape != (b,):
        raise ValueError(f"w_scale {tuple(w_scale.shape)}, bias {tuple(bias.shape)}, sx "
                         f"{tuple(sx.shape)}: expected ({cout},), ({cout},) and () or ({b},)")
    if not all(t.is_contiguous() for t in (x, kernel_q, w_scale, bias)):
        raise ValueError("x, kernel_q, w_scale and bias must be contiguous")
    if x.device.type == "cpu":
        return plain_qconv(x, kernel_q, w_scale, sx, bias, stride, groups, bn, divide)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    (pt, pb), (pl, pr) = _pads(x, k, stride)
    ho, wo = (h + pt + pb - k) // stride + 1, (w + pl + pr - k) // stride + 1
    y = torch.empty((b, cout, ho, wo), dtype=x.dtype, device=x.device)
    sx_stride = 0 if sx.stride(0) == 0 else 1
    if sx_stride and not sx.is_contiguous():
        sx = sx.contiguous()
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.tod_qconv(
            x.data_ptr(), kernel_q.data_ptr(), w_scale.data_ptr(), sx.data_ptr(), sx_stride,
            bias.data_ptr(), y.data_ptr(),
            DTYPES[x.dtype], b, cin, h, w, cout, k, stride, pt, pl, ho, wo, groups, int(divide),
            int(bn), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "qconv launch")
    qconv.launches += 1
    return y


qconv.launches = 0
