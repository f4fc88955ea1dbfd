"""The int8 convolution of a conv site: quantize, s8 x s8 -> s32, rescale.

Counterpart of the JAX package's ``models/qconv.py`` ``Conv8`` static and
dynamic branches (lines 149-179 and 240-267), whose s8 convolution XLA
computes on the TPU.  On a CUDA tensor ``qconv`` launches ``csrc/qconv.cu``
(one launch a site: the activation quantize fused into the load, the int32
sum on the tensor cores, the rescale and the bias); on a CPU tensor it runs
``plain_qconv``, the same function in float64 over the integer values.
While ``torch.export`` traces it, it calls the custom op ``tod::qconv``
(the same two), which an exported graph keeps.

A dense site's kernel reads its weights as ``pack_kernel`` lays them out
once, at load: K in the order the kernel walks it, cut into the N tiles and
K stages of ``qconv_tiling``, each stage already in the tensor cores'
128-byte swizzle, so that one bulk copy brings it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tod_tpu_torch.kernels import _build
from tod_tpu_torch.ops.padding import same_pads
from tod_tpu_torch.ops.ieee import fma, rdiv

SOURCE = "qconv"
SIGNATURES = {
    "tod_qconv_dense": ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                        + [ctypes.c_int] * 21 + [ctypes.c_void_p], ctypes.c_int),
    "tod_qconv_depthwise": ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                            + [ctypes.c_int] * 13 + [ctypes.c_void_p], ctypes.c_int),
}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_SIDES = (1, 3, 7)  # 7: the ResNet stem, dense only

BM = 64  # output pixels a tile: one wgmma's M
STAGE_K = 128  # K bytes a stage: one 128-byte swizzled row a pixel or channel
STEP_K = 32  # K a wgmma step
N_TILES = (64, 128, 256)  # output channels a block: BN / 64 wgmmas a step
MAX_SPLITS = 8  # blocks a tile's K splits across: one thread block cluster, the portable most


@dataclass(frozen=True)
class QConvTiling:
    """How a dense site's kernel cuts its implicit GEMM (M pixels, N
    channels, K = Cin * k * k)."""

    flat: bool  # K in (ci, ky, kx) order (Cin < 32 at 3x3), else (ky, kx, ci)
    cin_pad: int  # ci padded with zeros to a multiple of 32 in the (ky, kx, ci) order
    k_len: int  # K values, padding inside a tap included
    k_steps: int  # wgmma steps of 32: K padded with zeros to a multiple of 32
    n_stages: int  # stages of 4 steps (the last may hold fewer)
    bn: int  # output channels an N tile
    n_tiles: int
    m_tiles: int  # tiles of BM output pixels
    splits: int  # blocks a tile's K is split across, by whole stages (one cluster)
    stages_per_split: int

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits


def _layout(cin: int, cout: int, k: int) -> dict:
    """The weights' side of the tiling, which ``pack_kernel`` needs."""
    flat = k > 1 and cin < 32
    cin_pad = cin if flat else -(-cin // STEP_K) * STEP_K
    k_len = cin * k * k if flat else k * k * cin_pad
    k_steps = -(-k_len // STEP_K)
    if cout <= N_TILES[-1]:
        bn = min(t for t in N_TILES if t >= cout)
    else:  # the least padding; at a tie, the fewer tiles
        bn = min(N_TILES[1:], key=lambda t: (-(-cout // t) * t, -t))
    return dict(flat=flat, cin_pad=cin_pad, k_len=k_len, k_steps=k_steps,
                n_stages=-(-k_steps // (STAGE_K // STEP_K)), bn=bn, n_tiles=-(-cout // bn))


def qconv_tiling(b: int, cin: int, h: int, w: int, cout: int, k: int, stride: int,
                 sms: int) -> QConvTiling:
    """The tiles of a dense site with input (b, cin, h, w), ``cout``
    channels, a k x k kernel at ``stride`` (SAME: Ho = ceil(h / stride)) on
    a card of ``sms`` SMs: 64-pixel M tiles, one N tile of up to 256
    channels (or tiles of 128 or 256 above that), and K split by whole
    stages across as many blocks as fill the SMs that the tiles leave idle,
    at most ``MAX_SPLITS``."""
    lay = _layout(cin, cout, k)
    m_tiles = -(-(b * -(-h // stride) * -(-w // stride)) // BM)
    n_stages = lay["n_stages"]
    splits = max(1, min(n_stages, MAX_SPLITS, sms // (m_tiles * lay["n_tiles"])))
    per = -(-n_stages // splits)
    return QConvTiling(**lay, m_tiles=m_tiles, splits=-(-n_stages // per), stages_per_split=per)


def packed_shape(cin: int, cout: int, k: int) -> tuple[int, int, int, int]:
    """``pack_kernel``'s shape for a (cout, cin, k, k) kernel: (N tiles,
    stages, BN, 128)."""
    lay = _layout(cin, cout, k)
    return lay["n_tiles"], lay["n_stages"], lay["bn"], STAGE_K


def swizzle_index(rows: int, device=None) -> torch.Tensor:
    """(rows, 128) byte indices of the 128-byte swizzle: the 16-byte chunk c
    of row r sits at chunk c ^ (r % 8).  A permutation that is its own
    inverse: gathering with it packs, and gathering again unpacks."""
    r = torch.arange(rows, device=device).view(-1, 1)
    q = torch.arange(STAGE_K, device=device).view(1, -1)
    return ((q // 16) ^ (r % 8)) * 16 + q % 16


def pack_kernel(kernel_q: torch.Tensor) -> torch.Tensor:
    """A dense site's OIHW s8 kernel in the byte order the kernel reads:
    (N tiles, stages, BN, 128), each [tile, stage] one contiguous run of BN
    rows of 128 K bytes (``qconv_tiling``'s K order, zeros past K and past
    Cout) in the 128-byte swizzle.  On ``kernel_q``'s device."""
    if kernel_q.dim() != 4 or kernel_q.dtype != torch.int8:
        raise ValueError(f"expected an OIHW s8 kernel, got {tuple(kernel_q.shape)} "
                         f"{kernel_q.dtype}")
    cout, cin, k, _ = kernel_q.shape
    lay = _layout(cin, cout, k)
    if lay["flat"]:
        kmat = kernel_q.reshape(cout, cin * k * k)
    else:  # (ky, kx, ci) with ci padded
        kmat = F.pad(kernel_q.permute(0, 2, 3, 1), (0, lay["cin_pad"] - cin))
        kmat = kmat.reshape(cout, k * k * lay["cin_pad"])
    n_tiles, n_stages, bn = lay["n_tiles"], lay["n_stages"], lay["bn"]
    kmat = F.pad(kmat, (0, n_stages * STAGE_K - kmat.shape[1], 0, n_tiles * bn - cout))
    tiles = kmat.reshape(n_tiles, bn, n_stages, STAGE_K).permute(0, 2, 1, 3)
    index = swizzle_index(bn, kernel_q.device).expand(n_tiles, n_stages, bn, STAGE_K)
    return torch.gather(tiles, 3, index).contiguous()


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


_sms: dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def qconv(x: torch.Tensor, kernel_q: torch.Tensor, w_scale: torch.Tensor, sx: torch.Tensor,
          bias: torch.Tensor, stride: int = 1, groups: int = 1, bn: bool = False,
          divide: bool = False, packed: torch.Tensor | None = None) -> torch.Tensor:
    """The int8 convolution of ``x`` (B, Cin, H, W), f32 or bf16 contiguous,
    with ``kernel_q`` (Cout, Cin / groups, k, k) s8 (k 1, 3 or 7, the 7 dense
    only; ``groups`` 1 or Cin == Cout), ``w_scale`` (Cout,) f32, ``sx`` the activation scale,
    () or (B,) f32, and ``bias`` (Cout,) f32 -> (B, Cout, Ho, Wo) in
    ``x``'s dtype, SAME padding.  ``bn``: a ConvBN site (see ``epilogue``);
    ``divide``: quantize by ``x / sx`` (the dynamic branch) in place of
    ``x * (1 / sx)``.  ``packed``: ``pack_kernel(kernel_q)``, which a dense
    site on the card needs (a CPU call ignores it).  Raises on what the
    kernel does not take, before any launch."""
    if x.dim() != 4 or kernel_q.dim() != 4 or x.dtype not in DTYPES:
        raise ValueError(f"expected x (B, C, H, W) f32 or bf16 and an OIHW kernel, got "
                         f"{tuple(x.shape)} {x.dtype} and {tuple(kernel_q.shape)}")
    b, cin, h, w = x.shape
    cout, cpg, k, k2 = kernel_q.shape
    if k != k2 or k not in KERNEL_SIDES or stride < 1 or (groups != 1 and k == 7):
        raise ValueError(f"the kernel takes 1x1, 3x3 and (dense) 7x7 kernels and a stride "
                         f">= 1, got {k}x{k2} stride {stride}, groups {groups}")
    if groups == 1:
        if cpg != cin:
            raise ValueError(f"kernel {tuple(kernel_q.shape)} does not fit {cin} channels")
    elif groups != cin or cout != cin or cpg != 1:
        raise ValueError(f"groups={groups}: only dense (1) or depthwise (Cin == Cout) sites")
    if sx.dim() == 0:
        sx = sx.reshape(1).expand(b)
    tensors = {"kernel_q": (kernel_q, torch.int8), "w_scale": (w_scale, torch.float32),
               "sx": (sx, torch.float32), "bias": (bias, torch.float32)}
    if packed is not None:
        tensors["packed"] = (packed, torch.int8)
    for name, (t, dt) in tensors.items():
        if t.device != x.device or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} on {x.device}, got {t.dtype} on {t.device}")
    if w_scale.shape != (cout,) or bias.shape != (cout,) or sx.shape != (b,):
        raise ValueError(f"w_scale {tuple(w_scale.shape)}, bias {tuple(bias.shape)}, sx "
                         f"{tuple(sx.shape)}: expected ({cout},), ({cout},) and () or ({b},)")
    if not all(t.is_contiguous() for t in (x, kernel_q, w_scale, bias)):
        raise ValueError("x, kernel_q, w_scale and bias must be contiguous")
    if packed is not None:
        if groups != 1:
            raise ValueError("a depthwise site reads kernel_q; it takes no packed kernel")
        if tuple(packed.shape) != packed_shape(cin, cout, k) or not packed.is_contiguous():
            raise ValueError(f"packed {tuple(packed.shape)} is not pack_kernel's layout of "
                             f"kernel {tuple(kernel_q.shape)}: {packed_shape(cin, cout, k)}")
    if torch.compiler.is_exporting():
        return _op(x, kernel_q, w_scale, sx, bias, stride, groups, bn, divide, packed)
    if x.device.type == "cpu":
        return plain_qconv(x, kernel_q, w_scale, sx, bias, stride, groups, bn, divide)
    return _launch(x, kernel_q, w_scale, sx, bias, stride, groups, bn, divide, packed)


def _launch(x: torch.Tensor, kernel_q: torch.Tensor, w_scale: torch.Tensor, sx: torch.Tensor,
            bias: torch.Tensor, stride: int, groups: int, bn: bool, divide: bool,
            packed: torch.Tensor | None) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if groups == 1 and packed is None:
        raise ValueError("a dense site on the card reads its kernel as pack_kernel(kernel_q) "
                         "lays it out: pass packed")
    b, cin, h, w = x.shape
    cout, _, k, _ = kernel_q.shape
    (pt, pb), (pl, pr) = _pads(x, k, stride)
    ho, wo = (h + pt + pb - k) // stride + 1, (w + pl + pr - k) // stride + 1
    y = torch.empty((b, cout, ho, wo), dtype=x.dtype, device=x.device)
    sx_stride = 0 if sx.stride(0) == 0 else 1
    if sx_stride and not sx.is_contiguous():
        sx = sx.contiguous()
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if groups == 1:
            t = qconv_tiling(b, cin, h, w, cout, k, stride, _sm_count(x.device))
            err = lib.tod_qconv_dense(
                x.data_ptr(), packed.data_ptr(), w_scale.data_ptr(), sx.data_ptr(), sx_stride,
                bias.data_ptr(), y.data_ptr(), DTYPES[x.dtype], b, cin, h, w, cout, k, stride,
                pt, pl, ho, wo, int(divide), int(bn), t.bn, t.n_tiles, int(t.flat), t.cin_pad,
                t.k_steps, t.splits, t.stages_per_split, stream,
            )
        else:
            err = lib.tod_qconv_depthwise(
                x.data_ptr(), kernel_q.data_ptr(), w_scale.data_ptr(), sx.data_ptr(), sx_stride,
                bias.data_ptr(), y.data_ptr(), DTYPES[x.dtype], b, cin, h, w, k, stride, pt, pl,
                ho, wo, int(divide), int(bn), stream,
            )
    _build.check(lib, err, "qconv launch")
    qconv.launches += 1
    return y


qconv.launches = 0


def _plain(x: torch.Tensor, kernel_q: torch.Tensor, w_scale: torch.Tensor, sx: torch.Tensor,
           bias: torch.Tensor, stride: int, groups: int, bn: bool, divide: bool,
           packed: torch.Tensor | None) -> torch.Tensor:
    return plain_qconv(x, kernel_q, w_scale, sx, bias, stride, groups, bn, divide)


_op = torch.library.custom_op("tod::qconv", _plain, mutates_args=(), device_types="cpu")
_op.register_kernel("cuda")(_launch)


@_op.register_fake
def _(x, kernel_q, w_scale, sx, bias, stride, groups, bn, divide, packed):
    (pt, pb), (pl, pr) = _pads(x, kernel_q.shape[-1], stride)
    k = kernel_q.shape[-1]
    ho = (x.shape[2] + pt + pb - k) // stride + 1
    wo = (x.shape[3] + pl + pr - k) // stride + 1
    return x.new_empty((x.shape[0], kernel_q.shape[0], ho, wo))
