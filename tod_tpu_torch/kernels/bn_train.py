"""The training form of a MobileNetV2 ConvBN site after its convolution:
BatchNorm on the batch's statistics in f32, ReLU6 where the site has it, and
the cast back to the convolution's dtype, forward and backward.

No TPU kernel: the JAX package leaves this graph to XLA.  ``bn_act`` is the
function: on a CUDA tensor it runs ``csrc/bn_train.cu`` as one
``torch.autograd.Function`` (torch's reductions for the statistics and one
launch forward, two launches backward), on a CPU tensor or over a dp
mesh's global batch the plain graph below, ``plain_bn_act``.
``batch_norm_train`` is that graph's BatchNorm, which
``models/resnet.TrainBatchNorm`` computes too; both take the batch's
statistics from ``batch_moments``, so the kernel's forward is the plain
graph's bit for bit (a step's loss moved by 1e-3 of itself when only the
statistics' rounding changed, on an H100).  ``bn_tiling`` cuts a
channels-last tensor into blocks from its shape and the SM count.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from tod_tpu_torch.core.device import sm_count
from tod_tpu_torch.kernels import _build
from tod_tpu_torch.runtime.profiler import count

BN_EPS = 1e-5  # Flax nn.BatchNorm's epsilon
BN_MOMENTUM = 0.97  # the JAX models' nn.BatchNorm(momentum=0.97)

SOURCE = "bn_train"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "tod_bn_forward": ([_P] * 9 + [_I] * 8 + [_F] * 3 + [_P], _I),
    "tod_bn_backward": ([_P] * 11 + [_I] * 10 + [_P], _I),
}
THREADS = 256  # a block, csrc/bn_train.cu kThreads
# Blocks loop over rows with 4 loads in flight a thread; the last block of
# a channel group sums every statistics block's partials, so that pass
# takes one block an SM (on an H100 2.55 ms a VGA step's backward sums
# against 2.69 at two), the apply passes eight (1.14 and 1.71 ms forward
# and backward against 1.22 and 1.87 at sixteen)
STATS_BLOCKS_PER_SM = 1
APPLY_BLOCKS_PER_SM = 8
GROUP = 32  # the most vectors of a row one block takes
DTYPES = (torch.bfloat16, torch.float32)
REST = float(np.float32(1 - BN_MOMENTUM))  # the running statistics' batch weight, as f32 rounds it


def relu6(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.relu6``, whose gradient is 0 at 0 and at 6 (``clamp``'s is 1
    there: a channel that BatchNorm maps to exactly 0 would pass it on)."""
    return torch.where((x > 0) & (x < 6), x, x.detach().clamp(0.0, 6.0))


def batch_moments(xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2]) of f32 NCHW ``xf`` over (N, H, W), by torch's own
    reductions: the plain graph's statistics and the kernel's, bit for
    bit."""
    return xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     mean: torch.Tensor, var: torch.Tensor,
                     moments: Callable | None = None) -> torch.Tensor:
    """Flax's training BatchNorm in f32 on NCHW ``x``: normalised by the
    batch's mean and biased variance E[x^2] - E[x]^2, clipped at 0, and the
    running ``mean`` and ``var`` updated in place to ``0.97 running + 0.03
    batch``.  ``moments`` (``xf -> (E[x], E[x^2])``) takes the statistics
    over a dp mesh's global batch instead."""
    xf = x.float()
    bmean, sq = (moments or batch_moments)(xf)
    bvar = (sq - bmean * bmean).clamp_min(0.0)
    with torch.no_grad():
        mean.copy_(BN_MOMENTUM * mean + (1 - BN_MOMENTUM) * bmean)
        var.copy_(BN_MOMENTUM * var + (1 - BN_MOMENTUM) * bvar)
    mul = torch.rsqrt(bvar + BN_EPS) * scale
    return (xf - bmean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


def plain_bn_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
                 var: torch.Tensor, act: bool, moments: Callable | None = None) -> torch.Tensor:
    """``batch_norm_train``, then ``relu6`` where ``act``, in x's dtype."""
    y = batch_norm_train(x, scale, bias, mean, var, moments)
    return (relu6(y) if act else y).to(x.dtype)


class BNTiling(NamedTuple):
    """How ``csrc/bn_train.cu`` cuts a channels-last tensor of N * H * W
    ``rows`` of C: read ``bytes`` at a time; for each ``group`` of vectors
    of a row, ``tickets`` of them, the statistics pass's ``slices`` blocks
    of ``per`` rows and the apply pass's ``apply_slices`` of ``apply_per``."""

    rows: int
    bytes: int
    group: int
    per: int
    slices: int
    apply_per: int
    apply_slices: int
    tickets: int


def vector_bytes(elems: int, itemsize: int, align: int) -> int:
    """The widest load (16, 8, 4 or 2 bytes, not under ``itemsize``) that a
    run of ``elems`` elements and the pointers, ``align`` bytes past 16-byte
    alignment, are whole multiples of."""
    for b in (16, 8, 4, 2):
        if b >= itemsize and (elems * itemsize) % b == 0 and align % b == 0:
            return b
    raise ValueError(f"no load width fits {elems} elements of {itemsize} bytes")


def _cut(runs: int, slices: int) -> tuple[int, int]:
    """(per, slices): ``runs`` in at most ``slices`` blocks, none empty."""
    per = -(-runs // max(1, slices))
    return per, -(-runs // per)


@functools.lru_cache(maxsize=256)
def bn_tiling(shape: tuple, itemsize: int, align: int, sms: int) -> BNTiling:
    """The blocks for a channels-last (N, C, H, W) ``shape`` whose pointers
    sit ``align`` bytes past 16-byte alignment, on a card with ``sms`` SMs:
    a row's vectors in groups of at most ``GROUP``; the statistics pass
    ``STATS_BLOCKS_PER_SM`` blocks an SM over the rows, the apply pass
    ``APPLY_BLOCKS_PER_SM``, none with fewer rows than it takes at once."""
    n, c, h, w = shape
    if min(n, c, h, w, sms) < 1:
        raise ValueError(f"bn_tiling needs a non-empty shape and sms >= 1, got {shape}, {sms}")
    nbytes = vector_bytes(c, itemsize, align)
    rows = n * h * w
    hv = c * itemsize // nbytes
    group = -(-hv // -(-hv // GROUP))
    tickets = -(-hv // group)
    most = -(-rows // (THREADS // group))
    per, slices = _cut(rows, min(-(-sms * STATS_BLOCKS_PER_SM // tickets), most))
    apply = _cut(rows, min(-(-sms * APPLY_BLOCKS_PER_SM // tickets), most))
    return BNTiling(rows, nbytes, group, per, slices, *apply, tickets)


def _check(x: torch.Tensor, params) -> None:
    """Raises on what the kernels do not take."""
    if x.dim() != 4:
        raise ValueError(f"expected an (N, C, H, W) tensor, got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"bn_act takes {DTYPES}, got {x.dtype}")
    if x.numel() == 0 or x.numel() >= 2**31:
        raise ValueError(f"bn_act takes 1 to 2**31 - 1 elements, got {x.numel()}")
    for p in params:
        if (p.dtype != torch.float32 or not p.is_contiguous() or p.shape != (x.shape[1],)
                or p.device != x.device):
            raise ValueError(f"scale, bias, mean and var must be contiguous float32 "
                             f"({x.shape[1]},) on {x.device}, got {p.dtype} {tuple(p.shape)} "
                             f"on {p.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bn_act takes a channels-last tensor")


def bn_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
           var: torch.Tensor, act: bool, moments: Callable | None = None) -> torch.Tensor:
    """(N, C, H, W) bf16 or f32 -> y like it: BatchNorm on the batch's
    statistics (``mean`` and ``var`` updated in place), ReLU6 where ``act``,
    rounded to x's dtype; differentiable in x, scale and bias.  With
    ``moments`` (a dp mesh's, ``batch_norm_train``) or on the CPU the plain
    graph; on the card the kernel pair on a channels-last x, each launch
    counted in ``bn_act.launches`` and each call in ``train/bn_fused``."""
    if moments is not None or x.device.type == "cpu":
        return plain_bn_act(x, scale, bias, mean, var, act, moments)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, (scale, bias, mean, var))
    return _BNAct.apply(x, scale, bias, mean, var, act)


bn_act.launches = 0


class _BNAct(torch.autograd.Function):
    """The kernel pair: torch's reductions for the batch's statistics, then
    one launch forward and two backward.  Saves x, its (3, C) statistics
    (mean, r = rsqrt(var + eps), and 0 where the variance was clipped, else
    1) and the parameters; no f32 copy of an activation."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, var, act):
        c = x.shape[1]
        t = bn_tiling(x.shape, x.element_size(), x.data_ptr() & 15, sm_count(x.device))
        bmean, sq = batch_moments(x.float())
        y = torch.empty_like(x)
        saved = torch.empty(3 * c, dtype=torch.float32, device=x.device)
        lib = _build.load(SOURCE, SIGNATURES)
        with torch.cuda.device(x.device):
            err = lib.tod_bn_forward(
                x.data_ptr(), y.data_ptr(), bmean.data_ptr(), sq.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), mean.data_ptr(), var.data_ptr(), saved.data_ptr(),
                int(x.dtype == torch.bfloat16), int(act), c, t.rows, t.bytes, t.group,
                t.apply_per, t.apply_slices, BN_EPS, BN_MOMENTUM, REST,
                torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "bn_train forward")
        bn_act.launches += 1
        count("train/bn_fused")
        ctx.save_for_backward(x, saved, scale, bias)
        ctx.act = act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, saved, scale, bias = ctx.saved_tensors
        dy = dy.contiguous(memory_format=torch.channels_last)
        c = x.shape[1]
        t = bn_tiling(x.shape, x.element_size(), (x.data_ptr() | dy.data_ptr()) & 15,
                      sm_count(x.device))
        dx = torch.empty_like(x)
        part = 2 * c * t.slices
        buf = torch.empty(part + 4 * c + t.tickets, dtype=torch.float32, device=x.device)
        dscale, dbias = buf[part: part + c], buf[part + c: part + 2 * c]
        base = buf.data_ptr()
        lib = _build.load(SOURCE, SIGNATURES)
        err = lib.tod_bn_backward(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), base, base + 4 * (part + 4 * c),
            saved.data_ptr(), base + 4 * (part + 2 * c), scale.data_ptr(), bias.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), int(x.dtype == torch.bfloat16), int(ctx.act),
            c, t.rows, t.bytes, t.group, t.per, t.slices, t.apply_per, t.apply_slices,
            torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "bn_train backward")
        bn_act.launches += 2  # the statistics pass and dx
        return dx, dscale, dbias, None, None, None
