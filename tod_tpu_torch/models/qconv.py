"""Int8 convolutions (counterpart of the JAX package's ``models/qconv.py``).

``QConv`` takes the place of ``models/conv.py``'s ``Conv`` at every conv
site of a model built with ``ModelConfig.quantized``, as the JAX package's
``conv_factory`` puts ``Conv8`` there.  What the site holds picks its
branch, as the JAX tree does:

- **dynamic** (``weight`` f32 and ``bias``): the weights quantized per call
  and per output channel (and a dense site's packed), the activations per
  sample with the amax over the sample's own axes; calibration runs
  through it and records each site's ``max|x|``, max-reduced over its
  calls (the JAX ``sow``);
- **static** (``kernel_q`` s8, ``w_scale`` (cout,) f32, ``act_scale`` ()
  f32 and ``bias``): the prepared serving site, one launch of the int8
  kernel (``kernels/qconv.py``), which reads a dense site's weights from
  ``packed``, ``pack_kernel``'s layout of ``kernel_q``: a buffer outside
  the state dict, packed again whenever a state dict is loaded into the
  site and moved with the module;
- **float** (``weight`` in bfloat16, a depthwise kernel that the
  preparation cast): a plain convolution of the values in the kernel's
  type;
- **qat** (``weight`` f32 and ``bias``, set by ``set_branch`` for a
  ``ModelConfig.qat`` model's calibration): the fake-quantized f32
  convolution of the JAX ``Conv8(qat=True)`` (a depthwise one in float),
  recording ``max|x|`` as the dynamic branch does.

Every branch keeps the port's SAME padding.  The bias is always f32.  A
ConvBN site (``bn``) adds it after the conv's cast, as the JAX graph's
folded BatchNorm does.  ``load_prepared`` sets each site's branch from the
keys of a state dict and loads it.

Quantization-aware training (``ModelConfig.qat``) builds ``QATConv`` at
every site of the training graph: ``fake_quantize`` rounds a dense conv's
weights (per output channel) and activations (per tensor) to the int8 grid
in float, with straight-through gradients (``STERound``) and the clip's
gradient as ``jnp.clip`` gives it; a depthwise conv stays float.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from tod_tpu_torch.kernels.qconv import pack_kernel, qconv
from tod_tpu_torch.models.conv import Conv, TrainConv, Training, same_pads
from tod_tpu_torch.ops.ieee import clip, rdiv

BRANCHES = ("dynamic", "static", "float", "qat")


def _scale(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    """``max(amax / qmax, 1e-12)`` in f32 as compiled XLA computes it: the
    division by a constant becomes a product with its f32 reciprocal (the
    JAX package's calibration and dynamic branch run jitted)."""
    recip = rdiv(1.0, torch.full((), float(qmax), dtype=torch.float32, device=amax.device))
    return torch.maximum(amax.float() * recip, torch.full_like(recip, 1e-12))


def quantize_symmetric(x: torch.Tensor, dim=None, bits: int = 8):
    """``x`` f32 -> (int8 values, f32 scale broadcastable over ``x``):
    scale = max(amax / 127, 1e-12) (``_scale``), q = clip(round(x / scale),
    +-127), with the amax over ``dim`` (all of ``x`` when None)."""
    qmax = 2 ** (bits - 1) - 1
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    scale = _scale(amax, qmax)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale


class STERound(torch.autograd.Function):
    """``round`` with a straight-through gradient (the identity): the
    quantizer's staircase has zero gradient almost everywhere, so QAT
    trains through it as if it were the identity."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quantize(x: torch.Tensor, dim=None, bits: int = 8) -> torch.Tensor:
    """Quantize and dequantize in float with straight-through gradients (the
    JAX ``fake_quantize``): the values are the int8 grid's, scale =
    max(amax / 127, 1e-12) as compiled XLA computes it (``_scale``), with
    the amax over ``dim`` (all of ``x`` when None) taken outside the graph;
    the gradient is the identity strictly
    inside the clip, half of it on +-127 (``ops.ieee.clip``) and zero
    outside."""
    qmax = 2 ** (bits - 1) - 1
    with torch.no_grad():
        amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
        scale = _scale(amax, qmax)
    return clip(STERound.apply(x / scale), -qmax, qmax) * scale


class QConv(nn.Module):
    """The int8 conv of one site (NCHW), in the dynamic branch until
    ``set_branch`` changes it."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
                 bn: bool = False):
        super().__init__()
        self.k, self.stride, self.groups, self.bn = k, stride, groups, bn
        self.shape = (cout, cin // groups, k, k)
        self.weight = nn.Parameter(torch.empty(self.shape))
        self.bias = nn.Parameter(torch.empty(cout))
        self.branch = "dynamic"
        self.recording = False
        self.amax: torch.Tensor | None = None

    def set_branch(self, branch: str, serve_dtype: torch.dtype = torch.bfloat16) -> None:
        """Lay out the site's tensors for ``branch`` (their values come
        from ``load_state_dict``)."""
        if branch not in BRANCHES:
            raise ValueError(f"unknown branch {branch!r}")
        for name in ("weight", "kernel_q", "w_scale", "act_scale", "packed"):
            if hasattr(self, name):
                delattr(self, name)
        dev = self.bias.device
        if branch == "static":
            self.register_buffer("kernel_q", torch.empty(self.shape, dtype=torch.int8, device=dev))
            self.register_buffer("w_scale", torch.empty(self.shape[0], device=dev))
            self.register_buffer("act_scale", torch.empty((), device=dev))
            self.register_buffer("packed", None, persistent=False)
        else:
            dtype = serve_dtype if branch == "float" else torch.float32
            self.weight = nn.Parameter(torch.empty(self.shape, dtype=dtype, device=dev))
        self.branch = branch

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        """Load as ``nn.Module`` does, then pack a static dense site's
        ``kernel_q`` again, so that ``packed`` always holds the loaded
        weights."""
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        if self.branch == "static" and self.groups == 1:
            self.packed = pack_kernel(self.kernel_q)

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        ph = same_pads(x.shape[-2], self.k, self.stride)
        pw = same_pads(x.shape[-1], self.k, self.stride)
        return F.pad(x, (pw[0], pw[1], ph[0], ph[1]))

    def _float_serve(self, x: torch.Tensor) -> torch.Tensor:
        """The conv over the values rounded to the kernel's type, summed in
        f32, plus the bias in f32, rounded once to the compute type: the
        compiled XLA graph runs a bf16 conv in f32 and keeps that sum, unrounded,
        through the add that follows."""
        w = self.weight
        xw = self._pad(x.to(w.dtype).float())
        y = F.conv2d(xw, w.float(), None, self.stride, 0, 1, self.groups)
        return (y + self.bias.view(1, -1, 1, 1)).to(x.dtype)

    def _qat(self, x: torch.Tensor) -> torch.Tensor:
        """The QAT branch: the f32 convolution of the fake-quantized
        activations and weights (of the float values at a depthwise site),
        biased as the dynamic branch's epilogue biases (a ConvBN site after
        the cast)."""
        xf = x.float()
        if self.groups > 1:
            y = F.conv2d(self._pad(xf), self.weight, None, self.stride, 0, 1, self.groups)
        else:
            y = F.conv2d(self._pad(fake_quantize(xf)), fake_quantize(self.weight, dim=(1, 2, 3)),
                         None, self.stride, 0, 1, self.groups)
        bias = self.bias.view(1, -1, 1, 1)
        if self.bn:
            return (y.to(x.dtype).float() + bias).to(x.dtype)
        return (y + bias).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        if self.branch == "static":
            return qconv(x, self.kernel_q, self.w_scale, self.act_scale, self.bias,
                         self.stride, self.groups, self.bn, packed=self.packed)
        if self.branch == "float":
            return self._float_serve(x)
        amax = x.float().abs().amax(dim=(1, 2, 3))
        if self.recording:
            top = amax.max()
            self.amax = top if self.amax is None else torch.maximum(self.amax, top)
        if self.branch == "qat":
            return self._qat(x)
        wq, sw = quantize_symmetric(self.weight.float(), dim=(1, 2, 3))
        sx = _scale(amax, 127)
        packed = pack_kernel(wq) if self.groups == 1 else None
        return qconv(x, wq, sw.view(-1).contiguous(), sx, self.bias, self.stride,
                     self.groups, self.bn, divide=True, packed=packed)


class QATConv(TrainConv):
    """A conv site of the QAT training graph (the JAX ``Conv8(qat=True)``):
    the convolution in f32 of the fake-quantized activations (per tensor)
    by the fake-quantized weights (per output channel), a depthwise one of
    the float values; the bias in f32; the result in ``dtype``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.groups > 1:
            y = self.conv(xf, self.weight)
        else:
            y = self.conv(fake_quantize(xf), fake_quantize(self.weight, dim=(1, 2, 3)))
        if self.bias is not None:
            y = y + self.bias.view(1, -1, 1, 1)
        return y.to(self.dtype)


def make_conv(mode, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
              bn: bool = False) -> nn.Module:
    """The conv module of a site by the model's ``mode``: a ``Training``
    builds the training graph's site (``QATConv`` with ``qat``, else
    ``TrainConv``; no bias at a ConvBN site); a true ``mode`` (a quantized
    model) ``QConv``; else ``Conv`` (whose folded BatchNorm is its plain
    bias)."""
    if isinstance(mode, Training):
        cls = QATConv if mode.qat else TrainConv
        return cls(cin, cout, k, stride, groups, bias=not bn, dtype=mode.dtype)
    if mode:
        return QConv(cin, cout, k, stride, groups, bn)
    return Conv(cin, cout, k, stride, groups)


def conv_sites(model: nn.Module) -> dict[str, QConv]:
    """Every ``QConv`` of ``model`` by its name in the state dict."""
    return {name: m for name, m in model.named_modules() if isinstance(m, QConv)}


def site_branch(state: Mapping[str, torch.Tensor], site: str) -> str:
    """The branch that a state dict's tensors give a site."""
    if f"{site}.kernel_q" in state:
        return "static"
    return "dynamic" if state[f"{site}.weight"].dtype == torch.float32 else "float"


def is_prepared(state: Mapping[str, torch.Tensor]) -> bool:
    """Whether a state dict holds prepared int8 sites."""
    return any(key.endswith(".kernel_q") for key in state)


def load_prepared(model: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Set each site's branch from ``state`` and load it (strict; a static
    dense site packs its kernel as it loads)."""
    from tod_tpu_torch.core.weights import check_state

    for site, m in conv_sites(model).items():
        branch = site_branch(state, site)
        dtype = state[f"{site}.weight"].dtype if branch == "float" else torch.bfloat16
        m.set_branch(branch, dtype)
    check_state(model, state)
    model.load_state_dict(state)
