"""Spatial partitioning: the image's H axis split over the devices of a
mesh axis (counterpart of the JAX package's ``parallel/spatial.py``).

The JAX package annotates the activations' H axis onto a mesh axis and
lets GSPMD partition every conv with halo exchanges.  Here the forward runs
on :class:`Slabs`, a stand-in for an activation that holds one slab of rows
a device and takes part in torch's dispatch (``__torch_function__``):

- a convolution runs slab by slab; each slab's output rows are an equal
  share of the output, and the input rows they read, the halo of
  ``dilation * (k - 1) / 2`` rows on each side aligned to the stride, are
  copied from the neighbouring slabs (the rows past the image, its zero
  padding, are zeros);
- ``F.pad`` pads W on every slab and records the H padding as zero rows
  past the first and last slabs, which the next convolution reads;
- elementwise work and a permute that keeps the split axis run a slab at a
  time;
- any other op, or a conv whose output H the slab count does not divide,
  gathers the slabs onto the first device and runs there; an upsample's
  result is split again, as GSPMD reshards (the heads' reshapes stay
  gathered).

The wrapper counts the layers (convolutions) it ran split and the ops it
ran gathered, ``split_layers`` and ``gathered_layers``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tod_tpu_torch.parallel.mesh import Mesh
from tod_tpu_torch.parallel.sharding import upload

T = torch.Tensor
_ELEMENTWISE = {
    torch.relu, F.relu, T.relu, torch.clamp, T.clamp, T.clamp_min, T.clamp_max, T.float,
    T.contiguous, T.detach, torch.add, T.add, T.__add__, T.__radd__, torch.sub, T.sub,
    T.__sub__, T.__rsub__, torch.mul, T.mul, T.__mul__, T.__rmul__, torch.div, T.div,
    T.__truediv__, torch.where, torch.maximum, torch.minimum, torch.sigmoid, torch.tanh,
    T.__gt__, T.__lt__, T.__ge__, T.__le__, T.__and__, T.__or__, T.__neg__, T.to,
}
_RESPLIT = {F.interpolate}


class _Context:
    def __init__(self, devices: list[torch.device]):
        self.devices = devices
        self.split_layers = 0
        self.gathered_layers = 0


class Slabs:
    """A tensor split over ``axis`` into one slab a device.  ``slabs[i]``
    holds rows ``[bounds[i], bounds[i + 1])`` of the data; the logical
    tensor has ``pad[0]`` zero rows before the data and ``pad[1]`` after."""

    def __init__(self, ctx: _Context, slabs: list[torch.Tensor], axis: int,
                 pad: tuple[int, int] = (0, 0)):
        self.ctx, self.slabs, self.axis, self.pad = ctx, slabs, axis, pad
        sizes = [s.shape[axis] for s in slabs]
        self.bounds = [sum(sizes[:i]) for i in range(len(sizes) + 1)]

    @classmethod
    def split(cls, ctx: _Context, x: torch.Tensor, axis: int) -> "Slabs":
        n = len(ctx.devices)
        return cls(ctx, [upload(p, d) for p, d in zip(x.chunk(n, axis), ctx.devices)], axis)

    # --- metadata ---------------------------------------------------------
    @property
    def shape(self) -> torch.Size:
        s = list(self.slabs[0].shape)
        s[self.axis] = self.bounds[-1] + sum(self.pad)
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.slabs[0].dtype

    @property
    def device(self) -> torch.device:
        return self.ctx.devices[0]

    @property
    def ndim(self) -> int:
        return self.slabs[0].dim()

    def dim(self) -> int:
        return self.ndim

    def size(self, d=None):
        return self.shape if d is None else self.shape[d]

    # --- rows -------------------------------------------------------------
    def rows(self, lo: int, hi: int, device: torch.device) -> torch.Tensor:
        """Logical rows ``[lo, hi)`` on ``device``; rows outside the data
        (padding, or past the tensor) are zeros."""
        pieces, at = [], lo
        top = self.pad[0]
        for slab, b0, b1 in zip(self.slabs, self.bounds, self.bounds[1:]):
            s0, s1 = max(lo, top + b0), min(hi, top + b1)
            if s0 >= s1:
                continue
            if s0 > at:
                pieces.append(self._zeros(s0 - at, device))
            pieces.append(upload(slab.narrow(self.axis, s0 - top - b0, s1 - s0), device))
            at = s1
        if hi > at:
            pieces.append(self._zeros(hi - at, device))
        return torch.cat(pieces, dim=self.axis)

    def _zeros(self, n: int, device) -> torch.Tensor:
        s = list(self.slabs[0].shape)
        s[self.axis] = n
        return torch.zeros(s, dtype=self.dtype, device=device)

    def whole(self) -> torch.Tensor:
        return self.rows(0, self.shape[self.axis], self.ctx.devices[0])

    # --- dispatch ---------------------------------------------------------
    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        method = getattr(torch.Tensor, name)
        return lambda *a, **k: Slabs.__torch_function__(method, (Slabs,), (self, *a), k)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ctx = next(a.ctx for a in _leaves((args, kwargs)) if isinstance(a, Slabs))
        if func is T.dim or func is T.size:
            return getattr(args[0], func.__name__)(*args[1:], **kwargs)
        if func is F.conv2d:
            return _conv2d(ctx, *args, **kwargs)
        if func is F.pad:
            out = _pad(*args, **kwargs)
            if out is not None:
                return out
        elif func is T.permute:
            return _permute(*args, **kwargs)
        elif func in _ELEMENTWISE:
            out = _elementwise(ctx, func, args, kwargs)
            if out is not None:
                return out
        ctx.gathered_layers += 1
        out = func(*_map(args, _gather), **_map(kwargs, _gather))
        if (func in _RESPLIT and isinstance(out, torch.Tensor) and out.dim() == 4
                and out.shape[2] % len(ctx.devices) == 0):
            return Slabs.split(ctx, out, 2)
        return out


def _dunder(name):
    method = getattr(torch.Tensor, name)
    return lambda self, *a: Slabs.__torch_function__(method, (Slabs,), (self, *a))


for _name in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
              "__truediv__", "__gt__", "__lt__", "__ge__", "__le__", "__and__", "__or__",
              "__neg__"):
    setattr(Slabs, _name, _dunder(_name))


def _leaves(x):
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    else:
        yield x


def _map(x, fn):
    if isinstance(x, tuple):
        return tuple(_map(v, fn) for v in x)
    if isinstance(x, list):
        return [_map(v, fn) for v in x]
    if isinstance(x, dict):
        return {k: _map(v, fn) for k, v in x.items()}
    return fn(x)


def _gather(x):
    return x.whole() if isinstance(x, Slabs) else x


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv2d(ctx: _Context, x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    if not isinstance(x, Slabs) or x.axis != 2 or isinstance(padding, str):
        ctx.gathered_layers += 1
        return F.conv2d(_gather(x), weight, bias, stride, padding, dilation, groups)
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    kh = weight.shape[2]
    h = x.shape[2]
    h_out = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    n = len(ctx.devices)
    if h_out % n:
        ctx.gathered_layers += 1
        return F.conv2d(x.whole(), weight, bias, stride, padding, dilation, groups)
    ctx.split_layers += 1
    per = h_out // n
    slabs = []
    for i, dev in enumerate(ctx.devices):
        o0, o1 = i * per, (i + 1) * per
        lo = o0 * sh - ph
        hi = (o1 - 1) * sh - ph + dh * (kh - 1) + 1
        b = None if bias is None else upload(bias, dev)
        slabs.append(F.conv2d(x.rows(lo, hi, dev), upload(weight, dev), b, (sh, sw), (0, pw),
                              (dh, dw), groups))
    return Slabs(ctx, slabs, 2)


def _pad(x, pad, mode="constant", value=None):
    if (not isinstance(x, Slabs) or mode != "constant" or value not in (None, 0, 0.0)
            or x.axis != x.ndim - 2 or len(pad) not in (2, 4) or min(pad) < 0):
        return None
    wl, wr = pad[:2]
    ht, hb = pad[2:] if len(pad) == 4 else (0, 0)
    slabs = [F.pad(s, (wl, wr)) for s in x.slabs]
    return Slabs(x.ctx, slabs, x.axis, (x.pad[0] + ht, x.pad[1] + hb))


def _permute(x, *dims):
    dims = tuple(dims[0]) if len(dims) == 1 and not isinstance(dims[0], int) else dims
    if sum(x.pad):
        x = Slabs.split(x.ctx, x.whole(), x.axis)
    return Slabs(x.ctx, [s.permute(*dims) for s in x.slabs], dims.index(x.axis))


def _elementwise(ctx: _Context, func, args, kwargs):
    slabs = [a for a in _leaves((args, kwargs)) if isinstance(a, Slabs)]
    ref = slabs[0]
    if any(s.axis != ref.axis or s.bounds != ref.bounds or sum(s.pad) for s in slabs):
        return None
    if any(isinstance(a, (torch.device, str)) for a in _leaves((args, kwargs))):
        return None  # a move, not elementwise work
    h = ref.bounds[-1]

    def piece(i, dev):
        def part(a):
            if isinstance(a, Slabs):
                return a.slabs[i]
            if (isinstance(a, torch.Tensor) and a.dim() == ref.ndim
                    and a.shape[ref.axis] == h and h > 1):
                return upload(a.narrow(ref.axis, ref.bounds[i], ref.bounds[i + 1]
                                       - ref.bounds[i]), dev)
            if isinstance(a, torch.Tensor) and a.dim() > 0:
                return upload(a, dev)
            return a
        return part

    outs = []
    for i, dev in enumerate(ctx.devices):
        part = piece(i, dev)
        outs.append(func(*_map(args, part), **_map(kwargs, part)))
    return Slabs(ctx, outs, ref.axis)


@dataclasses.dataclass
class SpatialForward:
    """``forward(params, images)``: ``apply_fn`` with the NHWC images split
    over H into one slab a device of the mesh axis; the outputs whole on
    the first device.  ``split_layers`` / ``gathered_layers``: the counts of
    the last call."""

    apply_fn: object
    devices: list
    split_layers: int = 0
    gathered_layers: int = 0

    def __call__(self, params, images: torch.Tensor):
        n = len(self.devices)
        if images.shape[1] % n:
            raise ValueError(f"image height {images.shape[1]} not divisible by {n} slabs")
        ctx = _Context(self.devices)
        out = self.apply_fn(params, Slabs.split(ctx, images, 1))
        self.split_layers, self.gathered_layers = ctx.split_layers, ctx.gathered_layers
        return _map_out(out)


def _map_out(x):
    if isinstance(x, Slabs):
        return x.whole()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: _map_out(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(_map_out(v) for v in x)
    if isinstance(x, dict):
        return {k: _map_out(v) for k, v in x.items()}
    return x


def spatial_sharded_forward(apply_fn, mesh: Mesh, axis: str = "dp") -> SpatialForward:
    """Wrap ``apply_fn(params, images)`` so that the images' H axis (NHWC
    dim 1) is split over the devices of the mesh axis ``axis`` (the first
    device of each row or column of the other axis)."""
    devices = list(mesh.devices[:, 0] if axis == "dp" else mesh.devices[0, :])
    return SpatialForward(apply_fn, devices)


__all__ = ["Slabs", "SpatialForward", "spatial_sharded_forward"]
