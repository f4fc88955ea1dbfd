"""Sharding rules and the train step over a mesh (counterpart of the JAX
package's ``parallel/sharding.py``).

The layout rule is the JAX package's ``_leaf_spec``: a conv kernel or a
dense kernel whose output-channel count ``tp`` divides is sharded over
``tp`` on that axis; every other leaf (biases, BatchNorms, scalars, odd
widths) is replicated.  torch's layouts put the output channels first: dim
0 of a conv weight ``(cout, cin / groups, kh, kw)`` and of a ``Linear``
weight ``(out_features, in_features)``.  A spec is a tuple of axis names a
dim, as ``PartitionSpec`` is: ``("tp", None, None, None)`` sharded, ``()``
replicated.  Leaves are named as the state dict names them, the names the
weight carry (``core/weights.py``) maps to the Flax tree's.

The JAX package's sharded step is one global program whose answer is the
unsharded step's.  Here each slot of the mesh is a process
(``parallel/mesh.py``) that computes its piece, and the pieces are joined
so that the answer stays the unsharded step's:

- every slot draws the same global batch and takes its ``dp`` slice;
  the loss is the mean of per-example losses, so each slot's gradient is
  summed over ``dp`` and divided by ``dp`` (a batch ``dp`` does not divide
  is refused);
- BatchNorm normalises by the global batch's statistics, as Flax's
  ``BatchNorm`` does under ``jit`` over a mesh: each ``TrainBatchNorm``
  averages its per-channel means of x and x^2 (float64) over ``dp`` with an
  all-reduce whose backward is an all-reduce, so the gradient through the
  global statistics is the global one too (with ``dp = 1`` it keeps the
  batch's own, the unsharded step's operations);
- a tp-sharded conv holds its slice of the output channels and computes
  them from the whole input; the slices are gathered before the next layer
  (a depthwise conv takes the gathered input's channels of its slice).
  Everything after the gather is computed alike on every tp slot, so the
  gather's backward hands each slot its slice of the gradient, and the
  input's gradient, a sum over the slices, is all-reduced over ``tp``
  (``torch.distributed.nn.functional.all_gather`` would sum the identical
  copies instead);
- the AdamW moments are sharded like their parameters, and
  ``clip_by_global_norm``'s norm sums each sharded leaf's squares over
  ``tp`` and each replicated leaf's once.

Inference runs in one process, as the port's other serving paths do:
each ``dp`` row of the mesh serves its slice of the batch, and within a
row each serving conv site that the rule shards (``TPServeSite``) computes
its output channels' pieces on the row's ``tp`` devices and joins them on
the row's first device before the next layer; the rest of the graph runs
there, replicated.  An int8 model's ``QConv`` sites stay replicated.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Mapping

import torch

from tod_tpu_torch.parallel.mesh import Mesh

REPLICATED: tuple = ()


def _leaf_spec(shape, tp_size: int) -> tuple:
    shape = tuple(shape)
    if len(shape) == 4 and tp_size > 1 and shape[0] % tp_size == 0:
        return ("tp", None, None, None)  # conv weight (cout, cin/g, kh, kw)
    if len(shape) == 2 and tp_size > 1 and shape[0] % tp_size == 0:
        return ("tp", None)  # Linear weight (out, in)
    return REPLICATED


def _named(tree) -> dict[str, Any]:
    if isinstance(tree, torch.nn.Module):
        return dict(tree.state_dict())
    return dict(tree)


def param_sharding_tree(tree, mesh: Mesh) -> dict[str, tuple]:
    """``{name: spec}`` for a state dict (or a module's)."""
    tp = mesh.shape["tp"]
    return {name: _leaf_spec(getattr(v, "shape", ()), tp) for name, v in _named(tree).items()}


def batch_sharding(tree, mesh: Mesh) -> dict[str, tuple]:
    """Every leaf of a batch split over ``dp`` on its leading axis."""
    return {name: ("dp",) for name in _named(tree)}


def state_sharding_tree(state, mesh: Mesh) -> dict:
    """The spec tree of a ``train.trainer.TrainState``: its parameters, the
    AdamW moments and the BatchNorm statistics by the tp rule, the count
    and the step replicated."""
    opt = state.opt_state
    return {
        "params": param_sharding_tree(state.params, mesh),
        "batch_stats": param_sharding_tree(state.batch_stats, mesh),
        "opt_state": {"count": REPLICATED, "mu": param_sharding_tree(opt["mu"], mesh),
                      "nu": param_sharding_tree(opt["nu"], mesh)},
        "step": REPLICATED,
    }


# --- collectives with a backward ------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the gradient of each slot's input is the sum of
    the slots' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToTP(torch.autograd.Function):
    """The identity; the backward sums the input's gradient over ``tp``
    (each slot's conv slice contributes its part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherTP(torch.autograd.Function):
    """All-gather over ``tp`` on the channel axis; the backward is this
    slot's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        import torch.distributed as dist

        ctx.rank, ctx.width = rank, x.shape[1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.rank * ctx.width, ctx.width).contiguous(), None, None, None


def dp_moments(xf: torch.Tensor, group, n: int):
    """The global batch's per-channel E[x] and E[x^2] (f32) from this
    slot's NCHW f32 activations: the mean of the slots' means (equal
    shards), each slot's in float64, so that the reassociated sum rounds
    once, at the end."""
    x = xf.double()
    both = torch.stack([x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))])
    both = (_AllReduceSum.apply(both, group) / n).float()
    return both[0], both[1]


# --- the tensor-parallel conv site ----------------------------------------

class TPSite:
    """Mixed into a training conv site (``TrainConv``, ``QATConv``) whose
    output channels are sharded over ``tp``: the weight is this slot's
    slice, the bias stays whole and is added after the gather."""

    def tp_forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToTP.apply(x, self.tp_group)
        if self.tp_depthwise:
            n = self.weight.shape[0]
            x = x.narrow(1, self.tp_rank * n, n)
        y = self.compute(x)
        y = _GatherTP.apply(y, self.tp_group, self.tp_rank, self.tp_size)
        return self.finish(y)


def _tp_class(cls):
    return _TP_CLASSES.setdefault(cls, type(f"TP{cls.__name__}", (TPSite, cls),
                                            {"forward": TPSite.tp_forward}))


_TP_CLASSES: dict = {}


@dataclasses.dataclass
class SlotLayout:
    """One slot's place in the mesh and what it holds: its ``dp`` and
    ``tp`` indices and groups, and the spec of every state-dict entry."""

    dp: int
    tp: int
    dp_index: int
    tp_index: int
    dp_group: Any
    tp_group: Any
    specs: dict[str, tuple]

    @classmethod
    def of(cls, mesh: Mesh, state: Mapping[str, torch.Tensor]) -> "SlotLayout":
        if not mesh.joined:
            raise ValueError("a train step over a mesh runs in a slot's process: join the "
                             "mesh first (parallel.mesh.join, or parallel.mesh.launch)")
        dm = mesh.device_mesh
        return cls(dp=mesh.shape["dp"], tp=mesh.shape["tp"],
                   dp_index=dm.get_local_rank("dp"), tp_index=dm.get_local_rank("tp"),
                   dp_group=dm.get_group("dp"), tp_group=dm.get_group("tp"),
                   specs=param_sharding_tree(state, mesh))

    def sharded(self, name: str) -> bool:
        return bool(self.specs.get(name))

    def local_rows(self, n: int) -> slice:
        """This slot's ``dp`` slice of a batch of ``n``."""
        if n % self.dp:
            raise ValueError(f"batch {n} not divisible by dp={self.dp}")
        k = n // self.dp
        return slice(self.dp_index * k, (self.dp_index + 1) * k)

    def local_batch(self, batch: Mapping, axis: int = 0) -> dict:
        """This slot's ``dp`` slice of every field of a batch (numpy
        arrays or tensors), on ``axis`` (1 for a stacked chunk)."""
        rows = self.local_rows(next(iter(batch.values())).shape[axis])
        index = (slice(None),) * axis + (rows,)
        return {k: v[index] for k, v in batch.items()}

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This slot's piece of the whole tensor ``full`` named ``name``."""
        if not self.sharded(name):
            return full
        n = full.shape[0] // self.tp
        return full.narrow(0, self.tp_index * n, n)

    def full(self, name: str, piece: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every slot's piece (a collective over
        ``tp``: every slot calls it)."""
        if not self.sharded(name):
            return piece
        import torch.distributed as dist

        piece = piece.detach().contiguous()
        parts = [torch.empty_like(piece) for _ in range(self.tp)]
        dist.all_gather(parts, piece, group=self.tp_group)
        return torch.cat(parts, dim=0)

    def mean_over_dp_(self, tensors: list[torch.Tensor]) -> None:
        """Each tensor replaced in place by its mean over ``dp`` (one
        all-reduce of them all, flattened)."""
        import torch.distributed as dist

        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.dp_group)
        flat /= self.dp
        torch._foreach_copy_(tensors, [p.view_as(t) for p, t in
                                       zip(flat.split([t.numel() for t in tensors]), tensors)])

    def mean_metrics(self, metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """0-dim metrics -> their means over ``dp`` (the global batch's)."""
        values = [v.clone() for v in metrics.values()]
        self.mean_over_dp_(values)
        return dict(zip(metrics, values))


def shard_model(model: torch.nn.Module, mesh: Mesh) -> SlotLayout:
    """Shard a model built for training over ``mesh`` in place, for this
    process's slot: each conv site the rule shards keeps its slice of the
    output channels (``TPSite``), and every ``TrainBatchNorm`` takes the
    global batch's statistics over ``dp``.  Call before the optimizer is
    made (it replaces the sharded weights)."""
    from tod_tpu_torch.models.conv import TrainConv
    from tod_tpu_torch.models.resnet import TrainBatchNorm

    layout = SlotLayout.of(mesh, model.state_dict())
    for name, m in model.named_modules():
        if isinstance(m, TrainBatchNorm) and layout.dp > 1:
            m.moments_over = functools.partial(dp_moments, group=layout.dp_group, n=layout.dp)
        elif isinstance(m, TrainConv) and layout.sharded(f"{name}.weight"):
            cout = m.weight.shape[0]
            if m.groups not in (1, cout):
                raise ValueError(f"{name}: a grouped conv that is not depthwise cannot shard")
            depthwise = m.groups > 1
            m.weight = torch.nn.Parameter(layout.local(f"{name}.weight", m.weight.detach())
                                          .clone())
            m.__class__ = _tp_class(type(m))
            m.tp_group, m.tp_rank, m.tp_size = layout.tp_group, layout.tp_index, layout.tp
            m.tp_depthwise = depthwise
            if depthwise:
                m.groups = m.weight.shape[0]
    return layout


def tp_global_norm(grads, sharded: list[bool], group) -> torch.Tensor:
    """``||g||`` of the whole gradient from this slot's pieces: the sharded
    leaves' squares summed over ``tp``, the replicated leaves' once."""
    sq = torch.stack(torch._foreach_norm(grads)) ** 2
    mask = torch.tensor(sharded, device=sq.device)
    zero = torch.zeros((), dtype=sq.dtype, device=sq.device)
    part = torch.where(mask, sq, zero).sum()
    part = _AllReduceSum.apply(part, group)
    return torch.sqrt(part + torch.where(mask, zero, sq).sum())


def shard_train_step(model, anchors: torch.Tensor, tcfg, mesh: Mesh):
    """Shard ``model`` over ``mesh`` (:func:`shard_model`) and build its
    optimizer and step -> ``(step, opt, layout)``.

    ``step(local_batch, index, mark=None) -> metrics`` is
    ``train.trainer.make_train_step``'s step given this slot's layout: it
    runs on the slot's ``dp`` slice of the global batch and answers for the
    global batch.  Works for any ``(dp, tp)``, ``(n, 1)`` and ``(1, n)``
    too."""
    from tod_tpu_torch.train.trainer import AdamW, make_train_step

    layout = shard_model(model, mesh)
    norm = None
    if layout.tp > 1:
        sharded = [layout.sharded(n) for n, _ in model.named_parameters()]
        norm = functools.partial(tp_global_norm, sharded=sharded, group=layout.tp_group)
    opt = AdamW(model.parameters(), tcfg, global_norm=norm)
    return make_train_step(model, anchors, opt, tcfg, layout=layout), opt, layout


def shard_chunk_step(step: Callable):
    """The chunked form of a train step, sharded or not:
    ``chunk_step(stacked, first_index) -> metrics of the last step``, with
    ``stacked`` the staged ``(chunk, B, ...)`` batches (over a mesh this
    slot's ``(chunk, B / dp, ...)`` slice), run as a loop of steps: the
    same update sequence as ``chunk`` single steps."""

    def chunk_step(stacked: dict, first_index: int) -> dict[str, torch.Tensor]:
        metrics = {}
        for i in range(next(iter(stacked.values())).shape[0]):
            metrics = step({k: v[i] for k, v in stacked.items()}, first_index + i)
        return metrics

    return chunk_step


# --- inference ------------------------------------------------------------

def split_batch(x: torch.Tensor, devices: list[torch.device]) -> list[torch.Tensor]:
    """``x`` split on its leading axis into one piece a device, each copied
    to its device without waiting (from pinned memory off a card)."""
    n = x.shape[0]
    if n % len(devices):
        raise ValueError(f"batch {n} not divisible by dp={len(devices)}")
    return [upload(piece, dev) for piece, dev in zip(x.chunk(len(devices)), devices)]


def upload(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``; a CPU tensor bound for a card is pinned first,
    so that the copy does not wait."""
    if x.device == device:
        return x
    if x.device.type == "cpu" and device.type == "cuda":
        x = x.pin_memory()
    return x.to(device, non_blocking=True)


def gather_tree(outs: list, device: torch.device):
    """The per-device outputs joined on their leading axis on ``device``
    (tensors, dataclasses, tuples, lists and dicts of them)."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([upload(o, device) for o in outs])
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: gather_tree([getattr(o, f.name) for o in outs], device)
                              for f in dataclasses.fields(first)})
    if isinstance(first, (tuple, list)):
        return type(first)(gather_tree(list(parts), device) for parts in zip(*outs))
    if isinstance(first, dict):
        return {k: gather_tree([o[k] for o in outs], device) for k in first}
    raise TypeError(f"cannot gather {type(first).__name__}")


def dp_devices(mesh: Mesh) -> list[torch.device]:
    """The device of each ``dp`` row (its first ``tp`` slot): in one
    process the rows are the replicas."""
    return list(mesh.devices[:, 0])


class TPServeSite:
    """Mixed into a serving conv site (``models/conv.py``'s ``Conv`` and
    its forms) whose output channels are split over ``tp_devices``, the
    ``tp`` devices of a ``dp`` row: each device computes its slice of the
    output channels from the whole input (a depthwise site from its slice
    of the input's channels), with its slice of the weight and the bias
    copied there, and the slices are joined on the input's device."""

    def tp_forward(self, x: torch.Tensor) -> torch.Tensor:
        devices = self.tp_devices
        n = self.weight.shape[0] // len(devices)
        depthwise = self.groups > 1
        parts = []
        for j, dev in enumerate(devices):
            w = upload(self.weight.narrow(0, j * n, n), dev)
            b = upload(self.bias.narrow(0, j * n, n), dev)
            xj = upload(x.narrow(1, j * n, n) if depthwise else x, dev)
            parts.append(self.conv(xj, w, b, n if depthwise else 1))
        return torch.cat([upload(p, x.device) for p in parts], dim=1)


def _tp_serve_class(cls):
    return _TP_SERVE_CLASSES.setdefault(
        cls, type(f"TPServe{cls.__name__}", (TPServeSite, cls), {"forward": TPServeSite.tp_forward}))


_TP_SERVE_CLASSES: dict = {}


@contextlib.contextmanager
def tp_sharded(model: torch.nn.Module, devices: list[torch.device]):
    """While the block runs, every serving conv site of ``model`` whose
    output channels ``len(devices)`` divides (the layout rule) computes its
    slices on ``devices`` (``TPServeSite``); the classes are restored after.
    One device leaves the model as it is."""
    from tod_tpu_torch.models.conv import Conv, TrainConv

    swapped = []
    try:
        if len(devices) > 1:
            for m in model.modules():
                if (isinstance(m, Conv) and not isinstance(m, TrainConv)
                        and _leaf_spec(m.weight.shape, len(devices))):
                    swapped.append((m, type(m)))
                    m.__class__ = _tp_serve_class(type(m))
                    m.tp_devices = list(devices)
        yield
    finally:
        for m, cls in swapped:
            m.__class__ = cls
            del m.tp_devices


def shard_inference(fn: Callable, mesh: Mesh, model: torch.nn.Module | None = None):
    """``jit_with(params) -> run``, the JAX package's call shape;
    ``run(params, batch)`` applies ``fn(params, batch)`` to each ``dp``
    row's piece of ``batch`` on that row's device, with a replica of
    ``params`` there copied at each call (none on a row whose device holds
    ``params``), and joins the outputs in batch order on the first device.
    With ``tp > 1``, ``model`` is the module whose conv sites ``fn`` runs
    (``torch.func.functional_call(model, params, ...)``): within each row
    they are split over the row's ``tp`` devices (:func:`tp_sharded`).
    Every ``params`` gets the same ``run``."""
    devices = dp_devices(mesh)
    rows = [list(row) for row in mesh.devices]
    if mesh.shape["tp"] > 1 and model is None:
        raise ValueError("shard_inference over tp > 1 needs the model whose conv sites fn runs")

    def run(p: Mapping[str, torch.Tensor], batch: torch.Tensor):
        pieces = split_batch(batch, devices)
        outs = []
        for piece, dev, row in zip(pieces, devices, rows):
            with tp_sharded(model, row):
                outs.append(fn({k: upload(v, dev) for k, v in p.items()}, piece))
        return gather_tree(outs, devices[0])

    return lambda params: run
