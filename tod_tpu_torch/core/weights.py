"""Carry the Flax checkpoint tree across to the port's state dict.

The input is a flat dict of numpy arrays keyed by the Flax tree path
(``params/...`` and ``batch_stats/...``), the tree of the pinned checkpoint
``checkpoints/yolact_dr``.  Each Conv->BatchNorm pair is folded as
the JAX package's ``models/prepare.py::fold_batchnorm`` folds it (eps 1e-5, in float64,
stored as float32): the kernel absorbs ``gamma / sqrt(var + eps)`` and the BN
becomes the conv's bias ``beta - mean * gamma / sqrt(var + eps)``.  Kernels go
from HWIO to OIHW; a depthwise kernel ``(3, 3, 1, C)`` becomes ``(C, 1, 3, 3)``
by the same transpose.  A tree prepared for int8 serving (the JAX
``prepare_int8_params``: folded, ``kernel_q`` s8 with ``w_scale`` and
``act_scale``, bfloat16 depthwise kernels) comes across as it is, its BN
biases as the sites' biases; ``models.qconv.load_prepared`` loads it.
Only ``Conv_0`` + ``BatchNorm_0`` pairs fold (the JAX rule): a ResNet
block's BatchNorms come across unfolded (``scale``, ``bias``, ``mean``,
``var``) and its bias-less convs get a zero bias.  Every leaf must be consumed and every state entry filled with the right
shape, or the carry-across raises.

``carry_state`` carries the serving state across too: a track bank and an
obstacle memory of the JAX package's tracked steps.

``load_pinned`` reads ``tod_tpu_torch/weights/yolact_dr.npz``: the same tree,
written once from the JAX checkpoint and committed, so that the port needs
neither orbax nor msgpack.  ``load_checkpoint`` reads any other checkpoint
converted to that layout on the JAX side by
``python tests/test_torch_weights.py --write CKPT_DIR OUT.npz``.
"""

from __future__ import annotations

import pathlib
from typing import Mapping

import numpy as np
import torch
from torch import nn

PINNED = pathlib.Path(__file__).resolve().parents[1] / "weights" / "yolact_dr.npz"
BN_EPS = 1e-5


def carry_across(tree: Mapping[str, np.ndarray],
                 model: nn.Module | None = None) -> dict[str, torch.Tensor]:
    """Flat Flax tree -> state dict of CPU tensors (float32, or the prepared
    tree's types).

    With ``model`` given, the result must match its state dict key for key
    and shape for shape.
    """
    used: set[str] = set()

    def take(key: str) -> np.ndarray:
        if key not in tree:
            raise KeyError(f"checkpoint leaf {key!r} is missing")
        used.add(key)
        return np.asarray(tree[key])

    state: dict[str, torch.Tensor] = {}
    sites = sorted(k[len("params/"):].rpartition("/")[0] for k in tree
                   if k.startswith("params/") and k.rpartition("/")[2] in ("kernel", "kernel_q"))
    for site in sites:
        prepared = f"params/{site}/kernel_q" in tree
        key = f"params/{site}/kernel_q" if prepared else f"params/{site}/kernel"
        kernel = take(key)
        if kernel.ndim != 4:
            raise ValueError(f"{key}: expected an HWIO conv kernel, got shape {kernel.shape}")
        as_is = prepared or kernel.dtype != np.float32  # served as it is: not folded again
        parent, last = site.rpartition("/")[::2]
        if last == "Conv_0" and f"params/{parent}/BatchNorm_0/scale" in tree:
            bn = f"params/{parent}/BatchNorm_0/"
            st = f"batch_stats/{parent}/BatchNorm_0/"
            gamma = take(bn + "scale").astype(np.float64)
            beta = take(bn + "bias").astype(np.float64)
            mean = take(st + "mean").astype(np.float64)
            var = take(st + "var").astype(np.float64)
            if as_is and (np.any(gamma != 1.0) or np.any(mean != 0.0)):
                raise ValueError(f"{key}: a prepared kernel needs its BatchNorm folded")
            g = gamma / np.sqrt(var + BN_EPS)
            if not as_is:
                kernel = (kernel.astype(np.float64) * g).astype(np.float32)
            bias = (beta - mean * g).astype(np.float32)
        elif f"params/{site}/bias" in tree:
            bias = take(f"params/{site}/bias").astype(np.float32)
        else:  # a conv with no bias (a ResNet block's): a zero one
            bias = np.zeros(kernel.shape[-1], np.float32)
        name = site.replace("/", ".")
        oihw = np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))
        if prepared:
            state[name + ".kernel_q"] = torch.from_numpy(oihw.astype(np.int8))
            state[name + ".w_scale"] = torch.from_numpy(
                np.ascontiguousarray(take(f"params/{site}/w_scale"), dtype=np.float32))
            state[name + ".act_scale"] = torch.tensor(
                np.float32(take(f"params/{site}/act_scale")), dtype=torch.float32)
        else:
            dtype = getattr(torch, str(kernel.dtype))
            state[name + ".weight"] = torch.from_numpy(oihw.astype(np.float32)).to(dtype)
        state[name + ".bias"] = torch.from_numpy(np.ascontiguousarray(bias))

    # the BatchNorms no conv folded (a ResNet block's), carried as they are
    for key in sorted(k for k in tree if k.startswith("params/") and k.endswith("/scale")
                      and k not in used):
        bn = key[len("params/"):-len("/scale")]
        name = bn.replace("/", ".")
        for leaf, src in (("scale", "params"), ("bias", "params"), ("mean", "batch_stats"),
                          ("var", "batch_stats")):
            state[f"{name}.{leaf}"] = torch.from_numpy(
                np.array(take(f"{src}/{bn}/{leaf}"), dtype=np.float32))

    unused = sorted(set(tree) - used)
    if unused:
        raise ValueError(f"{len(unused)} checkpoint leaves not consumed, e.g. {unused[:3]}")
    if model is not None:
        check_state(model, state)
    return state


def check_state(model: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Raise unless ``state`` fills ``model``'s state dict exactly."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise ValueError(f"state dict mismatch: missing {missing[:3]}, extra {extra[:3]}")
    bad = [(k, tuple(state[k].shape), s) for k, s in want.items() if tuple(state[k].shape) != s]
    if bad:
        raise ValueError(f"state dict shape mismatch (key, got, want): {bad[:3]}")


def read_tree(path: str | pathlib.Path = PINNED) -> dict[str, np.ndarray]:
    """The flat Flax tree from an ``.npz`` written by ``np.savez``."""
    path = pathlib.Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"weight file {path} not found")
    with np.load(path, allow_pickle=False) as npz:
        return {k: npz[k] for k in npz.files}


CONVERTER = "python tests/test_torch_weights.py --write CKPT_DIR OUT.npz"


def load_checkpoint(path: str | pathlib.Path, cfg=None) -> dict[str, torch.Tensor]:
    """A checkpoint ``.npz`` in the pinned file's layout as the port's state
    dict (CPU, f32), checked against the model of ``cfg`` (a ModelConfig,
    the default one when None).  An orbax checkpoint directory raises with
    the command that converts it."""
    path = pathlib.Path(path)
    if path.is_dir():
        raise ValueError(f"{path} is a checkpoint directory (orbax), which the port cannot "
                         f"read: convert it to an npz on the JAX side with `{CONVERTER}`")
    return load_pinned(path, cfg)


def load_pinned(path: str | pathlib.Path = PINNED, cfg=None) -> dict[str, torch.Tensor]:
    """The pinned ``yolact_dr`` weights as the port's state dict (CPU, f32),
    checked against the default model."""
    from tod_tpu_torch.core.config import ModelConfig
    from tod_tpu_torch.models.yolact import Yolact

    return carry_across(read_tree(path), Yolact(cfg or ModelConfig()))


def carry_state(tracks: np.ndarray | None = None, memory: np.ndarray | None = None,
                device="cpu") -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The JAX package's serving state as the port's tensors on ``device``:
    a track bank (numpy ``(K, 10)``, or ``(N, K, 10)`` for the multistream
    banks) and an obstacle memory (numpy ``(H, W)``), each float32 and
    contiguous, copied (the engine updates them in place); None stays None."""
    def carry(a):
        if a is None:
            return None
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device)

    if tracks is not None and (np.ndim(tracks) not in (2, 3) or np.shape(tracks)[-1] != 10):
        raise ValueError(f"a track bank is (K, 10) or (N, K, 10), got {np.shape(tracks)}")
    if memory is not None and np.ndim(memory) != 2:
        raise ValueError(f"an obstacle memory is (H, W), got {np.shape(memory)}")
    return carry(tracks), carry(memory)
