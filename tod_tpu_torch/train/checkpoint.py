"""Checkpoints of training, in torch's and numpy's formats (counterpart of
the JAX package's ``train/checkpoint.py``, which writes orbax directories).

- The serving tree (``Trainer.save``) is an ``.npz`` in the JAX package's
  key layout (``params/...``, ``batch_stats/...``, unfolded):
  ``core.weights.load_checkpoint`` folds it for serving, so a trained model
  serves through ``--checkpoint`` and warm-starts through ``--init-from``.
- The full training state (``Trainer.save_state``) is one ``torch.save``
  file: parameters, BatchNorm statistics, the optimizer's moments and count,
  and the step.

Both are written crash-safe: to a sibling temporary file, then renamed over
the target, so at every instant one complete checkpoint is on disk (the
best-checkpoint keeper rewrites the same path for hours of training).
"""

from __future__ import annotations

import os
import pathlib
from typing import Any, Mapping

import numpy as np
import torch


def _replace(path: str | pathlib.Path, write) -> pathlib.Path:
    """``write(file)`` into ``path``'s sibling ``.saving`` file, then rename
    it over ``path``."""
    path = pathlib.Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".saving")
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def save_tree(path: str | pathlib.Path, tree: Mapping[str, np.ndarray]) -> pathlib.Path:
    """Write a flat tree of numpy arrays as an ``.npz`` (``np.savez``)."""
    return _replace(path, lambda f: np.savez(f, **tree))


def save_state(path: str | pathlib.Path, state: Mapping[str, Any]) -> pathlib.Path:
    """Write a training state with ``torch.save`` (tensors moved to the
    CPU first)."""
    def cpu(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu()
        if isinstance(v, Mapping):
            return {k: cpu(x) for k, x in v.items()}
        return v

    return _replace(path, lambda f: torch.save(cpu(state), f))


def load_state(path: str | pathlib.Path) -> dict:
    """Read a :func:`save_state` file (tensors only, no pickled code)."""
    return torch.load(pathlib.Path(path), map_location="cpu", weights_only=True)
