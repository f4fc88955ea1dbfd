"""Shared prediction head and semantic head (counterpart of
the JAX package's ``models/heads.py``)."""

from __future__ import annotations

import torch
from torch import nn

from tod_tpu_torch.models.qconv import make_conv


def _per_anchor(x: torch.Tensor, width: int) -> torch.Tensor:
    """(B, A*X, H, W) -> (B, H*W*A, X), position-major like the anchors."""
    b = x.shape[0]
    return x.permute(0, 2, 3, 1).reshape(b, -1, width)


class PredictionHead(nn.Module):
    """One parameter set applied to every pyramid level: a 3x3 tower, then
    box offsets, class logits and raw mask coefficients per anchor."""

    def __init__(self, cin: int, num_classes: int, num_anchors: int,
                 num_prototypes: int, channels: int = 128, quantized: bool = False):
        super().__init__()
        a, q = num_anchors, quantized
        self.num_classes, self.num_prototypes = num_classes, num_prototypes
        self.tower = make_conv(q, cin, channels, 3)
        self.loc = make_conv(q, channels, a * 4, 3)
        self.conf = make_conv(q, channels, a * num_classes, 3)
        self.coeff = make_conv(q, channels, a * num_prototypes, 3)

    def forward(self, p: torch.Tensor):
        x = torch.relu(self.tower(p))
        return (
            _per_anchor(self.loc(x), 4),
            _per_anchor(self.conf(x), self.num_classes),
            _per_anchor(self.coeff(x), self.num_prototypes),
        )


class SemanticHead(nn.Module):
    """1x1 conv on P3 -> per-pixel class logits at stride 8, f32 NHWC."""

    def __init__(self, cin: int, num_classes: int, quantized: bool = False):
        super().__init__()
        self.sem_out = make_conv(quantized, cin, num_classes, 1)

    def forward(self, p3: torch.Tensor) -> torch.Tensor:
        return self.sem_out(p3).float().permute(0, 2, 3, 1)
