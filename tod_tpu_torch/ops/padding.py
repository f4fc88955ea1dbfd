"""Flax's SAME padding, shared by the model's convolutions and the int8
kernel's wrapper (which an exported graph loads without the model code)."""

from __future__ import annotations

import math


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of one axis under SAME."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2
