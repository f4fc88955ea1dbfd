"""Model FLOPs counted on the plain reference at a cell's shapes, on the
meta device (no memory, no time): ``FlopCounterMode`` counts the
convolutions and matrix products, two FLOPs a multiply-add.  The count is
the benchmark's own: a change to the program does not change it."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import model as ref


@functools.lru_cache(maxsize=None)
def _count(mcfg_json: str, batch: int) -> float:
    mcfg = json.loads(mcfg_json)
    h, w = mcfg["input_size"]
    x = torch.empty((batch, h, w, 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        ref.forward({k: torch.empty(s, device="meta") for k, s in ref.param_shapes(mcfg).items()},
                    x, mcfg)
    return float(counter.get_total_flops())


def forward_flops(mcfg: dict, batch: int) -> float:
    """FLOPs of one forward of ``batch`` images."""
    return _count(json.dumps(mcfg, sort_keys=True), batch)


def train_flops(mcfg: dict, batch: int) -> float:
    """FLOPs of one forward and backward of ``batch`` images: each conv's
    products once forward, once for its kernel's gradient and once for its
    input's, but the first conv's input gradient, which nothing needs.  (The
    counter's own count of a convolution's backward ignores its groups, and
    so counts a depthwise conv's as a dense one's.)"""
    _, cin, cout, k, stride, _, _, _ = ref.sites(mcfg)[0]
    h, w = mcfg["input_size"]
    stem = 2 * batch * -(-h // stride) * -(-w // stride) * cout * cin * k * k
    return 3 * forward_flops(mcfg, batch) - stem
