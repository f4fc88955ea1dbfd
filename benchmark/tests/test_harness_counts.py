"""``benchmark/counts/`` against hand-counted small shapes."""

from __future__ import annotations

import json

import pytest

from benchmark.counts import flops
from benchmark.harness import BENCH
from benchmark.reference import model

def _mcfg(hw):
    m = json.loads((BENCH / "configs" / "yolact_mnv2_vga_train.json").read_text())["model"]
    m["input_size"] = list(hw)
    return m


def _hand_forward(mcfg, batch):
    """2 FLOPs a multiply-add: each site's output pixels x Cout x Cin/groups
    x k^2, with SAME padding's ceil(size / stride), plus ProtoNet's 2x
    upsample and the head applied at every pyramid level."""
    h, w = mcfg["input_size"]
    table = {s[0]: s for s in model.sites(mcfg)}
    total = 0

    def add(name, hw):
        nonlocal total
        _, cin, cout, k, stride, groups, _, _ = table[name]
        oh, ow = -(-hw[0] // stride), -(-hw[1] // stride)
        total += 2 * batch * oh * ow * cout * (cin // groups) * k * k
        return oh, ow

    size = add("MobileNetV2_0.ConvBN_0.Conv_0", (h, w))
    taps = []
    for name in [s[0] for s in model.sites(mcfg) if s[0].startswith("MobileNetV2_0.Inv")]:
        size = add(name, size)
        if name.endswith("ConvBN_2.Conv_0") or name == "MobileNetV2_0.InvertedResidual_0.ConvBN_1.Conv_0":
            taps.append((name, size))
    sizes = dict(taps)
    c3 = sizes["MobileNetV2_0.InvertedResidual_5.ConvBN_2.Conv_0"]
    c4 = sizes["MobileNetV2_0.InvertedResidual_12.ConvBN_2.Conv_0"]
    c5 = sizes["MobileNetV2_0.InvertedResidual_16.ConvBN_2.Conv_0"]
    for lat, s in (("FPN_0.lat5", c5), ("FPN_0.lat4", c4), ("FPN_0.lat3", c3)):
        add(lat, s)
    levels = [add("FPN_0.smooth3", c3), add("FPN_0.smooth4", c4), add("FPN_0.smooth5", c5)]
    levels.append(add("FPN_0.down6", levels[-1]))
    levels.append(add("FPN_0.down7", levels[-1]))
    s = c3
    for name in ("conv0", "conv1", "conv2"):
        s = add(f"ProtoNet_0.{name}", s)
    s = add("ProtoNet_0.post_up", (2 * s[0], 2 * s[1]))
    add("ProtoNet_0.proto_out", s)
    for lv in levels:
        for name in ("tower", "loc", "conf", "coeff"):
            add(f"PredictionHead_0.{name}", lv)
    add("SemanticHead_0.sem_out", c3)
    return total


@pytest.mark.parametrize("hw,batch", [((64, 80), 2), ((128, 160), 1)])
def test_forward_flops_match_a_hand_count(hw, batch):
    mcfg = _mcfg(hw)
    assert flops.forward_flops(mcfg, batch) == _hand_forward(mcfg, batch)


def test_train_flops_are_three_forwards_but_the_stems_input_gradient():
    mcfg = _mcfg((64, 80))
    stem = 2 * 2 * 32 * 40 * 32 * 3 * 9
    assert flops.train_flops(mcfg, 2) == 3 * _hand_forward(mcfg, 2) - stem

