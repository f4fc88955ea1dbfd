"""The plain reference of the YOLACT-MobileNetV2-FPN training graph.

A functional form over one flat dict of tensors keyed as the port's state
dict names them (``MobileNetV2_0.ConvBN_0.Conv_0.weight`` OIHW,
``...BatchNorm_0.scale`` / ``bias``).  Every ConvBN site is a convolution
without bias with its BatchNorm on the batch's statistics (mean and biased
variance E[x^2] - E[x]^2, clipped at 0), in float32.

The convolutions compute in the type the configuration states (``dtype``;
float32 is the witness that the graph is the program's).

Flax's SAME padding (the odd pixel at the bottom and right), ReLU6 whose
gradient is 0 at 0 and 6 (``jax.nn.relu6``), bilinear upsampling with
half-pixel centres.  Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5

# (expand_ratio, channels, num_blocks, first_stride), MobileNetV2 at width 1.0
MNV2 = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
        (6, 160, 3, 2), (6, 320, 1, 1))
TAPS = (2, 4, 6)  # the stages after which C3, C4, C5 are taken


def _divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def sites(mcfg: dict) -> list[tuple]:
    """Every conv site in forward order: ``(name, cin, cout, k, stride,
    groups, bn, act)``; ``bn`` sites have no bias and a BatchNorm named
    ``<parent>.BatchNorm_0``."""
    wm = mcfg["width_mult"]
    out = []
    cin = _divisible(32 * wm)
    out.append(("MobileNetV2_0.ConvBN_0.Conv_0", 3, cin, 3, 2, 1, True, True))
    idx = 0
    for t, c, n, s in MNV2:
        feats = _divisible(c * wm)
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = cin * t
            base = f"MobileNetV2_0.InvertedResidual_{idx}"
            j = 0
            if t != 1:
                out.append((f"{base}.ConvBN_{j}.Conv_0", cin, hidden, 1, 1, 1, True, True))
                j += 1
            out.append((f"{base}.ConvBN_{j}.Conv_0", hidden, hidden, 3, stride, hidden, True,
                        True))
            out.append((f"{base}.ConvBN_{j + 1}.Conv_0", hidden, feats, 1, 1, 1, True, False))
            cin = feats
            idx += 1
    ch = mcfg["fpn_channels"]
    c3, c4, c5 = (_divisible(MNV2[s][1] * wm) for s in TAPS)
    out += [("FPN_0.lat5", c5, ch, 1, 1, 1, False, False),
            ("FPN_0.lat4", c4, ch, 1, 1, 1, False, False),
            ("FPN_0.lat3", c3, ch, 1, 1, 1, False, False)]
    out += [(f"FPN_0.smooth{i}", ch, ch, 3, 1, 1, False, False) for i in (3, 4, 5)]
    out += [(f"FPN_0.down{6 + i}", ch, ch, 3, 2, 1, False, False)
            for i in range(mcfg["fpn_levels"] - 3)]
    pc, k = mcfg["proto_channels"], mcfg["num_prototypes"]
    out += [("ProtoNet_0.conv0", ch, pc, 3, 1, 1, False, False),
            ("ProtoNet_0.conv1", pc, pc, 3, 1, 1, False, False),
            ("ProtoNet_0.conv2", pc, pc, 3, 1, 1, False, False),
            ("ProtoNet_0.post_up", pc, pc, 3, 1, 1, False, False),
            ("ProtoNet_0.proto_out", pc, k, 1, 1, 1, False, False)]
    a = len(mcfg["anchor_aspect_ratios"]) * len(mcfg["anchor_scale_mults"])
    hc = mcfg["head_channels"]
    out += [("PredictionHead_0.tower", ch, hc, 3, 1, 1, False, False),
            ("PredictionHead_0.loc", hc, a * 4, 3, 1, 1, False, False),
            ("PredictionHead_0.conf", hc, a * mcfg["det_num_classes"], 3, 1, 1, False, False),
            ("PredictionHead_0.coeff", hc, a * k, 3, 1, 1, False, False),
            ("SemanticHead_0.sem_out", ch, mcfg["num_classes"], 1, 1, 1, False, False)]
    return out


def param_shapes(mcfg: dict) -> dict[str, tuple[int, ...]]:
    """The trainable tensors of the graph, by name."""
    shapes = {}
    for name, cin, cout, k, _, groups, bn, _ in sites(mcfg):
        shapes[name + ".weight"] = (cout, cin // groups, k, k)
        if bn:
            parent = name.rpartition(".")[0]
            shapes[parent + ".BatchNorm_0.scale"] = (cout,)
            shapes[parent + ".BatchNorm_0.bias"] = (cout,)
        else:
            shapes[name + ".bias"] = (cout,)
    return shapes


def init_params(mcfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Flax's initialisers from ``seed``, made on ``device`` in one draw:
    each conv kernel LeCun normal truncated at two deviations (variance
    1 / fan-in after the truncation), biases zero, BatchNorm scales one."""
    shapes = param_shapes(mcfg)
    weights = [n for n in shapes if n.endswith(".weight")]
    sizes = [math.prod(shapes[n]) for n in weights]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float64)
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    z = torch.erfinv(2 * (lo + (hi - lo) * u) - 1) * math.sqrt(2)
    std = torch.tensor([math.sqrt(1.0 / math.prod(shapes[n][1:])) / 0.87962566103423978
                        for n in weights], dtype=torch.float64, device=device)
    flat = (z * std.repeat_interleave(torch.tensor(sizes, device=device))).float()
    out = dict(zip(weights, (p.view(shapes[n]) for p, n in zip(flat.split(sizes), weights))))
    for n, shape in shapes.items():
        if n not in out:
            out[n] = (torch.ones if n.endswith(".scale") else torch.zeros)(
                shape, device=device)
    return {n: out[n] for n in shapes}


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride: int, groups: int):
    ph = same_pads(x.shape[-2], w.shape[-1], stride)
    pw = same_pads(x.shape[-1], w.shape[-1], stride)
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, b, stride, 0, 1, groups)


def train_conv(x, w, stride: int, groups: int):
    """A training site's convolution of operands already in the compute
    type.  On the CPU it sums the rounded operands' products in f32 and
    rounds once (torch's CPU bfloat16 convolution backward is not sound);
    on the card it is the library's convolution in that type."""
    if x.device.type == "cpu" and x.dtype != torch.float32:
        return conv(x.float(), w.float(), None, stride, groups).to(x.dtype)
    return conv(x, w, None, stride, groups)


def relu6(x):
    return torch.where((x > 0) & (x < 6), x, x.detach().clamp(0.0, 6.0))


def batchnorm(x, p: dict, name: str):
    """Training mode: the batch's mean and biased variance."""
    mean = x.mean(dim=(0, 2, 3))
    var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + BN_EPS) * p[name + ".scale"]
    return (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + p[name + ".bias"].view(1, -1, 1, 1)


def upsample(x, hw):
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


def forward(p: dict, x: torch.Tensor, mcfg: dict, dtype: torch.dtype = torch.float32) -> dict:
    """x (B, H, W, 3) in [-1, 1] -> the head outputs: ``loc`` (B, A, 4),
    ``conf`` (B, A, C), ``coeff`` (B, A, K), ``prototypes`` (B, H/4, W/4,
    K), ``sem_logits`` (B, H/8, W/8, 81); all f32 but ``coeff``, in
    ``dtype``.

    ``dtype`` is the type the convolutions compute in, as the configuration
    states it: their inputs and kernels are rounded to it and so are their
    results, the activations between them, the residual and pyramid sums and
    the upsampling.  The parameters, the BatchNorms, their ReLU6 and the
    heads' outputs stay in f32."""
    table = {s[0]: s for s in sites(mcfg)}

    def site(name, h):
        _, _, _, _, stride, groups, bn, act = table[name]
        parent = name.rpartition(".")[0] + ".BatchNorm_0"
        y = train_conv(h.to(dtype), p[name + ".weight"].to(dtype), stride, groups)
        if bn:
            y = batchnorm(y.float(), p, parent)
            return (relu6(y) if act else y).to(dtype)
        return y + p[name + ".bias"].to(dtype).view(1, -1, 1, 1)

    h = site("MobileNetV2_0.ConvBN_0.Conv_0", x.to(dtype).permute(0, 3, 1, 2))
    taps, idx, cin = [], 0, _divisible(32 * mcfg["width_mult"])
    for stage, (t, c, n, s) in enumerate(MNV2):
        feats = _divisible(c * mcfg["width_mult"])
        for i in range(n):
            base = f"MobileNetV2_0.InvertedResidual_{idx}"
            y, j = h, 0
            for j in range(3 if t != 1 else 2):
                y = site(f"{base}.ConvBN_{j}.Conv_0", y)
            h = y + h if (s if i == 0 else 1) == 1 and cin == feats else y
            cin = feats
            idx += 1
        if stage in TAPS:
            taps.append(h)
    c3, c4, c5 = taps
    p5 = site("FPN_0.lat5", c5)
    p4 = site("FPN_0.lat4", c4) + upsample(p5, c4.shape[-2:])
    p3 = site("FPN_0.lat3", c3) + upsample(p4, c3.shape[-2:])
    pyramid = [torch.relu(site(f"FPN_0.smooth{i}", q)) for i, q in ((3, p3), (4, p4), (5, p5))]
    q = pyramid[-1]
    for i in range(mcfg["fpn_levels"] - 3):
        q = site(f"FPN_0.down{6 + i}", q)
        pyramid.append(q)
    y = pyramid[0]
    for name in ("conv0", "conv1", "conv2"):
        y = torch.relu(site(f"ProtoNet_0.{name}", y))
    y = torch.relu(site("ProtoNet_0.post_up", upsample(y, (y.shape[-2] * 2, y.shape[-1] * 2))))
    protos = torch.relu(site("ProtoNet_0.proto_out", y).float()).permute(0, 2, 3, 1)
    b = x.shape[0]

    def per_anchor(t, width):
        return t.permute(0, 2, 3, 1).reshape(b, -1, width)

    locs, confs, coeffs = [], [], []
    for level in pyramid:
        tower = torch.relu(site("PredictionHead_0.tower", level))
        locs.append(per_anchor(site("PredictionHead_0.loc", tower), 4))
        confs.append(per_anchor(site("PredictionHead_0.conf", tower), mcfg["det_num_classes"]))
        coeffs.append(per_anchor(site("PredictionHead_0.coeff", tower), mcfg["num_prototypes"]))
    return {"loc": torch.cat(locs, 1).float(), "conf": torch.cat(confs, 1).float(),
            "coeff": torch.cat(coeffs, 1), "prototypes": protos,
            "sem_logits": site("SemanticHead_0.sem_out", pyramid[0]).float().permute(0, 2, 3, 1)}

