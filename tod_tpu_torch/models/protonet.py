"""ProtoNet (counterpart of the JAX package's ``models/protonet.py``): three 3x3 convs
on P3, a 2x bilinear upsample, one more conv, then a 1x1 conv to K
prototypes.  Prototypes are returned in f32, NCHW."""

from __future__ import annotations

import torch
from torch import nn

from tod_tpu_torch.models.qconv import make_conv
from tod_tpu_torch.models.fpn import upsample_to


class ProtoNet(nn.Module):
    def __init__(self, cin: int, num_prototypes: int = 32, channels: int = 128,
                 quantized: bool = False):
        super().__init__()
        q = quantized
        self.conv0 = make_conv(q, cin, channels, 3)
        self.conv1 = make_conv(q, channels, channels, 3)
        self.conv2 = make_conv(q, channels, channels, 3)
        self.post_up = make_conv(q, channels, channels, 3)
        self.proto_out = make_conv(q, channels, num_prototypes, 1)

    def forward(self, p3: torch.Tensor) -> torch.Tensor:
        x = p3
        for conv in (self.conv0, self.conv1, self.conv2):
            x = torch.relu(conv(x))
        x = upsample_to(x, (x.shape[-2] * 2, x.shape[-1] * 2))
        x = torch.relu(self.post_up(x))
        return torch.relu(self.proto_out(x).float())
