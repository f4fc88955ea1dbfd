"""Data-parallel batch serving over a mesh (counterpart of the JAX
package's ``parallel/serving.py``).

Raw uint8 frames in, batched ``Detections`` out: each ``dp`` row of the mesh
keeps a replica of the weights on its device and runs its slice of the
batch through ``resize_triangle`` -> ``normalize`` -> the YOLACT forward ->
``detect_batch`` (the mask assembly kernel K1, one launch a slice).  The
host only dispatches: each slice goes from pinned memory straight to its
own device without waiting, never through the first device, and the
outputs are joined in batch order on the first device.  With ``tp > 1``
each row's conv sites split their output channels over the row's devices
(``parallel/sharding.py tp_sharded``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tod_tpu_torch.core.config import PipelineConfig
from tod_tpu_torch.core.types import Detections
from tod_tpu_torch.parallel.mesh import Mesh
from tod_tpu_torch.parallel.sharding import dp_devices, gather_tree, split_batch, tp_sharded
from tod_tpu_torch.runtime.profiler import span


class DPBatchServer:
    """DP-batched inference over a ``(dp, tp)`` mesh.

    ``serve(rgb_batch)``: ``(B, H, W, 3)`` uint8 frames (numpy or a CPU
    tensor), ``B`` divisible by ``dp`` -> ``Detections`` whose every field
    has the leading batch axis ``B``, on the first device.  ``params`` is
    the port's serving state dict (the pinned weights when None)."""

    def __init__(self, cfg: PipelineConfig, mesh: Mesh,
                 params: Mapping[str, torch.Tensor] | None = None):
        from tod_tpu_torch.kernels.limits import refuse_kernel_limits
        from tod_tpu_torch.runtime.engine import serving_model

        self.cfg = cfg
        self.mesh = mesh
        self.devices = dp_devices(mesh)
        self.rows = [list(row) for row in mesh.devices]
        self.cam_hw = (cfg.camera.height, cfg.camera.width)
        # one replica a distinct device: rows that share a device share it
        self.replicas: dict[torch.device, tuple] = {}
        for dev in self.devices:
            if dev not in self.replicas:
                refuse_kernel_limits(cfg, "detect", dev)
                self.replicas[dev] = serving_model(cfg, params, dev)

    @property
    def dp(self) -> int:
        return self.mesh.shape["dp"]

    def _serve_slice(self, rgb: torch.Tensor, row: list[torch.device]) -> Detections:
        from tod_tpu_torch.models.yolact import detect_batch
        from tod_tpu_torch.ops.preprocess import normalize, resize_triangle

        model, dtype, anchors = self.replicas[rgb.device]
        mcfg = self.cfg.model
        x = normalize(resize_triangle(rgb, mcfg.input_size), dtype)
        with tp_sharded(model, row):
            out = model(x)
        return detect_batch(out, mcfg, anchors, out_hw=self.cam_hw)

    def serve(self, rgb_batch) -> Detections:
        """Dispatch one dp-split batch; returns the device-resident
        ``Detections`` (nothing is read back)."""
        rgb = torch.as_tensor(np.ascontiguousarray(rgb_batch, np.uint8))
        with torch.inference_mode(), span("stage/dp_serve"):
            outs = [self._serve_slice(piece, row)
                    for piece, row in zip(split_batch(rgb, self.devices), self.rows)]
            return gather_tree(outs, self.devices[0])
