"""One-time int8 preparation of the serving weights (counterpart of the JAX
package's ``models/prepare.py``).

The port's state dict arrives with every BatchNorm already folded into its
conv (``core/weights.carry_across``, the arithmetic of the JAX
``fold_batchnorm``), so the preparation is the JAX package's last two
steps, on OIHW kernels:

1. ``calibrate_amax``: calibration batches through the dynamic branch of a
   quantized model (the QAT branch of a ``ModelConfig.qat`` model, as the
   JAX package's calibration runs the model's own convs); each site records
   its activation ``max|x|``, the maximum over its calls and the batches.
2. ``quantize_prepared``: each dense kernel becomes ``kernel_q`` s8 (per
   output channel, symmetric), ``w_scale`` and the calibrated ``act_scale``;
   a depthwise kernel is cast to the serve dtype (bfloat16) unless
   ``quantize_depthwise``.

The arithmetic is the JAX package's, in numpy: ``w_scale = max(amax_c /
127, 1e-12)`` in f32, ``kernel_q = clip(round(kernel / w_scale), +-127)``,
and ``act_scale = float32(max(amax / 127.0, 1e-12))`` divided in float64.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch
from torch import nn

from tod_tpu_torch.models.qconv import conv_sites


def calibrate_amax(model: nn.Module, batches: Iterable[torch.Tensor]) -> dict[str, np.float32]:
    """Run ``batches`` (what the model's forward takes) through a quantized
    model whose every site is in the dynamic branch, or every site in the
    QAT branch -> each site's activation amax by site name.  The maxima
    stay on the model's device until the last batch has run."""
    sites = conv_sites(model)
    if not sites:
        raise ValueError("calibrate_amax needs a model built with ModelConfig.quantized")
    branch = next(iter(sites.values())).branch
    bad = [name for name, m in sites.items() if m.branch not in ("dynamic", "qat")
           or m.branch != branch]
    if bad:
        raise ValueError(f"calibration runs the dynamic or the QAT branch at every site; "
                         f"{bad[0]} is {sites[bad[0]].branch}")
    ran = False
    try:
        for m in sites.values():
            m.recording, m.amax = True, None
        with torch.inference_mode():
            for x in batches:
                model(x)
                ran = True
    finally:
        for m in sites.values():
            m.recording = False
    if not ran:
        raise ValueError("calibrate_amax: no calibration batches supplied")
    missing = [name for name, m in sites.items() if m.amax is None]
    if missing:
        raise ValueError(f"calibrate_amax: site {missing[0]} never ran")
    return {name: np.float32(m.amax.item()) for name, m in sites.items()}


def _is_depthwise(kernel: np.ndarray) -> bool:
    return kernel.shape[1] == 1 and kernel.shape[0] > 1


def quantize_prepared(state: Mapping[str, torch.Tensor], calib: Mapping[str, np.float32],
                      quantize_depthwise: bool = False) -> dict[str, torch.Tensor]:
    """The static int8 state dict of a folded float state dict: every 4-D
    ``<site>.weight`` becomes ``kernel_q``, ``w_scale`` and ``act_scale``
    (from ``calib[site]``), or, at a depthwise site without
    ``quantize_depthwise``, a bfloat16 weight (the JAX serve dtype).
    Raises ``KeyError`` for a dense site with no calibrated amax."""
    out: dict[str, torch.Tensor] = {}
    for key, value in state.items():
        site, _, leaf = key.rpartition(".")
        if leaf != "weight" or value.dim() != 4:
            out[key] = value
            continue
        kernel = value.detach().cpu().float().numpy()
        if _is_depthwise(kernel) and not quantize_depthwise:
            out[key] = value.detach().cpu().float().to(torch.bfloat16)
            continue
        if site not in calib:
            raise KeyError(f"no calibrated activation amax for conv at {site} (was "
                           "calibrate_amax run on the same model structure?)")
        w_amax = np.abs(kernel).max(axis=(1, 2, 3))
        w_scale = np.maximum(w_amax / np.float32(127.0), np.float32(1e-12)).astype(np.float32)
        kq = np.clip(np.round(kernel / w_scale[:, None, None, None]), -127, 127).astype(np.int8)
        act_scale = np.float32(max(float(np.max(calib[site])) / 127.0, 1e-12))
        out[f"{site}.kernel_q"] = torch.from_numpy(kq)
        out[f"{site}.w_scale"] = torch.from_numpy(w_scale)
        out[f"{site}.act_scale"] = torch.tensor(act_scale, dtype=torch.float32)
    return out


def prepare_int8_params(model: nn.Module, state: Mapping[str, torch.Tensor], calib_batches,
                        quantize_depthwise: bool = False) -> dict[str, torch.Tensor]:
    """Calibrate, then quantize: the static int8 state dict of the folded
    float ``state``.  ``model`` is a quantized model in the dynamic branch on
    the device the batches lie on; ``state`` is loaded into it first."""
    model.load_state_dict(state)
    calib = calibrate_amax(model, calib_batches)
    return quantize_prepared(state, calib, quantize_depthwise=quantize_depthwise)
