"""The YOLACT graph and its detection cleanup (counterpart of
the JAX package's ``models/yolact.py``).

``Yolact.forward`` takes NHWC images, as the JAX model does, and returns raw
head outputs (``Yolact(cfg, train=True)`` is the training graph: f32
parameters, unfolded BatchNorms, QAT's fake-quantized convs with
``ModelConfig.qat``); :func:`detect` turns them into fixed-shape ``Detections``: box
decode, softmax, Fast-NMS, mask assembly with the box crop (kernel K1), and
the per-pixel class and dense ball-id maps.  :func:`detect_batch` does so
for every sample of a batch, with one K1 launch for the batch.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tod_tpu_torch.core.config import ModelConfig
from tod_tpu_torch.core.registry import register_model
from tod_tpu_torch.core.types import Detections
from tod_tpu_torch.kernels.mask_assembly import assemble_crop_masks
from tod_tpu_torch.models.conv import Training
from tod_tpu_torch.models.fpn import FPN
from tod_tpu_torch.models.heads import PredictionHead, SemanticHead
from tod_tpu_torch.models.mobilenetv2 import MobileNetV2
from tod_tpu_torch.models.protonet import ProtoNet
from tod_tpu_torch.models.resnet import ResNet
from tod_tpu_torch.ops.anchors import decode_boxes
from tod_tpu_torch.ops.masks import masks_to_class_map
from tod_tpu_torch.ops.nms import fast_nms


@dataclasses.dataclass
class YolactOutputs:
    """loc (B, A, 4) f32, conf (B, A, C) f32, coeff (B, A, K) raw logits in
    the compute dtype, prototypes (B, H/4, W/4, K) f32, sem_logits
    (B, H/8, W/8, C) f32."""

    loc: torch.Tensor
    conf: torch.Tensor
    coeff: torch.Tensor
    prototypes: torch.Tensor
    sem_logits: torch.Tensor


class Yolact(nn.Module):
    """The YOLACT graph of ``cfg``: the serving form (folded BatchNorms; the
    int8 sites with ``quantized``, a QAT model's too), or with ``train`` the
    training form, whose parameters are f32 and whose convs compute in
    ``cfg.dtype`` (``models.conv.Training``)."""

    def __init__(self, cfg: ModelConfig, train: bool = False):
        super().__init__()
        if train and cfg.quantized and not cfg.qat:
            raise ValueError("a quantized model trains only with ModelConfig.qat "
                             "(quantization-aware training)")
        self.cfg = cfg
        self.train_form = train
        q = Training(getattr(torch, cfg.dtype), cfg.qat) if train else cfg.quantized
        if cfg.backbone == "mobilenetv2":
            self.backbone_name = "MobileNetV2_0"
            backbone = MobileNetV2(cfg.width_mult, q)
        elif cfg.backbone.startswith("resnet"):
            self.backbone_name = "ResNet_0"
            backbone = ResNet(cfg.backbone, q)
        else:
            raise ValueError(f"unknown backbone {cfg.backbone!r}")
        self.add_module(self.backbone_name, backbone)
        self.FPN_0 = FPN(backbone.out_channels, cfg.fpn_channels, cfg.fpn_levels, q)
        self.ProtoNet_0 = ProtoNet(cfg.fpn_channels, cfg.num_prototypes, cfg.proto_channels, q)
        self.PredictionHead_0 = PredictionHead(
            cfg.fpn_channels, cfg.det_num_classes, cfg.num_anchors,
            cfg.num_prototypes, cfg.head_channels, q,
        )
        self.SemanticHead_0 = SemanticHead(cfg.fpn_channels, cfg.num_classes, q)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The activations' type: the float model's weights' (a model cast
        with ``.to`` computes in that type); ``ModelConfig.dtype`` in an int8
        model, whose s8, f32 and bf16 tensors do not tell it, and in the
        training form, whose parameters are f32."""
        if self.cfg.quantized or self.train_form:
            return getattr(torch, self.cfg.dtype)
        return self.PredictionHead_0.tower.weight.dtype

    def forward(self, x: torch.Tensor) -> YolactOutputs:
        """x: (B, H, W, 3) normalised images."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        pyramid = self.FPN_0(*getattr(self, self.backbone_name)(x))
        prototypes = self.ProtoNet_0(pyramid[0]).permute(0, 2, 3, 1)
        outs = [self.PredictionHead_0(p) for p in pyramid]
        return YolactOutputs(
            loc=torch.cat([o[0] for o in outs], dim=1).float(),
            conf=torch.cat([o[1] for o in outs], dim=1).float(),
            coeff=torch.cat([o[2] for o in outs], dim=1),
            prototypes=prototypes,
            sem_logits=self.SemanticHead_0(pyramid[0]),
        )


def _nms_sample(loc, conf_logits, coeff_all, cfg: ModelConfig, anchors: torch.Tensor):
    """Per-sample box decode, softmax and Fast-NMS: loc (A, 4), conf_logits
    (A, C), coeff_all (A, K) -> (boxes, scores, classes, valid, the kept
    anchors' coefficients (N, K) f32)."""
    conf = torch.softmax(conf_logits, dim=-1)
    boxes_all = decode_boxes(loc, anchors)
    boxes, scores, classes, keep_idx, valid = fast_nms(
        boxes_all, conf,
        iou_threshold=cfg.nms_iou_threshold,
        top_k_per_class=cfg.nms_top_k,
        max_detections=cfg.max_detections,
        score_threshold=cfg.score_threshold,
    )
    # gather first, tanh after: only the kept anchors need the nonlinearity
    coeffs = torch.tanh(coeff_all[keep_idx].float())
    return boxes, scores, classes, valid, coeffs


def _maps_sample(boxes, scores, classes, valid, masks, cfg: ModelConfig,
                 out_hw: tuple[int, int]) -> Detections:
    """One sample's assembled masks (N, Hm, Wm) -> Detections with the class
    map and the dense ball-id map."""
    masks = masks * valid[:, None, None]
    class_map, id_map = masks_to_class_map(
        masks, classes, valid, out_hw, threshold=cfg.mask_threshold
    )
    # dense ball ids over the valid ball slots; every other pixel gets -1
    is_ball_slot = (classes == 3) & valid
    ball_rank = torch.cumsum(is_ball_slot.to(torch.int32), dim=0) - 1
    slot_ids = torch.where(is_ball_slot, ball_rank, -1).to(torch.int32)
    padded = torch.cat([slot_ids, slot_ids.new_full((1,), -1)])
    ball_ids = padded[torch.where(id_map >= 0, id_map, slot_ids.shape[0]).long()]
    return Detections(
        boxes=boxes, scores=scores, classes=classes, masks=masks, valid=valid,
        class_map=class_map, id_map=ball_ids,
    )


def detect_batch(outputs: YolactOutputs, cfg: ModelConfig, anchors: torch.Tensor,
                 out_hw: tuple[int, int] | None = None) -> Detections:
    """Head outputs of a batch -> Detections whose every field has a leading
    batch axis.  The cleanup runs per sample, as the JAX package's vmap of
    its per-sample core does, except the mask assembly: kernel K1 takes the
    whole batch in one launch."""
    out_hw = out_hw or cfg.input_size
    picked = [_nms_sample(loc, conf, coeff, cfg, anchors) for loc, conf, coeff in
              zip(outputs.loc, outputs.conf, outputs.coeff)]
    boxes, scores, classes, valid, coeffs = (torch.stack(f) for f in zip(*picked))
    masks = assemble_crop_masks(outputs.prototypes.float().contiguous(),
                                coeffs.contiguous(), boxes.contiguous())
    per = [_maps_sample(*fields, cfg, out_hw)
           for fields in zip(boxes, scores, classes, valid, masks)]
    return Detections(**{f.name: torch.stack([getattr(d, f.name) for d in per])
                         for f in dataclasses.fields(Detections)})


def detect(outputs: YolactOutputs, cfg: ModelConfig, anchors: torch.Tensor,
           out_hw: tuple[int, int] | None = None) -> Detections:
    """Head outputs -> Detections for batch element 0."""
    boxes, scores, classes, valid, coeffs = _nms_sample(
        outputs.loc[0], outputs.conf[0], outputs.coeff[0], cfg, anchors)
    masks = assemble_crop_masks(
        outputs.prototypes[0][None].float().contiguous(), coeffs[None].contiguous(),
        boxes[None].contiguous(),
    )[0]
    return _maps_sample(boxes, scores, classes, valid, masks, cfg, out_hw or cfg.input_size)


@register_model("yolact_mnv2_fpn")
def _yolact_mnv2(cfg: ModelConfig | None = None) -> Yolact:
    """The default family name: ``cfg.backbone`` decides (a ResNet config
    built under this name is a ResNet, as in the JAX registry)."""
    return Yolact(cfg or ModelConfig())


@register_model("yolact_r18_fpn")
def _yolact_r18(cfg: ModelConfig | None = None) -> Yolact:
    return Yolact(dataclasses.replace(cfg or ModelConfig(), backbone="resnet18"))


@register_model("yolact_r50_fpn")
def _yolact_r50(cfg: ModelConfig | None = None) -> Yolact:
    return Yolact(dataclasses.replace(cfg or ModelConfig(), backbone="resnet50"))
