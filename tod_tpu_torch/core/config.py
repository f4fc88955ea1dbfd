"""Typed configuration of the serving path.

A copy of the dataclasses in the JAX package's ``core/config.py`` that the port's main
path reads, with the same defaults: camera 640x480, the ``yolact_mnv2_fpn``
model at a 256x320 input in bfloat16, int8 inference, the fusion constants
of the reference shaders, the planner's backends and limits, the ball
tracker and training.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """RGB-D camera geometry (RealSense D435): 640x480, 87x58 degree FOV,
    4 m depth clamp, 30 frames a second."""

    width: int = 640
    height: int = 480
    x_fov: float = 1.51843644924  # 87 deg, radians
    y_fov: float = 1.01229096616  # 58 deg, radians
    max_depth_mm: float = 4000.0
    fps: float = 30.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """YOLACT family configuration (MobileNetV2 + FPN P3-P7 + ProtoNet,
    shared prediction head, semantic head)."""

    name: str = "yolact_mnv2_fpn"
    backbone: str = "mobilenetv2"  # or "resnet18", "resnet34", "resnet50" (models/resnet.py)
    input_size: tuple[int, int] = (256, 320)  # (H, W)
    num_classes: int = 81  # semantic head width
    meaningful_classes: int = 4  # 0 bg, 1 red robot, 2 blue robot, 3 ball
    det_num_classes: int = 4  # 0 bg, 1 red robot, 2 blue robot, 3 ball
    fpn_channels: int = 128
    fpn_levels: int = 5  # P3..P7
    num_prototypes: int = 32
    proto_channels: int = 128
    head_channels: int = 128
    anchor_aspect_ratios: tuple[float, ...] = (1.0, 0.5, 2.0)
    anchor_scales: tuple[float, ...] = (24.0, 48.0, 96.0, 192.0, 384.0)
    anchor_scale_mults: tuple[float, ...] = (1.0, 2 ** (1 / 3), 2 ** (2 / 3))
    width_mult: float = 1.0
    dtype: str = "bfloat16"  # compute dtype of the conv stack
    # Int8 inference (models/qconv.py): s8 weights (per output channel) x s8
    # activations (one calibrated scale a conv site) accumulated in int32 by
    # the kernel csrc/qconv.cu; the float weights are prepared once at load
    # (models/prepare.py).
    quantized: bool = False
    # Whether the int8 preparation quantizes the depthwise kernels too; off,
    # they serve as bfloat16 convolutions inside the int8 graph.
    quantize_depthwise: bool = False
    # Quantization-aware training (with quantized=True): the training graph
    # fake-quantizes each dense conv's weights (per output channel) and
    # activations (per tensor) with straight-through gradients
    # (models/qconv.py QATConv), the layout the static int8 serving path
    # quantizes to; the checkpoint then serves through --int8.
    qat: bool = False
    max_detections: int = 32
    score_threshold: float = 0.3
    nms_iou_threshold: float = 0.5
    nms_top_k: int = 64
    mask_threshold: float = 0.5

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_aspect_ratios) * len(self.anchor_scale_mults)

    @property
    def strides(self) -> tuple[int, ...]:
        return tuple(8 * (2**i) for i in range(self.fpn_levels))


@dataclasses.dataclass(frozen=True)
class GeometryConfig:
    """Depth to birdseye occupancy fusion constants (shaders/pt_cloud.comp)."""

    bot_avoidance_const: float = 100.0
    bot_norm_const: int = 20  # robot bump radius, px
    terrain_norm_const: int = 10  # terrain bump radius, px
    bump_err: float = 0.1
    max_balls: int = 100
    # Terrain dilation through the hand-written kernel K3 (whole 16-row
    # strips only, as in the JAX package); the ring loop otherwise.
    pallas_bump: bool = False


PLANNER_BACKENDS = ("auto", "native", "numpy", "tpu")


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Multi-source shortest-path planner.

    ``backend`` selects the host C++ Dijkstra (``native``), its NumPy
    fallback (``numpy``), or the relaxation on the device (``tpu``: the
    card, here).  ``auto`` plans on the device when the engine serves on
    the card, and on the host otherwise: native when its library builds,
    NumPy if not.
    """

    max_seed_balls: int = 3
    backend: str = "auto"  # "auto" | "native" | "numpy" | "tpu"
    start_offset: int = 240  # start column = W - start_offset
    tpu_max_iters: int = 2048  # relaxation sweep cap
    max_path_steps: int = 2048  # path-walk step cap
    min_ball_pixels: float = 3.0
    # Native height backend: bidirectional Dial-bucket search (forward from
    # the seeds, backward from the start, stopping when the frontiers'
    # bucket lower bounds cross the best meeting cost): the same optimal
    # cost with about half the settled nodes of the early-exit forward
    # pass.  Ties on the path may resolve differently.
    bidirectional: bool = True
    # False: unsigned angle between segments (reference parity);
    # True: signed turn from the carried heading.
    signed_turns: bool = False


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Temporal ball tracking (``tod_tpu_torch/track``): a bank of
    constant-velocity Kalman tracks over the fusion ball centroids, updated
    once a planning frame; the planner seeds from the confirmed tracks in
    place of the raw centroids.  Units are birdseye grid cells, velocities
    cells per update.  Off by default: the plain path plans from the
    centroids.
    """

    enabled: bool = False
    max_tracks: int = 8
    # association gate: the largest predicted-position to measurement
    # distance (cells)
    gate: float = 30.0
    # updates without a measurement before a track dies; measured updates
    # before it is confirmed (only confirmed tracks seed the planner)
    max_misses: int = 8
    min_hits: int = 2
    # white-acceleration process variance (cells^2 / update^2), centroid
    # measurement variance (cells^2), a newborn track's velocity variance
    accel_var: float = 1.0
    meas_var: float = 4.0
    vel0_var: float = 25.0
    # a measurement counts when its centroid has more pixels than this
    min_pixels: float = 3.0
    # Decaying obstacle memory: the planner's height is
    # max(fresh occupancy, decay^k x the remembered robot bumps), so a robot
    # whose detection flickers off keeps repelling the path for a few
    # planning frames.  0 disables; needs ``enabled``.
    obstacle_memory: float = 0.0


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """TCP control plane.  The defaults are plaintext, unauthenticated and
    loopback-only; the rest is opt-in hardening:

    - ``auth_token``: a connection must authenticate before any command:
      7-byte ``b"AuthTok"`` + u32 big-endian length + token bytes -> ``OK``.
      Unauthenticated or wrong-token connections are dropped and counted.
    - ``tls_cert``/``tls_key``: serve the same protocol over TLS.
    - ``tls_client_ca``: also require and verify client certificates
      (mutual TLS) against this CA bundle.
    """

    host: str = "127.0.0.1"
    port: int = 8080
    auth_token: str | None = None
    tls_cert: str | None = None
    tls_key: str | None = None
    tls_client_ca: str | None = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (``train/trainer.py``): clipped AdamW with a
    linear warmup and a cosine decay, the YOLACT loss weights."""

    batch_size: int = 8
    learning_rate: float = 1e-3
    weight_decay: float = 5e-4
    warmup_steps: int = 500
    total_steps: int = 20_000
    # YOLACT loss weights (cls, box, mask, semantic) per the YOLACT paper
    loss_weights: tuple[float, float, float, float] = (1.0, 1.5, 6.125, 1.0)
    cls_loss: str = "ohem"  # "ohem" | "focal"
    # Augmentation on the device inside the train step (train/augment.py):
    # flip and photometric jitter drawn per step from the step number.
    device_augment: bool = False
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level configuration of the frame-to-path pipeline."""

    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    geometry: GeometryConfig = dataclasses.field(default_factory=GeometryConfig)
    planner: PlannerConfig = dataclasses.field(default_factory=PlannerConfig)
    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


BACKBONES = ("mobilenetv2", "resnet18", "resnet34", "resnet50")


def validate(cfg: PipelineConfig) -> list[str]:
    """Human-readable config problems (empty = valid)."""
    problems = []
    h, w = cfg.model.input_size
    if h % 8 or w % 8:
        problems.append(f"model.input_size {cfg.model.input_size} not divisible by 8")
    if cfg.model.fpn_levels != len(cfg.model.anchor_scales):
        problems.append("anchor_scales must have one entry per FPN level")
    if cfg.model.meaningful_classes > cfg.model.num_classes:
        problems.append("meaningful_classes exceeds num_classes")
    if cfg.model.qat and not cfg.model.quantized:
        problems.append("model.qat requires model.quantized=True")
    if cfg.model.backbone not in BACKBONES:
        problems.append(f"backbone {cfg.model.backbone!r} is not one of {BACKBONES}")
    if cfg.planner.backend not in PLANNER_BACKENDS:
        problems.append(f"planner.backend {cfg.planner.backend!r} is not one of {PLANNER_BACKENDS}")
    if cfg.planner.max_seed_balls < 1:
        problems.append("planner.max_seed_balls must be >= 1")
    if cfg.planner.start_offset < 1:
        problems.append("planner.start_offset must be >= 1 (column w-offset)")
    tcfg = cfg.tracker
    if tcfg.enabled:
        if tcfg.max_tracks > cfg.geometry.max_balls:
            problems.append(
                "tracker.max_tracks exceeds geometry.max_balls (the track "
                "seeds are emitted in the ball-slot format)"
            )
        if tcfg.min_hits < 1 or tcfg.max_misses < 0:
            problems.append("tracker.min_hits must be >= 1, max_misses >= 0")
    if not (0.0 <= tcfg.obstacle_memory < 1.0):
        problems.append(
            "tracker.obstacle_memory must be in [0, 1) (a per-dispatch decay)"
        )
    if tcfg.obstacle_memory > 0.0 and not tcfg.enabled:
        problems.append(
            "tracker.obstacle_memory requires tracker.enabled (the memory "
            "lives in the tracked serving graph's HBM state)"
        )
    return problems
