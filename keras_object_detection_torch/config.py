"""Typed configuration: the same dataclass tree and JSON format as
``keras_object_detection_tpu/config.py``, kept as this package's own copy so
the port never imports the JAX package. A ``config.json`` written next to a
JAX checkpoint loads here unchanged.

Field meanings are documented at the JAX package's definitions; the comments
here only mark what this port implements. ``check_ported`` raises on a switch
whose value is unknown; features of families the port does not have yet
raise where they are built, naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """YOLO grid geometry: S (split size), B (boxes/cell), C (classes)."""

    grid: int = 7
    num_boxes: int = 2
    num_classes: int = 20
    # Anchor priors (w, h) in image ratios for head="anchor" (YOLOv2) and
    # head="fpn" (YOLOv3).
    anchors: Tuple[Tuple[float, float], ...] = ()

    @property
    def cell_depth(self) -> int:
        return self.num_classes + 5 * self.num_boxes

    @property
    def output_shape(self) -> Tuple[int, int, int]:
        return (self.grid, self.grid, self.cell_depth)

    def head_depth(self, head: str) -> int:
        """Last-axis depth the model emits for a head family: the v1
        layout C + 5B, or B_anchors * (5 + C) for the anchor head."""
        if head == "anchor":
            if not self.anchors:
                raise ValueError(
                    "head='anchor' requires GridConfig.anchors (fit with "
                    "python -m keras_object_detection_torch.cli.kmeans_anchors)")
            return len(self.anchors) * (5 + self.num_classes)
        if head == "fpn":
            raise ValueError(
                "head='fpn' emits one grid per scale; there is no single "
                "output depth (see core/fpn.py partition_anchors)")
        return self.cell_depth


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # darknet24 | darknet19 | darknet53 | darknet_tiny | darknet_micro |
    # vgg16 | mobilenetv2. darknet19 + head="anchor" + passthrough +
    # leaky_relu at 416 is the YOLOv2 of arXiv:1612.08242; darknet53 +
    # head="fpn" the YOLOv3 of arXiv:1804.02767 (yolov3_config)
    backbone: str = "darknet24"
    # conv | gap_dense | flatten_dense | anchor | fpn (the last two need
    # GridConfig.anchors; fpn splits them over fpn_scales scales)
    head: str = "conv"
    image_size: int = 448
    # Activations in this dtype; parameters and BN statistics stay float32.
    compute_dtype: str = "bfloat16"
    head_dense_units: int = 4960
    head_batchnorm: bool = True
    activation: str = "relu"  # or "leaky_relu" = LeakyReLU(0.1)
    # "flax" (plain torch) | "fused" (the hand-written BN-statistics kernels)
    # | "mxu" (float32 column sums in plain torch) | "flax@N" (batch
    # statistics of the first N images only)
    bn_mode: str = "flax"
    # Not read by the model, as in the JAX package: the flatten_dense head's
    # dropout rate is 0.5 whatever this says.
    dropout_rate: float = 0.5
    remat: bool = False
    remat_policy: str = "full"
    # A Keras .h5 (vgg16 / mobilenetv2) or darknet .weights file loaded into
    # the backbone at init (models/pretrained.py)
    pretrained_backbone: str = ""
    # The backbone runs in eval mode without gradient; its parameters get a
    # zero gradient
    freeze_backbone: bool = False
    # YOLOv2's passthrough (reorg) connection: head="anchor" and a darknet
    # backbone only
    passthrough: bool = False
    fpn_scales: int = 3

    @property
    def input_shape(self) -> Tuple[int, int, int]:
        return (self.image_size, self.image_size, 3)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    train_dir: str = ""
    val_dir: str = ""
    test_dir: str = ""
    batch_size: int = 64
    shuffle: bool = True
    drop_remainder: bool = True
    hflip_prob: float = 0.5
    color_jitter: Tuple[float, float, float, float] = (0.2, 0.2, 0.2, 0.2)
    crop_scale: Tuple[float, float] = (0.8, 1.0)
    crop_ratio: Tuple[float, float] = (0.75, 1.3333333333333333)
    min_visibility: float = 0.1
    letterbox: bool = False
    mosaic_prob: float = 0.0
    mosaic_center_range: Tuple[float, float] = (0.25, 0.75)
    mixup_prob: float = 0.0
    mixup_alpha: float = 1.5
    max_boxes_per_image: int = 64
    prefetch: int = 2
    num_workers: int = 8
    cache_in_memory: bool = False
    cache_dir: str = ""
    device_cache: bool = False
    device_cache_layout: str = "replicated"
    train_decode_size: Optional[int] = None

    def train_input_size(self, image_size: int) -> int:
        """Resolution train datasets must be decoded/cached at."""
        if self.train_decode_size is not None:
            if self.train_decode_size < image_size:
                raise ValueError(
                    f"train_decode_size {self.train_decode_size} < model "
                    f"image_size {image_size}")
            return self.train_decode_size
        return image_size


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "piecewise_warmup"  # piecewise_warmup | cosine_restarts | constant
    base_lr: float = 1e-3
    warmup_epochs: int = 75
    mid_epochs: int = 105
    warmup_target: float = 0.01
    mid_lr: float = 1e-3
    final_lr: float = 1e-4
    eta_min: float = 0.0
    t_max: int = 10
    t_mult: int = 2
    decay: float = 1.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 1000
    # adam | nadam | sgd | adamw | sgdw
    optimizer: str = "nadam"
    schedule: ScheduleConfig = dataclasses.field(default_factory=ScheduleConfig)
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    map_eval_start_epoch: int = 100
    map_eval_every: int = 10
    save_cooldown_epochs: int = 0
    # Also the default seed of build_model's weight initialisation.
    seed: int = 0
    lambda_coord: float = 5.0
    lambda_noobj: float = 0.5
    noobj_mode: str = "selected"
    # True: the fused loss with its hand-written forward/backward kernels
    use_pallas_loss: bool = False
    # mse | diou | ciou | alpha_iou (the last three on the plain loss only)
    box_loss_mode: str = "mse"
    # head="anchor" / "fpn" only (losses/yolov2.py): exempt unassigned slots
    # whose decoded box overlaps a ground truth above this IoU (v2: 0.6),
    # and the assigned slots' objectness target, "one" or the live IoU
    ignore_threshold: Optional[float] = None
    obj_target: str = "one"
    multiscale_sizes: tuple = ()
    multiscale_every: int = 1
    weight_decay: float = 1e-4
    grad_accum_steps: int = 1
    ema_decay: Optional[float] = None
    eval_with_ema: bool = True
    steps_per_dispatch: int = 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1 = all devices
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    conf_threshold: float = 0.4  # strict: conf > threshold survives
    iou_threshold: float = 0.5  # same-class iou >= threshold is suppressed
    map_iou_threshold: float = 0.5
    # Candidate sets larger than this are cut to the top-K by confidence
    # before NMS (ops/nms.py top_k_candidates); 0 disables.
    max_candidates: int = 512
    # Serving's NMS: "hard" (greedy, the reference's), "soft_gaussian" /
    # "soft_linear" (confidence decay) or "fast" (matrix NMS)
    nms_mode: str = "hard"
    soft_nms_sigma: float = 0.5
    mask_padded_images: bool = False
    # "none" | "hflip" (forward the mirror too; NMS merges 2*S*S candidates)
    tta: str = "none"
    coco_map: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    grid: GridConfig = dataclasses.field(default_factory=GridConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)

    def to_json(self) -> str:
        import json

        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        import json
        import typing

        d = json.loads(text)

        def build(tp, section):
            hints = typing.get_type_hints(tp)
            fields = {f.name: f for f in dataclasses.fields(tp)}
            kwargs = {}
            for k, v in section.items():
                if k not in fields:
                    continue
                ftype = hints[k]
                if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
                    kwargs[k] = build(ftype, v)
                elif isinstance(v, list):
                    kwargs[k] = _tuples(v)
                else:
                    kwargs[k] = v
            return tp(**kwargs)

        return cls(
            grid=build(GridConfig, d.get("grid", {})),
            model=build(ModelConfig, d.get("model", {})),
            data=build(DataConfig, d.get("data", {})),
            train=build(TrainConfig, d.get("train", {})),
            mesh=build(MeshConfig, d.get("mesh", {})),
            eval=build(EvalConfig, d.get("eval", {})),
        )


def _tuples(v):
    """JSON lists as tuples, nested ones too (``GridConfig.anchors``), so
    that a loaded config equals the one built in Python."""
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


OPTIMIZERS = ("adam", "nadam", "sgd", "adamw", "sgdw")
BOX_LOSS_MODES = ("mse", "diou", "ciou", "alpha_iou")


def check_bn_mode(bn_mode: str) -> None:
    """``flax``, ``fused``, ``mxu`` and ``flax@N`` (N >= 1); anything else
    raises ``ValueError``."""
    if bn_mode in ("flax", "fused", "mxu"):
        return
    base, _, rows = bn_mode.partition("@")
    if base != "flax" or not rows.isdigit() or int(rows) < 1:
        raise ValueError(f"unknown bn_mode {bn_mode!r}; options: flax, fused, "
                         "mxu, flax@N with N >= 1")


def check_ported(config: "Config", training: bool = False) -> None:
    """Raise ``ValueError`` on a switch of ``config`` whose value is unknown
    or belongs to another family. ``training`` adds the train step's
    switches."""
    m, t = config.model, config.train
    check_bn_mode(m.bn_mode)
    if not training:
        return
    if t.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {t.optimizer!r}; options: "
                         f"{', '.join(OPTIMIZERS)}")
    if t.box_loss_mode not in BOX_LOSS_MODES:
        raise ValueError(f"unknown box_loss_mode {t.box_loss_mode!r}; "
                         f"options: {', '.join(BOX_LOSS_MODES)}")
    if t.noobj_mode not in ("selected", "all"):
        raise ValueError(f"noobj_mode must be 'selected' or 'all', got "
                         f"{t.noobj_mode!r}")
    if m.head in ("anchor", "fpn"):
        if t.use_pallas_loss:
            raise ValueError("use_pallas_loss implements the v1 loss; the "
                             "anchor/fpn heads use losses/yolov2.py / "
                             "losses/yolov3.py")
        if t.box_loss_mode != "mse":
            raise ValueError("box_loss_mode applies to the v1 loss; the "
                             "anchor/fpn heads' box terms are fixed "
                             "(losses/yolov2.py)")
    elif t.ignore_threshold is not None:
        raise ValueError("ignore_threshold is an anchor/fpn-family knob "
                         "(losses/yolov2.py); the v1 loss has no "
                         "unassigned-slot confidence term to exempt")
    elif t.obj_target != "one":
        raise ValueError("obj_target is an anchor/fpn-family knob "
                         "(losses/yolov2.py); the v1 loss already uses the "
                         "reference's IoU-as-target convention")


def tiny_cpu_config(data_dir: str = "") -> Config:
    """CPU-runnable tiny model (darknet_tiny @224², C=3, float32)."""
    return Config(
        grid=GridConfig(grid=7, num_boxes=2, num_classes=3),
        model=ModelConfig(backbone="darknet_tiny", head="conv", image_size=224,
                          compute_dtype="float32"),
        data=DataConfig(train_dir=data_dir, val_dir=data_dir, test_dir=data_dir,
                        batch_size=2, drop_remainder=False),
        train=TrainConfig(epochs=5, optimizer="adam",
                          schedule=ScheduleConfig(kind="constant", base_lr=1e-3)),
    )


def test_model_config() -> Config:
    """The reference's ``test_model`` variant: MobileNetV2 + GAP + a plain
    Dense(4096) / ReLU head (no BatchNorm), grid-shaped output."""
    return Config(
        grid=GridConfig(grid=7, num_boxes=2, num_classes=20),
        model=ModelConfig(backbone="mobilenetv2", head="gap_dense",
                          image_size=448, head_dense_units=4096,
                          head_batchnorm=False),
    )


# The YOLOv3 416-model's 9 priors (arXiv:1804.02767 §2.3, pixels of the
# 416 input) as image ratios; core.fpn.partition_anchors splits them by area
# over the 3 scales.
YOLOV3_ANCHORS_416 = tuple(
    (w / 416.0, h / 416.0)
    for (w, h) in ((10, 13), (16, 30), (33, 23), (30, 61), (62, 45),
                   (59, 119), (116, 90), (156, 198), (373, 326)))


def yolov3_config(train_dir: str = "", val_dir: str = "",
                  test_dir: str = "", num_classes: int = 20) -> Config:
    """YOLOv3 (arXiv:1804.02767): Darknet-53 + the 3-scale FPN head at 416²
    (grids 13 / 26 / 52), the paper's 9 priors, LeakyReLU, batch 32, adam,
    ignore threshold 0.5 and IoU objectness. Refit the priors to a dataset
    with ``python -m keras_object_detection_torch.cli.kmeans_anchors --k
    9``."""
    return Config(
        grid=GridConfig(grid=13, num_boxes=2, num_classes=num_classes,
                        anchors=YOLOV3_ANCHORS_416),
        model=ModelConfig(backbone="darknet53", head="fpn", fpn_scales=3,
                          image_size=416, activation="leaky_relu"),
        data=DataConfig(train_dir=train_dir, val_dir=val_dir,
                        test_dir=test_dir, batch_size=32),
        train=TrainConfig(optimizer="adam", ignore_threshold=0.5,
                          obj_target="iou"),
    )


def voc_full_config(train_dir: str = "", val_dir: str = "", test_dir: str = "") -> Config:
    """The flagship: Darknet-24 + conv head at 448² on VOC (S=7, B=2, C=20),
    bfloat16 compute."""
    return Config(
        grid=GridConfig(grid=7, num_boxes=2, num_classes=20),
        model=ModelConfig(backbone="darknet24", head="conv", image_size=448),
        data=DataConfig(train_dir=train_dir, val_dir=val_dir, test_dir=test_dir,
                        batch_size=64),
        train=TrainConfig(epochs=1000, optimizer="nadam"),
    )
