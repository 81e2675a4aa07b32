"""Typed configuration: the same dataclass tree and JSON format as
``keras_object_detection_tpu/config.py``, kept as this package's own copy so
the port never imports the JAX package. A ``config.json`` written next to a
JAX checkpoint loads here unchanged.

Field meanings are documented at the JAX package's definitions; the comments
here only mark what this port implements so far. ``check_ported`` raises on a
switch whose value the port does not implement yet, naming its ROADMAP item.
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
    # Anchor priors (w, h) in image ratios for head="anchor" (YOLOv2 family).
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
                    "tools/kmeans_anchors.py)")
            return len(self.anchors) * (5 + self.num_classes)
        if head == "fpn":
            raise ValueError(
                "head='fpn' emits one grid per scale; there is no single "
                "output depth (see core/fpn.py partition_anchors)")
        return self.cell_depth


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # The port builds darknet24 | darknet_tiny | darknet_micro so far.
    backbone: str = "darknet24"
    # The port builds head="conv" so far.
    head: str = "conv"
    image_size: int = 448
    # Activations in this dtype; parameters and BN statistics stay float32.
    compute_dtype: str = "bfloat16"
    head_dense_units: int = 4960
    head_batchnorm: bool = True
    activation: str = "relu"  # or "leaky_relu" = LeakyReLU(0.1)
    # "flax" (plain torch) | "fused" (the hand-written BN-statistics kernels)
    bn_mode: str = "flax"
    dropout_rate: float = 0.5
    remat: bool = False
    remat_policy: str = "full"
    pretrained_backbone: str = ""
    freeze_backbone: bool = False
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
    # The port trains with adam | nadam | sgd so far.
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
    # The port implements "mse" so far.
    box_loss_mode: str = "mse"
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
    # The port serves "hard" (greedy) NMS only so far.
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
                    kwargs[k] = tuple(v)
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


# switch value -> the ROADMAP item that ports it
_BN_MODES_TO_PORT = {"mxu": "1.9"}
_OPTIMIZERS_TO_PORT = {"adamw": "1.7", "sgdw": "1.7"}
_BOX_LOSSES_TO_PORT = {"diou": "1.16", "ciou": "1.16", "alpha_iou": "1.16"}


def check_bn_mode(bn_mode: str) -> None:
    """``flax`` and ``fused`` are ported; ``mxu`` and ``flax@N`` raise."""
    if bn_mode in ("flax", "fused"):
        return
    if bn_mode in _BN_MODES_TO_PORT or bn_mode.startswith("flax@"):
        raise NotImplementedError(
            f"bn_mode {bn_mode!r} is not ported yet (ROADMAP 1.9)")
    raise ValueError(f"unknown bn_mode {bn_mode!r}; options: flax, fused")


def check_ported(config: "Config", training: bool = False) -> None:
    """Raise on a switch of ``config`` that the port does not implement yet
    (``NotImplementedError`` naming its ROADMAP item) or that is unknown
    (``ValueError``). ``training`` adds the train step's switches."""
    m, d, t = config.model, config.data, config.train
    check_bn_mode(m.bn_mode)
    if not training:
        return
    if t.optimizer in _OPTIMIZERS_TO_PORT:
        raise NotImplementedError(
            f"optimizer {t.optimizer!r} is not ported yet (ROADMAP "
            f"{_OPTIMIZERS_TO_PORT[t.optimizer]})")
    if t.optimizer not in ("adam", "nadam", "sgd"):
        raise ValueError(f"unknown optimizer {t.optimizer!r}; options: "
                         "adam, nadam, sgd")
    if t.box_loss_mode in _BOX_LOSSES_TO_PORT:
        raise NotImplementedError(
            f"box_loss_mode {t.box_loss_mode!r} is not ported yet (ROADMAP "
            f"{_BOX_LOSSES_TO_PORT[t.box_loss_mode]})")
    if t.box_loss_mode != "mse":
        raise ValueError(f"unknown box_loss_mode {t.box_loss_mode!r}")
    if t.noobj_mode not in ("selected", "all"):
        raise ValueError(f"noobj_mode must be 'selected' or 'all', got "
                         f"{t.noobj_mode!r}")
    if m.remat:
        # a recomputed forward would update the BN running stats twice
        raise NotImplementedError("remat is not ported yet (ROADMAP 1.7)")
    if m.freeze_backbone:
        raise NotImplementedError(
            "freeze_backbone is not ported yet (ROADMAP 1.7)")
    for name, on in (("mosaic_prob", d.mosaic_prob > 0),
                     ("mixup_prob", d.mixup_prob > 0),
                     ("multiscale_sizes", bool(t.multiscale_sizes))):
        if on:
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP 1.12)")
    if t.ignore_threshold is not None or t.obj_target != "one":
        raise ValueError("ignore_threshold / obj_target are anchor/fpn-family "
                         "knobs; the v1 loss has neither")


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
