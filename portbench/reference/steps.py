"""The reference's train steps and serving calls, run once the window has
closed on the inputs the benchmark handed the system, in float32 with TF32
off (or, with ``lowp``, the lower-precision control)."""

from __future__ import annotations

from typing import Dict, Iterator, List

import contextlib

import torch

from portbench.reference import augment, grids, loss, nms
from portbench.reference.model import Detector
from portbench.reference.optim import Adam


@contextlib.contextmanager
def exact():
    """TF32 off inside, as it was after."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def _model(cfg: dict, weights, device, lowp) -> Detector:
    with torch.device(device):
        model = Detector(cfg, lowp)
    model.load_state_dict(weights)
    return model


def encode(cfg: dict, boxes, valid):
    g, m = cfg["grid"], cfg["model"]
    if m["head"] == "fpn":
        return grids.encode_fpn(boxes, valid, g["num_classes"], g["anchors"],
                                g["grid"], m["fpn_scales"])
    return grids.encode_v1(boxes, valid, g["num_classes"], g["num_boxes"],
                           g["grid"])


def train(cfg: dict, weights: Dict[str, torch.Tensor], batches: List,
          seed: int, lowp=None, rows=None) -> Dict:
    """Steps 0, 1, ... on ``batches`` (each ``(images_u8, boxes, valid)``)
    from ``weights``: ``{"loss": [...], "grad": {leaf: norm of the first
    step's gradient}, "change": {leaf: norm of the parameters' change}}``.
    ``rows`` (a slice) runs each step on those rows alone, the loss scaled
    to the whole batch: the fault of a step that leaves rows out."""
    with exact():
        return _train(cfg, weights, batches, seed, lowp, rows)


def _train(cfg, weights, batches, seed, lowp, rows) -> Dict:
    device = batches[0][0].device
    model = _model(cfg, weights, device, lowp).train()
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = Adam(cfg["train"]["optimizer"], params.values(),
               cfg["train"]["schedule"]["base_lr"])
    out: Dict = {"loss": []}
    for step, (images_u8, boxes, valid) in enumerate(batches):
        b = images_u8.shape[0]
        draws = augment.step_draws(seed, step, b, cfg["data"])
        draws = {k: v.to(device) if torch.is_tensor(v) else v
                 for k, v in draws.items()}
        if rows is not None:
            images_u8, boxes, valid = images_u8[rows], boxes[rows], valid[rows]
            draws = {k: v[rows] if torch.is_tensor(v) else v
                     for k, v in draws.items()}
        images, aboxes, avalid = augment.augment(
            images_u8, boxes, valid, draws, cfg["data"],
            cfg["model"]["image_size"])
        total = loss.loss(encode(cfg, aboxes, avalid), model(images), aboxes,
                          avalid, cfg)
        if rows is not None:
            total = total * (b / images_u8.shape[0])
        model.zero_grad(set_to_none=True)
        total.backward()
        grads = [p.grad for p in params.values()]
        if step == 0:
            out["grad"] = {k: float(g.norm()) for k, g in zip(params, grads)}
        opt.step(grads)
        out["loss"].append(float(total.detach()))
    out["change"] = {k: float((p.detach() - start[k]).norm())
                     for k, p in params.items()}
    return out


@torch.no_grad()
def serve(cfg: dict, weights: Dict[str, torch.Tensor], batches: List,
          lowp=None) -> Iterator[Dict]:
    """Serving calls on ``batches`` of u8 images, one at a time: the
    answer, ``{"rows", "valid"}`` after the cut and NMS; ``decoded``, the
    ``(B, N)`` candidates, and ``kept``, which of them the cut and NMS keep;
    and ``{"choices", "margin"}``, every row decoding could give, ``N``
    groups of equal size in the candidates' order, and how far below
    decoding's own choice it lies (``grids.choices``)."""
    g, m, e = cfg["grid"], cfg["model"], cfg["eval"]
    model = _model(cfg, weights, batches[0].device, lowp).eval()
    c = g["num_classes"]
    for images_u8 in batches:
        with exact():
            preds = model(images_u8.to(torch.float32) * (1.0 / 255.0))
        if m["head"] == "fpn":
            decoded = grids.decode_fpn(preds, c, g["anchors"], g["grid"],
                                       m["fpn_scales"])
        else:
            decoded = grids.decode_v1(preds, c, g["num_boxes"], g["grid"])
        rows, valid = nms.nms(nms.top_k(decoded, e["max_candidates"]),
                              e["iou_threshold"], e["conf_threshold"])
        kept = nms.kept(decoded, e["max_candidates"], e["iou_threshold"],
                        e["conf_threshold"])
        choices, margin = grids.choices(preds, cfg)
        yield {"rows": rows, "valid": valid, "decoded": decoded,
               "kept": kept, "choices": choices, "margin": margin}
