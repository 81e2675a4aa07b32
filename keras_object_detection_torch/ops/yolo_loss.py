"""The fused YOLOv1 loss: forward and analytic backward (counterpart of
``keras_object_detection_tpu/ops/pallas_loss.py``), the loss of the train
step under ``TrainConfig.use_pallas_loss=True``.

``fused_yolo_v1_loss`` sends a CUDA tensor to the hand-written kernels of
``ops/csrc/yolo_loss.cu`` and a CPU tensor to their plain versions here,
``yolo_v1_loss_forward_plain`` (the sums of the plain autograd loss,
``losses/yolo.py``) and ``yolo_v1_loss_backward_plain``. Both work on the
``(N, C + 5B)`` row view of the grids.

The backward is the analytic gradient of ``_backward_kernel``, not autograd.
``y_true`` is a constant (its gradient is None). At ties it follows that
kernel's rules, which are neither ``jax.grad``'s nor torch autograd's:

- the intersection side ``clip(iw_raw, 0, 1)`` passes gradient only
  strictly inside (0, 1): 0 at a bound (``jax.grad``: 0.5; torch: 1);
- a tied corner (``max(t_x1, p_x1)`` with ``t_x1 == p_x1``) routes the whole
  gradient to the prediction (``jax.grad`` and torch: half).

``FORWARD_LAUNCHES`` and ``BACKWARD_LAUNCHES`` count the kernels' calls,
one CUDA launch each.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from keras_object_detection_torch.losses.yolo import yolo_v1_loss_terms
from keras_object_detection_torch.ops import _build

_EPS_IOU = 1e-6
_EPS_SQRT = 1e-6

FORWARD_LAUNCHES = 0
BACKWARD_LAUNCHES = 0


# ---------------------------------------------------------------- plain ----

def _corners(cx, cy, w, h):
    return (cx - w) / 2.0, (cy - h) / 2.0, (cx + w) / 2.0, (cy + h) / 2.0


def _iou_parts(tbox, pbox) -> Dict[str, torch.Tensor]:
    """The quirk IoU of the true box and one predicted slot, with the
    intermediates the backward needs. Arguments are lists of (N,) columns."""
    tx1, ty1, tx2, ty2 = _corners(*tbox)
    px1, py1, px2, py2 = _corners(*pbox)
    iw_raw = torch.minimum(tx2, px2) - torch.maximum(tx1, px1)
    ih_raw = torch.minimum(ty2, py2) - torch.maximum(ty1, py1)
    iw = torch.clamp(iw_raw, 0.0, 1.0)
    ih = torch.clamp(ih_raw, 0.0, 1.0)
    inter = iw * ih
    t_area = torch.abs((tx2 - tx1) * (ty2 - ty1))
    p_area = torch.abs((px2 - px1) * (py2 - py1))
    union = t_area + p_area - inter + _EPS_IOU
    return dict(tx1=tx1, ty1=ty1, tx2=tx2, ty2=ty2, px1=px1, py1=py1,
                px2=px2, py2=py2, iw_raw=iw_raw, ih_raw=ih_raw, iw=iw, ih=ih,
                inter=inter, union=union, iou=inter / union)


def _split(t: torch.Tensor, p: torch.Tensor, num_classes: int, num_boxes: int):
    c = num_classes
    tbox = [t[:, c + 1 + k] for k in range(4)]
    slots = [(p[:, c + 5 * s], [p[:, c + 5 * s + 1 + k] for k in range(4)])
             for s in range(num_boxes)]
    return t[:, :c], p[:, :c], t[:, c], tbox, slots


def _select_best(tbox, slots) -> Tuple[List[torch.Tensor], List[dict]]:
    """One-hot of the responsible slot per row (argmax IoU, strict '>', so
    ties keep the lower slot, as ``torch.argmax`` in the forward) and each
    slot's IoU parts."""
    parts = [_iou_parts(tbox, box) for _, box in slots]
    best = parts[0]["iou"]
    best_idx = torch.zeros_like(best)
    for s in range(1, len(slots)):
        take = parts[s]["iou"] > best
        best = torch.where(take, parts[s]["iou"], best)
        best_idx = torch.where(take, torch.full_like(best, float(s)), best_idx)
    onehots = [(best_idx == float(s)).to(best.dtype) for s in range(len(slots))]
    return onehots, parts


def yolo_v1_loss_forward_plain(t: torch.Tensor, p: torch.Tensor,
                               num_classes: int, num_boxes: int = 2,
                               lambda_coord: float = 5.0,
                               lambda_noobj: float = 0.5,
                               noobj_mode: str = "selected") -> torch.Tensor:
    """The 5 sums ``[total, box, object, no_object, class]`` (float32, on
    the rows' device) of the rows ``t``, ``p``: the plain loss
    ``losses.yolo.yolo_v1_loss_terms``, whose forward is this one's."""
    terms = yolo_v1_loss_terms(t, p, num_classes, num_boxes, lambda_coord,
                               lambda_noobj, noobj_mode)
    return torch.stack([terms[k] for k in ("total", "box_loss", "object_loss",
                                           "no_object_loss", "class_loss")])


def yolo_v1_loss_backward_plain(t: torch.Tensor, p: torch.Tensor,
                                g: torch.Tensor, num_classes: int,
                                num_boxes: int = 2, lambda_coord: float = 5.0,
                                lambda_noobj: float = 0.5,
                                noobj_mode: str = "selected") -> torch.Tensor:
    """``(N, C + 5B)`` d total / d p scaled by the 0-dim cotangent ``g``:
    ``_backward_kernel``'s formulas, operation for operation."""
    tcls, pcls, obj, tbox, slots = _split(t, p, num_classes, num_boxes)
    noobj = 1.0 - obj
    onehots, parts = _select_best(tbox, slots)
    conf_sel = sum(o * s[0] for o, s in zip(onehots, slots))
    iou_sel = sum(o * q["iou"] for o, q in zip(onehots, parts))

    cols = [-2.0 * g * obj[:, None] * (tcls - pcls)]
    u = iou_sel - conf_sel
    for s in range(num_boxes):
        sel = onehots[s]
        conf_s, box_s = slots[s]
        q = parts[s]

        dconf = sel * (-2.0 * g * obj * u)
        if noobj_mode == "selected":
            dconf = dconf + sel * (2.0 * g * lambda_noobj * noobj * conf_s)
        else:
            dconf = dconf + 2.0 * g * lambda_noobj * noobj * conf_s

        dx = sel * (-2.0 * g * lambda_coord * obj * (tbox[0] - box_s[0]))
        dy = sel * (-2.0 * g * lambda_coord * obj * (tbox[1] - box_s[1]))
        dwh = []
        for k in range(2):
            pk = box_s[2 + k]
            s_p = torch.sign(pk) * torch.sqrt(torch.abs(pk) + _EPS_SQRT)
            ds = torch.sign(pk) ** 2 / (2.0 * torch.sqrt(torch.abs(pk) + _EPS_SQRT))
            tgt = torch.sqrt(tbox[2 + k])
            dwh.append(sel * (-2.0 * g * lambda_coord * obj * (tgt - s_p) * ds))

        # the IoU chain; strict clip mask, corner ties routed to the prediction
        f32 = q["iw"].dtype
        iw_in = ((q["iw_raw"] > 0.0) & (q["iw_raw"] < 1.0)).to(f32)
        ih_in = ((q["ih_raw"] > 0.0) & (q["ih_raw"] < 1.0)).to(f32)
        g_x1 = (q["tx1"] <= q["px1"]).to(f32)
        g_y1 = (q["ty1"] <= q["py1"]).to(f32)
        g_x2 = (q["tx2"] >= q["px2"]).to(f32)
        g_y2 = (q["ty2"] >= q["py2"]).to(f32)
        diw_dpx = iw_in * (g_x2 - g_x1) * 0.5
        diw_dpw = iw_in * (g_x2 + g_x1) * 0.5
        dih_dpy = ih_in * (g_y2 - g_y1) * 0.5
        dih_dph = ih_in * (g_y2 + g_y1) * 0.5
        dI_dpx = q["ih"] * diw_dpx
        dI_dpw = q["ih"] * diw_dpw
        dI_dpy = q["iw"] * dih_dpy
        dI_dph = q["iw"] * dih_dph
        pw, ph = box_s[2], box_s[3]
        sgn_area = torch.sign(pw * ph)
        dAp_dpw = sgn_area * ph
        dAp_dph = sgn_area * pw
        U, I = q["union"], q["inter"]
        scale = 2.0 * g * obj * u * sel / (U * U)
        cols += [dconf[:, None],
                 (dx + scale * (dI_dpx * (U + I)))[:, None],
                 (dy + scale * (dI_dpy * (U + I)))[:, None],
                 (dwh[0] + scale * (dI_dpw * (U + I) - I * dAp_dpw))[:, None],
                 (dwh[1] + scale * (dI_dph * (U + I) - I * dAp_dph))[:, None]]
    return torch.cat(cols, dim=1)


# --------------------------------------------------------------- kernels ----

@functools.cache
def _library() -> ctypes.CDLL:
    from keras_object_detection_torch.ops._build import load_library

    lib = load_library("yolo_loss")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # n, C, B, lambda_coord, lambda_noobj, noobj_all, stream
    scalars = [i32, i32, i32, f32, f32, i32, ptr]
    lib.kot_loss_forward.argtypes = [ptr] * 5 + scalars
    lib.kot_loss_backward.argtypes = [ptr] * 4 + scalars
    lib.kot_loss_blocks.argtypes = [i32, i32]
    lib.kot_loss_error_string.argtypes = [i32]
    lib.kot_loss_error_string.restype = ctypes.c_char_p
    return lib


def kernel_blocks(n: int, backward: bool) -> int:
    """Blocks the loss kernel launches for ``n`` rows, by the library's
    chunk geometry."""
    return _library().kot_loss_blocks(n, int(backward))


_FORWARD_SCRATCH: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


def _forward_scratch(lib, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's per-block partials and its ticket counter on ``device``, made at
    the first call and kept, so that a CUDA graph captured later replays on
    the same buffers. The kernel leaves the counter at 0 after each launch.
    One stream at a time may use them: two forward launches in flight at
    once on one card would share them."""
    scratch = _FORWARD_SCRATCH.get(device.index)
    if scratch is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the loss forward makes its scratch buffers at its "
                               "first call on a device; make that call before "
                               "capturing a CUDA graph")
        scratch = (torch.empty(lib.kot_loss_forward_partials_floats(),
                               dtype=torch.float32, device=device),
                   torch.zeros(1, dtype=torch.int32, device=device))
        torch.cuda.synchronize(device)  # the zero lands before any stream reads it
        _FORWARD_SCRATCH[device.index] = scratch
    return scratch


def _check_rows(t: torch.Tensor, p: torch.Tensor, num_classes: int,
                num_boxes: int) -> None:
    for name, x in (("y_true", t), ("y_pred", p)):
        if not x.is_cuda:
            raise ValueError(f"the loss kernel takes CUDA tensors, {name} is "
                             f"on {x.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"the loss kernel takes float32, {name} is {x.dtype}")
        if x.dim() != 2 or x.shape[1] != num_classes + 5 * num_boxes:
            raise ValueError(f"the loss kernel takes (N, C + 5B) rows, {name} "
                             f"is {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"the loss kernel takes contiguous rows ({name})")
    if t.shape != p.shape or t.device != p.device:
        raise ValueError("y_true and y_pred differ in shape or device")
    if t.shape[0] < 1:
        raise ValueError("the loss kernel takes at least one row")


def _raise_on(lib, err: int, what: str) -> None:
    """A negative code is an input the kernel does not take (ValueError), a
    positive one a CUDA error (RuntimeError)."""
    if err:
        msg = f"{what}: " + lib.kot_loss_error_string(err).decode()
        raise (ValueError if err < 0 else RuntimeError)(msg)


def cuda_yolo_v1_loss_forward(t: torch.Tensor, p: torch.Tensor,
                              num_classes: int, num_boxes: int = 2,
                              lambda_coord: float = 5.0,
                              lambda_noobj: float = 0.5,
                              noobj_mode: str = "selected") -> torch.Tensor:
    """K4 on the card, one launch: the 5 sums of
    ``yolo_v1_loss_forward_plain``, the same bits on every call."""
    global FORWARD_LAUNCHES
    _check_rows(t, p, num_classes, num_boxes)
    lib = _library()
    partials, tickets = _forward_scratch(lib, t.device)
    out = torch.empty(5, dtype=torch.float32, device=t.device)
    err = _build.launch(lib.kot_loss_forward, t.device, t.data_ptr(),
                        p.data_ptr(), partials.data_ptr(), tickets.data_ptr(),
                        out.data_ptr(), t.shape[0], num_classes, num_boxes,
                        float(lambda_coord), float(lambda_noobj),
                        int(noobj_mode == "all"))
    _raise_on(lib, err, "loss forward kernel")
    FORWARD_LAUNCHES += 1
    return out


def cuda_yolo_v1_loss_backward(t: torch.Tensor, p: torch.Tensor,
                               g: torch.Tensor, num_classes: int,
                               num_boxes: int = 2, lambda_coord: float = 5.0,
                               lambda_noobj: float = 0.5,
                               noobj_mode: str = "selected") -> torch.Tensor:
    """K5 on the card: ``yolo_v1_loss_backward_plain``; the kernel reads the
    cotangent ``g`` (one float32 on the same card) from device memory."""
    global BACKWARD_LAUNCHES
    _check_rows(t, p, num_classes, num_boxes)
    if g.numel() != 1 or g.dtype != torch.float32 or g.device != t.device:
        raise ValueError("the cotangent must be one float32 on the rows' device")
    g = g.contiguous()
    lib = _library()
    dp = torch.empty_like(p)
    err = _build.launch(lib.kot_loss_backward, t.device, t.data_ptr(),
                        p.data_ptr(), g.data_ptr(), dp.data_ptr(), t.shape[0],
                        num_classes, num_boxes, float(lambda_coord),
                        float(lambda_noobj), int(noobj_mode == "all"))
    _raise_on(lib, err, "loss backward kernel")
    BACKWARD_LAUNCHES += 1
    return dp


def _route(x: torch.Tensor, kernel, plain):
    if x.is_cuda:
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"no YOLOv1 loss for device {x.device}")


class YoloV1LossFunction(torch.autograd.Function):
    """total = the fused loss of ``y_true`` (a constant) and ``y_pred``;
    the backward is K5 (or its plain version on the CPU)."""

    @staticmethod
    def forward(ctx, y_true, y_pred, num_classes, num_boxes, lambda_coord,
                lambda_noobj, noobj_mode):
        depth = num_classes + 5 * num_boxes
        t = y_true.detach().reshape(-1, depth).to(torch.float32).contiguous()
        p = y_pred.detach().reshape(-1, depth).to(torch.float32).contiguous()
        args = (num_classes, num_boxes, lambda_coord, lambda_noobj, noobj_mode)
        sums = _route(p, cuda_yolo_v1_loss_forward,
                      yolo_v1_loss_forward_plain)(t, p, *args)
        ctx.save_for_backward(t, p)
        ctx.args = args
        ctx.pred_shape, ctx.pred_dtype = y_pred.shape, y_pred.dtype
        return sums[0]

    @staticmethod
    def backward(ctx, g):
        t, p = ctx.saved_tensors
        g = g.to(torch.float32)
        dp = _route(p, cuda_yolo_v1_loss_backward,
                    yolo_v1_loss_backward_plain)(t, p, g, *ctx.args)
        return (None, dp.reshape(ctx.pred_shape).to(ctx.pred_dtype),
                None, None, None, None, None)


def fused_yolo_v1_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                       num_classes: int, num_boxes: int = 2,
                       lambda_coord: float = 5.0, lambda_noobj: float = 0.5,
                       noobj_mode: str = "selected") -> torch.Tensor:
    """The fused YOLOv1 loss scalar of ``(batch, S, S, C + 5B)`` grids
    (counterpart of ``pallas_yolo_v1_loss``); differentiable in
    ``y_pred``."""
    if noobj_mode not in ("selected", "all"):
        raise ValueError(
            f"noobj_mode must be 'selected' or 'all', got {noobj_mode!r}")
    return YoloV1LossFunction.apply(y_true, y_pred, num_classes, num_boxes,
                                    lambda_coord, lambda_noobj, noobj_mode)
