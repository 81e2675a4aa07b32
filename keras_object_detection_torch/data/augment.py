"""Train-time batch augmentation on the device (counterpart of
``keras_object_detection_tpu/data/augment.py`` ``augment_batch``, its
helpers and ``preprocess_eval_batch``).

u8 / 255, then colour jitter (brightness, contrast, saturation, hue; factors
per image, the order of the four per batch), then per image a horizontal
flip and a RandomResizedCrop with its box remap, clip and ``min_visibility``
filter.

The random draws are explicit: ``sample_augment_draws`` draws every number
the batch needs from a CPU ``torch.Generator`` (so one seed gives the same
draws whatever the device), and ``augment_batch`` is a deterministic
function of the images, boxes and those draws. Tests feed it the JAX step's
own draws.

The crop resamples as ``jax.image.scale_and_translate(method="linear")``
computes it, not as ``F.interpolate`` or ``grid_sample`` do: a triangle
kernel widened by ``max(1 / scale, 1)`` when downsampling (antialias), the
weights renormalised by their sum, and zero weight for output samples that
fall outside ``[-0.5, in - 0.5]``. Each image gets two ``(in, out)`` weight
matrices, applied as batched matrix products.

Before the crop the train step may compose mosaics (``mosaic_batch``, four
images resized into the quadrants of one, by the same resampler) and blend
images with a partner (``mixup_batch``); their draws are explicit too
(``MosaicDraws``, ``MixupDraws``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

_F32_EPS = 1.1920928955078125e-07  # numpy.finfo(numpy.float32).eps
# u8 / 255 as the jitted JAX functions compute it: XLA turns the division by
# a constant into a multiply by its float32 reciprocal
_INV_255 = 1.0 / 255.0


@dataclasses.dataclass
class AugmentDraws:
    """Every random number of one batch's augmentation. Per image:
    ``brightness``, ``contrast``, ``saturation`` (factors in
    ``[1 - s, 1 + s)``), ``hue`` (shift in ``[-s, s)``), ``flip`` (uniform;
    the image flips where it is below ``hflip_prob``), ``crop_area`` and
    ``crop_log_ratio`` (``(batch, attempts)`` window proposals), ``crop_x``
    and ``crop_y`` (uniform offsets). Per batch: ``order``, the order in
    which the four colour operations run (host ints)."""

    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    order: Tuple[int, ...]
    flip: torch.Tensor
    crop_area: torch.Tensor
    crop_log_ratio: torch.Tensor
    crop_x: torch.Tensor
    crop_y: torch.Tensor

    def to(self, device) -> "AugmentDraws":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "order"})


def sample_augment_draws(
    batch: int,
    generator: torch.Generator,
    color_strengths: Tuple[float, float, float, float] = (0.2, 0.2, 0.2, 0.2),
    crop_scale: Tuple[float, float] = (0.8, 1.0),
    crop_ratio: Tuple[float, float] = (0.75, 4.0 / 3.0),
    attempts: int = 10,
) -> AugmentDraws:
    """Draw one batch's ``AugmentDraws`` on the CPU from ``generator``."""

    def uniform(lo, hi, *shape):
        return lo + torch.rand(shape, generator=generator) * (hi - lo)

    sb, sc, ss, sh = color_strengths
    lr0, lr1 = math.log(crop_ratio[0]), math.log(crop_ratio[1])
    return AugmentDraws(
        brightness=uniform(1.0 - sb, 1.0 + sb, batch),
        contrast=uniform(1.0 - sc, 1.0 + sc, batch),
        saturation=uniform(1.0 - ss, 1.0 + ss, batch),
        hue=uniform(-sh, sh, batch),
        order=tuple(torch.randperm(4, generator=generator).tolist()),
        flip=uniform(0.0, 1.0, batch),
        crop_area=uniform(crop_scale[0], crop_scale[1], batch, attempts),
        crop_log_ratio=uniform(lr0, lr1, batch, attempts),
        crop_x=uniform(0.0, 1.0, batch),
        crop_y=uniform(0.0, 1.0, batch),
    )


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.amax(rgb, dim=-1)
    minc = torch.amin(rgb, dim=-1)
    v = maxc
    rng = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, rng / torch.clamp_min(maxc, 1e-12), zero)
    safe_rng = torch.clamp_min(rng, 1e-12)
    rc = (maxc - r) / safe_rng
    gc = (maxc - g) / safe_rng
    bc = (maxc - b) / safe_rng
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng > 0, torch.remainder(h / 6.0, 1.0), zero)
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = torch.remainder(i.to(torch.int64), 6)[..., None]

    def pick(*cols):  # jnp.select over the six sectors
        return torch.gather(torch.stack(cols, -1), -1, sector)[..., 0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def _luma(im: torch.Tensor) -> torch.Tensor:
    return 0.299 * im[..., 0] + 0.587 * im[..., 1] + 0.114 * im[..., 2]


def _color_jitter(imgs: torch.Tensor, d: AugmentDraws) -> torch.Tensor:
    """Brightness / contrast / saturation / hue of a ``(B, H, W, 3)`` batch
    in ``[0, 1]``, with per-image factors, in the batch's order."""
    fb = d.brightness[:, None, None, None]
    fc = d.contrast[:, None, None, None]
    fs = d.saturation[:, None, None, None]
    fh = d.hue[:, None, None]

    def brightness(im):
        return torch.clamp(im * fb, 0.0, 1.0)

    def contrast(im):
        gray_mean = torch.mean(_luma(im), dim=(1, 2), keepdim=True)[..., None]
        return torch.clamp((im - gray_mean) * fc + gray_mean, 0.0, 1.0)

    def saturation(im):
        gray = _luma(im)[..., None]
        return torch.clamp(gray + (im - gray) * fs, 0.0, 1.0)

    def hue(im):
        hsv = _rgb_to_hsv(im)
        hsv = torch.cat([torch.remainder(hsv[..., :1] + fh[..., None], 1.0),
                         hsv[..., 1:]], dim=-1)
        return torch.clamp(_hsv_to_rgb(hsv), 0.0, 1.0)

    ops = (brightness, contrast, saturation, hue)
    for k in d.order:
        imgs = ops[k](imgs)
    return imgs


def crop_windows(d: AugmentDraws, crop_ratio: Tuple[float, float]):
    """RandomResizedCrop windows ``(x0, y0, w, h)``, each ``(batch,)`` in
    relative units: the first of the proposals whose ``w = sqrt(area * r)``
    and ``h = sqrt(area / r)`` both fit in the unit square, else the
    fallback centre crop (counterpart of ``sample_crop_window``)."""
    r = torch.exp(d.crop_log_ratio)
    w = torch.sqrt(d.crop_area * r)
    h = torch.sqrt(d.crop_area / r)
    ok = (w <= 1.0) & (h <= 1.0)
    first = torch.argmax(ok.to(torch.uint8), dim=1, keepdim=True)
    any_ok = ok.any(dim=1)
    # torchvision's fallback for a square image (ratio 1.0)
    in_ratio = 1.0
    fb_w = 1.0 if in_ratio < crop_ratio[0] else (
        crop_ratio[1] if in_ratio > crop_ratio[1] else 1.0)
    fb_h = 1.0 / crop_ratio[0] if in_ratio < crop_ratio[0] else 1.0
    crop_w = torch.where(any_ok, torch.gather(w, 1, first)[:, 0],
                         torch.full_like(w[:, 0], fb_w))
    crop_h = torch.where(any_ok, torch.gather(h, 1, first)[:, 0],
                         torch.full_like(h[:, 0], fb_h))
    x0 = d.crop_x * (1.0 - crop_w)
    y0 = d.crop_y * (1.0 - crop_h)
    return x0, y0, crop_w, crop_h


def linear_weight_matrix(in_size: int, out_size: int, scale: torch.Tensor,
                         translation: torch.Tensor) -> torch.Tensor:
    """``(batch, in, out)`` weights of ``jax.image.scale_and_translate``'s
    ``compute_weight_mat`` for the linear (triangle) kernel with antialias:
    output sample ``o`` reads input ``(o + 0.5 - t) / s - 0.5``."""
    dev, dt = scale.device, scale.dtype
    inv_scale = (1.0 / scale)[:, None, None]
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    out_pos = torch.arange(out_size, dtype=dt, device=dev)[None, None, :]
    in_pos = torch.arange(in_size, dtype=dt, device=dev)[None, :, None]
    sample_f = ((out_pos + 0.5) * inv_scale
                - translation[:, None, None] * inv_scale - 0.5)
    x = torch.abs(sample_f - in_pos) / kernel_scale
    weights = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = torch.sum(weights, dim=1, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside, weights, torch.zeros_like(weights))


def _resized_crop(imgs, boxes, valid, d: AugmentDraws, crop_ratio,
                  min_visibility: float, out_size: int):
    b, in_size = imgs.shape[0], imgs.shape[1]
    x0, y0, crop_w, crop_h = crop_windows(d, crop_ratio)
    # out[o] samples in[(o + 0.5 - t) / s - 0.5]: the window maps onto the
    # whole output
    sy = out_size / (crop_h * in_size)
    sx = out_size / (crop_w * in_size)
    ty = -y0 * in_size * sy
    tx = -x0 * in_size * sx
    wy = linear_weight_matrix(in_size, out_size, sy, ty)  # (B, in, out)
    wx = linear_weight_matrix(in_size, out_size, sx, tx)
    chw = imgs.permute(0, 3, 1, 2)  # (B, 3, H, W)
    out = torch.matmul(torch.matmul(wy.transpose(1, 2)[:, None], chw), wx[:, None])
    out = torch.clamp(out.permute(0, 2, 3, 1), 0.0, 1.0)

    cx = (boxes[..., 0] - x0[:, None]) / crop_w[:, None]
    cy = (boxes[..., 1] - y0[:, None]) / crop_h[:, None]
    w = boxes[..., 2] / crop_w[:, None]
    h = boxes[..., 3] / crop_h[:, None]
    xmin = torch.clamp(cx - w / 2, 0.0, 1.0)
    xmax = torch.clamp(cx + w / 2, 0.0, 1.0)
    ymin = torch.clamp(cy - h / 2, 0.0, 1.0)
    ymax = torch.clamp(cy + h / 2, 0.0, 1.0)
    new_w = xmax - xmin
    new_h = ymax - ymin
    vis = (new_w * new_h) / torch.clamp_min(w * h, 1e-12)
    keep = valid & (vis >= min_visibility) & (new_w > 1e-4) & (new_h > 1e-4)
    new_boxes = torch.stack([(xmin + xmax) / 2, (ymin + ymax) / 2, new_w, new_h,
                             boxes[..., 4]], dim=-1)
    new_boxes = torch.where(keep[..., None], new_boxes,
                            torch.zeros_like(new_boxes))
    return out, new_boxes, keep


def augment_batch(
    images_u8: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    draws: AugmentDraws,
    hflip_prob: float = 0.5,
    color_strengths: Tuple[float, float, float, float] = (0.2, 0.2, 0.2, 0.2),
    crop_ratio: Tuple[float, float] = (0.75, 4.0 / 3.0),
    min_visibility: float = 0.1,
    out_size: Optional[int] = None,
):
    """``(B, H, W, 3)`` u8 images, ``(B, N, 5)`` boxes and ``(B, N)`` valid
    -> float32 images ``(B, out, out, 3)`` in [0, 1], remapped boxes and the
    updated mask, all on the images' device. ``draws`` must be on that
    device (``AugmentDraws.to``); the crop scale range is in its
    ``crop_area``, the ratio range is needed here for the fallback window."""
    out_size = images_u8.shape[1] if out_size is None else out_size
    imgs = preprocess_eval_batch(images_u8)
    if any(s > 0 for s in color_strengths):
        imgs = _color_jitter(imgs, draws)
    flip = draws.flip < hflip_prob
    imgs = torch.where(flip[:, None, None, None], imgs.flip(2), imgs)
    flipped = torch.cat([1.0 - boxes[..., :1], boxes[..., 1:]], dim=-1)
    boxes = torch.where(flip[:, None, None], flipped, boxes)
    return _resized_crop(imgs, boxes, valid.bool(), draws, crop_ratio,
                         min_visibility, out_size)


def preprocess_eval_batch(images_u8: torch.Tensor) -> torch.Tensor:
    """The eval path's Normalize(0, 1): u8 / 255 in float32, bit-equal to
    the jitted JAX function."""
    return images_u8.to(torch.float32) * _INV_255


def _resample(imgs: torch.Tensor, out_size: int, sy: torch.Tensor,
              sx: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor
              ) -> torch.Tensor:
    """``jax.image.scale_and_translate(method="linear")`` of ``(n, H, W,
    3)`` float images to ``(n, out, out, 3)``, per image scale and
    translation, zero outside the mapped input."""
    in_size = imgs.shape[1]
    wy = linear_weight_matrix(in_size, out_size, sy, ty)  # (n, in, out)
    wx = linear_weight_matrix(in_size, out_size, sx, tx)
    chw = imgs.permute(0, 3, 1, 2)
    out = torch.matmul(torch.matmul(wy.transpose(1, 2)[:, None], chw),
                       wx[:, None])
    return out.permute(0, 2, 3, 1)


def _to_u8(img: torch.Tensor) -> torch.Tensor:
    """``round(clip(img, 0, 1) * 255)`` as u8 (half to even, as jnp.round)."""
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


@dataclasses.dataclass
class MosaicDraws:
    """Every random number of one batch's mosaic: ``perms`` ``(batch, 3)``,
    three permutations of the batch that name each output image's second
    to fourth sources (the first is the image itself); ``center`` ``(batch,
    2)``, each mosaic's ``(cx, cy)`` in relative units; ``apply``
    ``(batch,)`` uniform, the image is a mosaic where it is below the
    probability."""

    perms: torch.Tensor
    center: torch.Tensor
    apply: torch.Tensor

    def to(self, device) -> "MosaicDraws":
        return MosaicDraws(*(getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)))


def sample_mosaic_draws(batch: int, generator: torch.Generator,
                        center_range: Tuple[float, float] = (0.25, 0.75)
                        ) -> MosaicDraws:
    """Draw one batch's ``MosaicDraws`` on the CPU from ``generator``."""
    lo, hi = center_range
    perms = torch.stack([torch.randperm(batch, generator=generator)
                         for _ in range(3)], dim=1)
    center = lo + torch.rand((batch, 2), generator=generator) * (hi - lo)
    return MosaicDraws(perms, center, torch.rand(batch, generator=generator))


def mosaic_batch(images_u8: torch.Tensor, boxes: torch.Tensor,
                 valid: torch.Tensor, draws: MosaicDraws, prob: float = 1.0,
                 out_size: Optional[int] = None):
    """YOLOv4's mosaic (counterpart of ``mosaic_batch``): output image b is
    composed of four sources, b itself and ``draws.perms[b]``, each resized
    whole into one quadrant of the unit square split at ``draws.center[b]``
    (top left, top right, bottom left, bottom right) by one linear
    ``scale_and_translate``; a pixel belongs to the right / bottom quadrants
    from the centre on (``>=``). Boxes follow their source's affine map and
    those not wider and taller than one output pixel are dropped. Where
    ``draws.apply >= prob`` the image passes through (resized to
    ``out_size``), its boxes in the first N of the 4N slots.

    Returns ``(B, out, out, 3)`` u8, ``(B, 4N, 5)`` boxes and ``(B, 4N)``
    validity, on the images' device (``draws`` must be there too)."""
    b, in_size = images_u8.shape[0], images_u8.shape[1]
    out_size = in_size if out_size is None else out_size
    dev = images_u8.device
    imgs = preprocess_eval_batch(images_u8)
    src = torch.cat([torch.arange(b, device=dev)[:, None], draws.perms], 1)
    cx, cy = draws.center[:, 0:1], draws.center[:, 1:2]  # (B, 1)
    zero = torch.zeros_like(cx)
    qx0 = torch.cat([zero, cx, zero, cx], 1)  # (B, 4): TL, TR, BL, BR
    qy0 = torch.cat([zero, zero, cy, cy], 1)
    qw = torch.cat([cx, 1.0 - cx, cx, 1.0 - cx], 1)
    qh = torch.cat([cy, cy, 1.0 - cy, 1.0 - cy], 1)

    pasted = _resample(imgs[src.reshape(-1)], out_size,
                       (qh * out_size / in_size).reshape(-1),
                       (qw * out_size / in_size).reshape(-1),
                       (qy0 * out_size).reshape(-1),
                       (qx0 * out_size).reshape(-1))
    pasted = pasted.reshape(b, 4, out_size, out_size, 3)
    pos = (torch.arange(out_size, device=dev) + 0.5) / out_size
    owner = ((pos[None, None, :] >= cx[:, :, None]).to(torch.int64)
             + 2 * (pos[None, :, None] >= cy[:, :, None]).to(torch.int64))
    index = owner[:, None, :, :, None].expand(b, 1, out_size, out_size, 3)
    mimg = torch.gather(pasted, 1, index)[:, 0]

    sboxes, svalid = boxes[src], valid[src]  # (B, 4, N, 5), (B, 4, N)
    bx = sboxes[..., 0] * qw[..., None] + qx0[..., None]
    by = sboxes[..., 1] * qh[..., None] + qy0[..., None]
    bw = sboxes[..., 2] * qw[..., None]
    bh = sboxes[..., 3] * qh[..., None]
    keep = svalid & (bw > 1.0 / out_size) & (bh > 1.0 / out_size)
    mboxes = torch.stack([bx, by, bw, bh, sboxes[..., 4]], dim=-1)
    mboxes = torch.where(keep[..., None], mboxes, torch.zeros_like(mboxes))
    n = boxes.shape[1]
    mboxes, keep = mboxes.reshape(b, 4 * n, 5), keep.reshape(b, 4 * n)

    pimg = imgs
    if out_size != in_size:  # jax.image.resize(..., "linear")
        s = torch.full((b,), out_size / in_size, dtype=torch.float32, device=dev)
        pimg = _resample(imgs, out_size, s, s, torch.zeros_like(s),
                         torch.zeros_like(s))
    pboxes = torch.cat([boxes, boxes.new_zeros(b, 3 * n, 5)], 1)
    pvalid = torch.cat([valid, valid.new_zeros(b, 3 * n)], 1)

    apply = draws.apply < prob
    img = torch.where(apply[:, None, None, None], mimg, pimg)
    out_boxes = torch.where(apply[:, None, None], mboxes, pboxes)
    out_valid = torch.where(apply[:, None], keep, pvalid)
    return _to_u8(img), out_boxes, out_valid


@dataclasses.dataclass
class MixupDraws:
    """Every random number of one batch's mixup: ``perm`` ``(batch,)``, each
    image's partner; ``lam`` ``(batch,)`` float32 Beta(alpha, alpha)
    draws (folded to ``max(lam, 1 - lam)`` by ``mixup_batch``); ``apply``
    ``(batch,)`` uniform, the image blends where it is below the
    probability."""

    perm: torch.Tensor
    lam: torch.Tensor
    apply: torch.Tensor

    def to(self, device) -> "MixupDraws":
        return MixupDraws(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


def sample_mixup_draws(batch: int, generator: torch.Generator,
                       alpha: float = 1.5) -> MixupDraws:
    """Draw one batch's ``MixupDraws`` on the CPU from ``generator``. torch's
    Beta sampler takes no generator, so ``lam`` comes from a numpy
    generator seeded from ``generator``."""
    perm = torch.randperm(batch, generator=generator)
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    lam = np.random.default_rng(seed).beta(alpha, alpha, batch)
    return MixupDraws(perm, torch.from_numpy(lam.astype(np.float32)),
                      torch.rand(batch, generator=generator))


def mixup_batch(images_u8: torch.Tensor, boxes: torch.Tensor,
                valid: torch.Tensor, draws: MixupDraws, prob: float = 1.0):
    """Detection mixup (counterpart of ``mixup_batch``): where ``draws.apply
    < prob`` image b becomes ``lam * x + (1 - lam) * x[perm[b]]`` with
    ``lam = max(lam, 1 - lam)``, rounded half to even into u8, and keeps
    both images' boxes; elsewhere it passes through with the partner's
    half of the boxes invalid. Returns ``(B, H, W, 3)`` u8, ``(B, 2N, 5)``
    boxes and ``(B, 2N)`` validity (boxes zero where invalid)."""
    lam = torch.maximum(draws.lam, 1.0 - draws.lam)[:, None, None, None]
    apply = draws.apply < prob
    x = images_u8.to(torch.float32)
    mixed = lam * x + (1 - lam) * x[draws.perm]
    img = torch.where(apply[:, None, None, None], mixed, x)
    img_u8 = torch.round(torch.clamp(img, 0.0, 255.0)).to(torch.uint8)
    out_boxes = torch.cat([boxes, boxes[draws.perm]], 1)
    out_valid = torch.cat([valid, valid[draws.perm] & apply[:, None]], 1)
    out_boxes = torch.where(out_valid[..., None], out_boxes,
                            torch.zeros_like(out_boxes))
    return img_u8, out_boxes, out_valid
