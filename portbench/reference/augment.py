"""The train step's augmentation, in plain torch and float32: u8 / 255, the
colour jitter (brightness, contrast, saturation, hue, in a drawn order), a
horizontal flip and a RandomResizedCrop resampled with a linear antialiased
kernel, boxes remapped, clipped and filtered by their visible share.

The random numbers of step ``step`` under ``seed`` come from a CPU
generator seeded by ``SeedSequence([seed, step])``, drawn in the order the
system draws them, so one seed gives both sides the same draws.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

_F32_EPS = 1.1920928955078125e-07
_INV_255 = 1.0 / 255.0


def step_draws(seed: int, step: int, batch: int, data: dict
               ) -> Dict[str, torch.Tensor]:
    """One step's colour, flip and crop draws on the CPU."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(state))

    def uniform(lo, hi, *shape):
        return lo + torch.rand(shape, generator=gen) * (hi - lo)

    sb, sc, ss, sh = data["color_jitter"]
    lr0, lr1 = (math.log(r) for r in data["crop_ratio"])
    a0, a1 = data["crop_scale"]
    return {
        "brightness": uniform(1.0 - sb, 1.0 + sb, batch),
        "contrast": uniform(1.0 - sc, 1.0 + sc, batch),
        "saturation": uniform(1.0 - ss, 1.0 + ss, batch),
        "hue": uniform(-sh, sh, batch),
        "order": tuple(torch.randperm(4, generator=gen).tolist()),
        "flip": uniform(0.0, 1.0, batch),
        "crop_area": uniform(a0, a1, batch, 10),
        "crop_log_ratio": uniform(lr0, lr1, batch, 10),
        "crop_x": uniform(0.0, 1.0, batch),
        "crop_y": uniform(0.0, 1.0, batch),
    }


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.amax(rgb, dim=-1)
    minc = torch.amin(rgb, dim=-1)
    rng = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, rng / torch.clamp_min(maxc, 1e-12), zero)
    safe = torch.clamp_min(rng, 1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng > 0, torch.remainder(h / 6.0, 1.0), zero)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    sector = torch.remainder(i.to(torch.int64), 6)[..., None]

    def pick(*cols):
        return torch.gather(torch.stack(cols, -1), -1, sector)[..., 0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def _luma(im):
    return 0.299 * im[..., 0] + 0.587 * im[..., 1] + 0.114 * im[..., 2]


def _color_jitter(imgs, d):
    fb = d["brightness"][:, None, None, None]
    fc = d["contrast"][:, None, None, None]
    fs = d["saturation"][:, None, None, None]
    fh = d["hue"][:, None, None]

    def brightness(im):
        return torch.clamp(im * fb, 0.0, 1.0)

    def contrast(im):
        mean = torch.mean(_luma(im), dim=(1, 2), keepdim=True)[..., None]
        return torch.clamp((im - mean) * fc + mean, 0.0, 1.0)

    def saturation(im):
        gray = _luma(im)[..., None]
        return torch.clamp(gray + (im - gray) * fs, 0.0, 1.0)

    def hue(im):
        hsv = _rgb_to_hsv(im)
        hsv = torch.cat([torch.remainder(hsv[..., :1] + fh[..., None], 1.0),
                         hsv[..., 1:]], dim=-1)
        return torch.clamp(_hsv_to_rgb(hsv), 0.0, 1.0)

    ops = (brightness, contrast, saturation, hue)
    for k in d["order"]:
        imgs = ops[k](imgs)
    return imgs


def _crop_windows(d, crop_ratio):
    """The first proposal ``w = sqrt(area r)``, ``h = sqrt(area / r)`` that
    fits the unit square, else the whole image."""
    r = torch.exp(d["crop_log_ratio"])
    w = torch.sqrt(d["crop_area"] * r)
    h = torch.sqrt(d["crop_area"] / r)
    ok = (w <= 1.0) & (h <= 1.0)
    first = torch.argmax(ok.to(torch.uint8), dim=1, keepdim=True)
    any_ok = ok.any(dim=1)
    fb_w = 1.0 if crop_ratio[0] <= 1.0 <= crop_ratio[1] else (
        crop_ratio[1] if 1.0 > crop_ratio[1] else 1.0)
    fb_h = 1.0 / crop_ratio[0] if 1.0 < crop_ratio[0] else 1.0
    crop_w = torch.where(any_ok, torch.gather(w, 1, first)[:, 0],
                         torch.full_like(w[:, 0], fb_w))
    crop_h = torch.where(any_ok, torch.gather(h, 1, first)[:, 0],
                         torch.full_like(h[:, 0], fb_h))
    return (d["crop_x"] * (1.0 - crop_w), d["crop_y"] * (1.0 - crop_h),
            crop_w, crop_h)


def _weights(in_size, out_size, scale, translation):
    """``(batch, in, out)`` linear-kernel resampling weights with antialias:
    output ``o`` reads input ``(o + 0.5 - t) / s - 0.5``."""
    dev, dt = scale.device, scale.dtype
    inv = (1.0 / scale)[:, None, None]
    kscale = torch.clamp_min(inv, 1.0)
    out_pos = torch.arange(out_size, dtype=dt, device=dev)[None, None, :]
    in_pos = torch.arange(in_size, dtype=dt, device=dev)[None, :, None]
    sample = (out_pos + 0.5) * inv - translation[:, None, None] * inv - 0.5
    x = torch.abs(sample - in_pos) / kscale
    w = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = torch.sum(w, dim=1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside, w, torch.zeros_like(w))


def augment(images_u8, boxes, valid, d, data: dict, out_size: int):
    """u8 ``(B, H, W, 3)`` images, ``(B, N, 5)`` boxes and ``(B, N)`` mask
    -> float images in [0, 1] at ``out_size``, boxes and mask."""
    imgs = images_u8.to(torch.float32) * _INV_255
    if any(s > 0 for s in data["color_jitter"]):
        imgs = _color_jitter(imgs, d)
    flip = d["flip"] < data["hflip_prob"]
    imgs = torch.where(flip[:, None, None, None], imgs.flip(2), imgs)
    flipped = torch.cat([1.0 - boxes[..., :1], boxes[..., 1:]], dim=-1)
    boxes = torch.where(flip[:, None, None], flipped, boxes)
    valid = valid.bool()

    in_size = imgs.shape[1]
    x0, y0, cw, ch = _crop_windows(d, data["crop_ratio"])
    sy, sx = out_size / (ch * in_size), out_size / (cw * in_size)
    wy = _weights(in_size, out_size, sy, -y0 * in_size * sy)
    wx = _weights(in_size, out_size, sx, -x0 * in_size * sx)
    chw = imgs.permute(0, 3, 1, 2)
    out = torch.matmul(torch.matmul(wy.transpose(1, 2)[:, None], chw),
                       wx[:, None])
    out = torch.clamp(out.permute(0, 2, 3, 1), 0.0, 1.0)

    cx = (boxes[..., 0] - x0[:, None]) / cw[:, None]
    cy = (boxes[..., 1] - y0[:, None]) / ch[:, None]
    w = boxes[..., 2] / cw[:, None]
    h = boxes[..., 3] / ch[:, None]
    xmin, xmax = torch.clamp(cx - w / 2, 0, 1), torch.clamp(cx + w / 2, 0, 1)
    ymin, ymax = torch.clamp(cy - h / 2, 0, 1), torch.clamp(cy + h / 2, 0, 1)
    nw, nh = xmax - xmin, ymax - ymin
    vis = (nw * nh) / torch.clamp_min(w * h, 1e-12)
    keep = (valid & (vis >= data["min_visibility"]) & (nw > 1e-4)
            & (nh > 1e-4))
    nb = torch.stack([(xmin + xmax) / 2, (ymin + ymax) / 2, nw, nh,
                      boxes[..., 4]], dim=-1)
    return out, torch.where(keep[..., None], nb, torch.zeros_like(nb)), keep
