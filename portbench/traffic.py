"""The general traffic generator: what a traffic file's parameters describe,
made on the device from the seed.

A traffic file (``traffic/<mix>.json``) names its ``kind`` (``train`` or
``serve``, the runner that runs it) and the sizes below. Every seed gives
the same sizes; only the contents and the order differ.

- ``dataset`` images (train) or ``pool`` images (serve), u8 scenes at the
  model's input size (``images``);
- per image ``objects`` boxes, their count drawn from ``objects.min`` ..
  ``objects.max`` with weights ``ratio ** (k - min)`` (a truncated
  geometric), classes uniform over the configuration's, each side
  log-uniform over ``box_side``, the centre uniform where the box fits;
- ``order``: the epoch's shuffled image order (a permutation from the
  seed, cut into batches, the remainder dropped).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

CHUNK_IMAGES = 128
# sides of the random colour grids a background is made of, coarse to fine
OCTAVES = (4, 8, 16, 32, 64, 128)


@dataclasses.dataclass
class Dataset:
    """Device-resident rows: ``images`` ``(n, s, s, 3)`` u8, ``boxes`` ``(n,
    max_boxes, 5)`` ``[cx, cy, w, h, class]`` and their ``valid`` mask."""

    images: torch.Tensor
    boxes: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None


def images(n: int, size: int, gen: torch.Generator, device,
           boxes: Optional[torch.Tensor] = None,
           valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(n, size, size, 3)`` u8 scenes: a background whose detail falls off
    as natural images' does (random colour grids of ``OCTAVES`` sizes,
    each upsampled bilinearly, its amplitude halving as its size doubles),
    and over it each valid box painted as a rectangle of a colour of its
    own with a little texture."""
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    for lo in range(0, n, CHUNK_IMAGES):
        m = min(CHUNK_IMAGES, n - lo)
        img = torch.zeros((m, 3, size, size), device=device)
        weight = 0.0
        for g in OCTAVES:
            grid = torch.rand((m, 3, g, g), generator=gen, device=device)
            img += F.interpolate(grid, size=(size, size), mode="bilinear",
                                 align_corners=False) * (OCTAVES[0] / g)
            weight += OCTAVES[0] / g
        img /= weight
        if boxes is not None:
            pos = (torch.arange(size, device=device) + 0.5) / size
            colour = torch.rand((m, boxes.shape[1], 3), generator=gen,
                                device=device)
            for j in range(int(valid[lo:lo + m].sum(1).max())):
                b = boxes[lo:lo + m, j]
                inside = (((pos[None, :] - b[:, 0:1]).abs() <= b[:, 2:3] / 2)
                          [:, None, :]
                          & ((pos[None, :] - b[:, 1:2]).abs() <= b[:, 3:4] / 2)
                          [:, :, None]
                          & valid[lo:lo + m, j, None, None])
                paint = 0.75 * colour[:, j, :, None, None] + 0.25 * img
                img = torch.where(inside[:, None], paint, img)
        out[lo:lo + m] = (img.clamp(0, 1) * 255).round().to(
            torch.uint8).permute(0, 2, 3, 1)
    return out


def boxes(n: int, max_boxes: int, classes: int, spec: dict,
          gen: torch.Generator, device):
    """``(boxes, valid)`` of ``n`` images, as the module docstring says."""
    lo, hi, ratio = spec["objects"]["min"], spec["objects"]["max"], \
        spec["objects"]["ratio"]
    if hi > max_boxes:
        raise ValueError(f"{hi} objects an image exceed the {max_boxes} "
                         "box slots")
    weights = torch.tensor([ratio ** k for k in range(hi - lo + 1)],
                           device=device)
    counts = lo + torch.multinomial(weights, n, replacement=True,
                                    generator=gen)
    valid = torch.arange(max_boxes, device=device)[None, :] < counts[:, None]
    s0, s1 = (math.log(v) for v in spec["box_side"])
    u = torch.rand((n, max_boxes, 4), generator=gen, device=device)
    wh = torch.exp(s0 + u[..., 2:] * (s1 - s0))
    centre = wh / 2 + u[..., :2] * (1 - wh)
    cls = torch.randint(0, classes, (n, max_boxes), generator=gen,
                        device=device).float()
    rows = torch.cat([centre, wh, cls[..., None]], dim=-1)
    return torch.where(valid[..., None], rows, torch.zeros_like(rows)), valid


def dataset(cfg: dict, spec: dict, seed: int, device) -> Dataset:
    """The train traffic's dataset (``dataset`` scenes and their boxes), or
    the serve traffic's pool (``pool`` scenes, their boxes dropped)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    size = cfg["model"]["image_size"]
    n = spec["dataset"] if spec["kind"] == "train" else spec["pool"]
    bx, valid = boxes(n, cfg["data"]["max_boxes_per_image"], cfg["grid"][
        "num_classes"], spec, gen, device)
    pictures = images(n, size, gen, device, bx, valid)
    if spec["kind"] == "serve":
        return Dataset(pictures)
    return Dataset(pictures, bx, valid)


def epoch_order(n: int, batch: int, seed: int, epoch: int) -> torch.Tensor:
    """``(steps, batch)`` row indices of one epoch on the CPU: a
    permutation drawn from the seed and the epoch, the remainder dropped."""
    gen = torch.Generator().manual_seed((seed * 1_000_003 + epoch) % 2 ** 63)
    perm = torch.randperm(n, generator=gen)
    steps = n // batch
    return perm[:steps * batch].reshape(steps, batch)
