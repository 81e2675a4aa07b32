"""Parity of the port's augmentation with the JAX package's.

``jax_draws`` repeats the ``jax.random.split`` chain of
``keras_object_detection_tpu/data/augment.py`` (``augment_batch`` :272-281,
``_color_jitter_batch`` :70-76 and :98, ``_flip_crop_one`` :231-233,
``sample_crop_window`` :128-131 and :149-150) and hands the JAX step's own
random numbers to the port, so ``augment_batch`` can be held against the
JAX function to 1e-5 (float32 sums in another order: the contrast mean and
the resampling products). The port's own sampler is held to its
distribution.
"""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.data import augment as jaug
from keras_object_detection_torch.data import augment as taug
from keras_object_detection_torch.data.augment import AugmentDraws


def jax_draws(key, batch, strengths=(0.2, 0.2, 0.2, 0.2),
              crop_scale=(0.8, 1.0), crop_ratio=(0.75, 4.0 / 3.0),
              attempts=10) -> AugmentDraws:
    """The random numbers ``augment_batch(..., key)`` draws, as the port's
    ``AugmentDraws``."""
    kjit, kspatial = jax.random.split(key)
    kb, kc, ks, kh, kperm = jax.random.split(kjit, 5)
    sb, sc, ss, sh = strengths
    n = batch
    fb = jax.random.uniform(kb, (n, 1, 1, 1), minval=1.0 - sb, maxval=1.0 + sb)
    fc = jax.random.uniform(kc, (n, 1, 1, 1), minval=1.0 - sc, maxval=1.0 + sc)
    fs = jax.random.uniform(ks, (n, 1, 1, 1), minval=1.0 - ss, maxval=1.0 + ss)
    fh = jax.random.uniform(kh, (n, 1, 1), minval=-sh, maxval=sh)
    perm = jax.random.permutation(kperm, 4)
    flips, areas, log_rs, xs, ys = [], [], [], [], []
    for k in jax.random.split(kspatial, n):
        kf, kcrop = jax.random.split(k, 2)
        flips.append(jax.random.uniform(kf, ()))
        ka, kr, kx, ky = jax.random.split(kcrop, 4)
        areas.append(jax.random.uniform(ka, (attempts,), minval=crop_scale[0],
                                        maxval=crop_scale[1]))
        log_rs.append(jax.random.uniform(kr, (attempts,),
                                         minval=jnp.log(crop_ratio[0]),
                                         maxval=jnp.log(crop_ratio[1])))
        xs.append(jax.random.uniform(kx, ()))
        ys.append(jax.random.uniform(ky, ()))

    def t(v):
        return torch.from_numpy(np.array(v, np.float32)).reshape(n, -1).squeeze(1)

    return AugmentDraws(
        brightness=t(fb), contrast=t(fc), saturation=t(fs), hue=t(fh),
        order=tuple(int(i) for i in np.asarray(perm)), flip=t(flips),
        crop_area=torch.from_numpy(np.array(areas, np.float32)),
        crop_log_ratio=torch.from_numpy(np.array(log_rs, np.float32)),
        crop_x=t(xs), crop_y=t(ys))


def batch_inputs(seed, b, size, n=6):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
    boxes = np.zeros((b, n, 5), np.float32)
    boxes[..., :2] = rng.uniform(0.05, 0.95, (b, n, 2))
    boxes[..., 2:4] = rng.uniform(0.02, 0.7, (b, n, 2))
    boxes[..., 4] = rng.randint(0, 5, (b, n))
    valid = rng.uniform(size=(b, n)) < 0.8
    boxes[:, 0] = [0.02, 0.5, 0.04, 0.3, 1]  # mostly cut off by most crops
    return images, boxes, valid


@pytest.mark.parametrize("name,in_size,out_size,kwargs", [
    ("default", 32, None, {}),
    ("downsample", 48, 32, {}),
    ("upsample", 24, 40, {}),
    ("always_flip", 32, None, {"hflip_prob": 1.0}),
    ("no_jitter", 32, None, {"color_strengths": (0.0, 0.0, 0.0, 0.0)}),
    ("strong_jitter", 32, None, {"color_strengths": (0.5, 0.6, 0.7, 0.45)}),
    ("wide_crops", 40, 32, {"crop_scale": (0.2, 1.0), "crop_ratio": (0.3, 3.0)}),
    ("all_rejected", 32, None, {"crop_scale": (1.5, 2.0)}),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_augment_batch_matches_jax_with_its_draws(name, in_size, out_size,
                                                  kwargs, seed):
    images, boxes, valid = batch_inputs(seed, 4, in_size)
    key = jax.random.PRNGKey(seed + 10)
    want_img, want_boxes, want_valid = jaug.augment_batch(
        jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid), key,
        out_size=out_size, **kwargs)
    draw_kw = {k: v for k, v in kwargs.items() if k != "hflip_prob"}
    if "color_strengths" in draw_kw:
        draw_kw["strengths"] = draw_kw.pop("color_strengths")
    draws = jax_draws(key, 4, **draw_kw)
    port_kw = {k: v for k, v in kwargs.items() if k != "crop_scale"}
    img, got_boxes, got_valid = taug.augment_batch(
        torch.from_numpy(images), torch.from_numpy(boxes),
        torch.from_numpy(valid), draws, out_size=out_size, **port_kw)
    size = out_size or in_size
    assert img.shape == (4, size, size, 3) and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(got_boxes.numpy(), np.asarray(want_boxes),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("in_size,out_size,scale,translation", [
    (16, 32, 2.0, 0.0),      # up-sampling
    (16, 24, 1.7, -3.2),     # up-sampling with an offset
    (40, 16, 0.4, 0.0),      # down-sampling: the kernel widens (antialias)
    (40, 24, 0.55, -2.7),    # down-sampling with an offset
    (20, 20, 1.0, 1.5),      # a shift that leaves output samples outside
    (30, 30, 1.25, -6.0),    # a crop-like zoom
])
def test_scale_and_translate_matches_jax(in_size, out_size, scale, translation):
    img = np.random.RandomState(0).uniform(0, 1, (in_size, in_size, 3)).astype(
        np.float32)
    want = jax.image.scale_and_translate(
        jnp.asarray(img), (out_size, out_size, 3), (0, 1),
        jnp.asarray([scale, scale], jnp.float32),
        jnp.asarray([translation, translation], jnp.float32), method="linear")
    s = torch.tensor([scale], dtype=torch.float32)
    t = torch.tensor([translation], dtype=torch.float32)
    w = taug.linear_weight_matrix(in_size, out_size, s, t)[0]  # (in, out)
    got = torch.einsum("hwc,hy,wx->yxc", torch.from_numpy(img), w, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_hsv_round_trip_matches_jax():
    rgb = np.random.RandomState(2).uniform(0, 1, (5, 7, 3)).astype(np.float32)
    rgb[0, :3] = [[0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [1.0, 0.2, 1.0]]  # ties
    hsv = taug._rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jaug._rgb_to_hsv(
        jnp.asarray(rgb))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(taug._hsv_to_rgb(hsv).numpy(), np.asarray(
        jaug._hsv_to_rgb(jnp.asarray(hsv.numpy()))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("crop_scale,crop_ratio", [
    ((0.8, 1.0), (0.75, 4.0 / 3.0)), ((0.3, 1.0), (0.2, 5.0)),
    ((1.2, 1.5), (0.75, 4.0 / 3.0)), ((1.2, 1.5), (1.5, 2.0))])
def test_crop_windows_match_sample_crop_window(crop_scale, crop_ratio):
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    want = np.array([jaug.sample_crop_window(k, crop_scale, crop_ratio)
                     for k in keys], np.float32)
    draws = []
    for k in keys:  # sample_crop_window's own key is the crop key
        ka, kr, kx, ky = jax.random.split(k, 4)
        draws.append((
            jax.random.uniform(ka, (10,), minval=crop_scale[0], maxval=crop_scale[1]),
            jax.random.uniform(kr, (10,), minval=jnp.log(crop_ratio[0]),
                               maxval=jnp.log(crop_ratio[1])),
            jax.random.uniform(kx, ()), jax.random.uniform(ky, ())))
    d = AugmentDraws(
        brightness=torch.ones(6), contrast=torch.ones(6),
        saturation=torch.ones(6), hue=torch.zeros(6), order=(0, 1, 2, 3),
        flip=torch.ones(6),
        crop_area=torch.tensor(np.array([a for a, _, _, _ in draws])),
        crop_log_ratio=torch.tensor(np.array([r for _, r, _, _ in draws])),
        crop_x=torch.tensor(np.array([x for _, _, x, _ in draws])),
        crop_y=torch.tensor(np.array([y for _, _, _, y in draws])))
    got = torch.stack(taug.crop_windows(d, crop_ratio), dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_port_sampler_distribution():
    """The port's own draws: ranges, means, every colour order, and crop
    windows inside the scale and ratio bounds; the same seed gives the same
    draws."""
    g = torch.Generator().manual_seed(0)
    batches = [taug.sample_augment_draws(64, g) for _ in range(60)]
    cat = lambda f: torch.cat([getattr(d, f).reshape(-1) for d in batches])
    for f, lo, hi in [("brightness", 0.8, 1.2), ("contrast", 0.8, 1.2),
                      ("saturation", 0.8, 1.2), ("hue", -0.2, 0.2),
                      ("flip", 0.0, 1.0), ("crop_area", 0.8, 1.0),
                      ("crop_log_ratio", math.log(0.75), math.log(4 / 3)),
                      ("crop_x", 0.0, 1.0), ("crop_y", 0.0, 1.0)]:
        v = cat(f)
        assert lo <= v.min() and v.max() < hi, f
        assert abs(v.mean().item() - (lo + hi) / 2) < 0.03 * (hi - lo), f
        assert abs(v.std().item() - (hi - lo) / math.sqrt(12)) < 0.03 * (hi - lo), f
    flips = cat("flip") < 0.5
    assert 0.45 < flips.float().mean().item() < 0.55
    orders = {d.order for d in batches}
    assert len(orders) > 15 and orders <= set(itertools.permutations(range(4)))
    x0, y0, w, h = taug.crop_windows(batches[0], (0.75, 4.0 / 3.0))
    assert ((w * h >= 0.8 - 1e-6) & (w * h <= 1.0 + 1e-6)).all()
    assert ((w <= 1.0) & (h <= 1.0) & (x0 >= 0) & (x0 + w <= 1.0 + 1e-6)).all()
    assert ((w / h >= 0.75 - 1e-5) & (w / h <= 4 / 3 + 1e-5)).all()
    again = taug.sample_augment_draws(64, torch.Generator().manual_seed(0))
    assert torch.equal(again.crop_area, batches[0].crop_area)
    assert again.order == batches[0].order


def test_preprocess_eval_batch_is_bit_equal():
    images = np.random.RandomState(4).randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        taug.preprocess_eval_batch(torch.from_numpy(images)).numpy(),
        np.asarray(jaug.preprocess_eval_batch(jnp.asarray(images))))
