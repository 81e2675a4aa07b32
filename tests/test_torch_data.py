"""The port's data modules against the JAX package's on the same files: the
reader (cv2 and the native loader, letterbox), ``YoloDataset`` (length,
padding, two shuffled epochs), the disk cache (either package's cache opens
in the other) and ``DeviceCachedDataset`` on the CPU.

The images are written with cv2 into ``tmp_path``: random pixels at 64x80,
so every decode resizes, with 0-3 boxes an image."""

import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from keras_object_detection_tpu.data import disk_cache as jdisk
from keras_object_detection_tpu.data import native as jnative
from keras_object_detection_tpu.data import pipeline as jpipe
from keras_object_detection_tpu.data import reader as jreader
from keras_object_detection_torch.data import disk_cache, native, pipeline, reader


def write_dataset(data_dir, n: int, seed: int = 0, shape=(64, 80),
                  num_classes: int = 3, max_objects: int = 3) -> str:
    """``n`` random JPEGs with YOLO labels in ``data_dir``."""
    import cv2

    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        img = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
        cv2.imwrite(os.path.join(data_dir, f"img{i:03d}.jpg"), img)
        with open(os.path.join(data_dir, f"img{i:03d}.txt"), "w") as f:
            for _ in range(rng.randint(0, max_objects + 1)):
                cx, cy = rng.uniform(0.2, 0.8, 2)
                w, h = rng.uniform(0.1, 0.4, 2)
                f.write(f"{rng.randint(num_classes)} {cx:.6f} {cy:.6f} "
                        f"{w:.6f} {h:.6f}\n")
    return str(data_dir)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("torch_data"), 7)


def _equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("letterbox", [False, True])
def test_reader_matches_jax(data_dir, letterbox):
    paths = reader.list_examples(data_dir)
    assert paths == jreader.list_examples(data_dir) and len(paths) == 7
    for p in paths:
        labels = os.path.splitext(p)[0] + ".txt"
        _equal(reader.read_yolo_labels(labels), jreader.read_yolo_labels(labels))
        got = reader.load_example(p, 56, 4, letterbox=letterbox)
        want = jreader.load_example(p, 56, 4, letterbox=letterbox)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            _equal(g, w)
    for h, w in [(64, 80), (80, 64), (33, 100)]:
        assert (reader.letterbox_geometry(h, w, 56)
                == jreader.letterbox_geometry(h, w, 56))
        dets = np.random.RandomState(h).uniform(0, 1, (5, 6)).astype(np.float32)
        _equal(reader.unletterbox_detections(dets, h, w, 56),
               jreader.unletterbox_detections(dets, h, w, 56))


def test_native_loader_matches_jax_binding(data_dir, monkeypatch):
    """``KOT_NATIVE=1`` decodes with the C++ loader: the same bytes as the
    JAX package's binding of the same library, one file or a batch."""
    if not (native.available() and jnative.available()):
        pytest.skip(f"native loader unavailable: {native.unavailable_reason()}")
    paths = reader.list_examples(data_dir)
    monkeypatch.setenv("KOT_NATIVE", "1")
    for p in paths:
        _equal(reader.load_example(p, 56, 4)[0],
               jnative.decode_resize_file(p, 56, 56))
    got, ok = native.load_batch(paths, 56, 48, n_threads=2)
    want, wok = jnative.load_batch(paths, 56, 48, n_threads=2)
    assert ok.all() and wok.all()
    _equal(got, want)


def test_native_loader_builds_outside_the_tracked_directory(tmp_path,
                                                           monkeypatch):
    """When the tracked library does not load, the source is built into
    the build directory given, never into ``native/``."""
    headers = shutil.which("g++") and subprocess.run(
        ["g++", "-E", "-x", "c++", "-"], input="#include <jpeglib.h>\n",
        capture_output=True, text=True).returncode == 0
    if not headers:
        pytest.skip("no g++ or libjpeg headers to build the native loader")
    before = sorted(os.listdir(native.SOURCE.parent))
    monkeypatch.setattr(native, "TRACKED", tmp_path / "missing.so")
    monkeypatch.setattr(native, "BUILT", tmp_path / "build" / "libkot_loader.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", None)
    assert native.available(), native.unavailable_reason()
    assert (tmp_path / "build" / "libkot_loader.so").exists()
    assert sorted(os.listdir(native.SOURCE.parent)) == before


def test_reader_raises_without_a_decoder(data_dir, monkeypatch):
    monkeypatch.setattr(reader, "_cv2", lambda: None)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "unavailable_reason", lambda: "no libjpeg")
    with pytest.raises(RuntimeError, match="cv2 does not import.*no libjpeg"):
        reader.load_example(reader.list_examples(data_dir)[0], 56, 4)
    with pytest.raises(RuntimeError, match="needs cv2"):
        reader.load_example(reader.list_examples(data_dir)[0], 56, 4,
                            letterbox=True)


@pytest.mark.parametrize("batch,drop", [(2, False), (2, True), (3, False),
                                        (4, True)])
def test_dataset_matches_jax_across_shuffled_epochs(data_dir, batch, drop):
    kw = dict(max_boxes=4, shuffle=True, drop_remainder=drop, seed=5,
              num_workers=2)
    ours = pipeline.YoloDataset(data_dir, 56, batch, **kw)
    theirs = jpipe.YoloDataset(data_dir, 56, batch, **kw)
    assert len(ours) == len(theirs) == (7 // batch if drop else -(-7 // batch))
    assert ours.num_examples == theirs.num_examples == 7
    for _ in range(2):
        got, want = list(ours.epoch()), list(theirs.epoch())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and a.shape == b.shape
                _equal(a, b)
    if not drop and 7 % batch:  # the padded tail: zero images, no box
        images, boxes, valid = got[-1]
        pad = slice(7 % batch, None)
        assert not images[pad].any() and not boxes[pad].any()
        assert not valid[pad].any()


def test_prefetched_on_the_cpu_gives_the_host_batches(data_dir):
    mk = lambda: pipeline.YoloDataset(data_dir, 56, 3, max_boxes=4,
                                      shuffle=True, seed=2, num_workers=2)
    host, fetched = mk(), mk()
    for _ in range(2):
        want = list(host.epoch())
        got = list(fetched.prefetched("cpu"))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert all(isinstance(t, torch.Tensor) for t in g)
            for a, b in zip(g, w):
                _equal(a, b)


def test_disk_cache_identical_and_rebuilt_when_stale(data_dir, tmp_path):
    cache = str(tmp_path / "cache")
    live = next(pipeline.YoloDataset(data_dir, 56, 7, max_boxes=4).epoch())
    cached = next(pipeline.YoloDataset(data_dir, 56, 7, max_boxes=4,
                                       cache_dir=cache).epoch())
    for a, b in zip(live, cached):
        _equal(a, b)
    meta = os.path.join(cache, "meta.json")
    before = os.path.getmtime(meta)
    pipeline.YoloDataset(data_dir, 56, 7, max_boxes=4, cache_dir=cache)
    assert os.path.getmtime(meta) == before  # a valid cache is reused
    ds48 = pipeline.YoloDataset(data_dir, 48, 7, max_boxes=4, cache_dir=cache)
    with open(meta) as f:
        assert json.load(f)["image_size"] == 48
    _equal(next(ds48.epoch())[0],
           next(pipeline.YoloDataset(data_dir, 48, 7, max_boxes=4).epoch())[0])


@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_a_cache_built_by_either_package_opens_in_the_other(data_dir, tmp_path,
                                                            built_by):
    cache = str(tmp_path / "cache")
    paths = reader.list_examples(data_dir)
    build, reopen = ((jdisk.open_or_build, disk_cache.open_or_build)
                     if built_by == "jax" else
                     (disk_cache.open_or_build, jdisk.open_or_build))
    first = build(paths, 56, 4, cache)
    stamp = os.path.getmtime(os.path.join(cache, "meta.json"))
    second = reopen(paths, 56, 4, cache)
    assert os.path.getmtime(os.path.join(cache, "meta.json")) == stamp
    for name in ("images", "boxes", "valid"):
        _equal(getattr(second, name), getattr(first, name))
    assert (disk_cache.meta_for(paths, 56, 4)
            == jdisk._meta_for(paths, 56, 4))


def test_cache_written_from_arrays_opens_without_decoding(tmp_path):
    """``disk_cache.write`` lays out arrays as a decoded cache; the files it
    names need not be JPEGs, so a dataset can be made without a decoder."""
    data = tmp_path / "data"
    data.mkdir()
    paths = [str(data / f"{i}.jpg") for i in range(5)]
    for p in paths:
        open(p, "wb").close()
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (5, 32, 32, 3)).astype(np.uint8)
    boxes = rng.uniform(0, 1, (5, 3, 5)).astype(np.float32)
    valid = rng.uniform(size=(5, 3)) < 0.5
    disk_cache.write(str(tmp_path / "cache"), paths, 32, 3,
                     zip(images, boxes, valid))
    for ds in (pipeline.YoloDataset(str(data), 32, 5, max_boxes=3,
                                    cache_dir=str(tmp_path / "cache")),
               jpipe.YoloDataset(str(data), 32, 5, max_boxes=3,
                                 cache_dir=str(tmp_path / "cache"))):
        got = next(ds.epoch())
        for a, b in zip(got, (images, boxes, valid)):
            _equal(a, b)


def test_device_cached_dataset_on_the_cpu_equals_the_host_batches(data_dir):
    mk = lambda: pipeline.YoloDataset(data_dir, 56, 3, max_boxes=4,
                                      shuffle=True, seed=9, num_workers=2,
                                      cache_in_memory=True)
    host, dev = mk(), pipeline.DeviceCachedDataset(mk(), "cpu")
    assert len(dev) == 3 and dev.num_examples == 7 and dev.pad_row == 7
    assert not dev.images[7].any() and not dev.valid[7].any()
    for _ in range(2):
        for (hi, hb, hv), (di, db, dv, idx) in zip(host.epoch(), dev.epoch()):
            for a, b in zip((di, db, dv), (hi, hb, hv)):
                _equal(a, b)
            assert idx.shape == (3,)


def test_device_cache_size_guard_and_sharded_layout(data_dir):
    ds = pipeline.YoloDataset(data_dir, 50000, 2, max_boxes=4)  # ~52 GB
    with pytest.raises(ValueError, match="too large for the device"):
        pipeline.DeviceCachedDataset(ds, "cpu")
    small = pipeline.YoloDataset(data_dir, 56, 2, max_boxes=4)
    # as JAX's: the sharded layout needs a mesh; over a one-device mesh
    # its batches are the replicated layout's (two ranks:
    # tests/test_torch_parallel_fit.py)
    with pytest.raises(ValueError, match="requires a mesh"):
        pipeline.DeviceCachedDataset(small, "cpu", layout="sharded")
    from keras_object_detection_torch.parallel import create_mesh
    mesh = create_mesh(devices=["cpu"])
    sharded = pipeline.DeviceCachedDataset(small, "cpu", "sharded", mesh)
    replicated = pipeline.DeviceCachedDataset(small, "cpu")
    for a, b in zip(sharded.epoch(), replicated.epoch()):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
