"""The port's darknet-weights and dataset round-trip commands
(``cli/darknet_weights.py``, ``cli/visualize_dataset.py``) against the
repository's ``tools/darknet_weights.py`` and ``tools/visualize_dataset.py``
on the JAX package:
- ``export`` of a port checkpoint of ``flax_to_torch`` weights writes the
  bytes JAX's tool writes from JAX's checkpoint of the same weights (whole,
  a ``.conv.NN`` prefix, the EMA weights);
- ``inspect`` prints JAX's lines, with and without an architecture table;
- the round trip (encode -> decode -> NMS) keeps exactly JAX's rows and
  writes pixel-equal images; with ``--augment`` it gives back the
  augmented labels the grid holds."""

import argparse
import importlib.util
import os
import pathlib
import struct
import sys

import jax
import numpy as np
import pytest

from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_tpu.train.checkpoint import \
    CheckpointManager as JCheckpointManager
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.cli import darknet_weights, visualize_dataset
from keras_object_detection_torch.train import create_train_state
from keras_object_detection_torch.train.checkpoint import CheckpointManager
from test_torch_data import write_dataset
from test_torch_fit import _jcfg, _load

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  TOOLS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """JAX's checkpoint of seeded darknet_micro weights (an EMA apart from
    the parameters) and the port's checkpoint of the same weights."""
    tmp = tmp_path_factory.mktemp("darknet")
    jcfg = _jcfg(str(tmp / "unused"), ema=0.99)
    jstate = jloop.create_train_state(jcfg, jax.random.PRNGKey(4))
    jstate = jstate.replace(step=7, ema_params=jax.tree_util.tree_map(
        lambda p: 0.5 * p + 0.01, jstate.params))
    jdir, tdir = tmp / "jax", tmp / "torch"
    for d in (jdir, tdir):
        os.makedirs(d)
        (d / "config.json").write_text(jcfg.to_json())
    manager = JCheckpointManager(str(jdir))
    manager.save(0, jstate, {"val_loss": 1.0})
    manager.close()
    state = create_train_state(tconfig.Config.from_json(jcfg.to_json()),
                               device="cpu")
    _load(state, *jax.device_get((jstate.params, jstate.batch_stats,
                                  jstate.ema_params)))
    state.step = 7  # the header's "seen"
    manager = CheckpointManager(str(tdir))
    manager.save(0, state, {"val_loss": 1.0})
    manager.close()
    return str(jdir), str(tdir)


@pytest.mark.parametrize("extra", [[], ["--num-convs", "2"], ["--ema"]],
                         ids=["whole", "prefix", "ema"])
def test_export_writes_jax_s_bytes(checkpoints, extra, tmp_path):
    jdir, tdir = checkpoints
    want_path, got_path = str(tmp_path / "jax.weights"), str(tmp_path / "t.w")
    _jax_tool("darknet_weights").cmd_export(argparse.Namespace(
        checkpoint=jdir, out=want_path, ema="--ema" in extra,
        num_convs=2 if "--num-convs" in extra else None))
    out = darknet_weights.main(["export", "--checkpoint", tdir, "--out",
                                got_path, "--device", "cpu", *extra])
    with open(want_path, "rb") as f, open(got_path, "rb") as g:
        want, got = f.read(), g.read()
    assert got == want and out["bytes"] == len(got)
    assert out["saved_convs"] == (2 if extra[:1] == ["--num-convs"] else 4)


def _weights_file(path, version, seen, floats):
    """A darknet header (int64 ``seen`` from version 0.2 on) and ``floats``
    float32 values."""
    major, minor = version
    head = struct.pack("<3i", major, minor, 0) + struct.pack(
        "<q" if major * 10 + minor >= 2 else "<i", seen)
    with open(path, "wb") as f:
        f.write(head + np.arange(floats, dtype="<f4").tobytes())
    return str(path)


# darknet19's first two convs exactly (4*32 + 27*32, 4*64 + 288*64), then
# a payload that ends inside the first conv's
@pytest.mark.parametrize("version,floats", [((0, 2), 992 + 18688),
                                            ((0, 1), 1000)])
@pytest.mark.parametrize("backbone", [None, "darknet19", "darknet53",
                                      "darknet_tiny"])
def test_inspect_prints_jax_s_lines(version, floats, backbone, tmp_path,
                                    capsys):
    path = _weights_file(tmp_path / "x.weights", version, 1234, floats)
    _jax_tool("darknet_weights").cmd_inspect(argparse.Namespace(
        weights=path, backbone=backbone))
    want = capsys.readouterr().out
    darknet_weights.main(["inspect", "--weights", path]
                         + (["--backbone", backbone] if backbone else []))
    got = capsys.readouterr().out
    assert got == want
    # darknet19 and darknet53 open with the same two convs
    assert ("<-- file ends here" in got) == (
        backbone in ("darknet19", "darknet53") and version == (0, 2))


@pytest.fixture(scope="module")
def viz_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("viz")
    data = write_dataset(root / "data", 5, seed=8, max_objects=4)
    names = root / "names.txt"
    names.write_text("cat\ndog\nbird\n")
    return data, str(names)


@pytest.mark.parametrize("letterbox", [False, True])
def test_round_trip_keeps_jax_s_rows_and_images(viz_data, letterbox, tmp_path,
                                                monkeypatch):
    import cv2

    from keras_object_detection_tpu.utils import viz as jviz

    data, names = viz_data
    flags = ["--data-dir", data, "--names", names, "--limit", "4"] + (
        ["--letterbox"] if letterbox else [])
    jax_rows = []
    tag = jviz.get_tagged_img

    def recording(img, boxes, names_path):
        jax_rows.append(np.asarray(boxes))
        return tag(img, boxes, names_path)

    monkeypatch.setattr(jviz, "get_tagged_img", recording)
    monkeypatch.setattr(sys, "argv", ["visualize_dataset.py", *flags,
                                      "--out-dir", str(tmp_path / "jax")])
    _jax_tool("visualize_dataset").main()
    got = visualize_dataset.main([*flags, "--out-dir", str(tmp_path / "t"),
                                  "--device", "cpu"])
    # get_grid_tagged_img draws through get_tagged_img: two calls an image
    assert len(got) == 4 and len(jax_rows) == 8
    for rt, want in zip(got, jax_rows[::2]):
        assert rt.kept.dtype == np.float32
        np.testing.assert_array_equal(rt.kept, want)
    assert sum(len(rt.kept) for rt in got) >= 4  # images with no label too
    files = sorted(os.listdir(tmp_path / "jax"))
    assert len(files) == 8 and files == sorted(os.listdir(tmp_path / "t"))
    for name in files:
        a = cv2.imread(str(tmp_path / "jax" / name))
        b = cv2.imread(str(tmp_path / "t" / name))
        assert a is not None and np.array_equal(a, b), name


def grid_labels(boxes, valid, grid=7):
    """The labels an S x S grid holds, ``(K, 5)`` sorted: the first box of
    each cell (the encoder's rule)."""
    taken, out = set(), []
    for b in boxes[valid]:
        cell = (min(int(np.floor(grid * b[1])), grid - 1),
                min(int(np.floor(grid * b[0])), grid - 1))
        if cell not in taken:
            taken.add(cell)
            out.append(b)
    out = np.asarray(out, np.float32).reshape(-1, 5)
    return out[np.lexsort((out[:, 1], out[:, 0]))]


def test_augmented_round_trip_gives_back_its_labels(viz_data, tmp_path):
    data, names = viz_data
    flags = ["--data-dir", data, "--names", names, "--limit", "5",
             "--image-size", "112", "--device", "cpu"]
    plain = visualize_dataset.main([*flags, "--out-dir", str(tmp_path / "p")])
    aug = visualize_dataset.main([*flags, "--augment", "--out-dir",
                                  str(tmp_path / "a")])
    again = visualize_dataset.main([*flags, "--augment", "--out-dir",
                                    str(tmp_path / "b")])
    # the last image's draws: a generator seeded with its index
    import torch

    from keras_object_detection_torch.data.augment import (
        augment_batch, sample_augment_draws)

    n = len(plain) - 1
    img, boxes, valid = augment_batch(
        torch.from_numpy(plain[n].image[None]),
        torch.from_numpy(plain[n].boxes[None]),
        torch.from_numpy(plain[n].valid[None]),
        sample_augment_draws(1, torch.Generator().manual_seed(n)))
    assert np.array_equal((img[0].numpy() * 255).astype(np.uint8),
                          aug[n].image)
    assert np.array_equal(boxes[0].numpy(), aug[n].boxes)
    moved = 0
    for p, a, b in zip(plain, aug, again):
        assert np.array_equal(a.image, b.image)  # seeded by the index
        assert np.array_equal(a.kept, b.kept)
        moved += not np.array_equal(a.image, p.image)
        want = grid_labels(a.boxes, a.valid)
        kept = a.kept[np.lexsort((a.kept[:, 3], a.kept[:, 2]))]
        assert len(kept) == len(want)
        np.testing.assert_array_equal(kept[:, 0], want[:, 4])
        np.testing.assert_array_equal(kept[:, 1], 1.0)
        np.testing.assert_allclose(kept[:, 2:], want[:, :4], atol=2 ** -22)
    assert moved == len(plain)
