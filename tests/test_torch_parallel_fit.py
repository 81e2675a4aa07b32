"""The port's data-parallel training run over 2 gloo ranks on the CPU
against JAX's ``Trainer.fit`` on a 2-device mesh (conftest's fake CPU
devices): ``darknet_micro`` @56, float32, SGD, batch 4 (2 a rank) over 6
images, augmentation off, the padded images masked (as
``test_torch_fit.py``). Each rank loads its row block of every shuffled
batch; rank 0 alone writes the log and the checkpoints.

Each epoch's train ``total``, ``val_loss`` and ``val_mAP`` agree with
JAX's within 1e-4 relative, the checkpoints kept on the same epochs, the
final parameters within 1e-4 (``test_torch_fit.py``'s bounds; JAX's and
the port's mAP part in float32's last bits, 6e-8 relative, where their
confidences do); the ranks hold bit-equal states and the same test-set
loss and mAP, that mAP exactly the one-process ``Evaluator``'s on the same
weights. The sharded
device cache (rank r holds rows ``[4r, 4r + 4)`` of the 8 padded rows)
gathers every batch of two shuffled epochs bit-equal to the replicated
layout. ``cli.train --data-parallel 2`` starts two ranks itself; the dry
run's FPN step runs in the same group."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.data.pipeline import YoloDataset as JaxDataset
from keras_object_detection_tpu.parallel.mesh import create_mesh
from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch.cli import train as cli_train
from keras_object_detection_torch.models import flax_to_torch
from keras_object_detection_torch.train import Trainer
from test_torch_data import write_dataset
from test_torch_fit import _jcfg, _logs, _port
from test_torch_parallel_step import run_ranks


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and these small tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def six(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("six"), 6, seed=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, six):
    tmp = tmp_path_factory.mktemp("dp_fit")
    jcfg = _jcfg(str(tmp / "jax"), lr=1e-6, epochs=2, map_eval_start_epoch=0,
                 map_eval_every=1)
    jtrainer = jloop.Trainer(jcfg, mesh=create_mesh(
        data_parallel=2, devices=jax.devices()[:2]), use_tensorboard=False)
    jstate = jtrainer.init_state()
    init = jax.device_get((jstate.params, jstate.batch_stats))
    jstate = jtrainer.fit(JaxDataset(six, 56, 4, max_boxes=8, shuffle=True,
                                     seed=0),
                          JaxDataset(six, 56, 4, max_boxes=8), state=jstate,
                          verbose=False)
    jtrainer.ckpt.close()
    cfg = _port(jcfg, str(tmp / "torch"))
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, data_parallel=-1))
    got = run_ranks("fit", {"config": cfg.to_json(), "train": six,
                            "state_dict": flax_to_torch(*init)},
                    str(tmp / "ranks"))
    return (jtrainer, jstate, str(tmp / "jax")), got, str(tmp / "torch")


def test_dp_fit_matches_jax_mesh_fit(runs):
    (jtrainer, jstate, jdir), got, tdir = runs
    mine, want = _logs(tdir), _logs(jdir)
    assert [r["step"] for r in mine] == [r["step"] for r in want]
    for g, w in zip(mine, want):
        for k in ("total", "val_loss", "val_mAP"):
            assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-6), k
    assert sorted(int(d) for d in os.listdir(os.path.join(tdir, "ckpt"))
                  if d.isdigit()) == jtrainer.ckpt.all_steps
    want_sd = flax_to_torch(*jax.device_get((jstate.params,
                                             jstate.batch_stats)))
    for k, v in got["fit_0"]["state_dict"].items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_dp_fit_ranks_agree_and_rank_0_writes(runs):
    _, got, tdir = runs
    a, b = got["fit_0"], got["fit_1"]
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    assert a["test"]["val_loss"] == b["test"]["val_loss"]
    assert a["test"]["val_mAP"] == b["test"]["val_mAP"]
    assert len(_logs(tdir)) == 2  # one line an epoch: rank 0's


def test_dp_evaluation_equals_one_process(runs, six):
    """The ranks' test-set mAP (each evaluating its row block, the grids
    gathered in global row order) is the one-process ``Evaluator``'s on the
    same weights exactly; the loss to 1e-6 (two partial sums)."""
    from keras_object_detection_torch.data import YoloDataset
    from keras_object_detection_torch.eval import Evaluator
    from keras_object_detection_torch.train import create_train_state

    (_, _, jdir), got, tdir = runs
    cfg = _port(_jcfg(jdir, map_eval_start_epoch=0, map_eval_every=1), tdir)
    state = create_train_state(cfg, device="cpu")
    state.model.load_state_dict(got["fit_0"]["state_dict"])
    out = Evaluator(cfg, device="cpu").evaluate(
        state, YoloDataset(six, 56, 4, max_boxes=8))
    assert got["fit_0"]["test"]["val_mAP"] == out["mAP"]
    assert got["fit_0"]["test"]["val_loss"] == pytest.approx(out["loss"],
                                                             rel=1e-6)


def test_dp_sharded_device_cache_equals_replicated(runs):
    _, got, _ = runs
    for rank in (0, 1):
        out = got[f"fit_{rank}"]
        assert out["cache_equal"] and out["cache_batches"] == 4
        assert out["cache_rows"] == 4  # 6 images + 1 sentinel, padded to 8


def test_host_shards_split_the_files_as_jax_s(six):
    """``YoloDataset(shard_index, shard_count)``: JAX's strided split of the
    file list, one slice a host."""
    from keras_object_detection_torch.data import YoloDataset

    for index in (0, 1):
        got = YoloDataset(six, 56, 2, shard_index=index, shard_count=2)
        want = JaxDataset(six, 56, 2, shard_index=index, shard_count=2)
        assert list(got.paths) == list(want.paths) and len(got.paths) == 3


def test_trainer_mesh_larger_than_the_world_raises_jax_s_error(tmp_path):
    cfg = _port(_jcfg(str(tmp_path)))
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, data_parallel=2))
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        Trainer(cfg, device="cpu", use_tensorboard=False)


def test_train_cli_starts_its_ranks(tmp_path, capsys, monkeypatch):
    """``--data-parallel 2 --device cpu``: two gloo ranks from one command,
    rank 0 writing the config, the log and the checkpoint."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = write_dataset(tmp_path / "data", 4, seed=2, shape=(80, 64))
    ckpt = str(tmp_path / "ckpt")
    cli_train.main(["--data-dir", data, "--preset", "tiny", "--backbone",
                    "darknet_micro", "--image-size", "56", "--batch-size", "2",
                    "--epochs", "1", "--device", "cpu", "--data-parallel", "2",
                    "--checkpoint-dir", ckpt, "--log-dir",
                    str(tmp_path / "logs")])
    with open(os.path.join(ckpt, "config.json")) as f:
        assert json.load(f)["mesh"]["data_parallel"] == 2
    assert os.path.exists(os.path.join(ckpt, "0", "state.pt"))
    assert len(_logs(str(tmp_path))) == 1



def test_dryrun_fpn_step_over_two_ranks(runs):
    """``parallel/dryrun.py``'s FPN step (one image a rank) in the ranks'
    group: a finite loss, the same on both (it checks that itself)."""
    _, got, _ = runs
    losses = [got[f"fit_{r}"]["dryrun_fpn_loss"] for r in (0, 1)]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
