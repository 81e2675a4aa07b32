"""Mesh serving and mesh evaluation (``InferenceModel``,
``Int8InferenceModel`` and ``Evaluator`` with ``mesh=``: one process, a
replica of the weights on each device of a device mesh, here CPU
replicas) against JAX's ``tests/test_sharded_serving.py`` cases on
conftest's fake CPU devices.

- float (a mesh of 4) and the FPN head (4): the port's mesh against its
  single-device model, ``predict_raw`` to 1e-5, keep sets exact and rows
  to 1e-5 (JAX's own bounds there); the conv head against JAX's mesh
  model too, the decoded candidates to 1e-4 and, on a seed whose
  decisions sit 1e-5 clear of every threshold (``near_boundary``), the
  keep sets exact and rows to 1e-4 (``test_torch_serving.py``'s bounds;
  the FPN head's single-device serving is held to JAX's in
  ``test_torch_fpn_train.py``);
- int8 (a mesh of 8): ``predict_raw`` bit-equal to the single-device
  model's, as JAX's test holds its own (the port's int8 forward is held
  to JAX's op by op in ``test_torch_int8.py``);
- the guards: a batch that does not divide by the data axis, staged
  latency on a mesh (both ValueError, JAX's messages), fused latency
  works;
- ``Evaluator``: a mesh of 2 against JAX's ``Evaluator`` on a 2-device
  mesh (loss 1e-5 relative, mAP 1e-6, ``test_torch_fit.py``'s bounds) and
  against the port's single device (mAP exact, loss 1e-6).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.config import tiny_cpu_config
from keras_object_detection_tpu.data.pipeline import YoloDataset as JaxDataset
from keras_object_detection_tpu.eval.evaluator import Evaluator as JEvaluator
from keras_object_detection_tpu.eval.evaluator import \
    InferenceModel as JInferenceModel
from keras_object_detection_tpu.parallel.mesh import \
    create_mesh as jcreate_mesh
from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.data import YoloDataset
from keras_object_detection_torch.eval import Evaluator, InferenceModel
from keras_object_detection_torch.export import Int8InferenceModel
from keras_object_detection_torch.models import flax_to_torch
from keras_object_detection_torch.parallel import Mesh, create_mesh
from keras_object_detection_torch.train import create_train_state
from test_sharded_serving import _dp_mesh, _micro_cfg, _setup
from test_torch_data import write_dataset
from test_torch_fit import _jcfg, _load, _port
from test_torch_serving import near_boundary


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and these small tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(n):
    return create_mesh(data_parallel=n, devices=["cpu"] * n)


def port_models(cfg, sd, n, cls=InferenceModel):
    """The port's single-device model of JAX's ``cfg`` and ``state_dict``
    ``sd``, and the same over a mesh of ``n`` CPU replicas."""
    tcfg = tconfig.Config.from_json(cfg.to_json())
    return (cls(tcfg, sd, device="cpu"),
            cls(tcfg, sd, mesh=cpu_mesh(n)))


def fpn_cfg():
    cfg = _micro_cfg(head="fpn", fpn_scales=2, activation="leaky_relu")
    g = dataclasses.replace(
        tiny_cpu_config().grid,
        anchors=((0.1, 0.15), (0.3, 0.3), (0.2, 0.4), (0.5, 0.5)))
    return dataclasses.replace(cfg, grid=g)


def live(cfg, sd, imgs, q=0.5):
    """``cfg`` filtering at the ``q`` quantile of the candidate confidences
    of ``imgs`` (seeded weights put none above 0.4), so that NMS keeps and
    drops."""
    decoded = port_models(cfg, sd, 1)[0].predict_decoded(imgs).numpy()
    return dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, conf_threshold=float(np.quantile(decoded[..., 1], q))))


def clean_images(jmodel, cfg):
    """4 images whose decisions sit clear of every threshold."""
    for seed in range(7, 60):
        x = np.random.RandomState(seed).randint(
            0, 256, (4, cfg.model.image_size, cfg.model.image_size, 3),
            np.uint8)
        if not near_boundary(np.asarray(jmodel.predict_decoded(x)), cfg.eval):
            return x
    pytest.fail("no clean seed")


@pytest.fixture(scope="module")
def conv_setup():
    """JAX's ``_setup()``: the micro conv model, its variables, 8 images."""
    return _setup()


def fpn_setup():
    """The FPN head's port ``state_dict`` from seeded weights (its serving
    is held to JAX's in ``test_torch_fpn_train.py``)."""
    from keras_object_detection_torch.models import build_model

    cfg = fpn_cfg()
    sd = build_model(tconfig.Config.from_json(cfg.to_json()),
                     torch.Generator().manual_seed(0)).state_dict()
    imgs = np.random.RandomState(7).randint(0, 256, (8, 56, 56, 3), np.uint8)
    return cfg, sd, imgs


@pytest.mark.parametrize("head", ["conv", "fpn"])
def test_mesh_serving_matches_single_device_and_jax(head, conv_setup):
    if head == "fpn":
        cfg, sd, imgs = fpn_setup()
    else:
        cfg, params, stats, imgs = conv_setup
        sd = flax_to_torch(params, stats)
    # the FPN head's 490 candidates an image: its top tenth
    cfg = live(cfg, sd, imgs, 0.9 if head == "fpn" else 0.5)
    single, sharded = port_models(cfg, sd, 4)
    assert len(sharded._replicas) == 4 and sharded.device.type == "cpu"
    for a, b in zip(*(m.predict_raw(imgs) if head == "fpn"
                      else (m.predict_raw(imgs),) for m in (single, sharded))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    b0, v0 = single.predict(imgs)
    b1, v1 = sharded.predict(imgs)
    assert torch.equal(v0, v1) and 0 < int(v0.sum()) < v0.numel()
    np.testing.assert_allclose(b0[v0].numpy(), b1[v1].numpy(), atol=1e-5,
                               rtol=1e-5)
    if head == "fpn":  # the FPN head's serving against JAX's:
        return  # test_torch_fpn_train.py::test_serving_matches_jax
    jsharded = JInferenceModel(cfg, params, stats, mesh=_dp_mesh(4))
    x = clean_images(jsharded, cfg)
    np.testing.assert_allclose(sharded.predict_decoded(x).numpy(),
                               np.asarray(jsharded.predict_decoded(x)),
                               atol=1e-4, rtol=1e-4)
    want_rows, want_valid = jsharded.predict(x)
    rows, valid = sharded.predict(x)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    assert 0 < int(valid.sum()) < valid.numel()
    np.testing.assert_allclose(rows[valid].numpy(), want_rows[want_valid],
                               atol=1e-4, rtol=1e-4)


def test_mesh_int8_serving_matches_single_device(conv_setup):
    cfg, params, stats, imgs = conv_setup
    sd = flax_to_torch(params, stats)
    cfg = live(cfg, sd, imgs)
    single, sharded = port_models(cfg, sd, 8, Int8InferenceModel)
    assert torch.equal(single.predict_raw(imgs), sharded.predict_raw(imgs))
    v0, v1 = single.predict(imgs)[1], sharded.predict(imgs)[1]
    assert torch.equal(v0, v1) and 0 < int(v0.sum()) < v0.numel()


@pytest.mark.parametrize("cls", [InferenceModel, Int8InferenceModel])
def test_mesh_serving_batch_guard_and_staged_guard(cls, conv_setup):
    cfg, params, stats, imgs = conv_setup
    _, sharded = port_models(cfg, flax_to_torch(params, stats), 8, cls)
    with pytest.raises(ValueError, match="divide"):
        sharded.predict(imgs[:3])
    with pytest.raises(ValueError, match="single-device"):
        sharded.benchmark_latency(imgs, staged=True)
    # fused latency benchmarking still works under a mesh
    assert sharded.benchmark_latency(imgs, runs=2)["batch"] == 8


def test_mesh_shardings_cut_and_copy_as_jax_s():
    """``batch_sharding`` cuts a global batch into one contiguous block a
    device (JAX's ``P(data)``), ``replicated_sharding`` copies it to each;
    a batch that does not divide raises."""
    from keras_object_detection_torch.parallel import (batch_sharding,
                                                       replicated_sharding)

    mesh = cpu_mesh(4)
    assert mesh.shape == {"data": 4, "model": 1}
    x = torch.arange(8)
    blocks = batch_sharding(mesh)(x)
    assert [b.tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    copies = replicated_sharding(mesh)(x)
    assert len(copies) == 4 and all(torch.equal(c, x) for c in copies)
    assert copies[0].data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="divide"):
        batch_sharding(mesh)(torch.arange(6))


def test_serving_refuses_a_process_mesh_and_a_model_axis():
    """A process mesh still raises; a model axis, which the port refused
    before its tensor parallelism, builds JAX's (1, 2) mesh, whose one data
    row serves every row (tests/test_torch_tensor_parallel.py)."""
    from keras_object_detection_torch.parallel import batch_sharding

    cfg = tconfig.tiny_cpu_config()
    with pytest.raises(ValueError, match="device mesh"):
        InferenceModel(cfg, {}, device="cpu", mesh=Mesh(2, group=object()))
    mesh = create_mesh(data_parallel=1, model_parallel=2, devices=["cpu"] * 2)
    assert mesh.shape == {"data": 1, "model": 2}
    assert mesh.data_devices == (torch.device("cpu"),)
    assert [b.tolist() for b in batch_sharding(mesh)(torch.arange(4))] == [
        [0, 1, 2, 3]]
    with pytest.raises(ValueError, match="mesh 4x1 != 2 devices"):
        create_mesh(data_parallel=4, devices=["cpu"] * 2)


def test_a_mesh_takes_the_gpus_by_default():
    # no quiet fall back to the CPU: without a GPU the default mesh (the
    # one ``InferenceModel(cfg, sd, mesh=create_mesh())`` would serve on)
    # raises as the default device does
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_mesh(data_parallel=-1)


@pytest.fixture(scope="module")
def six(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("six"), 6, seed=1)


def test_mesh_evaluator_matches_jax_and_single_device(tmp_path, six):
    jcfg = _jcfg(str(tmp_path))
    jstate = jloop.create_train_state(jcfg, jax.random.PRNGKey(1))
    want = JEvaluator(jcfg, mesh=jcreate_mesh(
        data_parallel=2, devices=jax.devices()[:2])).evaluate(
        jstate, JaxDataset(six, 56, 4, max_boxes=8))
    cfg = _port(jcfg)
    state = _load(create_train_state(cfg, device="cpu"),
                  *jax.device_get((jstate.params, jstate.batch_stats)))
    ds = YoloDataset(six, 56, 4, max_boxes=8)
    got = Evaluator(cfg, mesh=cpu_mesh(2)).evaluate(state, ds)
    one = Evaluator(cfg, device="cpu").evaluate(state, ds)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert abs(got["mAP"] - want["mAP"]) <= 1e-6
    assert got["mAP"] == one["mAP"]
    assert got["loss"] == pytest.approx(one["loss"], rel=1e-6)
    odd = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                            batch_size=3))
    with pytest.raises(ValueError, match="must divide by the data-parallel"):
        Evaluator(odd, mesh=cpu_mesh(2))
