"""The port's measurement tools (``cli/train_step_breakdown.py``,
``cli/serving_device_time.py``, ``cli/tp_comm_analysis.py``) against the
JAX package's (``tools/``), on the CPU at a tiny size (``darknet_micro``
@56, C=3, float32; the MobileNetV2 + GAP Dense head at 64 for the FLOPs).

- **Records.** Each tool's JSON has the keys of the committed JAX records
  (``benchmarks/train_step_breakdown_flagship448.json``,
  ``serving_device_time.json``, ``tp_comm_analysis.json``, read as data),
  plus the extras each tool's docstring names; on the CPU the device fields
  are null with a ``trace_note``. No tool writes a file without ``--out``,
  and each defaults to the GPU.
- **The chunk.** ``--scan K``'s chunk (``stage_chunk``, the device cache's
  ``steps_per_dispatch``) leaves the state bit-equal to K bare steps.
- **FLOPs.** ``cost_analysis_gflops`` equals the analytic count of the
  model's convolutions and Dense layers (2 x output values x inputs a
  value).
- **Collectives.** One group of 2 gloo ranks runs the tiny step at a
  (2, 1) and a (1, 2) mesh (``state_sharding``'s threshold at 4096 values,
  so that four convs shard); JAX's same step is lowered over conftest's
  fake CPU devices and read with ``tools/tp_comm_analysis.py``'s
  ``collect_collectives``. At (2, 1) the port's all-reduce bytes exceed
  JAX's by one float32 vector a BatchNorm, term by term: both reduce each
  BatchNorm's forward sums (2, C), every parameter's gradient and the five
  loss terms; in the backward the port reduces the gradient of both sums,
  (2, C), where XLA reduces one vector and takes the other from the bias
  gradient's all-reduce (the same sum of dy). At (1, 2) the port's gathers
  are pinned to the shapes of the sharded blocks: each gathers its output
  and its new running statistics.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import unittest.mock

import jax
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.parallel.mesh import (batch_sharding,
                                                      create_mesh as
                                                      jcreate_mesh,
                                                      replicated_sharding)
from keras_object_detection_tpu.parallel.mesh import \
    state_sharding as jstate_sharding
from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.cli import serving_device_time as sdt
from keras_object_detection_torch.cli import tp_comm_analysis as tca
from keras_object_detection_torch.cli import train_step_breakdown as tsb
from keras_object_detection_torch.data.augment import preprocess_eval_batch
from keras_object_detection_torch.eval import InferenceModel
from keras_object_detection_torch.models import build_model
from keras_object_detection_torch.models.layers import (BatchNorm, Conv2d,
                                                        ConvBlock, Dense)
from keras_object_detection_torch.parallel import Mesh
from keras_object_detection_torch.parallel.mesh import state_sharding
from keras_object_detection_torch.train import (create_train_state,
                                                make_train_step)
from keras_object_detection_torch.train.checkpoint import CheckpointManager
from keras_object_detection_torch.utils.profiling import PORT_KERNELS
from test_torch_train import _cfg

ROOT = pathlib.Path(__file__).resolve().parents[1]
MIN_ELEMENTS = 4096  # four of darknet_micro's convs shard


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads here and one in the ranks: the suite runs
    several workers on the same cores, and these small tensors gain
    nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with unittest.mock.patch.dict(os.environ, {"OMP_NUM_THREADS": "1"}):
        yield
    torch.set_num_threads(threads)


def jax_record(name):
    with open(ROOT / "benchmarks" / name) as f:
        return json.load(f)


def port_config(kernels: bool):
    return tconfig.Config.from_json(_cfg(kernels, "sgd").to_json())


def write_checkpoint(path, cfg):
    """A run directory the tools read: ``config.json`` and a checkpoint."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(cfg.to_json())
    state = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    ckpt = CheckpointManager(str(path))
    ckpt.save(0, state, {"val_loss": 1.0})
    ckpt.close()
    return str(path)


@pytest.fixture(scope="module")
def kernel_run(tmp_path_factory):
    """The kernels' path (fused BatchNorm, the fused loss), as the card's
    phase runs it: their plain versions here."""
    return write_checkpoint(tmp_path_factory.mktemp("kernels"),
                            port_config(True))


def test_tools_default_to_the_gpu_and_write_nothing():
    for tool in (tsb, sdt, tca):
        args = tool.parse_args([])
        assert args.device == "cuda" and args.out is None, tool.__name__
    if not torch.cuda.is_available():
        for tool in (tsb, sdt, tca):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tool.main([])


def test_train_step_breakdown_record(kernel_run, tmp_path):
    out = tmp_path / "breakdown.json"
    got = tsb.main(["--checkpoint", kernel_run, "--steps", "2",
                    "--timed-steps", "2", "--scan", "2", "--device", "cpu",
                    "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(got))
    want = jax_record("train_step_breakdown_flagship448.json")
    extras = {"trace_note", "port_kernels_per_step"}
    assert set(got) == set(want) | extras | {"scan_dispatch",
                                             "port_kernel_launches"}
    # the plain versions ran: no kernel of the port was launched
    assert got["port_kernel_launches"] == dict.fromkeys(PORT_KERNELS, 0)
    assert set(got["model"]) == set(want["model"])
    # the JAX tool's scan_dispatch keys (tools/train_step_breakdown.py)
    assert set(got["scan_dispatch"]) == {
        "steps_per_dispatch", "wall_p50_ms_per_step", "device_ms_per_step",
        "vs_bare_step_device", "categories_ms_per_step"} | extras
    assert got["model"] == {"backbone": "darknet_micro", "head": "conv",
                            "image_size": 56, "batch": 4,
                            "source": f"checkpoint config {kernel_run}",
                            "platform": "cpu"}
    assert got["wall_p50_ms"] > 0 and got["traced_steps"] == 2
    # no GPU lane on the CPU: the device fields are null, as JAX's tool
    # writes them where its trace has no device lane
    for rec in (got, got["scan_dispatch"]):
        assert rec["device_ms_per_step"] is None
        assert rec["trace_note"].startswith("no device lane events")
        assert rec["categories_ms_per_step"] == {}
        # the plain versions ran: no kernel was launched or traced
        assert rec["port_kernels_per_step"] == {
            "traced": dict.fromkeys(PORT_KERNELS, 0.0),
            "counted": dict.fromkeys(PORT_KERNELS, 0.0)}
    assert got["images_per_s_device"] is None
    assert got["scan_dispatch"]["vs_bare_step_device"] is None


def test_a_trace_that_lost_the_kernels_gives_null_device_fields(
        monkeypatch):
    """Where the trace's port kernels still differ from the counters after
    its retakes, no device time or category is read from it."""
    from keras_object_detection_torch.utils import profiling

    counted = dict.fromkeys(PORT_KERNELS, 0)
    counted["nms"] = 8
    events = [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
               "name": "elementwise_kernel", "dur": 5.0, "ts": 0}]
    monkeypatch.setattr(profiling, "checked_trace", lambda run, calls: (
        events, dict.fromkeys(PORT_KERNELS, 0), counted, 3))
    rec = tsb.trace_breakdown(lambda: None, 8, 8)
    assert rec["device_ms"] is None
    assert rec["categories_ms_per_step"] is None
    assert rec["top_ops_ms_per_step"] is None
    assert rec["trace_note"].startswith("the profiler lost device events "
                                        "in 3 traces")
    assert rec["port_kernels_per_step"]["counted"]["nms"] == 1.0
    row = sdt.trace_device_ms(lambda: None, 8)
    assert row["trace_device_ms"] is None and row["traces"] == 3
    assert "K1 0 traced, 8 launched" in row["trace_note"]


@pytest.mark.parametrize("k", [1, 3])
def test_scan_chunk_equals_bare_steps(k):
    """K steps through ``chunk_runner`` (one staged copy of the K steps'
    indices and draws) leave the model, the optimizer and the summed loss
    bit-equal to K bare steps."""
    cfg = port_config(True)
    batch = tsb.synthetic_batch(cfg, "cpu")
    step = make_train_step(cfg)
    bare = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    total = None
    for _ in range(k):
        bare, metrics = step(bare, *batch, 1)
        total = metrics["total"] if total is None else total + metrics["total"]
    chunked = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    chunked, summed = tsb.chunk_runner(cfg, step, batch, 1, k)(chunked)
    assert chunked.step == bare.step == k
    assert torch.equal(summed["total"], total)
    for name, v in bare.model.state_dict().items():
        assert torch.equal(chunked.model.state_dict()[name], v), name
    for a, b in zip(chunked.opt.trace or [], bare.opt.trace or []):
        assert torch.equal(a, b)


def analytic_flops(model, images) -> int:
    """2 x output values x inputs a value, over every convolution and Dense
    layer of one forward (their output shapes from hooks)."""
    total = []

    def hook(module, inputs, output):
        per_value = (module.weight[0].numel() if isinstance(module, Conv2d)
                     else module.weight.shape[1])
        total.append(2 * output.numel() * per_value)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv2d, Dense))]
    with torch.no_grad():
        model(preprocess_eval_batch(images))
    for h in hooks:
        h.remove()
    return sum(total)


@pytest.mark.parametrize("arch", [
    dict(backbone="darknet_micro", head="conv", image_size=56),
    dict(backbone="mobilenetv2", head="gap_dense", image_size=64,
         head_dense_units=32)])
def test_flops_equal_the_analytic_count(arch):
    cfg = port_config(False)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             **arch))
    model = build_model(cfg, torch.Generator().manual_seed(0)).eval()
    serving = InferenceModel(cfg, model.state_dict(), device="cpu")
    size = arch["image_size"]
    images = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (2, size, size, 3), np.uint8))
    got = sdt.call_gflops(lambda: serving.predict(images))
    assert got * 1e9 == analytic_flops(model, images)


def test_serving_device_time_record(kernel_run, tmp_path):
    out = tmp_path / "serving.json"
    got = sdt.main(["--checkpoint", kernel_run, "--batches", "1,2",
                    "--runs", "2", "--pipeline-k", "2", "--trace-calls", "1",
                    "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(got))
    want = jax_record("serving_device_time.json")
    assert set(got) == set(want) | {"port_kernel_launches"}
    assert got["port_kernel_launches"] == dict.fromkeys(PORT_KERNELS, 0)
    assert set(got["model"]) == set(want["model"])
    assert [r["batch"] for r in got["fused_serving"]] == [1, 2]
    for row in got["fused_serving"]:
        assert set(row) == set(want["fused_serving"][0]) | {"cost_note",
                                                            "traces"}
        assert row["traces"] == 1
        assert row["trace_device_ms"] is None
        assert row["serial_min_ms"] <= row["serial_p50_ms"]
        assert row["cost_analysis_gflops"] > 0
    assert set(got["pallas_nms"]) == set(want["pallas_nms"]) | {"note",
                                                                "traces"}
    assert (got["pallas_nms"]["batch"], got["pallas_nms"]["candidates"]) == (
        32, 512)
    # the inputs are JAX's tool's (tools/serving_device_time.py), drawn in
    # its order from RandomState(0): each batch's images, then the
    # standalone NMS input
    images, boxes = sdt.draw_inputs((1, 2), 56, 3)
    rng = np.random.RandomState(0)
    for b in (1, 2):
        assert np.array_equal(images[b], rng.randint(
            0, 255, (b, 56, 56, 3), np.uint8))
    assert np.array_equal(boxes, np.concatenate([
        rng.randint(0, 3, (32, 512, 1)).astype(np.float32),
        rng.uniform(0, 1, (32, 512, 5)).astype(np.float32)], axis=-1))


# --- collectives -------------------------------------------------------------


def jax_collectives(jcfg, dp, tp):
    """tools/tp_comm_analysis.py's ``compile_step`` for ``jcfg`` at
    ``MIN_ELEMENTS``: the optimised HLO's collectives (its
    ``collect_collectives``) and the leaves ``state_sharding`` shards."""
    spec = importlib.util.spec_from_file_location(
        "jax_tp_comm_analysis", ROOT / "tools" / "tp_comm_analysis.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    mesh = jcreate_mesh(data_parallel=dp, model_parallel=tp,
                        devices=jax.devices()[:dp * tp])
    shapes = jax.eval_shape(
        lambda r: jloop.create_train_state(jcfg, r), jax.random.PRNGKey(0))
    shardings = jstate_sharding(mesh, shapes, min_elements=MIN_ELEMENTS)
    n_sharded = sum(1 for s in jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: hasattr(x, "spec"))
        if any(p is not None for p in s.spec))

    def sds(shape, dtype, sharding):
        return jax.ShapeDtypeStruct(shape, dtype, sharding=sharding)

    b, n, size = 4, jcfg.data.max_boxes_per_image, jcfg.model.image_size
    bsh = batch_sharding(mesh)
    state_in = jax.tree_util.tree_map(
        lambda leaf, s: sds(leaf.shape, leaf.dtype, s), shapes, shardings,
        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    step = jax.jit(jloop.make_train_step(jcfg), donate_argnums=(0,),
                   out_shardings=(shardings, replicated_sharding(mesh)))
    compiled = step.lower(
        state_in, sds((b, size, size, 3), np.uint8, bsh),
        sds((b, n, 5), np.float32, bsh), sds((b, n), np.bool_, bsh),
        sds((2,), np.uint32, replicated_sharding(mesh))).compile()
    return tool.collect_collectives(compiled.as_text()), n_sharded


@pytest.fixture(scope="module")
def comm(tmp_path_factory):
    """The port's record of both layouts (one group of 2 ranks) and JAX's
    collectives of each."""
    cfg = port_config(False)
    assert cfg.data.batch_size == 4
    out = tmp_path_factory.mktemp("comm_out") / "tp.json"
    doc = tca.analyse(cfg, [(2, 1), (1, 2)], "cpu", MIN_ELEMENTS, "tiny")
    tsb.write(doc, str(out))
    assert json.loads(out.read_text()) == doc
    jcfg = _cfg(False, "sgd")
    return cfg, doc, {(dp, tp): jax_collectives(jcfg, dp, tp)
                      for dp, tp in ((2, 1), (1, 2))}


def test_comm_record_has_jax_keys(comm):
    _, doc, _ = comm
    want = jax_record("tp_comm_analysis.json")
    assert set(doc) == set(want)
    assert set(doc["delta"]) == set(want["delta"])
    assert set(doc["configs"]) == {"dp2", "dp1_tp2"}
    extras = {"all_reduce_sizes", "all_gather_sizes", "ranks_agree",
              "counted_step_ms", "counters"}
    for rec in doc["configs"].values():
        assert set(rec) == set(want["configs"]["dp4_tp2"]) | extras
        assert rec["ranks_agree"]
    assert doc["delta"]["extra_bytes_per_device_per_step"] == (
        doc["configs"]["dp1_tp2"]["total_collective_bytes_per_device"]
        - doc["configs"]["dp2"]["total_collective_bytes_per_device"])


def test_sharded_leaves_are_jax_s(comm):
    _, doc, jax_side = comm
    for (dp, tp), (_, n_sharded) in jax_side.items():
        assert doc["configs"][tca.layout_name(dp, tp)][
            "tp_sharded_leaves"] == n_sharded


def test_dp_all_reduce_bytes_against_jax_term_by_term(comm):
    cfg, doc, jax_side = comm
    got = doc["configs"]["dp2"]
    model = build_model(cfg, torch.Generator().manual_seed(0))
    channels = [m.weight.numel() for m in model.modules()
                if isinstance(m, BatchNorm)]
    values = sum(p.numel() for p in model.parameters())
    metrics = 5 * 4  # the plain loss's five terms, float32
    # the port: each BatchNorm's (2, C) forward sums and the gradient of
    # both, one flat gradient bucket, the metrics
    want_sizes = {}
    for c in channels:
        want_sizes[str(8 * c)] = want_sizes.get(str(8 * c), 0) + 2
    want_sizes[str(4 * values)] = 1
    want_sizes[str(metrics)] = 1
    assert got["all_reduce_sizes"] == dict(sorted(
        want_sizes.items(), key=lambda kv: int(kv[0])))
    assert got["collectives"] == {"all-reduce": {
        "count": 2 * len(channels) + 2,
        "bytes": 16 * sum(channels) + 4 * values + metrics}}
    # JAX's: the same but one vector a BatchNorm in the backward
    jax_stats, _ = jax_side[(2, 1)]
    assert set(jax_stats) == {"all-reduce"}
    assert jax_stats["all-reduce"]["bytes"] == (
        12 * sum(channels) + 4 * values + metrics)
    assert got["total_collective_bytes_per_device"] - jax_stats[
        "all-reduce"]["bytes"] == 4 * sum(channels)
    assert got["counters"]["ALL_REDUCE_BYTES"] == got["collectives"][
        "all-reduce"]["bytes"]


def test_tp_gathers_pinned_to_the_sharded_blocks(comm):
    """(1, 2): each sharded ``ConvBlock`` gathers its output (the batch's 4
    images) and its new running mean and variance, (2, C) float32; each
    sharded conv sums its input's gradient over the model group, and the
    sharded channels' 1-D parameters' gradients are summed in one flat
    all-reduce."""
    cfg, doc, _ = comm
    got = doc["configs"]["dp1_tp2"]
    model = build_model(cfg, torch.Generator().manual_seed(0)).train()
    specs = state_sharding(Mesh(1, 2, group=object()),
                           dict(model.named_parameters()), "model",
                           MIN_ELEMENTS)
    sharded = {n.rsplit(".", 1)[0] for n, s in specs.items() if s}
    blocks = {p: m for p, m in model.named_modules()
              if isinstance(m, ConvBlock) and f"{p}.conv" in sharded}
    assert len(blocks) == 4
    outputs, inputs = {}, {}
    hooks = [m.register_forward_hook(
        lambda mod, a, y, p=p: outputs.__setitem__(p, y))
        for p, m in blocks.items()]
    hooks += [m.conv.register_forward_hook(
        lambda mod, a, y, p=p: inputs.__setitem__(p, a[0]))
        for p, m in blocks.items()]
    images, _, _ = tsb.synthetic_batch(cfg, "cpu")
    with torch.no_grad():
        model(preprocess_eval_batch(images))
    for h in hooks:
        h.remove()
    gathered = sorted(
        [y.numel() * y.element_size() for y in outputs.values()]
        + [8 * m.bn.weight.numel() for m in blocks.values()])
    assert got["collectives"]["all-gather"] == {"count": 2 * len(blocks),
                                                "bytes": sum(gathered)}
    sizes = {}
    for b in gathered:
        sizes[str(b)] = sizes.get(str(b), 0) + 1
    assert got["all_gather_sizes"] == sizes
    # the raw counter holds each rank's shard: half of every result
    assert got["counters"]["GATHER_BYTES"] * 2 == sum(gathered)
    partial = sum(m.conv.bias.numel() + 2 * m.bn.weight.numel()
                  for m in blocks.values())
    summed = [x.numel() * 4 for x in inputs.values()] + [4 * partial]
    assert got["collectives"]["all-reduce"] == {"count": len(summed),
                                                "bytes": sum(summed)}
