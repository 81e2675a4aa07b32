"""The port's profiling (``utils/profiling.py``) against the JAX package's
``utils/profiling.py``: ``op_category`` on JAX's HLO names, and
``device_lane_ms`` / ``op_breakdown`` on ``tests/test_profiling.py``'s
synthetic device plane, give JAX's numbers exactly; on a torch trace's
layout (GPU kernels on stream lanes) they sum the kernels by function
name; a live CPU ``trace`` is written and read back; ``StepTimer`` is
JAX's."""

import pytest
import torch

from keras_object_detection_tpu.utils import profiling as jprof
from keras_object_detection_torch.utils import profiling as prof
from test_profiling import _synthetic_events

HLO_NAMES = ["fusion.123", "%convolution.5", "copy-done.2", "copy-start",
             "all-reduce-start.1", "reduce-window.7", "reduce.3",
             "select-and-scatter.2", "custom-call.4", "dynamic-slice",
             "123garbage", "all-gather.9", "collective-permute-done"]


@pytest.mark.parametrize("name", HLO_NAMES)
def test_op_category_is_jax_s_on_hlo_names(name):
    assert prof.op_category(name) == jprof.op_category(name)


def test_jax_s_synthetic_trace_reads_as_in_jax():
    events = _synthetic_events()
    assert prof.device_lane_ms(events) == jprof.device_lane_ms(events)
    assert prof.op_breakdown(events) == jprof.op_breakdown(events)


def torch_events():
    """A torch trace's layout: a host process with a CPU op, the device's
    kernels and a copy on two streams (durations in microseconds)."""
    k2 = "void bn_stats_kernel<__nv_bfloat16, 8, false, 8>(__nv_bfloat16 const*)"
    k3 = "void bn_stats_kernel<__nv_bfloat16, 4, true, 4>(__nv_bfloat16 const*)"
    return [
        {"ph": "M", "name": "process_name", "pid": 4242,
         "args": {"name": "python3"}},
        {"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 1,
         "name": "aten::conv2d", "dur": 900.0, "ts": 0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": k2,
         "dur": 30.0, "ts": 0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": k2,
         "dur": 10.0, "ts": 40},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": k3,
         "dur": 50.0, "ts": 60},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "loss_forward_kernel", "dur": 5.0, "ts": 120},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 13,
         "name": "Memcpy HtoD (Pinned -> Device)", "dur": 20.0, "ts": 0},
    ]


def test_torch_trace_breakdown():
    events = torch_events()
    assert prof.kernel_category(events[2]["name"]) == "bn_stats_kernel"
    assert prof.kernel_category(
        "void at::native::(anonymous namespace)::reduce_kernel<512, 1>(int)"
    ) == "reduce_kernel"
    assert prof.kernel_category("sm90_xmma_fprop_bf16") == "sm90_xmma_fprop_bf16"
    assert prof.device_lane_ms(events) == pytest.approx(
        {"0/stream 7": 0.095, "0/stream 13": 0.02})
    bd = prof.op_breakdown(events, top_k=None)
    assert bd["total_ms"] == pytest.approx(0.115)
    assert bd["categories"] == pytest.approx(
        {"bn_stats_kernel": 0.09, "Memcpy HtoD": 0.02,
         "loss_forward_kernel": 0.005})
    counts = {op["name"]: op["count"] for op in bd["top_ops"]}
    assert counts[events[2]["name"]] == 2 and counts[events[4]["name"]] == 1
    assert len(prof.op_breakdown(events, top_k=2)["top_ops"]) == 2


def test_live_cpu_trace(tmp_path):
    conv = torch.nn.Conv2d(3, 8, 3)
    x = torch.ones(1, 3, 16, 16)
    with prof.trace(str(tmp_path)):
        conv(x).sum().item()
    events = prof.traced_events(str(tmp_path))
    names = {str(e.get("name", "")) for e in events}
    assert "aten::conv2d" in names
    # no GPU here: no device event
    assert prof.device_lane_ms(events) == {}
    assert prof.op_breakdown(events)["total_ms"] == 0.0
    with pytest.raises(RuntimeError, match="no trace"):
        prof.traced_events(str(tmp_path / "empty"))


def test_device_memory_stats_and_step_timer():
    if not torch.cuda.is_available():
        assert prof.device_memory_stats() is None
    mine, theirs = prof.StepTimer(64, sync_every=2), jprof.StepTimer(64, 2)
    assert mine.summary() == theirs.summary() == {
        "steps": 0, "images_per_s": 0.0, "p50_ms": 0.0}
    for _ in range(6):
        mine.tick(torch.tensor(1.0))
    s = mine.summary()
    assert s["steps"] == 6 and s["p50_ms"] > 0 and s["images_per_s"] > 0
