"""The port's profiling (``utils/profiling.py``): ``device_lane_ms`` /
``op_breakdown`` on a torch trace's layout (GPU kernels on stream lanes)
sum the kernels by function name; a live CPU ``trace`` is written and read
back, its window bracketed by the margin; ``StepTimer`` is the JAX
package's. The port's spans are ``test_torch_spans.py``'s."""

import time

import pytest
import torch

from keras_object_detection_tpu.utils import profiling as jprof
from keras_object_detection_torch.utils import profiling as prof


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
    # the port's kernels by name: K2 and K3 by bn_stats_kernel's GRAD
    assert prof.traced_port_kernels(events) == {
        "nms": 0, "bn_stats": 2, "bn_grad_stats": 1, "yolo_loss_forward": 1,
        "yolo_loss_backward": 0, "optim_update": 0}
    assert prof.port_kernel("void nms_kernel<32, true>(float const*)") == "nms"
    assert prof.port_kernel("void optim_update_kernel<1>(Table, Scalars)") == (
        "optim_update")
    assert prof.port_kernel("void loss_backward_kernel<2>(float const*)") == (
        "yolo_loss_backward")
    assert prof.port_kernel("sm90_xmma_fprop_bf16") is None


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


def test_trace_margin_brackets_the_work(tmp_path):
    """The window opens ``TRACE_MARGIN_S`` before the work and closes as
    long after it."""
    t0 = time.perf_counter()
    with prof.trace(str(tmp_path)):
        torch.ones(4).sum().item()
    assert time.perf_counter() - t0 >= 2 * prof.TRACE_MARGIN_S
    assert "aten::sum" in {e.get("name")
                           for e in prof.traced_events(str(tmp_path))}
    assert prof.TRACE_MARGIN_S == 0.05


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


def test_checked_trace_retakes_a_trace_that_lost_the_kernels(monkeypatch):
    calls = []

    def run():
        calls.append(1)
        torch.ones(4).sum().item()

    # on the CPU no kernel runs and none is traced: one trace
    events, seen, counted, tries = prof.checked_trace(run, 2)
    assert tries == 1 and len(calls) == 2
    assert seen == counted == dict.fromkeys(prof.PORT_KERNELS, 0)
    assert any(e.get("name") == "aten::sum" for e in events)
    # a trace whose kernels differ from the counters is taken again, up to
    # three times, and the difference is returned
    lost = dict.fromkeys(prof.PORT_KERNELS, 0)
    lost["nms"] = 1
    monkeypatch.setattr(prof, "traced_port_kernels", lambda events: lost)
    calls.clear()
    _, seen, counted, tries = prof.checked_trace(run, 2)
    assert tries == 3 and len(calls) == 6 and seen != counted


def test_device_busy_ms_is_the_busiest_lane():
    busy, note = prof.device_busy_ms(torch_events())
    assert busy == pytest.approx(0.095)
    assert note.startswith("device lane '0/stream 7'")
    assert prof.device_busy_ms(torch_events()[:2]) == (
        None, "no device lane events in trace")


@pytest.mark.parametrize("pipeline_k", [0, 3])
def test_call_latency_counts_its_calls(pipeline_k):
    log = []
    got = prof.call_latency(lambda: log.append("run"),
                            lambda: log.append("sync"), 4, pipeline_k)
    # a warm-up call and its sync, 4 synchronised calls, then the
    # pipelined calls and one sync
    want = ["run", "sync"] * 5 + (["run"] * pipeline_k + ["sync"]
                                  if pipeline_k else [])
    assert log == want
    assert set(got) == {"p50_ms", "min_ms", "mean_ms"} | (
        {"pipelined_per_call_ms"} if pipeline_k else set())
    assert 0 <= got["min_ms"] <= got["p50_ms"]


def test_trace_contents_counts_device_events_and_launches():
    launch = {"ph": "X", "cat": "cuda_runtime", "pid": 4242, "tid": 1,
              "name": "cudaLaunchKernelExC", "dur": 3.0, "ts": 0}
    sync = dict(launch, name="cudaDeviceSynchronize")
    assert prof.trace_contents(torch_events() + [launch, sync]) == {
        "device_events": 5, "launch_records": 1}
    # a trace that lost its device events keeps the host's launches
    assert prof.trace_contents(torch_events()[:2] + [launch] * 8) == {
        "device_events": 0, "launch_records": 8}
