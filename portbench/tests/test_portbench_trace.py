"""The trace arithmetic on a hand-made Chrome trace: kernel names, the
system's kernels, the busiest lane, the window without its margins, busy
time and idle gaps named by the benchmark's spans."""

import json

from portbench import trace


def _events():
    k = "kernel"
    return [
        # the margin before the work: nothing of the benchmark's
        {"ph": "X", "cat": "user_annotation", "name": "train.dispatch",
         "ts": 100.0, "dur": 50.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "train.readback",
         "ts": 300.0, "dur": 40.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": k, "ts": 110.0, "dur": 20.0, "pid": 0, "tid": 7,
         "name": "void at::native::vectorized_elementwise_kernel<4, F>(int)"},
        {"ph": "X", "cat": k, "ts": 200.0, "dur": 30.0, "pid": 0, "tid": 7,
         "name": "void (anonymous namespace)::bn_stats_kernel<float, 8, "
                 "true, 8>(float const*)"},
        {"ph": "X", "cat": k, "ts": 250.0, "dur": 60.0, "pid": 0, "tid": 7,
         "name": "nms_kernel"},
        {"ph": "X", "cat": k, "ts": 120.0, "dur": 5.0, "pid": 0, "tid": 9,
         "name": "other_lane_kernel"},
        {"ph": "X", "cat": "gpu_user_annotation", "ts": 100.0, "dur": 300.0,
         "pid": 0, "tid": 7, "name": "train.dispatch"},
    ]


def test_kernel_names():
    assert trace.kernel_category(
        "void ns::(anonymous namespace)::bn_stats_kernel<float, 8>(x)") \
        == "bn_stats_kernel"
    assert trace.kernel_category("Memcpy HtoD (Pinned -> Device)") \
        == "Memcpy HtoD"
    assert trace.port_kernel("bn_stats_kernel<float, 8, false, 8>(x)") \
        == "bn_stats"
    assert trace.port_kernel("bn_stats_kernel<float, 8, true, 8>(x)") \
        == "bn_grad_stats"
    assert trace.port_kernel("nms_kernel") == "nms"
    assert trace.port_kernel("elementwise_kernel") is None


def test_lanes_window_busy_and_gaps(tmp_path):
    lanes, spans = trace._lanes(_events(), ("train.",))
    busiest = max(lanes.values(), key=lambda l: sum(d for _, d, _ in l))
    t = trace.Trace(sorted(busiest), spans, {}, {}, 1, 1)
    assert [s[2] for s in t.spans] == ["train.dispatch", "train.readback"]
    assert t.window_us == (100.0, 340.0)
    assert t.busy_us() == 110.0
    assert t.idle_gaps() == [("train.dispatch", 70.0),   # 130 .. 200
                             ("train.readback", 30.0),   # 310 .. 340
                             ("host.other", 20.0),       # 230 .. 250
                             ("train.dispatch", 10.0)]   # 100 .. 110
    assert t.by_category()["nms_kernel"] == 60.0
    assert t.port_kernel_us(("bn_grad_stats",)) == 30.0


def test_a_trace_is_complete_only_where_it_holds_the_counted_kernels():
    t = trace.Trace([(0.0, 1.0, "nms_kernel")], [(0.0, 1.0, "serve.predict")],
                    {"nms": 1}, {"nms": 1}, 1, 1)
    assert t.complete
    t.counted = {"nms": 2}
    assert not t.complete


def test_reading_an_exported_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    assert len(trace._events(str(path))) == len(_events())
