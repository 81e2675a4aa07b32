"""The readers of the system's own spans (``portbench/spans.py`` and the
``*_host_ms.*`` / ``*_idle_ms.*`` metrics) on a hand-made Chrome trace:
self time less the spans nested inside, idle gaps by the innermost open
span, None where the trace holds no span of the name (as a system without
them gives), 0.0 where the span holds no gap, and the gaps under the
system's spans, the benchmark's own and none adding up to the idle time
that ``device_idle_pct.train`` reads."""

import types

import pytest

from portbench import run, spans, trace

STAGES = ("augment", "encode", "forward", "loss", "backward", "optimizer")
CALLS = 2


def _span(name, start, end):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": start,
            "dur": end - start, "pid": 1, "tid": 1}


def _kernel(start, end):
    return {"ph": "X", "cat": "kernel", "name": "elementwise_kernel",
            "ts": start, "dur": end - start, "pid": 0, "tid": 7}


def _trace(program=True):
    events = [_span("train.dispatch", 100.0, 500.0),
              _span("train.readback", 520.0, 560.0)]
    if program:
        events += [_span("train.step.augment", 110.0, 150.0),
                   _span("train.step.encode", 150.0, 160.0),
                   _span("train.step.forward", 160.0, 250.0),
                   _span("train.step.inner", 170.0, 180.0),  # nested twice
                   _span("train.step.loss", 250.0, 270.0),
                   _span("train.step.backward", 270.0, 380.0),
                   _span("train.step.optimizer", 390.0, 480.0)]
    # gaps: 100-120 dispatch, 140-155 augment, 300-330 backward, 400-420
    # optimizer, 500-505 and 510-530 none open, 540-560 readback
    events += [_kernel(a, b) for a, b in
               ((120, 140), (155, 200), (200, 300), (330, 385), (385, 400),
                (420, 430), (430, 500), (505, 510), (530, 540))]
    lanes, found = trace._lanes(events, ("train.", "serve."))
    return trace.Trace(sorted(lanes[(0, 7)]), found, {}, {}, CALLS, 1)


def _ctx(t):
    return types.SimpleNamespace(trace=t, window={"train": True})


def test_self_time_leaves_out_what_nests_inside():
    t = _trace()
    host = {s: spans.host_ms(t, f"train.step.{s}") * CALLS * 1e3
            for s in STAGES}
    assert host == {"augment": 40.0, "encode": 10.0, "forward": 80.0,
                    "loss": 20.0, "backward": 110.0, "optimizer": 90.0}
    # the benchmark's span less its six stages (the twice-nested span
    # counted once, inside the forward)
    assert spans.host_ms(t, "train.dispatch") * CALLS * 1e3 == 40.0


def test_idle_gaps_go_to_the_innermost_open_span():
    t = _trace()
    idle = {s: spans.idle_ms(t, f"train.step.{s}") * CALLS * 1e3
            for s in STAGES}
    assert idle == {"augment": 15.0, "encode": 0.0, "forward": 0.0,
                    "loss": 0.0, "backward": 30.0, "optimizer": 20.0}
    assert spans.idle_ms(t, "train.step.encode") == 0.0
    assert spans.idle_ms(t, "train.dispatch") * CALLS * 1e3 == 20.0


def test_no_span_of_the_name_reads_none():
    t = _trace()
    assert spans.host_ms(t, "serve.predict.nms") is None
    assert spans.idle_ms(t, "serve.predict.nms") is None
    t.device = []
    assert spans.idle_ms(t, "train.step.augment") is None
    assert spans.host_ms(t, "train.step.augment") is not None


@pytest.mark.parametrize("metric", [
    m["name"] for m in run.benchmark()["per_layer"]
    if m["source"] == "program_span"])
def test_each_reader_without_the_system_s_spans_reads_none(metric):
    """A trace of a system that opens no span of its own: only the
    benchmark's."""
    assert run._reader(metric)(_ctx(_trace(program=False))) is None


@pytest.mark.parametrize("kind", ["host", "idle"])
def test_the_train_readers_read_their_stage(kind):
    t = _trace()
    fn = spans.host_ms if kind == "host" else spans.idle_ms
    for s in STAGES:
        got = run._reader(f"{s}_{kind}_ms.train")(_ctx(t))
        assert got == fn(t, f"train.step.{s}")


def test_the_gaps_add_up_to_the_idle_share():
    t = _trace()
    ctx = _ctx(t)
    program = sum(run._reader(f"{s}_idle_ms.train")(ctx) for s in STAGES)
    benchmark = sum(spans.idle_ms(t, n)
                    for n in ("train.dispatch", "train.readback"))
    other = sum(us for n, us in t.idle_gaps() if n == "host.other") \
        / CALLS / 1e3
    assert other == 25.0 / CALLS / 1e3
    lo, hi = t.window_us
    pct = run._reader("device_idle_pct.train")(ctx)
    assert program + benchmark + other == pytest.approx(
        pct / 100.0 * (hi - lo) / CALLS / 1e3, rel=1e-12)
    assert (program + benchmark + other) * CALLS * 1e3 == 130.0
