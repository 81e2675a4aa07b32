"""The port's host spans (``utils/profiling.py`` ``span``) on the CPU: with
no profiler recording a span is one shared no-op context and makes no
``record_function``; torch's flag that guards it is true inside a
``torch.profiler`` session and false after it; a traced train step holds
``train.step.augment``, ``encode``, ``forward``, ``loss`` and ``backward``
once a microbatch and then ``train.step.optimizer``, in that order, inside
the caller's span (the conv head, the same with two microbatches, the FPN
head); a traced ``predict`` holds ``serve.predict.forward``, ``decode``
and ``nms`` once; a step's and a ``predict``'s outputs are the same with
and without a recording profiler. One tiny step and one ``predict`` are
traced per module."""

import numpy as np
import pytest
import torch

from keras_object_detection_torch.config import (Config, DataConfig,
                                                 EvalConfig, GridConfig,
                                                 ModelConfig, ScheduleConfig,
                                                 TrainConfig)
from keras_object_detection_torch.eval import InferenceModel
from keras_object_detection_torch.train import (create_train_state,
                                                make_train_step)
from keras_object_detection_torch.utils import profiling as prof

STEP = ["train.step.augment", "train.step.encode", "train.step.forward",
        "train.step.loss", "train.step.backward"]
OPTIMIZER = "train.step.optimizer"
PREDICT = ["serve.predict.forward", "serve.predict.decode",
           "serve.predict.nms"]
OUTER = "test.outer"
ANCHORS6 = ((0.8, 0.7), (0.5, 0.6), (0.35, 0.3),
            (0.2, 0.25), (0.12, 0.1), (0.05, 0.06))


def conv_config(accum=1) -> Config:
    """``darknet_micro`` @56 + the conv head, nadam with an EMA."""
    return Config(
        grid=GridConfig(grid=7, num_boxes=2, num_classes=3),
        model=ModelConfig(backbone="darknet_micro", head="conv",
                          image_size=56, compute_dtype="float32"),
        data=DataConfig(batch_size=4),
        train=TrainConfig(optimizer="nadam", ema_decay=0.99,
                          grad_accum_steps=accum,
                          schedule=ScheduleConfig(kind="constant",
                                                  base_lr=1e-3)),
        eval=EvalConfig(conf_threshold=0.0, tta="hflip"))


def fpn_config() -> Config:
    """``darknet_micro`` @56 + the FPN head over 2 scales, adam."""
    return Config(
        grid=GridConfig(grid=7, num_boxes=2, num_classes=3, anchors=ANCHORS6),
        model=ModelConfig(backbone="darknet_micro", head="fpn", fpn_scales=2,
                          image_size=56, compute_dtype="float32",
                          activation="leaky_relu"),
        data=DataConfig(batch_size=4),
        train=TrainConfig(optimizer="adam", ignore_threshold=0.5,
                          obj_target="iou",
                          schedule=ScheduleConfig(kind="constant",
                                                  base_lr=1e-3)))


def batch(b=4, size=56, n=6):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
    boxes = np.zeros((b, n, 5), np.float32)
    boxes[..., :2] = rng.uniform(0.2, 0.8, (b, n, 2))
    boxes[..., 2:4] = rng.uniform(0.1, 0.4, (b, n, 2))
    boxes[..., 4] = rng.randint(0, 3, (b, n))
    valid = np.zeros((b, n), bool)
    valid[:, :3] = True
    return images, boxes, valid


def traced(run, tmp_path):
    """``run()``'s output and the trace's user spans ``(start_us, end_us,
    name)`` in time order, ``run`` called inside the span ``OUTER``."""
    with prof.trace(str(tmp_path)):
        with torch.profiler.record_function(OUTER):
            out = run()
    events = prof.traced_events(str(tmp_path))
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation")
    return out, spans


def inside_outer(spans):
    """The spans other than ``OUTER``, each checked to lie within it."""
    (lo, hi), = [(s, e) for s, e, n in spans if n == OUTER]
    rest = [sp for sp in spans if sp[2] != OUTER]
    assert all(lo <= s and e <= hi for s, e, _ in rest)
    return rest


def step_both_ways(cfg, tmp_path):
    """One step from the same initial state with and without a recording
    profiler: ``(spans, (metrics, state) untraced, (metrics, state)
    traced)``."""
    images, boxes, valid = batch()
    step = make_train_step(cfg)
    outs = []
    for profiled in (False, True):
        state = create_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")

        def run():
            return step(state, images, boxes, valid, 3)

        if profiled:
            (_, metrics), spans = traced(run, tmp_path)
        else:
            _, metrics = run()
        outs.append((metrics, state))
    return spans, outs[0], outs[1]


@pytest.fixture(scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def steps(few_threads, tmp_path_factory):
    """Each case's microbatches and ``step_both_ways``."""
    cases = {"conv": (1, conv_config()), "accum2": (2, conv_config(2)),
             "fpn": (1, fpn_config())}
    return {k: (accum, step_both_ways(cfg, tmp_path_factory.mktemp(k)))
            for k, (accum, cfg) in cases.items()}


@pytest.fixture(scope="module")
def served(few_threads, tmp_path_factory):
    """One ``predict`` (hflip TTA: two forward passes) traced and one not,
    and the traced call's spans."""
    cfg = conv_config()
    sd = create_train_state(cfg, torch.Generator().manual_seed(0),
                            device="cpu").model.state_dict()
    model = InferenceModel(cfg, sd, device="cpu")
    images = batch()[0]
    plain = model.predict(images)
    out, spans = traced(lambda: model.predict(images),
                        tmp_path_factory.mktemp("serve"))
    return spans, plain, out


def test_span_makes_no_record_function_when_nothing_records(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = prof.span("train.step.forward")
    assert first is prof.span("serve.predict.nms")
    with first:
        with prof.span("train.step.loss"):
            pass


def test_the_guard_is_true_while_a_session_records():
    from torch.profiler import ProfilerActivity, profile

    assert not torch.autograd.profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        assert isinstance(prof.span("x"), torch.profiler.record_function)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert not isinstance(prof.span("x"), torch.profiler.record_function)


@pytest.mark.parametrize("name", STEP + [OPTIMIZER])
def test_each_train_stage_is_a_span_of_the_step(steps, name):
    _, (spans, _, _) = steps["conv"]
    names = [n for _, _, n in inside_outer(spans)]
    assert names.count(name) == 1
    assert names == STEP + [OPTIMIZER]


@pytest.mark.parametrize("case", ["accum2", "fpn"])
def test_train_stages_once_a_microbatch(steps, case):
    accum, (spans, _, _) = steps[case]
    rest = inside_outer(spans)
    assert [n for _, _, n in rest] == STEP * accum + [OPTIMIZER]
    # one after another: no stage opens before the previous one closed
    assert all(a[1] <= b[0] for a, b in zip(rest, rest[1:]))


@pytest.mark.parametrize("name", PREDICT)
def test_each_predict_stage_is_a_span_of_the_call(served, name):
    spans = inside_outer(served[0])
    names = [n for _, _, n in spans]
    assert names.count(name) == 1
    assert names == PREDICT


@pytest.mark.parametrize("case", ["conv", "accum2", "fpn"])
def test_a_step_is_the_same_with_a_recording_profiler(steps, case):
    _, (_, (m0, s0), (m1, s1)) = steps[case]
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for (n, a), b in zip(s0.model.state_dict().items(),
                         s1.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert all(torch.equal(a, b) for a, b in zip(s0.opt.mu, s1.opt.mu))
    if s0.ema is not None:
        assert all(torch.equal(s0.ema[k], s1.ema[k]) for k in s0.ema)


def test_predict_is_the_same_with_a_recording_profiler(served):
    _, (rows0, valid0), (rows1, valid1) = served
    assert torch.equal(rows0, rows1) and torch.equal(valid0, valid1)
    assert bool(valid0.any())
