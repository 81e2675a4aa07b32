"""A run with the timed path broken underneath comes out not correct, for
each fault its cell can have: a step that returns its state unchanged, a
step that leaves half of the batch out (the loss scaled to the whole), a
served answer altered where it is produced, a call that answers half of its
batch twice, an empty answer, the candidates served without NMS, and a
model whose ReLU and LeakyReLU are the identity (a fusion of BatchNorm and
activation that lost the activation). The cells run at a tiny size on the
CPU against their own limits; the sound program, computing in float32,
comes out correct."""

import types

import pytest
import torch

from keras_object_detection_torch.models import layers
from portbench import run
from portbench.calibrate import IdentityActivations
from portbench.tests import tiny

F32 = {"model": {"compute_dtype": "float32"}}


def _program(**replace):
    return types.SimpleNamespace(**dict(vars(run.load_program()), **replace))


def _unchanged_step(program):
    def make(cfg):
        step = program.make_train_step(cfg)

        def broken(state, *args, **kw):
            before = [p.detach().clone() for p in state.model.parameters()]
            state, metrics = step(state, *args, **kw)
            with torch.no_grad():
                for p, b in zip(state.model.parameters(), before):
                    p.copy_(b)
            return state, metrics
        return broken
    return make


def _half_batch_step(program):
    def make(cfg):
        step = program.make_train_step(cfg)

        def broken(state, images, boxes, valid, seed, draws):
            half = slice(0, images.shape[0] // 2)
            draws = [d.rows(half) for d in draws]
            state, metrics = step(state, images[half], boxes[half],
                                  valid[half], seed, draws)
            return state, {k: 2 * v for k, v in metrics.items()}
        return broken
    return make


class _Altered:
    """``InferenceModel`` whose served boxes are altered where they are
    produced: each given the next class and moved by a third of the
    image."""

    def __init__(self, *args, **kw):
        self.inner = run.load_program().InferenceModel(*args, **kw)

    def predict_decoded(self, x):
        return self.inner.predict_decoded(x)

    def predict(self, x):
        rows, valid = self.inner.predict(x)
        rows = rows.clone()
        rows[..., 0] = (rows[..., 0] + 1) % 20
        rows[..., 2] = (rows[..., 2] + 0.3) % 1.0
        return rows, valid


class _HalfAnswered(_Altered):
    """``InferenceModel`` that answers the first half of each batch and
    hands those answers to the second half too."""

    def predict(self, x):
        h = x.shape[0] // 2
        rows, valid = self.inner.predict(x[:h])
        return torch.cat([rows, rows]), torch.cat([valid, valid])


class _Empty(_Altered):
    """``InferenceModel`` that serves no box."""

    def predict(self, x):
        rows, valid = self.inner.predict(x)
        return rows, torch.zeros_like(valid)


class _NoNms(_Altered):
    """``InferenceModel`` that serves every candidate of the cut above the
    confidence threshold, NMS left out."""

    def predict(self, x):
        e = self.inner.config.eval
        boxes = self.inner.predict_decoded(x)
        if boxes.shape[1] > e.max_candidates:
            top = boxes[..., 1].topk(e.max_candidates, dim=1).indices
            boxes = torch.gather(boxes, 1, top[..., None].expand(-1, -1, 6))
        return boxes, boxes[..., 1] > e.conf_threshold


CELLS = ["yolov1-train-b64", "yolov3-train-b64", "yolov1-serve-b32",
         "yolov3-serve-b32"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_sound_program_is_correct(workload):
    assert tiny.result(workload, over=F32)["correct"]


@pytest.mark.parametrize("workload", ["yolov1-train-b64", "yolov3-train-b64"])
@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch_step])
def test_a_broken_step_is_not_correct(workload, fault):
    base = run.load_program()
    program = _program(make_train_step=fault(base))
    result = tiny.result(workload, over=F32, program=program)
    assert not result["correct"]


@pytest.mark.parametrize("workload", ["yolov1-serve-b32", "yolov3-serve-b32"])
@pytest.mark.parametrize("model", [_Altered, _HalfAnswered, _Empty])
def test_a_broken_answer_is_not_correct(workload, model):
    result = tiny.result(workload, over=F32,
                         program=_program(InferenceModel=model))
    assert not result["correct"]


def test_an_answer_without_nms_is_not_correct():
    # at the tiny size only YOLOv1's candidates overlap within a class
    result = tiny.result("yolov1-serve-b32", over=F32,
                         program=_program(InferenceModel=_NoNms))
    assert result["check"]["served_overlap"]["value"] > 0.5
    assert not result["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_identity_activations_are_not_correct(workload, monkeypatch):
    monkeypatch.setattr(layers, "F", IdentityActivations())
    assert not tiny.result(workload, over=F32)["correct"]
