"""On the card: each cell at a tiny size through the whole run, the sound
program correct, the result's device fields set; and a trace that holds
the system's kernels. Skips where there is no card."""

import pytest
import torch

from portbench import run
from portbench.tests import tiny

F32 = {"model": {"compute_dtype": "float32"}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["yolov1-train-b64", "yolov3-train-b64",
                                      "yolov1-serve-b32", "yolov3-serve-b32"])
def test_tiny_cells_on_the_card(card, workload):
    cell = tiny.cell(workload, over=F32, device=card, tracing=True)
    result = run.run_cell(cell, run.benchmark())
    assert result["correct"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert cell.trace.complete
