"""The control at each cell's own size, on the card: the reference a
precision lower in the program's place (fp8 convolutions and a bfloat16
detect for inference, TF32 for float32 training) must come out as not
correct. Skipped where no CUDA device is visible; on the card:
``python3 -m pytest portbench/tests/test_portbench_card.py``."""

import pytest

from portbench import run

SEEDS = (2**31 + 101, 2**32 + 7, 3 * 2**31 + 5)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")


@pytest.mark.parametrize("cell", ["infer-2d-f256", "train-2d-f256", "infer-3d-f24"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct_on_the_card(card, cell, seed):
    files = run.cell_files(cell)
    out = run.run_cell(files, seed, 0.0, False, mode="control")
    result = run.report(files, out, False)
    assert not result["correct"], result["checks"]
