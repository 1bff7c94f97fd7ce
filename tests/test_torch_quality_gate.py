"""The port's copy of the in-suite learning gate (``test_quality_gate.py``):
the same data, model and recipe (``chip_smoke.gate_recipe``: grid loss, lr
1e-3, 400 steps), trained and inferred by ``cellulus_tpu_torch`` on the
CPU, must reach F1 >= 0.9 through the full pipeline on ``best_loss.pth``.
Seeded end to end.

At lr 1e-3 the recipe's loss rises after 100-200 steps in most runs of
either package, and the gate passes when ``best_loss.pth`` holds a good
early checkpoint, so its outcome at one seed moves with the arithmetic:
with 4 or 8 CPU threads seed 0 reaches F1 0.933 (best_loss.pth from
iteration 100), with 1 or 2 threads the reduction order differs and it
reads 0.089 (``python tests/gate_seeds.py torch 0 --torch-threads N``).
The test pins 8 threads, the count the suite has run it with on 8-core
hosts, so its outcome does not depend on the host's core count; a change
of the step's arithmetic can still flip it, and is judged over seeds
(``tests/gate_seeds.py`` on the CPU, ``scripts/torch_learn_check.py`` on
the card)."""

import os

import pytest
import torch

import chip_smoke

ITERS = int(os.environ.get("CELLULUS_TPU_GATE_ITERS", "400"))
THREADS = 8


@pytest.fixture
def fixed_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


@pytest.mark.quality_gate
def test_learning_quality_gate(tmp_path, fixed_threads):
    f1, seg, best, _, _, windows = chip_smoke.learn_grid(str(tmp_path), seed=0, device="cpu",
                                                         iters=ITERS)
    assert f1 >= 0.9, (
        f"quality gate failed: best F1 {f1:.3f} < 0.9 (SEG {seg:.3f}; best_loss.pth from "
        f"iteration {best}; 50-step mean losses {windows.round(0).tolist()})"
    )
