"""The port's in-suite learning gate: tests/test_quality_gate.py's data,
model, crop and pipeline with the port's recipe (``chip_smoke.gate_recipe``:
grid loss, lr 1.5e-3, temperature 5, regularizer weight 2e-3, 1000 steps),
trained and inferred by ``cellulus_tpu_torch`` on the CPU, must reach F1 >=
0.9 through the full pipeline on ``best_loss.pth``; the step-0 checkpoint
(``000000.pth``) must not, so a gate that passes an untrained model fails.
Seeded end to end.

tests/test_quality_gate.py's own recipe (lr 1e-3, temperature 10,
regularizer 1e-5, 400 steps) lets the embeddings run away after 100-200
steps, so its outcome at one seed moved with the host's arithmetic. This
recipe's loss falls through its 1000 steps, but F1 is coarse (12 blobs a
sample, the smallest near IoU 0.5), and no recipe tried passed every seed
at every thread count (ROADMAP.md section 3; ``python tests/gate_seeds.py
torch 0 1 2 --torch-threads N``). The rate a seed depends on the thread
count, which sets the order of the CPU's sums: 10/10 at 1 thread (seeds
0-9), 27/30 at 8 (seeds 0-29; 8/10 over seeds 0-9), and 13/15 on the card.
The test keeps the host's thread count and judges by p = 0.8, at or below
each of those rates: it trains ``chip_smoke.GATE_SEEDS`` (0-4) in turn and
passes at the first that reaches the bar, so a sound port fails it with
probability (1 - p)^5 = 3.2e-4 < 1e-3 (the binomial sum P(X < 1) for
n = 5). It takes one run (about 40 s on 8 threads) unless a seed misses.
The rule catches a port that stops learning (the step-0 checkpoint reads
F1 near 0), not one that learns at a lower rate: at p = 0.5 a seed it
still passes with probability 0.97. The seeds tried and the share that
passed are printed, recorded in the test's junit properties, and warned
about when a seed missed.
"""

import os
import warnings

import pytest

import chip_smoke

ITERS = int(os.environ.get("CELLULUS_TPU_GATE_ITERS", str(chip_smoke.GATE_STEPS)))


@pytest.mark.quality_gate
def test_learning_quality_gate(tmp_path, record_property):
    passed, runs, f1_start = chip_smoke.gate_over_seeds(str(tmp_path), device="cpu",
                                                        iters=ITERS)
    summary = chip_smoke.gate_summary(passed, runs, f1_start)
    print(summary)
    record_property("gate_seeds_tried", len(runs))
    record_property("gate_seeds_passed", sum(r["f1"] >= 0.9 for r in runs))
    assert f1_start < 0.9, f"the step-0 checkpoint reads F1 {f1_start:.3f}: the bar is void"
    if len(runs) > 1:
        warnings.warn(f"learning gate: {summary}", stacklevel=1)
    if not passed:
        pytest.fail("quality gate failed: no seed reaches F1 >= 0.9: " + summary
                    + "; 50-step mean losses by seed "
                    + str([r["windows"] for r in runs]))
