"""Whole runs of each cell at a CPU size (the look for a card skipped, the
port's plain kernels): a sound run is correct; the control, the reference
a precision lower in the program's place, is not; and each fault a cell
can have, planted under the timed path, makes ``correct`` false."""

import pytest
import torch

import cellulus_tpu_torch.pipeline as pipeline
import cellulus_tpu_torch.predict as predict
from portbench.tests.tiny_cells import run_tiny

CELLS = ["infer-2d-f256", "infer-3d-f24", "train-2d-f256"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = run_tiny(cell, trace=True)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"]
    for v in result["checks"].values():
        assert v["value"] <= v["limit"]


@pytest.mark.parametrize("cell", ["infer-2d-f256", "infer-3d-f24"])
def test_control_is_not_correct(cell):
    """fp8 convolutions and a bfloat16 detect in the program's place."""
    result = run_tiny(cell, mode="control")
    assert not result["correct"], result["checks"]


def test_train_faults_of_the_reference_are_not_correct():
    for mode in ("half", "altered"):
        result = run_tiny("train-2d-f256", mode=mode)
        assert not result["correct"], (mode, result["checks"])


# --- faults planted in the program, under the timed path ---------------


def _state_unchanged(step, cell):
    """A step that returns its state unchanged: the update is thrown away."""
    def broken(raw, generator):
        saved = {n: p.detach().clone() for n, p in cell.model.named_parameters()}
        out = step(raw, generator)
        with torch.no_grad():
            for n, p in cell.model.named_parameters():
                p.copy_(saved[n])
        cell.optimizer.adam.state.clear()
        return out
    return broken


def _half_batch(step, cell):
    """Half of the batch left out: its rows replaced by the other half's."""
    def broken(raw, generator):
        half = raw.shape[0] // 2
        return step(torch.cat([raw[:half], raw[:half]]), generator)
    return broken


def _altered_gradient(step, cell):
    """An answer altered where it is produced: one leaf's gradient doubled."""
    params = list(cell.model.parameters())
    params[len(params) // 2].register_hook(lambda g: 2 * g)
    return step


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _altered_gradient])
def test_train_fault_is_not_correct(fault):
    result = run_tiny("train-2d-f256", fault=fault)
    assert not result["correct"], (fault.__name__, result["checks"])


def _half_copies(monkeypatch):
    """Half of the TTA batch left out, the mean taken over the rest."""
    original = predict.tta_embeddings

    def broken(model, tiles, uniform, p, nii, dtype):
        half = nii // 2
        return original(model, tiles, uniform[: 2 * half], p, half, dtype)

    monkeypatch.setattr(predict, "tta_embeddings", broken)


def _altered_embeddings(monkeypatch):
    """An answer altered where it is produced: one tile's offsets moved."""
    original = pipeline.predict_sample

    def broken(*args, **kwargs):
        out = original(*args, **kwargs)
        out[0, :8, :8] += 1.0
        return out

    monkeypatch.setattr(pipeline, "predict_sample", broken)


def _altered_detections(monkeypatch):
    """An answer altered where it is produced: each image's instances merged
    in pairs (ids 1 and 2, 3 and 4, ...). A single merged pair is below the
    check's resolution: the reference's mean shift and K3 sum in different
    orders, so sound runs differ at the boundary of an instance or two."""
    original = pipeline.detect_sample

    def broken(*args, **kwargs):
        threshold, mask, centered, det = original(*args, **kwargs)
        return threshold, mask, centered, ((det.astype("int64") + 1) // 2).astype(det.dtype)

    monkeypatch.setattr(pipeline, "detect_sample", broken)


@pytest.mark.parametrize("fault", [_half_copies, _altered_embeddings, _altered_detections])
def test_infer_2d_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = run_tiny("infer-2d-f256")
    assert not result["correct"], (fault.__name__, result["checks"])


@pytest.mark.parametrize("fault", [_half_copies, _altered_detections])
def test_infer_3d_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = run_tiny("infer-3d-f24")
    assert not result["correct"], (fault.__name__, result["checks"])
