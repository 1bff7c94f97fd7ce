"""The port's profiling module (``cellulus_tpu_torch/utils/profiling.py``)
against the JAX package's contract (tests/test_profiling.py): stage timers,
device timers off by default and filling ``{predict,detect,segment}.device``
when on, identical outputs either way, and a profiler trace on the CPU."""

import json
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import cellulus_tpu_torch
from cellulus_tpu.models.torch_export import save_torch_checkpoint
from cellulus_tpu_torch.io import zarr
from cellulus_tpu_torch.utils.profiling import (
    maybe_trace,
    perf_report,
    reset_perf,
    stage_timer,
    time_device,
)
from tests.test_torch_pipeline import _config
from tests.unet_pairs import unet_pair


def _weights(tmp_path):
    """tests/test_torch_pipeline.py's model, seeded, as .pth."""
    weights = tmp_path / "w.pth"
    save_torch_checkpoint(weights, unet_pair(2, [(2, 2)])[1])
    return weights


def test_stage_timer_accumulates(capsys):
    reset_perf()
    with stage_timer("stage-a", items=10, unit="tiles"):
        time.sleep(0.01)
    with stage_timer("stage-a", items=5, unit="tiles"):
        pass
    report = perf_report()
    assert report["stage-a"]["items"] == 15
    assert report["stage-a"]["seconds"] >= 0.01
    out = capsys.readouterr().out
    assert "[perf] stage-a: " in out and " 10 tiles, " in out and "tiles/s" in out
    reset_perf()


def test_stage_timer_propagates_exceptions():
    reset_perf()
    with pytest.raises(ValueError):
        with stage_timer("boom"):
            raise ValueError("x")
    assert "boom" in perf_report()
    reset_perf()


def test_time_device_off_by_default(monkeypatch):
    monkeypatch.delenv("CELLULUS_TPU_DEVICE_TIMERS", raising=False)
    reset_perf()
    assert time_device("detect.device", lambda a, b: a + b, 1, 2) == 3
    assert "detect.device" not in perf_report()


def test_time_device_off_adds_no_sync(monkeypatch):
    """Off, nothing waits for a stream: the pipelined path keeps its overlap."""
    monkeypatch.delenv("CELLULUS_TPU_DEVICE_TIMERS", raising=False)

    def refuse(*args):
        raise AssertionError("synchronized")

    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert time_device("predict.device", torch.ones, 3).sum() == 3


def test_time_device_accumulates_when_enabled(monkeypatch):
    monkeypatch.setenv("CELLULUS_TPU_DEVICE_TIMERS", "1")
    reset_perf()
    fn = lambda x: torch.as_tensor(x) * 2  # noqa: E731
    out1 = time_device("detect.device", fn, np.arange(4.0))
    out2 = time_device("detect.device", fn, np.arange(4.0))
    torch.testing.assert_close(out1, out2)
    rep = perf_report()
    assert rep["detect.device"]["items"] == 2
    assert rep["detect.device"]["seconds"] > 0
    reset_perf()


def test_report_is_exact_under_threads(monkeypatch):
    monkeypatch.setenv("CELLULUS_TPU_DEVICE_TIMERS", "1")
    reset_perf()

    def work():
        for _ in range(500):
            time_device("segment.device", lambda: None)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert perf_report()["segment.device"]["items"] == 2000
    reset_perf()


@pytest.mark.parametrize("pipelined", [False, True])
def test_infer_device_timers_cover_stages(pipelined, blob_container_2d, tmp_path, monkeypatch):
    """Both paths fill {predict,detect,segment}.device with timers on, and
    give the segmentation of the run with timers off."""
    weights = _weights(tmp_path)
    out = tmp_path / "out.zarr"
    config = cellulus_tpu_torch.configs.ExperimentConfig(
        **_config(blob_container_2d, out, weights, pipelined))

    monkeypatch.setenv("CELLULUS_TPU_DEVICE_TIMERS", "1")
    reset_perf()
    cellulus_tpu_torch.infer(config)
    rep = perf_report()
    for stage in ("predict", "detect", "segment"):
        assert rep[f"{stage}.device"]["seconds"] > 0, sorted(rep)
    timed = zarr.open(out, "r")["segmentation"][...]

    monkeypatch.delenv("CELLULUS_TPU_DEVICE_TIMERS")
    reset_perf()
    shutil.rmtree(out)
    cellulus_tpu_torch.infer(config)
    assert "predict.device" not in perf_report()
    np.testing.assert_array_equal(zarr.open(out, "r")["segmentation"][...], timed)
    reset_perf()


def test_profile_env_writes_a_trace(blob_container_2d, tmp_path, monkeypatch, capsys):
    """CELLULUS_TPU_PROFILE=<dir> writes a Chrome trace of the pipelined
    infer, which holds the calling thread's predict and the worker threads'
    detect and segment spans and ops."""
    weights = _weights(tmp_path)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("CELLULUS_TPU_PROFILE", str(trace_dir))
    config = cellulus_tpu_torch.configs.ExperimentConfig(
        **_config(blob_container_2d, tmp_path / "out.zarr", weights, True))
    cellulus_tpu_torch.infer(config)
    assert f"[perf] profiler trace written to {trace_dir}" in capsys.readouterr().out
    traces = list(trace_dir.glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    tid = {e["name"]: e["tid"] for e in events
           if e.get("name", "").startswith(("predict sample", "detect+segment sample"))}
    assert {"predict sample 0", "predict sample 1", "detect+segment sample 0",
            "detect+segment sample 1"} <= set(tid)
    assert tid["predict sample 0"] != tid["detect+segment sample 0"]
    worker_ops = [e for e in events if e.get("cat") == "cpu_op"
                  and e["tid"] == tid["detect+segment sample 0"]]
    assert worker_ops, "the worker thread's ops are missing from the trace"


def test_no_profile_env_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("CELLULUS_TPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with maybe_trace():
        torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []
