"""The port's profiling module (``cellulus_tpu_torch/utils/profiling.py``)
against the JAX package's contract (tests/test_profiling.py): stage timers,
device timers off by default and filling ``{predict,detect,segment}.device``
when on, identical outputs either way, and a profiler trace on the CPU.
Then the port's own spans and counters: off without a profiler, on every
thread a profiler records, each span of the pipelined path inside its
parent, and K3's counters against the plain fit's iterations."""

import concurrent.futures
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
from cellulus_tpu_torch.ops import mean_shift as ms
from cellulus_tpu_torch.ops.ball_stats import point_set
from cellulus_tpu_torch.ops.mean_shift_fit import mean_shift_fit_plain
from cellulus_tpu_torch.utils import profiling
from cellulus_tpu_torch.utils.profiling import (
    count,
    counters,
    maybe_trace,
    perf_report,
    recording,
    reset_perf,
    span,
    stage_timer,
    time_device,
)
from tests.test_torch_pipeline import _config
from tests.unet_pairs import unet_pair


def _weights(tmp_path, ndim=2):
    """tests/test_torch_pipeline.py's model, seeded, as .pth."""
    weights = tmp_path / f"w{ndim}.pth"
    factors = [(2, 2)] if ndim == 2 else [(1, 2, 2)]
    save_torch_checkpoint(weights, unet_pair(ndim, factors)[1])
    return weights


def _profiler():
    """torch.profiler over every thread, as maybe_trace and the benchmark
    run it."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _spans(prof, tmp_path):
    """``(name, tid, start, end)`` of each span of the profiler's trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["tid"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


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


# --- spans and counters -------------------------------------------------


def test_span_and_count_off_without_a_profiler(monkeypatch):
    """No profiler: span opens no record_function (one shared no-op
    context), count records nothing, and neither synchronizes or makes an
    event."""
    def refuse(*args, **kwargs):
        raise AssertionError("called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    reset_perf()
    assert not recording()
    assert span("predict: read") is span("detect: fit")
    with span("predict: read"):
        count("k3.fits", 1)
        count("k3.iterations_max", 7, max)
    assert counters() == {}


def test_span_and_count_on_worker_threads(tmp_path):
    """Under a profiler of every thread the check reads true on the worker
    threads too: their spans land in the trace on their own threads and
    their counts in the registry (sums, and a running maximum)."""
    reset_perf()
    seen = {}

    def work(tag, n):
        seen[tag] = recording()
        with span(f"work {tag}"):
            count("k3.fits", 1)
            count("k3.iterations_max", n, max)

    with _profiler() as prof:
        work("main", 3)
        thread = threading.Thread(target=work, args=("thread", 9))
        thread.start()
        thread.join()
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            pool.submit(work, "pool", 5).result()
    assert seen == {"main": True, "thread": True, "pool": True}
    assert not recording()
    tids = {name: tid for name, tid, _, _ in _spans(prof, tmp_path)}
    assert {"work main", "work thread", "work pool"} <= set(tids)
    assert len({tids["work main"], tids["work thread"], tids["work pool"]}) == 3
    assert counters() == {"k3.fits": 3, "k3.iterations_max": 9}
    count("k3.fits", 1)  # the profiler has stopped: not counted
    assert counters()["k3.fits"] == 3
    reset_perf()
    assert counters() == {}


# the spans of the pipelined path on the CPU (no graph capture there), by
# the parent each sits in and that parent's thread
CALLING = ("pipeline: open", "pipeline: slot wait", "pipeline: drain")
PREDICT = ("predict: read", "predict: tiles", "predict: upload", "predict: forward",
           "predict: wait", "predict: emit")
DETECT = {
    2: ("detect: threshold", "detect: centre", "detect: seeds", "detect: fit",
        "detect: label", "segment: sample"),
    3: ("detect: threshold", "detect: centre", "greedy: prep", "greedy: loop",
        "greedy: fetch", "segment: sample"),
}


@pytest.mark.parametrize("ndim", [2, 3])
def test_pipelined_spans_nest_in_their_parents(ndim, blob_container_2d, blob_container_3d,
                                               tmp_path):
    """infer_pipelined under a profiler of every thread (2D mean shift, 3D
    greedy): every span the CPU path runs is recorded, predict's parts
    inside their ``predict sample N`` on the calling thread, detect's,
    greedy's and segment's inside their ``detect+segment sample N`` on a
    worker thread; the fits' counters are those of the fits that ran."""
    container = blob_container_2d if ndim == 2 else blob_container_3d
    inference = {"clustering": "greedy"} if ndim == 3 else {}
    config = cellulus_tpu_torch.configs.ExperimentConfig(**_config(
        container, tmp_path / "out.zarr", _weights(tmp_path, ndim), True, ndim, **inference))
    reset_perf()
    with _profiler() as prof:
        cellulus_tpu_torch.infer(config)
    spans = _spans(prof, tmp_path)
    names = {name for name, _, _, _ in spans}
    parents = {kind: [sp for sp in spans if sp[0].startswith(kind)]
               for kind in ("predict sample ", "detect+segment sample ")}
    samples = len(parents["predict sample "])
    assert samples >= 1 and len(parents["detect+segment sample "]) == samples
    calling = parents["predict sample "][0][1]
    assert {sp[1] for sp in parents["detect+segment sample "]} != {calling}

    def inside(child, kind):
        return any(p[1] == child[1] and p[2] <= child[2] and child[3] <= p[3]
                   for p in parents[kind])

    for name in CALLING:
        assert name in names, name
    assert all(sp[1] == calling for sp in spans if sp[0] in CALLING)
    for name in PREDICT:
        assert name in names, name
    for sp in spans:
        if sp[0] in PREDICT:
            assert inside(sp, "predict sample "), sp
    for name in DETECT[ndim]:
        assert name in names, name
    for sp in spans:
        if sp[0].startswith(("detect: ", "greedy: ", "segment: ")):
            assert inside(sp, "detect+segment sample "), sp
    # one fit a sample at one bandwidth; greedy fits nothing
    assert counters().get("k3.fits", 0) == (samples if ndim == 2 else 0)
    reset_perf()


def test_k3_counters_equal_the_plain_fits_iterations(tmp_path):
    """Two fits through mean_shift_fit_predict on the CPU under a profiler:
    each k3.* counter equals what mean_shift_fit_plain's n_iter gives for
    the same points and seeds."""
    rng = np.random.default_rng(5)
    centres = np.array([[10.0, 10.0], [30.0, 12.0], [20.0, 35.0]], np.float32)
    X = np.concatenate([c + rng.normal(0, 2.0, (150, 2)) for c in centres]).astype(np.float32)
    bandwidths = (4.0, 6.0)
    want = {"k3.fits": 0, "k3.points": 0, "k3.seeds": 0, "k3.seed_iterations": 0,
            "k3.pair_iterations": 0, "k3.iterations_max": 0}
    for bw in bandwidths:
        seeds = torch.from_numpy(ms.bin_seeds(X, bin_size=bw))
        points = point_set(torch.from_numpy(X), torch.ones(len(X), dtype=torch.bool))
        bw2, stop = ms.fit_thresholds(bw)
        n_iter = mean_shift_fit_plain(seeds, points, bw2, stop, 300)[3].long()
        want["k3.fits"] += 1
        want["k3.points"] += len(X)
        want["k3.seeds"] += len(seeds)
        want["k3.seed_iterations"] += int(n_iter.sum())
        want["k3.pair_iterations"] += len(X) * int(n_iter.sum())
        want["k3.iterations_max"] = max(want["k3.iterations_max"], int(n_iter.max()))
    assert want["k3.seed_iterations"] > want["k3.seeds"]  # seeds moved
    reset_perf()
    with _profiler():
        for bw in bandwidths:
            ms.mean_shift_fit_predict(X, bw, None, device="cpu")
    assert counters() == want
    reset_perf()


def test_profile_env_prints_the_counters(blob_container_2d, tmp_path, monkeypatch, capsys):
    """maybe_trace prints the registry's counters beside its line."""
    monkeypatch.setenv("CELLULUS_TPU_PROFILE", str(tmp_path / "trace"))
    reset_perf()
    with maybe_trace():
        X = np.random.default_rng(1).normal(0, 1.0, (64, 2)).astype(np.float32)
        ms.mean_shift_fit_predict(X, 1.0, None, device="cpu")
    line = [ln for ln in capsys.readouterr().out.splitlines() if "trace written" in ln][0]
    assert "; counters k3.fits 1, k3.iterations_max " in line
    assert profiling.counters()["k3.points"] == 64
    reset_perf()
