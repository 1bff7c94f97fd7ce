"""The readers of the program's spans and counters (predict_idle_ms,
drain_ms, greedy_capture_ms, k3_roofline) against hand-built traces: the
exact number where their spans and counters are, nothing where they are
not (a program without them), and a traced CPU run of each infer cell."""

import pytest

from portbench import run
from portbench.trace import WINDOW_SPAN, Trace
from portbench.tests.tiny_cells import run_tiny

MS = 1_000_000  # ns
CALLING, WORKER = 1, 2
CONFIG_2D = {"infer": {"crop_size": [252, 252]}}


def _span(name, start_ms, end_ms, tid=CALLING):
    return (name, tid, int(start_ms * MS), int(end_ms * MS))


def _trace(spans=(), device=()):
    return Trace(window=(50 * MS, 1000 * MS),
                 device=[(name, int(s * MS), int(e * MS)) for name, s, e in device],
                 spans=[_span(WINDOW_SPAN, 50, 1000)] + list(spans), window_tid=CALLING)


def _read(metric, trace, config=CONFIG_2D):
    return run.reader(metric)({"trace": trace, "config": config, "details": {}, "work": {}})


PREDICT = [
    _span("predict sample 0", 100, 400),
    _span("predict: read", 100, 120), _span("predict: tiles", 120, 150),
    _span("predict: upload", 150, 152), _span("predict: forward", 152, 160),
    _span("predict: wait", 160, 350), _span("predict: emit", 350, 400),
    _span("predict sample 1", 500, 800),
    _span("predict: read", 500, 530), _span("predict: wait", 530, 800),
    _span("predict: tiles", 0, 1000, tid=WORKER),  # another thread's: not read
]
KERNELS = [("conv_pass_kernel", 155, 340), ("conv_pass_kernel", 540, 790),
           ("elementwise_kernel", 600, 700)]


def test_predict_idle_ms():
    # sample 0: 300 ms of parts, 185 busy; sample 1: 300 of parts, 250 busy
    value = _read("predict_idle_ms.infer", _trace(PREDICT, KERNELS))
    assert value == pytest.approx((115 + 50) / 2, abs=1e-9)


def test_drain_ms():
    spans = [_span("pipeline: drain", 0, 40),  # before the window: not read
             _span("pipeline: drain", 400, 430), _span("pipeline: drain", 800, 900),
             _span("pipeline: drain", 950, 1010)]
    assert _read("drain_ms.infer", _trace(spans)) == pytest.approx(60.0, abs=1e-9)


def test_greedy_capture_ms():
    spans = [_span("greedy: capture", 200, 220, WORKER), _span("greedy: capture", 600, 650, 3),
             _span("greedy: capture", 1100, 1200, WORKER)]  # after the window: not read
    assert _read("greedy_capture_ms.3d", _trace(spans)) == pytest.approx(35.0, abs=1e-9)


def test_k3_roofline(monkeypatch):
    from cellulus_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters",
                        lambda: {"k3.fits": 4, "k3.pair_iterations": 10**9})
    device = [("void (anonymous namespace)::mean_shift_fit_kernel<2>(float const*)", 300, 300.5),
              ("void (anonymous namespace)::fit_rows_kernel(float const*)", 301, 302)]
    # 1e9 pairs x (2d + 4 = 8) operations at 67 TFLOP/s over 0.5 ms
    want = 100.0 * 8e9 / 67e12 / 0.5e-3
    assert _read("k3_roofline", _trace(device=device)) == pytest.approx(want, rel=1e-12)
    config_3d = {"infer": {"crop_size": [40, 76, 76]}}
    assert _read("k3_roofline", _trace(device=device), config_3d) == pytest.approx(
        want * 10 / 8, rel=1e-12)


@pytest.mark.parametrize("metric", ["predict_idle_ms.infer", "drain_ms.infer",
                                    "greedy_capture_ms.3d", "k3_roofline"])
def test_silent_without_the_programs_spans_and_counters(metric, monkeypatch):
    """The parent's trace (its own spans only, kernels included) and its
    profiling module (no counters) give nothing."""
    from cellulus_tpu_torch.utils import profiling

    parent = _trace([_span("portbench: pass", 60, 990), _span("predict sample 0", 100, 400)],
                    KERNELS + [("mean_shift_fit_kernel", 300, 301)])
    monkeypatch.delattr(profiling, "counters")
    assert _read(metric, parent) is None
    assert _read(metric, None) is None


def test_k3_roofline_silent_without_fits(monkeypatch):
    from cellulus_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: {})
    device = [("mean_shift_fit_kernel", 300, 301)]
    assert _read("k3_roofline", _trace(device=device)) is None
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"k3.fits": 1, "k3.pair_iterations": 5})
    assert _read("k3_roofline", _trace()) is None  # no fit kernel in the trace


@pytest.mark.parametrize("cell", ["infer-2d-f256", "infer-3d-f24"])
def test_traced_cpu_run_prints_the_span_metrics(cell):
    metrics = run_tiny(cell, trace=True)["metrics"]
    for name in ("predict_idle_ms.infer", "drain_ms.infer"):
        assert metrics[name]["value"] > 0 and metrics[name]["unit"] == "ms", name
