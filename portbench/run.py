"""One run of one benchmark cell.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration in
``portbench/configs/<config>.json``, its traffic in
``portbench/traffic/<traffic>.json`` (a ``kind``, the module
``portbench/traffic/<kind>.py``, and its parameters), its limits in
``portbench/workloads/<name>.json``, each per-layer metric's reader in
``portbench/metrics/<metric>.py`` or, where there is none,
``portbench/metrics/<stem>.py`` (the name before its first ``.``).

A run loads, warms up, measures for ``--seconds``, checks what the window
produced against the plain reference (``portbench/reference/``), and
prints one JSON line last on standard output: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiler trace of the window. Each compared number is printed beside its
limit, last on standard error and under ``checks`` in the line.

It exits with an error, printing no result, when no CUDA card is visible
(or fewer than the cell asks for), or when a JAX module or the JAX package
is loaded once the window has closed: the look comes last, after the check
and the per-layer readers, just before the result is printed.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import trace as tracing  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that must not be loaded in the process that
# prints a result: JAX and the JAX package (the port's name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "cellulus_tpu")


class NoCard(RuntimeError):
    pass


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str, bench: dict = None) -> dict:
    """The cell's entry and the files it names."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return {
        "cell": cell,
        "bench": bench,
        "config": load_json(HERE / "configs" / f"{cell['config']}.json"),
        "traffic": traffic,
        "workload": load_json(HERE / "workloads" / f"{name}.json"),
    }


def metrics_of(bench: dict, name: str):
    """``(end-to-end, per-layer)`` metric entries the cell reports."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in e2e_names)]
    return e2e, per_layer


def reader(metric: str):
    """``read(ctx)`` of ``portbench/metrics/<metric>.py``, or where there is
    none of ``<stem>.py``, the name before its first ``.``: ``mfu.train``
    and ``mfu.infer`` both read ``mfu.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def traffic_module(kind: str):
    return importlib.import_module(f"portbench.traffic.{kind}")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def bytes_written() -> str:
    """What this process wrote: the bytes it passed to ``write`` (``wchar``)
    and those that reached storage (``write_bytes``), where the system says."""
    try:
        with open("/proc/self/io") as f:
            fields = dict(line.split(":") for line in f if ":" in line)
        return f"wchar {int(fields['wchar'])} write_bytes {int(fields['write_bytes'])}"
    except (OSError, KeyError, ValueError):
        return "unknown"


def check_card(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device is visible")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} visible")


def run_cell(files: dict, seed: int, seconds: float, trace: bool, device="cuda:0",
             require_card: bool = True, mode: str = "program", fault=None) -> dict:
    """Set up, measure, check; return the result's parts. ``mode`` other
    than ``"program"`` and ``fault`` serve the checks of the check
    (``calibrate.py``, the tests)."""
    timings = {}
    t = time.perf_counter()
    import torch

    timings["torch_import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cell, config, traffic = files["cell"], files["config"], files["traffic"]
    if require_card:
        check_card(int(cell["chips"]))
        torch.cuda.init()
        torch.zeros(1, device=device)
    timings["cuda_s"] = time.perf_counter() - t
    t = time.perf_counter()
    import cellulus_tpu_torch  # noqa: F401
    from cellulus_tpu_torch.ops import conv_dw, conv_pass, mean_shift_fit
    from cellulus_tpu_torch.utils import kernels

    timings["import_s"] = time.perf_counter() - t
    if torch.device(device).type == "cuda":
        t = time.perf_counter()
        kernels.build_all()
        timings["libraries_s"] = time.perf_counter() - t

    workdir = ROOT / ".portbench_run" / cell["name"]
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        kwargs = {"fault": fault} if fault is not None else {}
        cell_type = traffic_module(traffic["kind"]).Cell
        state = cell_type(config, traffic, seed, device, workdir, timings, **kwargs)
        setup_s = time.perf_counter() - START
        counters = (conv_pass.conv_pass_2d, conv_dw.conv3x3_dw, mean_shift_fit.mean_shift_fit)
        before = [c.launches for c in counters]
        traced = {}
        ctx = tracing.profiled(traced) if trace else contextlib.nullcontext()
        with ctx:
            with torch.profiler.record_function(tracing.WINDOW_SPAN):
                details = state.window(seconds)
        launches = dict(zip(("k1", "k2", "k3"),
                            (c.launches - b for c, b in zip(counters, before))))
        is_cuda = torch.device(device).type == "cuda"
        peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
        state.release()
        t = time.perf_counter()
        numbers = state.judge(mode)
        check_s = time.perf_counter() - t
        work = state.work(details)
    finally:
        # the containers a run wrote, whatever became of it
        shutil.rmtree(workdir.parent, ignore_errors=True)
    return {"setup_s": setup_s, "timings": timings, "details": details, "work": work,
            "launches": launches, "peak": peak, "numbers": numbers, "check_s": check_s,
            "trace": traced.get("trace")}


def report(files: dict, out: dict, trace: bool, device="cuda:0") -> dict:
    """The result line's object, the compared numbers last."""
    import torch

    from .reference.judge import check

    name = files["cell"]["name"]
    e2e, per_layer = metrics_of(files["bench"], name)
    details = out["details"]
    checks = check(out["numbers"], files["workload"]["limits"])
    result = {
        "correct": all(c["ok"] for c in checks.values()) and details["failed"] == 0,
        "attempted": details["attempted"],
        "failed": details["failed"],
        "metrics": {},
    }
    if not trace:
        values = dict(details["end_to_end"], setup_s=out["setup_s"])
        for m in e2e:
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = {"cell": name, "config": files["config"], "details": details,
               "work": out["work"], "trace": out["trace"]}
        for m in per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    is_cuda = torch.device(device).type == "cuda"
    result["device"] = {
        "platform": "gpu" if is_cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if is_cuda else "cpu",
        "count": int(files["cell"]["chips"]),
        "memory_peak_bytes": int(out["peak"]),
    }
    tr = out["trace"]
    if trace and tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    files = cell_files(args.workload)
    try:
        out = run_cell(files, args.seed, args.seconds, bool(args.trace))
    except NoCard as exc:
        print(f"portbench: {exc}; no result", file=sys.stderr)
        return 2
    result = report(files, out, bool(args.trace))
    t = out["timings"]
    print("portbench: set-up " + ", ".join(f"{k} {v:.3f}" for k, v in t.items())
          + f"; setup_s {out['setup_s']:.3f}; window {out['details']['window_s']:.3f} s; "
          f"check {out['check_s']:.3f} s; memory_peak_bytes {out['peak']}; "
          f"written {bytes_written()}; window launches {out['launches']}",
          file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    # last, after the check and the readers: whatever they loaded counts
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that a run must not load: {bad}; no result",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
