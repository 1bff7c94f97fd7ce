"""What the harness and the reference load, by whole top-level names."""

import functools
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import sys
{body}
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def top_level(body):
    out = subprocess.run([sys.executable, "-c", PROBE.format(body=body)], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_run_and_reference_load_no_jax():
    names = top_level("import portbench.run, portbench.reference.infer, "
                      "portbench.reference.train, portbench.reference.judge, "
                      "portbench.traffic.infer_pipelined, portbench.traffic.train_step")
    assert not names & {"jax", "jaxlib", "flax", "cellulus_tpu"}


def test_a_whole_run_loads_no_jax():
    body = ("from portbench.tests.tiny_cells import run_tiny\n"
            "run_tiny('infer-2d-f256')\nrun_tiny('train-2d-f256')")
    names = top_level(body)
    assert "cellulus_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "cellulus_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = top_level("import portbench.reference.infer, portbench.reference.train, "
                      "portbench.reference.judge, portbench.reference.unet")
    assert not names & {"cellulus_tpu_torch", "cellulus_tpu", "jax"}


@pytest.mark.parametrize("loads_jax", [False, True])
def test_a_module_loaded_after_the_window_stops_the_result(loads_jax, monkeypatch, capsys):
    """A traced run at a CPU size through ``main``; a per-layer reader, which
    runs after the window and the check, loads a stand-in ``jax``: then the
    run prints no result, exits with another code than 0 and names it."""
    from portbench import run
    from portbench.tests.tiny_cells import tiny

    files = tiny("infer-2d-f256")
    monkeypatch.setattr(run, "cell_files", lambda name: files)
    monkeypatch.setattr(run, "run_cell", functools.partial(run.run_cell, device="cpu",
                                                           require_card=False))
    monkeypatch.setattr(run, "report", functools.partial(run.report, device="cpu"))
    if loads_jax:
        original = run.reader

        def reader(metric):
            def read(ctx):
                monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
                return original(metric)(ctx)
            return read

        monkeypatch.setattr(run, "reader", reader)
    rc = run.main(["--workload", "infer-2d-f256", "--seed", str(2**32 + 15),
                   "--seconds", "0", "--trace", "1"])
    out = capsys.readouterr()
    if loads_jax:
        assert rc != 0 and out.out.strip() == ""
        assert "['jax']" in out.err.strip().splitlines()[-1]
    else:
        assert rc == 0
        assert json.loads(out.out.strip().splitlines()[-1])["correct"]
