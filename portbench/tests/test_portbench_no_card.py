"""The measuring path fails, and prints no result, without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "infer-2d-f256", "--seed", "4294967311", "--seconds", "1"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_check_card_refuses_the_cpu():
    import torch

    from portbench import run

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(run.NoCard):
        run.check_card(1)


def test_unknown_workload():
    from portbench import run

    with pytest.raises(SystemExit):
        run.cell_files("no-such-cell")


def test_result_line_is_json_last():
    # the result's keys in the order the format gives, the compared numbers last
    from portbench.tests.tiny_cells import run_tiny

    result = run_tiny("infer-2d-f256")
    assert list(result)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(result)[-1] == "checks"
    json.dumps(result)
