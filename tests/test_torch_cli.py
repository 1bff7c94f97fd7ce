"""The port's command line (``cellulus_tpu_torch/cli.py``) against the JAX
package's (``cellulus_tpu/cli.py``): subcommands, flags and their dispatch,
``geometry``'s text, ``--version``, and ``export``'s flags (its artifact:
tests/test_torch_export.py)."""

import subprocess
import sys
from pathlib import Path

import pytest

import cellulus_tpu.cli as jax_cli
import cellulus_tpu_torch
import cellulus_tpu_torch.infer as infer_mod
import cellulus_tpu_torch.train as train_mod
from cellulus_tpu_torch import cli

REPO = Path(__file__).resolve().parents[1]
TRAIN_TOML = str(REPO / "examples" / "2d" / "train.toml")
INFER_TOML = str(REPO / "examples" / "real-data" / "infer.toml")


@pytest.fixture
def calls(monkeypatch):
    """Record what each subcommand would run."""
    seen = []
    monkeypatch.setattr(train_mod, "train", lambda config: seen.append(("train", config)))
    monkeypatch.setattr(infer_mod, "infer", lambda config: seen.append(("infer", config)))
    monkeypatch.setattr(
        infer_mod, "checkpoint_sweep",
        lambda config, keep_outputs=False: seen.append(("sweep", config, keep_outputs)))
    return seen


@pytest.mark.parametrize("entry", ["main", "standalone"])
def test_train_and_infer_dispatch(calls, entry):
    if entry == "main":
        cli.main(["train", TRAIN_TOML])
        cli.main(["infer", INFER_TOML])
        cli.main(["infer", INFER_TOML, "--checkpoint-sweep"])
        cli.main(["infer", INFER_TOML, "--checkpoint-sweep", "--keep-sweep-outputs"])
    else:
        cli.train([TRAIN_TOML])
        cli.infer([INFER_TOML])
        cli.infer([INFER_TOML, "--checkpoint-sweep"])
        cli.infer([INFER_TOML, "--checkpoint-sweep", "--keep-sweep-outputs"])
    assert [c[0] for c in calls] == ["train", "infer", "sweep", "sweep"]
    assert [c[2] for c in calls[2:]] == [False, True]
    assert calls[1][1].inference_config.pipelined  # examples/real-data/infer.toml as written
    assert calls[0][1].train_config.max_iterations > 0


# valid and too small, 2D and 3D
GEOMETRY_CASES = [
    ["252", "252"],
    ["100", "100", "--factors", "2,2;2,2"],
    ["40", "76", "76", "--factors", "1,2,2"],
    ["41", "77", "77", "--factors", "1,2,2"],
    ["5", "5"],
    ["4", "36", "36", "--factors", "1,2,2"],
]


@pytest.mark.parametrize("argv", GEOMETRY_CASES, ids=lambda a: "_".join(a))
@pytest.mark.parametrize("entry", ["main", "standalone"])
def test_geometry_prints_the_jax_text(argv, entry, capsys):
    jax_cli.geometry(argv)
    theirs = capsys.readouterr().out
    if entry == "main":
        cli.main(["geometry", *argv])
    else:
        cli.geometry(argv)
    assert capsys.readouterr().out == theirs
    assert "nearby valid sizes:" in theirs
    assert ("invalid crop size" in theirs) == (int(argv[0]) < 10)


def test_version(capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["--version"])
    assert exit_info.value.code == 0
    assert capsys.readouterr().out.strip() == cellulus_tpu_torch.__version__


@pytest.mark.parametrize("argv,platforms,tile_batch", [
    (["export", INFER_TOML, "out"], None, None),
    (["export", INFER_TOML, "out", "--platforms", "cpu,cuda", "--tile-batch", "8"],
     ["cpu", "cuda"], 8),
])
def test_export_passes_its_flags(argv, platforms, tile_batch, monkeypatch, capsys):
    """``export <toml> <dir> [--platforms P] [--tile-batch N]`` as in the JAX
    package's CLI: the TOML's config, the directory and both flags reach
    ``export_from_experiment``."""
    import cellulus_tpu_torch.export as export_mod

    seen = []
    monkeypatch.setattr(export_mod, "export_from_experiment",
                        lambda config, out, **kw: seen.append((config, out, kw)) or out)
    cli.main(argv)
    (config, out, kwargs), = seen
    assert out == "out" and kwargs == {"tile_batch_size": tile_batch, "platforms": platforms}
    assert str(config.model_config.checkpoint) == "models/best_loss.ckpt"
    assert capsys.readouterr().out.endswith("Serving artifact written to out\n")


def test_module_entry_point(tmp_path):
    """``python -m cellulus_tpu_torch`` runs the same main."""
    proc = subprocess.run(
        [sys.executable, "-m", "cellulus_tpu_torch", "geometry", "252", "252"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("input  (252, 252)\noutput ")
