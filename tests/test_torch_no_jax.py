"""The port, chip_smoke.py and the port's scripts (``scripts/torch_*.py``)
import neither JAX, flax, msgpack nor the JAX package, and
the port runs end to end on the CPU through its API and its command line."""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import json, sys
import chip_smoke
import cellulus_tpu_torch

model = dict(num_fmaps=4, fmap_inc_factor=2, features_in_last_layer=8,
             downsampling_factors=[[2, 2]])
settings = dict(device="cpu", crop_size=[44, 44], num_infer_iterations=2,
                mean_shift_max_iterations=20)
container = chip_smoke.write_blob_container("data.zarr", 1, 48, seed=1, dtype="uint8")
chip_smoke.save_random_checkpoint("w.pth", seed=0, **model)
config = chip_smoke.infer_config(container, "w.pth", model, **settings)
stage_seconds = {}
results = cellulus_tpu_torch.infer(config, stage_seconds)
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "msgpack") or m.startswith(("jax.", "jaxlib", "flax", "msgpack."))
    or m == "cellulus_tpu" or m.startswith("cellulus_tpu.")
)

# the same run as a TOML for the command line
lines = ["object_size = %d" % chip_smoke.OBJECT_SIZE, "[model_config]"]
lines += ["%s = %s" % (k, json.dumps(v)) for k, v in model.items()]
lines += ['checkpoint = "w.pth"', "[inference_config]"]
lines += ["%s = %s" % (k, json.dumps(v)) for k, v in settings.items()]
ic = config.inference_config
for stage in ("", "prediction_", "detection_", "segmentation_", "evaluation_"):
    dc = getattr(ic, stage + "dataset_config")
    lines += ["[inference_config.%sdataset_config]" % stage,
              'container_path = "%s"' % dc.container_path,
              'dataset_name = "%s"' % dc.dataset_name]
    if dc.secondary_dataset_name:
        lines.append('secondary_dataset_name = "%s"' % dc.secondary_dataset_name)
open("infer.toml", "w").write("\n".join(lines) + "\n")
print("RESULT " + json.dumps({"bad": bad, "stages": sorted(stage_seconds),
                              "F1": results[0]["F1"]}))
"""


_TRAIN_SCRIPT = r"""
import json, sys
import chip_smoke
import cellulus_tpu_torch

model = dict(num_fmaps=4, fmap_inc_factor=2, features_in_last_layer=8,
             downsampling_factors=[[2, 2]])
container = chip_smoke.write_blob_container("data.zarr", 1, 64, seed=1, dtype="uint8")
train = dict(device="cpu", crop_size=[44, 44], batch_size=2, kappa=4.0, max_iterations=3,
             num_workers=1, elastic_deform=True, save_model_every=2,
             save_best_model_every=2, save_snapshot_every=2)
config = chip_smoke.train_config(container, model, **train)
state = cellulus_tpu_torch.train(config)
infer = chip_smoke.infer_config(container, "models/best_loss.pth", model, device="cpu",
                                crop_size=[44, 44], num_infer_iterations=2,
                                mean_shift_max_iterations=20)
results = cellulus_tpu_torch.infer(infer)
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "msgpack") or m.startswith(("jax.", "jaxlib", "flax", "msgpack."))
    or m == "cellulus_tpu" or m.startswith("cellulus_tpu.")
)
lines = ["object_size = %d" % chip_smoke.OBJECT_SIZE, "[model_config]"]
lines += ["%s = %s" % (k, json.dumps(v)) for k, v in model.items()]
lines += ["[train_config]"]
lines += ["%s = %s" % (k, json.dumps(v)) for k, v in dict(train, max_iterations=2).items()]
lines += ["[train_config.train_data_config]", 'container_path = "data.zarr"',
          'dataset_name = "raw"']
open("train.toml", "w").write("\n".join(lines) + "\n")
print("RESULT " + json.dumps({"bad": bad, "losses": state["logger_data"]["loss"],
                              "F1": results[0]["F1"]}))
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_port_runs_without_jax(tmp_path):
    out = _run(["-c", _SCRIPT], tmp_path)
    line = [l for l in out.splitlines() if l.startswith("RESULT ")][-1]
    result = json.loads(line[len("RESULT "):])
    assert result["bad"] == []
    assert result["stages"] == ["detect", "evaluate", "predict", "segment"]
    assert 0.0 <= result["F1"] <= 1.0

    # python -m cellulus_tpu_torch infer <toml> reruns it from the TOML
    out = _run(["-m", "cellulus_tpu_torch", "infer", "infer.toml"], tmp_path)
    assert "[perf] segment" in out and "F1 for dataset" in out


def test_port_trains_without_jax(tmp_path):
    """train() on the CPU (elastic on, device pairs), its checkpoint through
    infer, and ``python -m cellulus_tpu_torch train <toml>``, without JAX."""
    out = _run(["-c", _TRAIN_SCRIPT], tmp_path)
    line = [l for l in out.splitlines() if l.startswith("RESULT ")][-1]
    result = json.loads(line[len("RESULT "):])
    assert result["bad"] == []
    assert len(result["losses"]) == 3 and all(map(math.isfinite, result["losses"]))
    assert 0.0 <= result["F1"] <= 1.0
    assert sorted(os.listdir(tmp_path / "models")) == [
        "000000.pth", "000002.pth", "best_loss.pth"]

    os.rename(tmp_path / "models", tmp_path / "models_api")
    out = _run(["-m", "cellulus_tpu_torch", "train", "train.toml"], tmp_path)
    assert "===> iteration: 1" in out
    assert (tmp_path / "models" / "000001.pth").exists()


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_imports_in_the_sources():
    files = (sorted((REPO / "cellulus_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "scripts").glob("torch_*.py")))
    names = {str(f.relative_to(REPO)) for f in files}
    for module in ("datasets/zarr_dataset.py", "datasets/sampling.py", "datasets/elastic.py",
                   "datasets/elastic_device.py", "criterions/oce_loss.py", "train.py",
                   "segment.py", "ops/conv_dw.py", "ops/conv_vjp.py", "utils/checkpoint.py",
                   "utils/logger.py", "ops/components.py", "ops/nucleus.py", "pipeline.py",
                   "utils/profiling.py", "cli.py", "utils/msgpack.py", "utils/progress.py",
                   "export.py", "predict.py", "models/convert.py"):
        assert f"cellulus_tpu_torch/{module}" in names
    for script in ("torch_kernel_check.py", "torch_learn_check.py", "torch_real_hela.py"):
        assert f"scripts/{script}" in names
    offending = [
        (str(f.relative_to(REPO)), name)
        for f in files
        for name in _imported_modules(f)
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "cellulus_tpu")
    ]
    assert offending == []
