"""Train, infer and score the port on real HeLa pixels (the vendored panels).

    python3 scripts/torch_real_hela.py [--iters N] [--seed S] [--workdir D] [--device cuda:0]

The recipe of ``scripts/run_real_hela.py`` through ``cellulus_tpu_torch``:
24 fmaps, factor 3, crop 140, batch 8, lr 4e-4, density 0.1, kappa 10,
bfloat16, host elastic augmentation, 5,000 steps on the two panels
(``examples/real-data/vendored/hela_large.npy`` and ``hela_panel.npy``),
then infer on ``best_loss.pth`` over the clean 253x253 panel with 5
bandwidths and object size 23, segmented in "nucleus" mode (the reference's
HeLa setting, on the host) and scored against ``hela_panel_silver_gt.npy``;
then the same detections segmented in "nucleus" mode on the device
(``device_nucleus``) and in "cell" mode, each scored again. Prints one
``RESULT`` JSON line with the best F1/SEG of each mode and each
bandwidth's scores.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
VENDORED = REPO / "examples" / "real-data" / "vendored"
OBJECT_SIZE = 23  # nuclei here are ~23 px across (silver-truth median area 417 px)


def _write(path, name, data):
    from cellulus_tpu_torch.io import zarr

    f = zarr.open(path, "a")
    f[name] = data
    f[name].attrs.update({"axis_names": ["s", "c", "y", "x"], "resolution": [1, 1]})


def hela_config(work: Path, iters: int, device: str, seed: int = 0, crop: int = 140,
                num_bandwidths: int = 5):
    """``scripts/run_real_hela.py``'s experiment on the port, on ``device``."""
    from cellulus_tpu_torch.configs import ExperimentConfig

    def out(name, secondary=None):
        d = {"container_path": str(work / "out.zarr"), "dataset_name": name}
        if secondary:
            d["secondary_dataset_name"] = secondary
        return d

    return ExperimentConfig(**{
        "experiment_name": "real-hela",
        "object_size": OBJECT_SIZE,
        "normalization_factor": 1.0,  # pixels already in [0, 1]
        "model_config": {"num_fmaps": 24, "fmap_inc_factor": 3},
        "train_config": {
            "device": device,
            "seed": seed,
            "crop_size": [crop, crop],
            "batch_size": 8,
            "max_iterations": iters,
            "initial_learning_rate": 4e-4,
            "density": 0.1,
            "kappa": 10.0,
            "num_workers": 4,
            "elastic_deform": True,
            "precision": "bfloat16",
            "save_model_every": max(1000, iters // 2),
            "save_snapshot_every": 10**9,
            "save_best_model_every": 100,
            "train_data_configs": [
                {"container_path": str(work / "large.zarr"), "dataset_name": "train"},
                {"container_path": str(work / "panel.zarr"), "dataset_name": "train"},
            ],
        },
        "inference_config": {
            "device": device,
            "crop_size": [crop, crop],
            "tile_batch_size": 4,
            "num_bandwidths": num_bandwidths,
            "post_processing": "nucleus",
            "device_nucleus": False,
            "dataset_config": {"container_path": str(work / "panel.zarr"),
                               "dataset_name": "train"},
            "prediction_dataset_config": out("embeddings"),
            "detection_dataset_config": out("detection", "embeddings"),
            "segmentation_dataset_config": out("segmentation", "detection"),
            "evaluation_dataset_config": out("groundtruth", "segmentation"),
        },
    })


def _best(results):
    index = max(results, key=lambda i: results[i]["F1"])
    return {"bandwidth": index, "F1": results[index]["F1"], "SEG": results[index]["SEG"],
            "per_bandwidth": {str(i): [r["F1"], r["SEG"]] for i, r in sorted(results.items())}}


def run_hela(work, iters: int = 5000, device: str = "cuda:0", seed: int = 0, log=None):
    """Train (unless ``iters`` is 0 and ``models/best_loss.pth`` exists),
    then score nucleus mode on the host and on the device, and cell mode;
    returns ``{"nucleus": ..., "nucleus_device": ..., "cell": ...,
    "train_seconds": ..., "best_iteration": ...}``. The labels are the
    ``segmentation``, ``segmentation_device`` and ``segmentation_cell``
    datasets of ``work/out.zarr``."""
    import cellulus_tpu_torch
    import torch
    from cellulus_tpu_torch.io import zarr

    work = Path(work).resolve()
    work.mkdir(parents=True, exist_ok=True)
    panel = np.load(VENDORED / "hela_panel.npy")  # (253, 253) float32 in [0, 1]
    large = np.load(VENDORED / "hela_large.npy")  # (507, 507)
    silver = np.load(VENDORED / "hela_panel_silver_gt.npy")
    for name, image in (("panel.zarr", panel), ("large.zarr", large)):
        if not (work / name / "train").exists():
            _write(work / name, "train", image[None, None].astype(np.float32))
    config = hela_config(work, iters, device, seed)
    redirect = contextlib.redirect_stdout(log) if log is not None else contextlib.nullcontext()
    with contextlib.chdir(work), redirect:
        t0 = time.perf_counter()
        if iters:
            cellulus_tpu_torch.train(config)
        train_seconds = time.perf_counter() - t0
        out = zarr.open(work / "out.zarr", "a")
        out["groundtruth"] = silver[None, None].astype(np.uint16)
        out["groundtruth"].attrs.update({"axis_names": ["s", "c", "y", "x"],
                                         "resolution": [1, 1]})
        config.model_config.checkpoint = str(work / "models" / "best_loss.pth")
        nucleus = cellulus_tpu_torch.infer(config)
        # the same detections segmented again: segment and evaluate only
        ic = config.inference_config
        ic.prediction_dataset_config = ic.detection_dataset_config = None
        scores = {}
        for mode, name, device_nucleus in (("nucleus_device", "segmentation_device", True),
                                           ("cell", "segmentation_cell", False)):
            ic.post_processing = mode.split("_")[0]
            ic.device_nucleus = device_nucleus
            ic.segmentation_dataset_config.dataset_name = name
            ic.evaluation_dataset_config.secondary_dataset_name = name
            scores[mode] = _best(cellulus_tpu_torch.infer(config))
        best_iteration = torch.load(work / "models" / "best_loss.pth",
                                    weights_only=True)["iteration"]
    return {"nucleus": _best(nucleus), **scores, "train_seconds": train_seconds,
            "best_iteration": int(best_iteration), "iters": iters, "seed": seed}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    work = Path(args.workdir or tempfile.mkdtemp(prefix="hela_torch_"))
    with open(os.devnull, "w") as quiet:
        result = run_hela(work, args.iters, args.device, args.seed, log=quiet)
    print("RESULT " + json.dumps(result))


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main()
