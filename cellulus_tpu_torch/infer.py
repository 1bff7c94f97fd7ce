"""Inference orchestrator: predict -> detect -> segment -> evaluate.

Port of ``cellulus_tpu/infer.py:infer`` (staged path), 2D and 3D. Derives
the mean-shift bandwidth and the minimum instance size from ``object_size``,
loads the ``.pth`` checkpoint named by ``model_config.checkpoint``, and runs
each stage whose dataset config is present, on
``inference_config.device`` (``"cuda:0"`` by default).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from .configs import ExperimentConfig
from .detect import detect
from .evaluate import evaluate
from .io import DatasetMetaData
from .models import load_checkpoint, unet_from_config
from .predict import predict
from .segment import segment
from .utils.device import compute_dtype_for, resolve_device


def infer(
    experiment_config: ExperimentConfig,
    stage_seconds: Optional[Dict[str, float]] = None,
):
    """Run the configured stages; return the evaluate results (or None).

    ``stage_seconds``, when given, receives the wall time of each stage
    that ran (device work included: every stage ends on the host).
    """
    print(experiment_config)
    ic = experiment_config.inference_config
    model_config = experiment_config.model_config
    if ic.pipelined:
        raise NotImplementedError(
            "pipelined inference is not ported yet (ROADMAP: M12, pipelined path)"
        )
    device = resolve_device(ic.device)
    compute_dtype = compute_dtype_for(ic.precision)
    if ic.precision == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    meta = DatasetMetaData.from_dataset_config(ic.dataset_config)
    if ic.bandwidth is None:
        ic.bandwidth = 0.5 * experiment_config.object_size
    if ic.min_size is None:
        # a tenth of the area (2D) or volume (3D) of an object_size disk/ball
        object_size = experiment_config.object_size
        if meta.num_spatial_dims == 2:
            ic.min_size = int(0.1 * np.pi * (object_size**2) / 4)
        else:
            ic.min_size = int(0.1 * 4.0 / 3.0 * np.pi * (object_size**3) / 8)

    model = unet_from_config(
        model_config, in_channels=meta.num_channels, num_spatial_dims=meta.num_spatial_dims
    )
    if model_config.checkpoint is None or not os.path.exists(model_config.checkpoint):
        raise FileNotFoundError(
            f"Model weights do not exist at this location: {model_config.checkpoint}!"
        )
    load_checkpoint(model_config.checkpoint, model)
    model = model.to(device).eval()

    stages = [
        ("predict", ic.prediction_dataset_config,
         lambda: predict(model, ic, experiment_config.normalization_factor, device,
                         compute_dtype)),
        ("detect", ic.detection_dataset_config, lambda: detect(ic, device)),
        ("segment", ic.segmentation_dataset_config, lambda: segment(ic, device)),
        ("evaluate", ic.evaluation_dataset_config, lambda: evaluate(ic)),
    ]
    results = None
    for name, dataset_config, run in stages:
        if dataset_config is None:
            continue
        t0 = time.perf_counter()
        out = run()
        seconds = time.perf_counter() - t0
        print(f"[perf] {name}: {seconds:.2f}s, {meta.num_samples} samples")
        if stage_seconds is not None:
            stage_seconds[name] = seconds
        if name == "evaluate":
            results = out
    return results


# Callable module: keeps `cellulus_tpu_torch.infer(config)` working after an
# `import cellulus_tpu_torch.infer` rebinds the package attribute to this module.
class _CallableModule(type(sys.modules[__name__])):
    def __call__(self, experiment_config, stage_seconds=None):
        return infer(experiment_config, stage_seconds)


sys.modules[__name__].__class__ = _CallableModule
