"""Inference orchestrator: predict -> detect -> segment -> evaluate.

Port of ``cellulus_tpu/infer.py`` (``infer`` and ``checkpoint_sweep``), 2D
and 3D. Derives the mean-shift bandwidth and the minimum instance size from
``object_size``, loads the checkpoint named by ``model_config.checkpoint``
(a torch ``.pth`` or a JAX-package ``.ckpt``, under the rule of
``utils/checkpoint.resolve_checkpoint`` for a ``.ckpt`` that only exists
as ``.pth``), and runs each stage whose dataset config is
present, on ``inference_config.device`` (``"cuda:0"`` by default): staged
(each stage over every sample in turn), or pipelined (``pipeline.py``) when
``pipelined`` is set and predict, detect and segment are all configured.
Both paths run under ``stage_timer`` and ``maybe_trace``
(``utils/profiling.py``).
"""

from __future__ import annotations

import copy
import json
import shutil
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .configs import ExperimentConfig
from .detect import detect
from .evaluate import evaluate
from .io import DatasetMetaData, zarr
from .models import load_checkpoint, unet_from_config
from .predict import predict
from .segment import segment
from .utils.checkpoint import resolve_checkpoint
from .utils.device import compute_dtype_for, resolve_device
from .utils.profiling import maybe_trace, stage_timer

PIPELINED_STAGE = "predict+detect+segment (pipelined)"


def infer(
    experiment_config: ExperimentConfig,
    stage_seconds: Optional[Dict[str, float]] = None,
    intervals: Optional[Dict[str, Dict[int, tuple]]] = None,
):
    """Run the configured stages; return the evaluate results (or None).

    ``stage_seconds``, when given, receives the wall time of each stage
    that ran (device work included: every stage ends on the host); the
    pipelined path's three stages are one, ``PIPELINED_STAGE``.
    ``intervals``, when given and the path is pipelined, receives each
    sample's host-clock intervals of predict, detect and segment
    (:func:`~cellulus_tpu_torch.pipeline.infer_pipelined`).
    """
    print(experiment_config)
    ic = experiment_config.inference_config
    model_config = experiment_config.model_config
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
    checkpoint = resolve_checkpoint(model_config.checkpoint)
    if checkpoint is None or not checkpoint.exists():
        raise FileNotFoundError(
            f"Model weights do not exist at this location: {model_config.checkpoint}!"
        )
    load_checkpoint(checkpoint, model)
    model = model.to(device).eval()
    normalization_factor = experiment_config.normalization_factor

    pipelined = (
        ic.pipelined
        and ic.prediction_dataset_config is not None
        and ic.detection_dataset_config is not None
        and ic.segmentation_dataset_config is not None
    )
    if pipelined:
        from .pipeline import infer_pipelined

        stages = [(PIPELINED_STAGE, ic.prediction_dataset_config,
                   lambda: infer_pipelined(model, ic, normalization_factor, device,
                                           compute_dtype, intervals=intervals))]
    else:
        stages = [
            ("predict", ic.prediction_dataset_config,
             lambda: predict(model, ic, normalization_factor, device, compute_dtype)),
            ("detect", ic.detection_dataset_config, lambda: detect(ic, device)),
            ("segment", ic.segmentation_dataset_config, lambda: segment(ic, device)),
        ]
    stages.append(("evaluate", ic.evaluation_dataset_config, lambda: evaluate(ic)))
    results = None
    with maybe_trace():
        for name, dataset_config, run in stages:
            if dataset_config is None:
                continue
            t0 = time.perf_counter()
            with stage_timer(name, items=meta.num_samples, unit="samples"):
                out = run()
            if stage_seconds is not None:
                stage_seconds[name] = time.perf_counter() - t0
            if name == "evaluate":
                results = out
    return results


def checkpoint_sweep(
    experiment_config: ExperimentConfig,
    checkpoint_dir=None,
    keep_outputs: bool = False,
):
    """Model selection by measurement: score every retained checkpoint.

    Port of ``cellulus_tpu/infer.py:checkpoint_sweep``, on the port's
    ``.pth`` files and the JAX package's ``.ckpt`` files alike. Training
    keeps the checkpoint of the lowest windowed loss, but the unsupervised
    loss can select against F1 on real data. With ground truth at hand this
    runs the full inference for every numbered checkpoint (``NNNNNN``, in
    ascending order) and then ``best_loss``, and keeps each one's best
    bandwidth's scores, rounded to 4 places. A name that exists with both
    suffixes is swept once, as ``resolve_checkpoint`` reads a configured
    ``.ckpt``: the ``.ckpt``; the rows are keyed by file name.

    Each checkpoint's stage outputs go to a throwaway
    ``<prediction container>.sweep-<stem>`` container (the ground truth is
    staged in, since evaluate reads it and the segmentation from one
    container), deleted after scoring unless ``keep_outputs``. A checkpoint
    that fails gives an ``error`` row and the sweep goes on; if every one
    fails, ``RuntimeError``. The winner is the first checkpoint, in
    candidate order, with the highest F1 (the JAX package takes ``max``
    over a set, so among equal F1 its winner depends on string hashing).

    Writes ``checkpoint_sweep.json`` next to the checkpoints; returns the
    rows by checkpoint name. Command line: ``python -m cellulus_tpu_torch
    infer config.toml --checkpoint-sweep``.
    """
    ic = experiment_config.inference_config
    mc = experiment_config.model_config
    if ic.evaluation_dataset_config is None:
        raise ValueError(
            "checkpoint_sweep needs inference_config.evaluation_dataset_config"
            " (ground truth to measure against)"
        )
    if ic.prediction_dataset_config is None:
        raise ValueError("checkpoint_sweep needs prediction_dataset_config")
    ckpt_dir = Path(
        checkpoint_dir or (Path(mc.checkpoint).parent if mc.checkpoint else "models")
    )
    stems = {p.stem for p in ckpt_dir.glob("*") if p.suffix in (".pth", ".ckpt")}
    names = sorted((s for s in stems if s.isdigit()), key=int)
    names += ["best_loss"] if "best_loss" in stems else []
    candidates = [resolve_checkpoint(ckpt_dir / f"{stem}.ckpt", announce=False)
                  for stem in names]
    if not candidates:
        raise ValueError(f"no .pth checkpoints and no .ckpt checkpoints under {ckpt_dir}")
    best_loss = candidates[-1].name if names and names[-1] == "best_loss" else None

    gt_cfg = ic.evaluation_dataset_config
    gt_src = zarr.open(gt_cfg.container_path, "r")[gt_cfg.dataset_name]
    gt_data = np.asarray(gt_src[...])
    gt_attrs = gt_src.attrs.asdict()

    rows = {}
    for ckpt in candidates:
        cfg = copy.deepcopy(experiment_config)
        cfg.model_config.checkpoint = str(ckpt)
        sic = cfg.inference_config
        base = Path(ic.prediction_dataset_config.container_path)
        sweep_container = base.with_name(f"{base.name}.sweep-{ckpt.stem}")
        if sweep_container.exists():
            shutil.rmtree(sweep_container)
        dst = zarr.open(sweep_container, "a")
        dst[gt_cfg.dataset_name] = gt_data
        dst[gt_cfg.dataset_name].attrs.update(gt_attrs)
        for name in ("prediction", "detection", "segmentation", "evaluation"):
            dc = getattr(sic, f"{name}_dataset_config")
            if dc is not None:
                dc.container_path = str(sweep_container)
        try:
            results = infer(cfg)
        except Exception as exc:
            # one corrupt or truncated checkpoint must not discard the rows
            # already scored; the row records the error
            print(f"checkpoint_sweep: {ckpt.name} FAILED, skipping: {exc!r}")
            rows[ckpt.name] = {"checkpoint": str(ckpt), "error": repr(exc)}
            continue
        finally:
            if not keep_outputs:
                shutil.rmtree(sweep_container, ignore_errors=True)
        best_bw = max(sorted(results), key=lambda k: results[k]["F1"])
        rows[ckpt.name] = {
            "checkpoint": str(ckpt),
            "bandwidth_index": int(best_bw),
            **{k: round(float(v), 4) for k, v in results[best_bw].items()},
        }

    scored = [name for name, row in rows.items() if "F1" in row]
    if not scored:
        raise RuntimeError(
            f"checkpoint_sweep: every checkpoint under {ckpt_dir} failed to"
            " score — see the per-checkpoint errors above"
        )
    winner = max(scored, key=lambda name: rows[name]["F1"])  # the first maximum
    print("checkpoint sweep (best bandwidth per checkpoint):")
    for name, row in rows.items():
        if "error" in row:
            print(f"  {name:>18}: FAILED ({row['error']})")
            continue
        marker = "  <- selected" if name == winner else ""
        print(
            f"  {name:>18}: "
            + " ".join(f"{k} {v:.4f}" for k, v in row.items() if isinstance(v, float))
            + marker
        )
    if best_loss in scored and winner != best_loss:
        delta = rows[winner]["F1"] - rows[best_loss]["F1"]
        print(
            f"  NOTE: measured selection beats best-loss selection by "
            f"{delta:+.4f} F1 — the unsupervised loss is not a reliable "
            "model-selection proxy on this data"
        )
    out_path = ckpt_dir / "checkpoint_sweep.json"
    out_path.write_text(json.dumps({"selected": winner, "rows": rows}, indent=2))
    print(f"sweep written to {out_path}")
    return rows


# Callable module: keeps `cellulus_tpu_torch.infer(config)` working after an
# `import cellulus_tpu_torch.infer` rebinds the package attribute to this module.
class _CallableModule(type(sys.modules[__name__])):
    def __call__(self, experiment_config, stage_seconds=None, intervals=None):
        return infer(experiment_config, stage_seconds, intervals)


sys.modules[__name__].__class__ = _CallableModule
