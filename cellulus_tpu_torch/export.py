"""Serving export: the tile predictor as a ``torch.export`` program.

Port of ``cellulus_tpu/export.py``. The unit of deployment is the batched
TTA tile predictor (the noise batch, the U-Net forward, the mean and std
reduction) traced by ``torch.export`` with the trained weights in the
program, saved with ``torch.export.save``, plus a JSON sidecar holding the
geometry a scheduler needs. Every 2D conv pass is one node of the custom op
``cellulus_tpu_torch::conv_pass_2d`` (kernel K1 on the card, its plain
version on the CPU); a 3D pass is its four ``F.conv3d``.

The calling convention differs from the JAX artifact's, which takes one PRNG
key a tile and draws inside. The port's forward takes its draws as a tensor:

    predict(tiles f32[T, *in_tile, C], uniform f32[2 * nii, T, *in_tile, C])
        -> f32[T, *out_tile, D + 1]

``T`` is fixed at export, ``in_tile`` includes the valid-conv context, and
``uniform`` holds U[0, 1) draws (a pixel of copy ``i`` takes the noise
value where its draw is ``<= p_salt_pepper``). :func:`draw_uniform` draws
them from a ``torch.Generator`` as the live predict does, so a server whose
generator is in the same state reproduces the live path bit for bit.

One artifact file is written a platform (``cpu``, ``cuda``); its device is
fixed at export, so a platform the exporting host cannot reach raises. The
JAX package's cross-platform lowering (a CPU host building TPU artifacts)
has no torch counterpart.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Optional, Sequence

import torch

from .models import compute_geometry, tta_embeddings
from .predict import draw_uniform
from .utils.device import compute_dtype_for, resolve_device

META_NAME = "predictor.json"
FORMAT = "torch.export/pt2"
CALLING_CONVENTION = (
    "predict(tiles f32[T,*in,C], uniform f32[2*nii,T,*in,C]) -> f32[T,*out,D+1]"
)
PLATFORMS = ("cpu", "cuda")

__all__ = ["draw_uniform", "export_from_experiment", "export_predictor", "load_predictor"]


def artifact_name(platform: str) -> str:
    return f"predictor-{platform}.pt2"


class TilePredictor(torch.nn.Module):
    """``tta_embeddings`` of a frozen model at fixed TTA settings."""

    def __init__(self, model, p_salt_pepper: float, num_infer_iterations: int, compute_dtype):
        super().__init__()
        self.model = model
        self.p_salt_pepper = float(p_salt_pepper)
        self.num_infer_iterations = int(num_infer_iterations)
        self.compute_dtype = compute_dtype

    def forward(self, tiles: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
        return tta_embeddings(self.model, tiles, uniform, self.p_salt_pepper,
                              self.num_infer_iterations, self.compute_dtype)


def _platform_device(platform: str, inference_config) -> torch.device:
    """The device an artifact for ``platform`` is traced on; raises when the
    host cannot reach it."""
    if platform not in PLATFORMS:
        raise ValueError(f"unknown platform {platform!r} (use one of {PLATFORMS})")
    if platform == "cpu":
        return torch.device("cpu")
    configured = torch.device(inference_config.device)
    return resolve_device(configured if configured.type == "cuda" else "cuda:0")


def export_predictor(
    model,
    inference_config,
    path,
    tile_batch_size: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
    normalization_factor: Optional[float] = None,
) -> Path:
    """Serialize the batched-TTA tile predictor for serving.

    Args:
        model: the trained :class:`~cellulus_tpu_torch.models.UNet` (the
            JAX package's ``spec`` and ``params`` in one); it is copied and
            frozen, not changed.
        inference_config: crop_size, num_infer_iterations, p_salt_pepper
            and precision (the TTA recipe), and the CUDA device to trace on.
        path: output directory (created); receives one
            ``predictor-<platform>.pt2`` a platform and ``predictor.json``.
        tile_batch_size: tiles a call (default: the config's).
        platforms: ``cpu`` and/or ``cuda``; default the platform of
            ``inference_config.device``.
        normalization_factor: the scale predict multiplies raw intensities
            by before the program, recorded in the sidecar.

    Returns:
        The artifact directory.
    """
    ic = inference_config
    geometry = compute_geometry(tuple(ic.crop_size), model.downsampling_factors)
    out_tile = geometry.output_size
    in_tile = tuple(o + 2 * c for o, c in zip(out_tile, geometry.context))
    if tile_batch_size is not None and int(tile_batch_size) < 1:
        raise ValueError(f"tile_batch_size must be >= 1, got {tile_batch_size}")
    T = int(tile_batch_size if tile_batch_size is not None else ic.tile_batch_size)
    compute_dtype = compute_dtype_for(ic.precision)
    nii = int(ic.num_infer_iterations)
    in_channels = model.backbone.l_conv[0].conv_pass[0].in_channels
    if platforms is None:
        platforms = (resolve_device(ic.device).type,)
    platforms = tuple(dict.fromkeys(platforms))
    devices = {p: _platform_device(p, ic) for p in platforms}

    out_dir = Path(path)
    out_dir.mkdir(parents=True, exist_ok=True)
    for platform, device in devices.items():
        # frozen: UNet.forward takes the inference path (K1 in 2D), and the
        # program needs no gradient
        frozen = copy.deepcopy(model).to(device).eval().requires_grad_(False)
        predictor = TilePredictor(frozen, ic.p_salt_pepper, nii, compute_dtype)
        tiles = torch.zeros((T, *in_tile, in_channels), dtype=torch.float32, device=device)
        uniform = torch.ones((2 * nii, *tiles.shape), dtype=torch.float32, device=device)
        program = torch.export.export(predictor, (tiles, uniform))
        torch.export.save(program, out_dir / artifact_name(platform))

    meta = {
        "format": FORMAT,
        "calling_convention": CALLING_CONVENTION,
        "tile_batch_size": T,
        "in_tile": list(in_tile),
        "out_tile": list(out_tile),
        "context": list(geometry.context),
        "in_channels": int(in_channels),
        "out_channels": int(model.head[2].out_channels) + 1,
        "num_spatial_dims": int(model.num_spatial_dims),
        "num_infer_iterations": nii,
        "p_salt_pepper": float(ic.p_salt_pepper),
        "platforms": list(platforms),
        "precision": ic.precision,
        # tiles fed to predict() must be raw intensities times this factor
        # (null = the caller normalizes to the training scale)
        "normalization_factor": (
            float(normalization_factor) if normalization_factor is not None else None
        ),
    }
    (out_dir / META_NAME).write_text(json.dumps(meta, indent=2))
    return out_dir


def load_predictor(path, platform: Optional[str] = None):
    """Load a serving artifact: ``(predict_fn, meta)``, where ``predict_fn``
    maps ``(tiles, uniform)`` on the artifact's device to the embeddings.

    ``platform`` picks one of the artifact's platforms (default: the first
    it was exported for); one the host cannot reach raises. The port's ops
    module is imported first, so that the custom op exists in a fresh
    process; on the card K1's library is built or loaded at the first call.
    A float32 artifact turns TF32 off for cuDNN and matmuls, as ``infer``
    does."""
    from .ops import conv_pass  # noqa: F401  (registers cellulus_tpu_torch::conv_pass_2d)

    art_dir = Path(path)
    meta = json.loads((art_dir / META_NAME).read_text())
    if platform is None:
        platform = meta["platforms"][0]
    if platform not in meta["platforms"]:
        raise ValueError(
            f"the artifact at {art_dir} was exported for {meta['platforms']}, not {platform!r}"
        )
    if platform == "cuda":
        resolve_device("cuda")
    if meta.get("precision") == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    program = torch.export.load(art_dir / artifact_name(platform))
    return program.module(), meta


def export_from_experiment(experiment_config, path, **kwargs) -> Path:
    """Export straight from a TOML-level config: builds the model, loads the
    checkpoint named by ``model_config.checkpoint`` (a ``.pth`` or a JAX
    ``.ckpt``, under ``resolve_checkpoint``'s rule), and serializes. The
    normalization factor is resolved as the live pipeline does (the config's
    value, else from the dataset's dtype) and recorded in the sidecar."""
    from .datasets import normalization_factor_for
    from .io import DatasetMetaData, zarr
    from .models import load_checkpoint, unet_from_config
    from .utils.checkpoint import resolve_checkpoint

    dataset_config = experiment_config.inference_config.dataset_config
    meta = DatasetMetaData.from_dataset_config(dataset_config)
    if "normalization_factor" not in kwargs:
        nf = experiment_config.normalization_factor
        if nf is None:
            raw_ds = zarr.open(dataset_config.container_path, "r")[dataset_config.dataset_name]
            nf = normalization_factor_for(raw_ds.dtype)
        kwargs["normalization_factor"] = nf
    model = unet_from_config(experiment_config.model_config, in_channels=meta.num_channels,
                             num_spatial_dims=meta.num_spatial_dims)
    checkpoint = resolve_checkpoint(experiment_config.model_config.checkpoint)
    if checkpoint is None:
        raise ValueError("model_config.checkpoint must name a trained model")
    load_checkpoint(checkpoint, model)
    return export_predictor(model, experiment_config.inference_config, path, **kwargs)
