"""Spatially sharded U-Net forward with a halo exchange between devices.

Port of ``cellulus_tpu/parallel/spatial.py``. Tiled inference covers any
volume with independent tiles whose halos come from overlapping host reads.
Here a whole sample is split instead along its first spatial axis over a
device list: each shard's rows live on their own device, its halo is
``context`` rows copied from its neighbours' slices (reflected at the global
edges, the tiled path's boundary rule), and the valid-conv U-Net then gives
exactly the shard's own output rows. The JAX package exchanges the halo
with ``lax.ppermute`` over a mesh; the port runs in one process and copies
the rows with ``.to(device, non_blocking=True)``. In 2D each shard's forward
runs K1 at the shard's shape.

The plans take anything with the U-Net's ``downsampling_factors`` and
``num_spatial_dims`` (a :class:`~cellulus_tpu_torch.models.UNet`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..models import compute_geometry
from ..utils.device import seeded_generator
from ..utils.profiling import time_device
from .mesh import as_devices, local_devices, replicate


def exchange_halo(shards: Sequence[torch.Tensor], context: int, dim: int = 1) -> List[torch.Tensor]:
    """Each shard with ``context`` rows of its neighbours on both sides along
    ``dim`` (``cellulus_tpu/parallel/spatial.py:_exchange_halo``): the
    previous shard's last rows on top, the next shard's first rows below,
    and at the global edges the shard's own rows reflected (row ``-k``
    mirrors row ``+k``). Each shard stays on its device."""
    n = len(shards)
    out = []
    for i, x in enumerate(shards):
        if i == 0:
            top = torch.flip(x.narrow(dim, 1, context), dims=(dim,))
        else:
            prev = shards[i - 1]
            top = prev.narrow(dim, prev.shape[dim] - context, context).to(x.device,
                                                                       non_blocking=True)
        if i == n - 1:
            bottom = torch.flip(x.narrow(dim, x.shape[dim] - context - 1, context), dims=(dim,))
        else:
            bottom = shards[i + 1].narrow(dim, 0, context).to(x.device, non_blocking=True)
        out.append(torch.cat([top, x, bottom], dim=dim))
    return out


def _axis_context(model, h_local: int, n_shards: int) -> int:
    """Halo rows needed so a local slice of ``h_local`` output rows is
    computable: half of (input - output) along the sharded axis."""
    for inp in range(h_local, h_local + 256):
        try:
            out = compute_geometry(
                (inp,) * model.num_spatial_dims, model.downsampling_factors
            ).output_size[0]
        except ValueError:
            continue
        if out == h_local:
            return (inp - h_local) // 2
    raise ValueError(f"no valid halo found for local extent {h_local}")


def plan_spatial_split(model, n_shards: int, min_h_local: int = 8) -> Tuple[int, int]:
    """The smallest ``(H, context)`` with ``H = n_shards * h_local`` for which
    the sharded forward is self-consistent."""
    h_local = min_h_local
    while h_local < 4096:
        try:
            return n_shards * h_local, _axis_context(model, h_local, n_shards)
        except ValueError:
            h_local += 1
    raise ValueError("no valid spatial split found")


def _axis_output(model, axis: int, inp: int) -> int:
    """Output extent along ``axis`` for input extent ``inp`` (the other axes
    probed at a large valid size, so the axes' geometries decouple)."""
    probe = [512] * model.num_spatial_dims
    probe[axis] = inp
    return compute_geometry(tuple(probe), model.downsampling_factors).output_size[axis]


def _axis_pad_for_output(model, axis: int, extent: int) -> int:
    """The smallest input pad a side for which the output along ``axis``
    equals ``extent``."""
    for inp in range(extent, extent + 512):
        try:
            out = _axis_output(model, axis, inp)
        except ValueError:
            continue
        if out == extent and (inp - extent) % 2 == 0:
            return (inp - extent) // 2
    raise ValueError(f"no valid pad found for extent {extent} on axis {axis}")


def plan_whole_sample(model, spatial, n_shards: int):
    """``(h_pad, context, rest_pads)`` of a whole-sample sharded forward over
    ``spatial``: the first axis padded to ``h_pad = n_shards * h_local`` (with
    ``h_pad - H >= context``, so the bottom halo comes from reflected rows, as
    in the tiled path), and each other axis reflect-padded by
    ``rest_pads[i]`` a side so its output extent equals its input's."""
    H = int(spatial[0])
    h_local = -(-H // n_shards)
    while h_local < H + 4096:
        try:
            ctx = _axis_context(model, h_local, n_shards)
        except ValueError:
            h_local += 1
            continue
        if n_shards * h_local >= H + ctx:
            return n_shards * h_local, ctx, [
                _axis_pad_for_output(model, i, int(r)) for i, r in enumerate(spatial[1:], start=1)
            ]
        h_local += 1
    raise ValueError(f"no valid whole-sample split for H={H} x{n_shards}")


def spatial_devices(shards: int, device, devices=None) -> List[torch.device]:
    """The devices of a ``shards``-way forward: the first ``shards`` of
    ``devices``, else that many of ``device``'s type (every visible GPU on
    CUDA, ``shards`` times the CPU). Fewer raises ``ValueError``, in the
    JAX package's words (``cellulus_tpu/predict.py:138-142``)."""
    if devices is None:
        device = torch.device(device)
        found = "visible"
        devices = (local_devices(torch.cuda.device_count(), device) if device.type == "cuda"
                   else [device] * shards)
    else:
        found, devices = "given", as_devices(devices)
    if len(devices) < shards:
        raise ValueError(f"spatial_shards={shards} but only {len(devices)} devices are {found}")
    return devices[:shards]


def sharded_forward(model, raw: torch.Tensor, devices, compute_dtype=torch.float32,
                    replicas=None) -> torch.Tensor:
    """The U-Net forward with the first spatial axis split over ``devices``
    (``cellulus_tpu/parallel/spatial.py:sharded_forward``).

    Args:
        raw: ``(B, H, *rest, C)`` channels-last. ``H`` must split evenly
            over the devices, and each slice plus its halo must be a valid
            U-Net input whose output is the slice (pick sizes with
            :func:`plan_spatial_split`).

    Returns:
        ``(B, H, *rest_out, D)`` on ``devices[0]``: the unsharded forward of
        ``raw`` reflect-padded by the halo along the first spatial axis.
    """
    devices = as_devices(devices)
    n_shards = len(devices)
    H = raw.shape[1]
    if H % n_shards:
        raise ValueError(f"H={H} does not split over {n_shards} devices")
    h_local = H // n_shards
    context = _axis_context(model, h_local, n_shards)
    ext_out = compute_geometry((h_local + 2 * context,) + tuple(raw.shape[2:-1]),
                               model.downsampling_factors).output_size[0]
    if ext_out != h_local:
        raise ValueError(
            f"local slice {h_local} + halo {context} is not self-consistent "
            f"(output {ext_out}); pick sizes with plan_spatial_split"
        )
    replicas = replicas or replicate(model, devices)
    shards = [x.to(d, non_blocking=True) for x, d in zip(torch.split(raw, h_local, dim=1), devices)]
    with torch.no_grad():
        outs = [replicas[d](x, compute_dtype)
                for d, x in zip(devices, exchange_halo(shards, context, dim=1))]
    return torch.cat([o.to(devices[0]) for o in outs], dim=1)


def spatial_tta_sample(model, raw: np.ndarray, inference_config, normalization_factor: float,
                       sample_seed: int = 0, compute_dtype=torch.float32, devices=None,
                       replicas=None) -> np.ndarray:
    """Test-time-augmented embeddings of one whole sample as one sharded
    forward over ``inference_config.spatial_shards`` devices
    (``cellulus_tpu/parallel/spatial.py:spatial_tta_sample``).

    Each shard draws its salt-and-pepper noise for its own rows from a
    generator seeded by ``(seed, sample, shard)`` on its device, before the
    halo exchange, so halo rows carry the neighbour's noise, as in one
    noisy volume. Per pixel the output equals the tiled path's at
    ``p_salt_pepper = 0`` only; with noise the draws differ.

    Args:
        raw: ``(C, *spatial)`` un-normalized.
        devices: the shards' devices (default: :func:`spatial_devices` of
            the model's device); ``replicas`` the model a device
            (:func:`replicate`), made once by the caller for many samples.

    Returns:
        ``(D + 1, *spatial)`` float32, as ``predict_sample``.
    """
    ic = inference_config
    n_shards = int(ic.spatial_shards)
    devices = spatial_devices(n_shards, next(model.parameters()).device, devices)
    if replicas is None or any(d not in replicas for d in devices):
        replicas = replicate(model, devices)
    spatial = tuple(int(s) for s in raw.shape[1:])
    H = spatial[0]
    h_pad, context, rest_pads = plan_whole_sample(model, spatial, n_shards)
    h_local = h_pad // n_shards
    x = np.moveaxis(np.asarray(raw, np.float32) * float(normalization_factor), 0, -1)
    x = np.pad(x, [(0, h_pad - H)] + [(p, p) for p in rest_pads] + [(0, 0)], mode="reflect")

    nii = int(ic.num_infer_iterations)
    n, p = 2 * nii, float(ic.p_salt_pepper)
    transfer_dtype = torch.float16 if ic.transfer_precision == "float16" else torch.float32

    def run():
        noisy = []
        for i, d in enumerate(devices):
            local = torch.from_numpy(np.ascontiguousarray(x[i * h_local : (i + 1) * h_local]))
            local = local.to(d, non_blocking=True)
            gen = seeded_generator(d, ic.seed, sample_seed, i)
            uniform = torch.rand((n, *local.shape), generator=gen, device=d, dtype=torch.float32)
            noise_vals = torch.cat([torch.full((nii,), 0.5, device=d),
                                    torch.full((nii,), 1.0, device=d)])
            noisy.append(torch.where(uniform <= p, noise_vals.reshape((n,) + (1,) * local.dim()),
                                     local[None]))
        outs = []
        with torch.no_grad():
            for d, ext in zip(devices, exchange_halo(noisy, context, dim=1)):
                preds = replicas[d](ext, compute_dtype)
                out = torch.cat([preds.mean(dim=0),
                                 preds.std(dim=0, correction=0).sum(dim=-1, keepdim=True)], dim=-1)
                outs.append(out.to(transfer_dtype))
        return outs

    outs = time_device("predict.device", run)
    result = torch.cat([o.cpu() for o in outs], dim=0).float().numpy()[:H]
    return np.moveaxis(result, -1, 0)
