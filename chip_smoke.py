"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) if it fails:

1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. the build: every kernel of ``cellulus_tpu_torch/csrc`` built by ``nvcc``
   for ``sm_90a``, all at once, timed;
3. K1, the fused conv pass: the kernel against its plain version at the
   three pass shapes of the full-width 2D model's tile batch, in float32
   (TF32 off) and bfloat16, with the design each shape takes, its TFLOP/s
   and its plain, cuDNN and bound times; then ``[K1-wide]``: the wrapper's
   Python mirrors of the kernel's size and cost formulas against the
   library's, and K1 at the passes of ``examples/real-data``'s 256-fmap
   model (tile batch 16), whose bottom pass takes the staged route;
4. K2, the 3x3 filter gradient: the kernel against its plain version at the
   six dw shapes of the full-width train step, float32 and bfloat16, two
   launches bit-identical, with the plan each shape takes (tensor or CUDA
   cores), its TFLOP/s and its plain, cuDNN (``conv2d_weight``) and bound
   times;
5. K3, the mean-shift ball statistics: the kernel against its plain version
   on random points and on points lying exactly on the ball boundary;
6. K3-fit, the whole mean-shift fit in one launch: bit-identical over two
   launches, over a fit of every other seed (the sums do not depend on the
   seed groups) and to ``tests/mean_shift_fit_emu.py`` on four small
   fixtures (d = 2, 3, 5, and points beyond shared memory);
   one step against the plain version; labels against the plain version on
   two clustered fixtures; timed against the one-iteration route
   (``mean_shift_fit_plain`` over ``ball_stats``) and the plain version on a
   long fit (87,000 uniform points, 300 iterations at most) and on K3's
   input run as a fit;
7. reference checks: the full-width U-Net on the card against the CPU
   (forward, and every gradient of the training path), mean-shift labels,
   and ``conv_pass_2d`` refusing to run under autograd;
8. the infer main path: ``cellulus_tpu_torch.infer`` with the default
   inference settings (float32), on a synthetic 2-sample 512x512 uint16
   container and seeded random weights at the full width of ``examples/2d``,
   through predict -> detect -> segment -> evaluate, then again at
   ``examples/2d/infer.toml``'s bfloat16; each run must launch K1 18 times,
   the fit kernel once per sample and ``ball_stats`` never; after the
   float32 run, sample 0's detect is timed in parts (``[detect]``) and its
   fit input is K3-fit's third timed input; ``[variants]``: greedy, seeded
   mean shift, the bandwidth sweep and device detect on the bf16 run's
   embeddings, card against CPU (differences only where rounding explains
   them), seconds a sample, fit launches, each new path's fit timed;
   ``[wide-main]``: ``cellulus_tpu_torch.infer`` at
   ``examples/real-data/infer.toml``'s model and settings on one 512^2
   sample (bf16, pipelined off), K1 launched 9 times;
9. the train main path: ``cellulus_tpu_torch.train`` at the full width of
   ``examples/2d/train.toml`` (bf16, elastic on, device pairs) for 20 steps,
   K2 launched 6 times a step, a resume, 3 float32 steps, then infer on the
   trained checkpoint;
10. learn: a small recipe trains 400 steps and must beat its step-0 F1;
11. ``[3d-check]``: the full-width 3D U-Net of ``examples/3d``, and
    transposed-conv upsampling (``constant_upsample=False``) in 3D and 2D,
    on the card against the CPU: forward, and every training-path gradient;
12. ``[3d-train]``: ``examples/3d/train.toml`` (bf16, crop [40, 76, 76],
    all_dims pairs on the card) on a synthetic 2 x 128^3 uint16 blob
    container for 200 steps, the loss finite and below 3x its first value,
    then a 1-step resume;
13. ``[3d-main]``: the 3D infer main path on that checkpoint in float32 and
    in bfloat16 (default mean shift, cell mode, evaluate against the
    container's ground truth), the fit kernel launched once per sample and
    no other kernel; after the float32 run sample 0's segment and
    (``[3d-detect]``) detect in parts, labels on a small 3D fixture against
    the plain version, and the fit kernel timed at d = 3 on sample 0's fit
    input (``[K3-fit]``);
14. ``[3d-greedy]``: ``examples/3d/infer.toml`` as it is (greedy clustering)
    on the bf16 3D embeddings through detect, segment and evaluate, greedy's
    iterations, host syncs and seconds a sample, and a 48^3 crop card
    against CPU;
15. the kernels line (JSON, one row per kernel and input type; K1 at both
    widths; the fit at d = 2 and d = 3 and on each new detect path), then
    the last line ``{"ok": true, "device": {...}}``.

Needs CUDA: without it the script exits non-zero and prints no result.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import cellulus_tpu_torch
from cellulus_tpu_torch.configs import ExperimentConfig
from cellulus_tpu_torch.io import zarr
from cellulus_tpu_torch.models import UNet, compute_geometry
from cellulus_tpu_torch.models.geometry import conv_pass_inputs
from cellulus_tpu_torch.detect import detect_sample, mean_center_embeddings, sample_rng
from cellulus_tpu_torch.ops import mean_shift as msops
from cellulus_tpu_torch.ops.ball_stats import ball_stats, ball_stats_plain, point_set
from cellulus_tpu_torch.ops.conv_dw import conv3x3_dw, conv3x3_dw_design, conv3x3_dw_plain
from cellulus_tpu_torch.ops import conv_pass
from cellulus_tpu_torch.ops.conv_pass import conv_pass_2d, conv_pass_2d_design, conv_pass_2d_plain
from cellulus_tpu_torch.ops.mean_shift import mean_shift_fit_predict
from cellulus_tpu_torch.ops.mean_shift_fit import (
    mean_shift_fit,
    mean_shift_fit_plain,
    mean_shift_fit_plan,
    near_boundary,
)
from cellulus_tpu_torch.ops.components import filter_relabel
from cellulus_tpu_torch.ops.greedy_cluster import greedy_cluster
from cellulus_tpu_torch.ops.peaks import smooth_peak_seeds
from cellulus_tpu_torch.utils.parity import (
    mean_shift_fit_inputs,
    unexplained_greedy,
    unexplained_mean_shift,
)
from cellulus_tpu_torch.ops.morphology import halo_removal
from cellulus_tpu_torch.ops.otsu import threshold_otsu
from cellulus_tpu_torch.predict import tile_origins
from cellulus_tpu_torch.utils import kernels

# H100 SXM published peaks (dense): HBM bytes/s; the least time of K1 and
# K2 takes the tensor cores' rate of each input type: bfloat16 989 TFLOP/s,
# float32 as 3xTF32 (three TF32 products per float32 product, 495 / 3 TFLOP/s,
# which is how the kernels compute float32: with the CUDA cores' 67 TFLOP/s
# a share could read above 100%); K3 runs on the CUDA cores in float32
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
CUDA_CORE_F32_OPS = 67e12

# the full-width 2D model of examples/2d/infer.toml and the default
# inference settings
MODEL = dict(num_fmaps=64, fmap_inc_factor=3, features_in_last_layer=64,
             downsampling_factors=[[2, 2]])
CROP = 252
TILE_BATCH = 4
NUM_INFER_ITERATIONS = 16
TRAIN_BATCH = 8
DEVICE = "cuda:0"
OBJECT_SIZE = 40
IMAGE_SIZE = 512
# the model of examples/real-data/infer.toml (the repo's real-data recipe),
# and the tile batch at which [K1-wide] times its passes: small enough for
# the float32 up pass (1024 -> 64 channels) and its plain version
MODEL_WIDE = dict(num_fmaps=256, fmap_inc_factor=3, features_in_last_layer=64,
                  downsampling_factors=[[2, 2]])
K1_WIDE_BATCH = 16
# the long fit: the reference's trained 2D fit scale (87k fit points), here
# uniform in the image so that seeds wander; and K3's (seeds, points) as a fit
LONG_FIT_POINTS = 87000
K3_FIT_SHAPE = (1024, 16384)
# the 3D model of examples/3d (train.toml, infer.toml) with its crop and
# object size, on volumes of examples/3d/01-data.py's size
MODEL_3D = dict(num_fmaps=24, fmap_inc_factor=3, features_in_last_layer=64,
                downsampling_factors=[[1, 2, 2]])
CROP_3D = [40, 76, 76]
OBJECT_SIZE_3D = 12
VOLUME_SIZE = 128
TRAIN_STEPS_3D = 200
LONG_FIT_POINTS_3D = 100000
REPO = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def make_blobs(num_samples, size, seed, dtype=np.uint16, num_blobs=40, radius=(0.025, 0.045),
               ndim=2):
    """Bright disks (balls in 3D) on a dark noisy background: ``(raw (s, 1,
    *spatial), labels (s, 1, *spatial) uint16)``, ``spatial = (size,) *
    ndim``; radii are ``radius`` times ``size``."""
    rng = np.random.default_rng(seed)
    spatial = (size,) * ndim
    raw = np.zeros((num_samples, 1, *spatial), np.float32)
    labels = np.zeros((num_samples, 1, *spatial), np.uint16)
    grid = np.meshgrid(*[np.arange(size)] * ndim, indexing="ij")
    for s in range(num_samples):
        next_id = 1
        for _ in range(num_blobs):
            r = rng.uniform(radius[0] * size, radius[1] * size)
            center = rng.uniform(r, size - r, size=ndim)
            dist2 = sum((g - c) ** 2 for g, c in zip(grid, center))
            mask = dist2 < r**2
            if (labels[s, 0][mask] != 0).any():
                continue
            labels[s, 0][mask] = next_id
            raw[s, 0][mask] = rng.uniform(0.6, 1.0) * np.exp(
                -dist2[mask] / (2 * (r / 1.5) ** 2)
            )
            next_id += 1
        raw[s, 0] += rng.normal(0, 0.02, spatial).clip(0)
    scale = np.iinfo(dtype).max
    return (raw.clip(0, 1) * scale).astype(dtype), labels


def write_blob_container(path, num_samples, size, seed, dtype=np.uint16, ndim=2, **blobs):
    raw, labels = make_blobs(num_samples, size, seed, dtype, ndim=ndim, **blobs)
    f = zarr.open(path, "a")
    for name, data in (("raw", raw), ("groundtruth", labels)):
        f[name] = data
        f[name].attrs.update({"axis_names": ["s", "c"] + ["z", "y", "x"][-ndim:],
                              "resolution": [1] * ndim})
    return path


def random_unet(seed, in_channels=1, num_spatial_dims=2, **model):
    """Seeded Kaiming-normal weights (every conv and transposed conv)."""
    torch.manual_seed(seed)
    net = UNet(in_channels, num_spatial_dims, num_spatial_dims=num_spatial_dims, **model)
    for m in net.modules():
        if isinstance(m, torch.nn.modules.conv._ConvNd):
            torch.nn.init.kaiming_normal_(m.weight)
    return net


def save_random_checkpoint(path, seed, in_channels=1, num_spatial_dims=2, **model):
    """Seeded Kaiming-normal weights as a reference-format ``.pth``."""
    net = random_unet(seed, in_channels, num_spatial_dims, **model)
    torch.save({"iteration": 0, "lowest_loss": 0.0, "model_state_dict": net.state_dict(),
                "optim_state_dict": {}, "logger_data": {}}, path)
    return net


def infer_config(container, checkpoint, model, object_size=OBJECT_SIZE, **inference):
    """All stages read and write one container, which holds the ground truth."""

    def ds(name, secondary=None):
        d = {"container_path": str(container), "dataset_name": name}
        if secondary:
            d["secondary_dataset_name"] = secondary
        return d

    return ExperimentConfig(**{
        "object_size": object_size,
        "model_config": {**model, "checkpoint": str(checkpoint)},
        "inference_config": {
            "dataset_config": ds("raw"),
            "prediction_dataset_config": ds("embeddings"),
            "detection_dataset_config": ds("detection", "embeddings"),
            "segmentation_dataset_config": ds("segmentation", "detection"),
            "evaluation_dataset_config": ds("groundtruth", "segmentation"),
            **inference,
        },
    })


@contextlib.contextmanager
def logged(path):
    """Send the port's per-iteration prints to ``path``; on an error print
    the tail of the log before it propagates."""
    try:
        with open(path, "a") as f, contextlib.redirect_stdout(f):
            yield
    except BaseException:
        with open(path) as f:
            sys.stdout.write("".join(f.readlines()[-30:]))
        raise


def cuda_ms(fn, reps=3):
    """Mean milliseconds per call on the current stream, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")


def phase_build():
    t0 = time.perf_counter()
    libs = kernels.build_all()
    print(f"[build] {len(libs)} kernels in {time.perf_counter() - t0:.1f}s: "
          + ", ".join(sorted(libs)))
    for name, log in sorted(kernels.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def _pass_params(c_in, c_out, gen, device):
    params = {}
    for i, k in enumerate((3, 1, 1, 3)):
        fan_in = k * k * c_in
        w = torch.randn((k, k, c_in, c_out), generator=gen) * math.sqrt(2.0 / fan_in)
        b = (torch.rand((c_out,), generator=gen) * 2 - 1) / math.sqrt(fan_in)
        params[f"conv{i}"] = {"w": w.to(device), "b": b.to(device)}
        c_in = c_out
    return params


def _pass_flops(B, H, W, c_in, c):
    return (2 * B * (H - 2) * (W - 2) * 9 * c_in * c
            + 2 * 2 * B * (H - 2) * (W - 2) * c * c
            + 2 * B * (H - 4) * (W - 4) * 9 * c * c)


def _library_pass(x, params, dtype):
    """cuDNN yardstick (never called by the port): four native-dtype convs."""
    y = x.to(dtype).permute(0, 3, 1, 2)
    for i in range(4):
        p = params[f"conv{i}"]
        w = p["w"].to(dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        y = torch.relu(torch.nn.functional.conv2d(y, w, p["b"].to(dtype)))
    return y


def pass_shapes(batch, model=MODEL):
    """``(name, NHWC input shape, C_out)`` of every conv pass of a tile
    batch of ``batch`` images at ``model``'s width."""
    return [(name, (batch, *size, c_in), c_out) for name, size, c_in, c_out in conv_pass_inputs(
        (CROP, CROP), model["downsampling_factors"], 1, model["num_fmaps"],
        model["fmap_inc_factor"], model["features_in_last_layer"])]


def phase_conv_pass(device, model=MODEL, batch=TILE_BATCH * 2 * NUM_INFER_ITERATIONS,
                    tag="K1"):
    """K1 against its plain version at the pass shapes of a tile batch of
    ``batch`` images at ``model``'s width, in both compute types; returns
    the sums per type."""
    gen = torch.Generator().manual_seed(1)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                 "max_abs_err": 0.0, "flops": 0.0, "nbytes": 0.0}
        for name, shape, c_out in pass_shapes(batch, model):
            params = _pass_params(shape[-1], c_out, gen, device)
            x = torch.rand(shape, generator=gen).to(device)
            got = conv_pass_2d(x, params, dtype)
            ref = conv_pass_2d_plain(x, params, dtype)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            max_err = float(err.max())
            if dtype == torch.float32:
                tol = 1e-5 + 1e-4 * ref.float().abs()
                ok = bool((err <= tol).all())
                tol_text = "rtol 1e-4, atol 1e-5"
            else:
                atol = 2e-2 * float(ref.float().abs().max())
                ok = max_err <= atol
                tol_text = f"atol 2e-2*max|ref| = {atol:.3g}"
            if not ok or not torch.isfinite(got.float()).all():
                fail(f"conv_pass_2d {name} {dtype}: max abs err {max_err:.3g} ({tol_text})")
            del got, ref, err
            ms = cuda_ms(lambda: conv_pass_2d(x, params, dtype))
            plain_ms = cuda_ms(lambda: conv_pass_2d_plain(x, params, dtype))
            library_ms = cuda_ms(lambda: _library_pass(x, params, dtype))
            B, H, W, c_in = shape
            e = torch.tensor([], dtype=dtype).element_size()
            flops = _pass_flops(B, H, W, c_in, c_out)
            nbytes = e * (B * H * W * c_in + B * (H - 4) * (W - 4) * c_out) + e * sum(
                p["w"].numel() for p in params.values()) + 4 * 4 * c_out
            bound_ms = 1e3 * max(flops / PEAK_OPS[dtype], nbytes / HBM_BYTES_PER_S)
            print(f"[{tag}] {name:6s} {str(dtype):14s} {tuple(shape)}->{c_out}: "
                  f"{conv_pass_2d_design(shape, c_out, dtype)}; "
                  f"max_abs_err {max_err:.3g} ({tol_text}); kernel {ms:.2f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.2f} ms, "
                  f"cuDNN {library_ms:.2f} ms, bound {bound_ms:.3f} ms")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                           ("bound_ms", bound_ms), ("flops", flops), ("nbytes", nbytes)):
                total[key] += v
            total["max_abs_err"] = max(total["max_abs_err"], max_err)
            del x
            torch.cuda.empty_cache()
        by_ops = total.pop("flops") / PEAK_OPS[dtype] >= total.pop("nbytes") / HBM_BYTES_PER_S
        total["bound_by"] = "operations" if by_ops else "bytes"
        print(f"[{tag}] per tile batch of {batch} images, {dtype}: kernel {total['ms']:.2f} ms, "
              f"plain {total['plain_ms']:.2f} ms, cuDNN {total['library_ms']:.2f} ms, bound "
              f"{total['bound_ms']:.3f} ms ({total['bound_by']})", flush=True)
        out[dtype] = total
    return out


def phase_k1_plans():
    """The wrapper chooses K1's route and tile from Python mirrors of the
    source's size and cost formulas: hold them against the library's at
    every candidate tile of every pass of both models, both types."""
    lib = kernels.load("conv_pass", conv_pass._SIGNATURES)
    n = 0
    for model in (MODEL, MODEL_WIDE):
        for _, (_, H, W, c_in), c_out in pass_shapes(1, model):
            for elem in (2, 4):
                for t in conv_pass.TILE_CANDIDATES:
                    got = (lib.conv_pass_2d_smem_bytes(c_in, c_out, t, t, elem),
                           lib.conv_pass_2d_cost(c_in, c_out, t, t, H, W, elem),
                           *(lib.conv_pass_2d_staged_smem_bytes(k, ci, t, t, elem)
                             for k, ci in ((3, c_in), (1, c_out), (3, c_out))))
                    want = (conv_pass.fused_smem_bytes(c_in, c_out, t, t, elem),
                            conv_pass.fused_cost(c_in, c_out, t, t, H, W, elem),
                            *(conv_pass.staged_smem_bytes(k, ci, t, t, elem)
                              for k, ci in ((3, c_in), (1, c_out), (3, c_out))))
                    if got != want:
                        fail(f"K1 plan mirrors differ from the library at {c_in}->{c_out}, "
                             f"tile {t}, {elem} B: library {got}, mirror {want}")
                    n += 1
    print(f"[K1-wide] the wrapper's mirrors of the size and cost formulas equal the library's "
          f"at {n} (pass, type, tile) cases of the 64- and 256-fmap models", flush=True)


def dw_shapes(batch):
    """``(name, x shape, g shape)`` of every 3x3 filter gradient of a train
    step: the first and last conv of each pass."""
    shapes = []
    for name, (B, H, W, c_in), c in pass_shapes(batch):
        shapes.append((f"{name} c0", (B, H, W, c_in), (B, H - 2, W - 2, c)))
        shapes.append((f"{name} c3", (B, H - 2, W - 2, c), (B, H - 4, W - 4, c)))
    return shapes


def phase_conv_dw(device):
    """K2 against its plain version at the train step's six dw shapes."""
    gen = torch.Generator(device=device).manual_seed(6)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                 "max_abs_err": 0.0, "flops": 0.0, "nbytes": 0.0}
        for name, xs, gs in dw_shapes(TRAIN_BATCH):
            x = torch.randn(xs, generator=gen, device=device).to(dtype)
            g = torch.randn(gs, generator=gen, device=device).to(dtype)
            got = conv3x3_dw(x, g)
            again = conv3x3_dw(x, g)
            ref = conv3x3_dw_plain(x, g)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"conv3x3_dw {name} {dtype}: two launches on the same inputs differ")
            err = (got - ref).abs()
            max_err, scale = float(err.max()), float(ref.abs().max())
            if dtype == torch.float32:
                ok = bool((err <= 1e-4 * ref.abs() + 1e-5 * scale).all())
                tol_text = "rtol 1e-4, atol 1e-5*max|ref|"
            else:
                ok = max_err <= 2e-2 * scale
                tol_text = f"atol 2e-2*max|ref| = {2e-2 * scale:.3g}"
            if not ok or not torch.isfinite(got).all():
                fail(f"conv3x3_dw {name} {dtype}: max abs err {max_err:.3g} ({tol_text})")
            del got, again, ref, err
            B, H, W, c_in = xs
            c_out = gs[-1]
            w_shape = (c_out, c_in, 3, 3)
            x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            ms = cuda_ms(lambda: conv3x3_dw(x, g))
            plain_ms = cuda_ms(lambda: conv3x3_dw_plain(x, g))
            library_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(x_nchw, w_shape, g_nchw))
            flops = 2 * B * (H - 2) * (W - 2) * 9 * c_in * c_out
            nbytes = x.element_size() * (x.numel() + g.numel()) + 4 * 9 * c_in * c_out
            bound_ms = 1e3 * max(flops / PEAK_OPS[dtype], nbytes / HBM_BYTES_PER_S)
            print(f"[K2] {name:9s} {str(dtype):14s} x{tuple(xs)} g{tuple(gs)}: "
                  f"{conv3x3_dw_design(c_in, c_out, dtype)}; bit-identical over two launches; "
                  f"max_abs_err {max_err:.3g} ({tol_text}); kernel {ms:.3f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
                  f"cuDNN {library_ms:.3f} ms, bound {bound_ms:.3f} ms")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                           ("bound_ms", bound_ms), ("flops", flops), ("nbytes", nbytes)):
                total[key] += v
            total["max_abs_err"] = max(total["max_abs_err"], max_err)
            del x, g, x_nchw, g_nchw
            torch.cuda.empty_cache()
        by_ops = total.pop("flops") / PEAK_OPS[dtype] >= total.pop("nbytes") / HBM_BYTES_PER_S
        total["bound_by"] = "operations" if by_ops else "bytes"
        print(f"[K2] per train step, {dtype}: kernel {total['ms']:.3f} ms, plain "
              f"{total['plain_ms']:.3f} ms, cuDNN {total['library_ms']:.3f} ms, bound "
              f"{total['bound_ms']:.3f} ms ({total['bound_by']})")
        out[dtype] = total
    return out


def phase_ball_stats(device):
    """K3 against its plain version; counts exact except on the sphere."""
    rng = np.random.default_rng(2)
    S, N, d = 1024, 16384, 2
    bw = np.float32(0.5 * OBJECT_SIZE)
    bw2 = float(bw * bw)
    centers = torch.from_numpy(rng.uniform(0, IMAGE_SIZE, (S, d)).astype(np.float32)).to(device)
    x = torch.from_numpy(rng.uniform(0, IMAGE_SIZE, (N, d)).astype(np.float32)).to(device)
    points = point_set(x, torch.from_numpy(rng.random(N) > 0.05).to(device))
    counts, sums = ball_stats(centers, points, bw2)
    ref_counts, ref_sums = ball_stats_plain(centers, points, bw2)
    torch.cuda.synchronize()
    # a count may differ only through a point whose distance lies within
    # 1e-5 * bw^2 of the boundary (the two sum c.x in different orders)
    d2 = ((centers[:, None, :] - points.x[None, :, :]) ** 2).sum(-1)
    near = ((d2 - bw2).abs() <= 1e-5 * bw2) & points.valid[None, :]
    n_near = near.sum(dim=1)
    diff = (counts - ref_counts).abs()
    if bool((diff > n_near).any()):
        fail("ball_stats counts differ beyond boundary points")
    exact = diff == 0
    sum_err = (sums - ref_sums).abs()
    if not bool((sum_err[exact] <= 1e-5 * ref_sums[exact].abs() + 1e-3).all()):
        fail(f"ball_stats sums differ: max abs err {float(sum_err[exact].max()):.3g}")
    print(f"[K3] S={S} N={N} d={d}: counts equal for {int(exact.sum())}/{S} seeds, "
          f"{int(n_near.sum())} (seed, point) pairs within 1e-5*bw^2 of the boundary, "
          f"max sum err {float(sum_err[exact].max()):.3g} (rtol 1e-5)")

    # boundary case: integer coordinates make every distance exact, and the
    # 3-4-5 offsets put points exactly on the sphere of radius 5
    grid = torch.stack(torch.meshgrid(torch.arange(40.0), torch.arange(40.0), indexing="ij"), -1)
    bpoints = point_set(grid.reshape(-1, 2).to(device), torch.ones(1600, dtype=torch.bool, device=device))
    bcenters = torch.tensor([[20.0, 20.0], [5.0, 7.0], [0.0, 0.0], [33.0, 12.0]], device=device)
    bc, bs = ball_stats(bcenters, bpoints, 25.0)
    rc, rs = ball_stats_plain(bcenters, bpoints, 25.0)
    torch.cuda.synchronize()
    if not (torch.equal(bc, rc) and torch.equal(bs, rs)) or float(bc[0]) != 81.0:
        fail(f"ball_stats boundary case: counts {bc.tolist()} vs {rc.tolist()} (want 81 at [20,20])")
    print(f"[K3] boundary case: counts {bc.tolist()} equal to the plain version, inclusive")

    ms = cuda_ms(lambda: ball_stats(centers, points, bw2), reps=20)
    plain_ms = cuda_ms(lambda: ball_stats_plain(centers, points, bw2), reps=20)
    within = float(counts.sum())
    ops = S * N * (2 * d + 4) + within * (d + 1)
    nbytes = 4 * (S * d + S) + N * (4 * d + 4 + 1) + 4 * S * (d + 1)
    bound_ms = 1e3 * max(ops / CUDA_CORE_F32_OPS, nbytes / HBM_BYTES_PER_S)
    bound_by = "operations" if ops / CUDA_CORE_F32_OPS >= nbytes / HBM_BYTES_PER_S else "bytes"
    print(f"[K3] kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": float(sum_err[exact].max())}


def _load_fit_emulation():
    """tests/mean_shift_fit_emu.py, loaded by path (numpy only)."""
    path = os.path.join(REPO, "tests", "mean_shift_fit_emu.py")
    spec = importlib.util.spec_from_file_location("mean_shift_fit_emu", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fit_problem(X, seeds, bandwidth, device, valid=None):
    """``(seeds, points, bw2, stop)`` on the card, as mean_shift_fit_predict
    prepares them."""
    bw = np.float32(bandwidth)
    valid = np.ones(len(X), bool) if valid is None else valid
    points = point_set(torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device),
                       torch.from_numpy(valid).to(device))
    return (torch.from_numpy(np.asarray(seeds, np.float32)).to(device), points,
            float(bw * bw), float(np.float32(1e-3) * bw))


def _fit_step_check(name, seeds, points, bw2, stop):
    """One fit step (max_iter = 1, then the recount) against the plain
    version. A seed is left out when a point lies within rounding of its
    ball at the start or at the end, or its shift within 1e-4 bw of the stop
    threshold: there the two may decide differently, since they sum c.x and
    the coordinates in other orders. The rest must agree: counts and frozen
    exactly, centers within rtol 1e-5, atol 1e-4."""
    got = mean_shift_fit(seeds, points, bw2, stop, 1)
    ref = mean_shift_fit_plain(seeds, points, bw2, stop, 1)
    torch.cuda.synchronize()
    shift = (ref[0] - seeds).norm(dim=1)
    undecided = (near_boundary(seeds, points, bw2) | near_boundary(ref[0], points, bw2)
                 | near_boundary(got[0], points, bw2)
                 | ((shift - stop).abs() <= 1e-4 * math.sqrt(bw2)))
    ok = ~undecided
    err = (got[0] - ref[0]).abs()
    max_err = float(err[ok].max()) if bool(ok.any()) else 0.0
    if not (bool((err[ok] <= 1e-5 * ref[0][ok].abs() + 1e-4).all())
            and torch.equal(got[1][ok], ref[1][ok]) and torch.equal(got[2][ok], ref[2][ok])
            and bool((got[3] == 1).all())):
        fail(f"mean_shift_fit {name}: one step differs from the plain version "
             f"(max center err {max_err:.3g} on {int(ok.sum())} seeds)")
    return max_err, int(undecided.sum())


def _fit_bound(S, N, d, n_iter, frozen, inball):
    """Least time of a fit whose seeds were live ``n_iter`` iterations: each
    live (seed, point) pair's distance and test (2d + 4 FLOP), the recount
    of the never-frozen seeds, and d + 1 adds per point in a ball."""
    pairs = (int(n_iter.sum()) + int((~frozen).sum())) * N
    ops = pairs * (2 * d + 4) + inball * (d + 1)
    nbytes = 4 * S * d + N * (4 * d + 4 + 1) + S * (4 * d + 4 + 1 + 4)
    by_ops = ops / CUDA_CORE_F32_OPS >= nbytes / HBM_BYTES_PER_S
    return 1e3 * max(ops / CUDA_CORE_F32_OPS, nbytes / HBM_BYTES_PER_S), (
        "operations" if by_ops else "bytes")


def time_fit(name, seeds, points, bw2, stop, max_iter):
    """The fit kernel against the one-iteration route (``ball_stats`` each
    iteration, the fit before the one-launch kernel) and the plain version
    on one input: determinism, one step against the plain version, times
    and the bound."""
    S, d = seeds.shape
    N = int(points.valid.sum())
    out = mean_shift_fit(seeds, points, bw2, stop, max_iter)
    again = mean_shift_fit(seeds, points, bw2, stop, max_iter)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        fail(f"mean_shift_fit {name}: two launches on the same inputs differ")
    centers, n_final, frozen, n_iter = out
    if not (torch.isfinite(centers).all() and bool((n_final >= 0).all())
            and int(n_iter.max()) <= max_iter):
        fail(f"mean_shift_fit {name}: centers finite {bool(torch.isfinite(centers).all())}, "
             f"n_iter max {int(n_iter.max())}")
    max_err, undecided = _fit_step_check(name, seeds, points, bw2, stop)

    # the points that lie in a ball, over the live iterations, counted on
    # the one-iteration route's run (its sums follow the same trajectories
    # up to their order)
    calls = []

    def recorded(c, p, b):
        counts, sums = ball_stats(c, p, b)
        calls.append(counts)
        return counts, sums

    _, _, r_frozen, r_iter = mean_shift_fit_plain(seeds, points, bw2, stop, max_iter, recorded)
    inball = sum(float(cnt[r_iter > i].sum()) for i, cnt in enumerate(calls[:-1]))
    inball += float(calls[-1][~r_frozen].sum())

    reps = 20 if max_iter * S * N < 1e10 else 5
    ms = cuda_ms(lambda: mean_shift_fit(seeds, points, bw2, stop, max_iter), reps=reps)
    route_ms = cuda_ms(lambda: mean_shift_fit_plain(seeds, points, bw2, stop, max_iter, ball_stats),
                       reps=2)
    plain_ms = cuda_ms(lambda: mean_shift_fit_plain(seeds, points, bw2, stop, max_iter), reps=2)
    bound_ms, bound_by = _fit_bound(S, N, d, n_iter, frozen, inball)
    group, clusters, resident, smem = mean_shift_fit_plan(S, points.x.shape[0], d)
    print(f"[K3-fit] {name}: S={S} N={N} d={d} max_iter={max_iter}; plan {clusters} clusters "
          f"of 8 blocks, {group} seeds a group, {resident} points a block in shared memory "
          f"({smem / 1024:.0f} KB); iterations max {int(n_iter.max())}, sum over seeds "
          f"{int(n_iter.sum())}, frozen {int(frozen.sum())}/{S}; bit-identical over two "
          f"launches; one step vs plain: max center err {max_err:.3g} (rtol 1e-5, atol 1e-4; "
          f"{undecided} seeds at the boundary left out); kernel {ms:.3f} ms a fit, "
          f"one-iteration route {route_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {len(calls) - 1} route iterations", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "route_ms": route_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": max_err,
            "out": out}


def _same_partition(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not ((a == -1) == (b == -1)).all():
        return False
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def phase_fit(device):
    """K3-fit: the whole mean-shift fit in one launch."""
    emu = _load_fit_emulation()
    rng = np.random.default_rng(8)
    # (N, d, S, extent, bandwidth, max_iter, share of valid points): the
    # small fixture, then d = 3 and d = 5 (8-seed groups), then more points
    # than the cluster's shared memory holds (the rest read from L2)
    for N, d, S, extent, bw, max_iter, p_valid in (
            (2048, 2, 64, 64, 4.0, 50, 1.0), (3000, 3, 100, 30, 4.0, 30, 1.0),
            (3000, 5, 50, 30, 6.0, 20, 1.0), (200000, 2, 40, 512, 20.0, 5, 0.9)):
        X = rng.uniform(0, extent, (N, d)).astype(np.float32)
        valid = rng.random(N) < p_valid
        seeds, points, bw2, stop = _fit_problem(X, X[rng.choice(N, S, replace=False)], bw, device,
                                                valid=valid)
        got = [t.cpu().numpy() for t in mean_shift_fit(seeds, points, bw2, stop, max_iter)]
        want = emu.fit(seeds.cpu().numpy(), X, points.x_norm.cpu().numpy(), valid, bw2, stop,
                       max_iter)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            fail(f"mean_shift_fit differs from tests/mean_shift_fit_emu.py at N={N} d={d}")
        print(f"[K3-fit] S={S} N={N} d={d} max_iter={max_iter}, {valid.mean():.0%} valid: "
              f"bit-identical to the emulation (iterations max {got[3].max()}, frozen "
              f"{int(got[2].sum())}/{S}; plan {mean_shift_fit_plan(S, N, d)})", flush=True)

    # labels against the plain version: three clusters (2D), forty (3D)
    rng = np.random.default_rng(1)
    X3 = np.concatenate([rng.normal(c, 0.6, size=(60, 2)) for c in
                         ([0.0, 0.0], [8.0, 8.0], [0.0, 9.0])]).astype(np.float32)
    rng = np.random.default_rng(7)
    centers40 = rng.uniform(0, 100, size=(40, 3)).astype(np.float32)
    X40 = np.concatenate([rng.normal(c, 0.8, size=(50, 3)) for c in centers40]
                         + [rng.uniform(-50, -40, size=(5, 3))]).astype(np.float32)
    for name, Xc, bw in (("3 clusters", X3, 2.0), ("40 clusters", X40, 3.0)):
        mean_shift_fit.launches = 0
        gpu = mean_shift_fit_predict(Xc, bw, None, device=device)
        launches = mean_shift_fit.launches
        cpu = mean_shift_fit_predict(Xc, bw, None, device="cpu")
        if launches != 1 or not _same_partition(gpu, cpu):
            fail(f"mean_shift_fit {name}: labels differ from the plain version's "
                 f"({launches} launches)")
        print(f"[K3-fit] {name}: labels equal the plain version's as a partition "
              f"({len(set(gpu.tolist()) - {-1})} clusters, ids equal: {np.array_equal(gpu, cpu)})")

    # a long fit: uniform points at the reference's trained 2D fit scale
    rng = np.random.default_rng(9)
    X = rng.uniform(0, IMAGE_SIZE, (LONG_FIT_POINTS, 2)).astype(np.float32)
    bw = 0.5 * OBJECT_SIZE
    seeds, points, bw2, stop = _fit_problem(X, msops.bin_seeds(X, bw), bw, device)
    long_fit = time_fit("long fit", seeds, points, bw2, stop, 300)
    half = mean_shift_fit(seeds[::2].contiguous(), points, bw2, stop, 300)
    if not all(torch.equal(h, f[::2]) for h, f in zip(half, long_fit["out"])):
        fail("mean_shift_fit: a fit of every other seed differs from the full fit")
    print("[K3-fit] long fit: every other seed fitted alone is bit-identical to the full fit")

    # K3's input, run as a fit
    rng = np.random.default_rng(2)
    S, N = K3_FIT_SHAPE
    c = rng.uniform(0, IMAGE_SIZE, (S, 2)).astype(np.float32)
    X = rng.uniform(0, IMAGE_SIZE, (N, 2)).astype(np.float32)
    seeds, points, bw2, stop = _fit_problem(X, c, bw, device, valid=rng.random(N) > 0.05)
    k3_fit = time_fit("K3 input", seeds, points, bw2, stop, 300)
    half = mean_shift_fit(seeds[1::2].contiguous(), points, bw2, stop, 300)
    if not all(torch.equal(h, f[1::2]) for h, f in zip(half, k3_fit["out"])):
        fail("mean_shift_fit: a fit of every other seed differs from the full fit (K3 input)")


def _route_fit(seeds, points, bw2, stop, max_iter):
    """The one-iteration route, the fit before the one-launch kernel:
    ``ball_stats`` every iteration."""
    return mean_shift_fit_plain(seeds, points, bw2, stop, max_iter, ball_stats)


def _detect_in_parts(container, ic, ndim, device, reps):
    """Sample 0's detect in parts, with the port's own functions on the
    container a float32 main path left: the read, host preparation (Otsu
    threshold, mean-centring, points = coordinate grid + mask + subsample,
    bin seeds), transfers to the card, fit, dedupe, predict and the labels'
    transfer back. Returns the median ms of each part over ``reps`` runs and
    the last run's ``emb``, ``X``, ``X_fit``, bin seeds, kept centers and
    fit problem ``(seeds, points, bw2, stop)``."""
    parts = {k: [] for k in ("read", "otsu", "centre", "points", "bin_seeds", "to_device",
                             "fit", "dedupe", "predict", "to_host")}
    for _ in range(reps):
        t = [time.perf_counter()]
        emb = np.asarray(zarr.open(container, "r")["embeddings"][0], dtype=np.float32)
        t.append(time.perf_counter())
        threshold = threshold_otsu(emb[-1])
        t.append(time.perf_counter())
        mask = emb[-1] < threshold
        mean_center_embeddings(emb, mask)
        t.append(time.perf_counter())
        X = msops.add_coordinate_grid(emb[:ndim]).reshape(ndim, -1).T[mask.ravel()]
        X_fit = X[sample_rng(ic.seed, 0).random(len(X)) < ic.reduction_probability]
        t.append(time.perf_counter())
        seeds_np = msops.bin_seeds(X_fit, bin_size=ic.bandwidth)
        t.append(time.perf_counter())
        seeds, points, bw2, stop = _fit_problem(X_fit, seeds_np, ic.bandwidth, device)
        X_t = torch.from_numpy(X).to(device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        centers, n_final, _, _ = mean_shift_fit(seeds, points, bw2, stop,
                                                ic.mean_shift_max_iterations)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        kept = msops._dedupe(centers, n_final, bw2)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        labels = msops._predict(X_t, kept, bw2)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        labels.cpu().numpy()
        t.append(time.perf_counter())
        for key, a, b in zip(parts, t[:-1], t[1:]):
            parts[key].append(1e3 * (b - a))
    median = {k: float(np.median(v)) for k, v in parts.items()}
    return median, emb, X, X_fit, seeds_np, kept, (seeds, points, bw2, stop)


def phase_detect(container, device, detect_seconds):
    """Sample 0's detect in parts (:func:`_detect_in_parts`, median of 5)
    with the default settings; the whole ``detect_sample`` with the fit
    kernel and with the one-iteration route, in turns; the rest of the main
    path's detect stage (the zarr read and writes). Then the fit kernel
    timed on sample 0's fit input."""
    ic = infer_config(container, "unused.pth", MODEL, device=str(device)).inference_config
    ic.bandwidth = 0.5 * OBJECT_SIZE
    median, emb, X, X_fit, seeds_np, kept, (seeds, points, bw2, stop) = _detect_in_parts(
        container, ic, 2, device, 5)

    whole = {"kernel": [], "route": []}
    for order in (("route", "kernel"), ("kernel", "route")) * 3:
        for which in order:
            msops.mean_shift_fit = mean_shift_fit if which == "kernel" else _route_fit
            try:
                t0 = time.perf_counter()
                detect_sample(emb, ic, 2, sample_rng(ic.seed, 0), device)
                whole[which].append(1e3 * (time.perf_counter() - t0))
            finally:
                msops.mean_shift_fit = mean_shift_fit
    whole = {k: float(np.median(v)) for k, v in whole.items()}
    stage_ms = 1e3 * detect_seconds / 2
    print(f"[detect] sample 0 in parts, median of 5 (ms): "
          f"{json.dumps({k: round(v, 3) for k, v in median.items()})}, sum "
          f"{sum(median.values()):.2f} ms; {len(X)} foreground points, {len(X_fit)} fitted, "
          f"{len(seeds_np)} seeds, {len(kept)} clusters", flush=True)
    print(f"[detect] detect_sample, median of 6 in turns: {whole['kernel']:.2f} ms with the fit "
          f"kernel, {whole['route']:.2f} ms with the one-iteration route; the main path's "
          f"detect stage {stage_ms:.1f} ms a sample, so {stage_ms - whole['kernel']:.1f} ms a "
          f"sample outside detect_sample (the zarr read and writes)", flush=True)
    return time_fit("main input (sample 0)", seeds, points, bw2, stop,
                    ic.mean_shift_max_iterations)


def _card_vs_cpu(net, x, device):
    """``net`` on the card against the CPU in float32: ``(forward max abs
    err / max(1, max|out|), (training-path gradient max abs err / max|grad|,
    tensor) at the worst tensor, the tensors whose gradient is zero on the
    card, the tensor count)``."""
    with torch.no_grad():
        ref = net.to("cpu").eval()(x)
        got = net.to(device)(x.to(device)).cpu()
    forward_err = float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))
    grads = {}
    for dev in ("cpu", device):
        net.to(dev).zero_grad()
        net(x.to(dev)).square().sum().backward()
        # clone: moving the module later rewrites .grad in place
        grads[str(dev)] = {k: p.grad.cpu().clone() for k, p in net.named_parameters()}
    cpu_g, gpu_g = grads["cpu"], grads[str(device)]
    zero = [k for k, g in gpu_g.items() if not bool(g.abs().sum() > 0)]
    worst = max((float((gpu_g[k] - cpu_g[k]).abs().max() / cpu_g[k].abs().max()), k)
                for k in cpu_g)
    return forward_err, worst, zero, len(gpu_g)


def phase_reference_checks(work, device):
    """Small inputs where the card must agree with the port's CPU path."""
    net = save_random_checkpoint(os.path.join(work, "small.pth"), seed=3, **MODEL)
    x = torch.rand((2, 92, 92, 1), generator=torch.Generator().manual_seed(4))
    err, (worst, _), zero, n = _card_vs_cpu(net, x, device)
    if not err <= 1e-4:
        fail(f"U-Net forward on the card differs from the CPU: max abs err {err:.3g} x "
             "max(1, max|out|)")
    rng = np.random.default_rng(1)
    centers = np.array([[0.0, 0.0], [8.0, 8.0], [0.0, 9.0]])
    X = np.concatenate([rng.normal(c, 0.6, size=(60, 2)) for c in centers]).astype(np.float32)
    cpu = mean_shift_fit_predict(X, 2.0, None, device="cpu")
    gpu = mean_shift_fit_predict(X, 2.0, None, device=device)
    if not np.array_equal(cpu, gpu):
        fail("mean shift labels on the card differ from the CPU")
    print(f"[check] U-Net forward card vs CPU max abs err {err:.3g} x max(1, max|out|); "
          f"mean-shift labels equal ({len(set(gpu.tolist()))} clusters)")

    # K1 defines no gradient and says so; the training path gives every conv
    # a gradient, the card's (K2 filter gradients) against the CPU's
    params = net.backbone.l_conv[0].pass_params()
    try:
        conv_pass_2d(x.to(device), params, torch.float32)
    except RuntimeError as e:
        if "inference-only" not in str(e):
            raise
    else:
        fail("conv_pass_2d ran under autograd with weights that require a gradient")
    if zero:
        fail(f"training path left these gradients zero on the card: {zero}")
    if not worst <= 1e-4:
        fail(f"U-Net gradients card vs CPU: max abs err / max|grad| {worst:.3g} (limit 1e-4)")
    print(f"[check] conv_pass_2d raises under autograd; training-path gradients of all "
          f"{n} tensors non-zero, card vs CPU max abs err / max|grad| {worst:.3g} "
          f"(limit 1e-4)")


def _infer_main(work, container, checkpoint, precision):
    """One run of the infer main path at ``precision``, with the kernel
    counts set to 0 just before it; returns its launches and stage seconds."""
    config = infer_config(container, checkpoint, MODEL, device="cuda:0", precision=precision)
    conv_pass_2d.launches = 0
    ball_stats.launches = 0
    mean_shift_fit.launches = 0
    stage_seconds = {}
    t0 = time.perf_counter()
    with contextlib.chdir(work):  # evaluate writes its results files to the working directory
        results = cellulus_tpu_torch.infer(config, stage_seconds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"conv_pass_2d": conv_pass_2d.launches, "mean_shift_fit": mean_shift_fit.launches,
                "ball_stats": ball_stats.launches}

    f = zarr.open(container, "r")
    emb = f["embeddings"][...]
    seg = f["segmentation"][...]
    if emb.shape != (2, 3, IMAGE_SIZE, IMAGE_SIZE) or not np.isfinite(emb).all():
        fail(f"{precision}: embeddings {emb.shape}, finite={np.isfinite(emb).all()}")
    if emb[:, 2].min() < 0:
        fail(f"{precision}: negative uncertainty channel")
    if seg.shape != (2, 1, IMAGE_SIZE, IMAGE_SIZE):
        fail(f"{precision}: segmentation shape {seg.shape}")
    instances = [int(len(np.unique(seg[s, 0])) - (seg[s, 0] == 0).any()) for s in range(2)]
    for s in range(2):
        ids = np.unique(seg[s, 0])
        ids = ids[ids > 0]
        if len(ids) and not np.array_equal(ids, np.arange(1, len(ids) + 1)):
            fail(f"{precision}: segmentation labels are not consecutive from 1")
    if results is None or not all(0.0 <= results[0][k] <= 1.0 for k in ("F1", "SEG")):
        fail(f"{precision}: evaluate results {results}")
    expected_k1 = 3 * math.ceil(9 / TILE_BATCH) * 2  # 3 passes per tile batch
    if launches["conv_pass_2d"] != expected_k1:
        fail(f"{precision}: conv_pass_2d launched {launches['conv_pass_2d']} times, "
             f"expected {expected_k1}")
    # one fit per (sample, bandwidth), the one-iteration kernel never
    if launches["mean_shift_fit"] != 2 or launches["ball_stats"] != 0:
        fail(f"{precision}: mean_shift_fit launched {launches['mean_shift_fit']} times (expected "
             f"2), ball_stats {launches['ball_stats']} (expected 0)")
    print(f"[main] {precision} stages (s): "
          f"{json.dumps({k: round(v, 3) for k, v in stage_seconds.items()})}, total {wall:.2f}s")
    print(f"[main] {precision} instances per sample {instances}, F1 {results[0]['F1']:.4f}, "
          f"SEG {results[0]['SEG']:.4f} (random weights), launches {json.dumps(launches)}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches, stage_seconds


def phase_main_path(work):
    """The infer main path with the default inference settings (float32),
    sample 0's detect in parts, then the main path again at
    examples/2d/infer.toml's ``precision = "bfloat16"``. Returns the launches
    of each run, by precision, and the fit kernel's timing on sample 0."""
    container = write_blob_container(os.path.join(work, "data.zarr"), 2, IMAGE_SIZE, seed=5)
    checkpoint = os.path.join(work, "weights.pth")
    save_random_checkpoint(checkpoint, seed=0, **MODEL)
    ic = infer_config(container, checkpoint, MODEL, device="cuda:0").inference_config
    if (ic.crop_size, ic.tile_batch_size, ic.num_infer_iterations, ic.p_salt_pepper,
            ic.precision) != ([CROP, CROP], TILE_BATCH, NUM_INFER_ITERATIONS, 0.01, "float32"):
        fail("the default inference settings differ from the ones this script assumes")
    launches, stage_seconds = _infer_main(work, container, checkpoint, "float32")
    launches = {"float32": launches}
    fit = phase_detect(container, torch.device("cuda:0"), stage_seconds["detect"])
    launches["bfloat16"] = _infer_main(work, container, checkpoint, "bfloat16")[0]
    return launches, fit


def train_config(container, model, object_size=OBJECT_SIZE, **train):
    return ExperimentConfig(**{
        "object_size": object_size,
        "model_config": dict(model),
        "train_config": {
            "train_data_config": {"container_path": str(container), "dataset_name": "raw"},
            "device": DEVICE,
            **train,
        },
    })


def _run_train(config, step_times=None):
    """``cellulus_tpu_torch.train`` with the K2 count set to 0 just before;
    returns ``(state, K2 launches)``."""
    conv3x3_dw.launches = 0
    conv_pass_2d.launches = 0
    state = cellulus_tpu_torch.train(config, step_times)
    torch.cuda.synchronize()
    if conv_pass_2d.launches:
        fail(f"the train step launched the inference-only K1 {conv_pass_2d.launches} times")
    losses = state["logger_data"]["loss"]
    if not losses or not np.isfinite(losses).all():
        fail(f"train losses {losses}")
    return state, conv3x3_dw.launches


def phase_train(work, k2_step_ms):
    """The train main path at the full width of examples/2d/train.toml:
    bf16 (as the TOML sets it), then float32, a resume, then infer on the
    trained checkpoint."""
    container = os.path.join(work, "data.zarr")
    iters, f32_iters = 20, 3
    # cadences only at the first and the last step, so the loss fetches in
    # between time the steady state (each waits for the step before it)
    common = dict(crop_size=[CROP, CROP], batch_size=TRAIN_BATCH, elastic_deform=True,
                  save_best_model_every=10**6, save_model_every=10**6,
                  save_snapshot_every=10**6)
    # train writes models/, loss.csv and snapshots.zarr to the working directory
    with contextlib.chdir(work), logged(os.path.join(work, "train.log")):
        config = train_config(container, MODEL, precision="bfloat16", max_iterations=iters,
                              **common)
        tc = config.train_config
        if (tc.device_pair_sampling, tc.loss_mode, tc.steps_per_dispatch, tc.density,
                tc.kappa) != (True, "pairs", 1, 0.1, 10.0):
            fail("the default train settings differ from the ones this script assumes")
        step_times = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, launches = _run_train(config, step_times)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        if launches != 6 * iters:
            fail(f"conv3x3_dw launched {launches} times in {iters} steps, expected {6 * iters}")
        ckpts = sorted(p for p in os.listdir("models") if p.endswith(".pth"))
        if "best_loss.pth" not in ckpts or f"{iters - 1:06d}.pth" not in ckpts:
            fail(f"checkpoints after training: {ckpts}")
        step_ms = 1e3 * float(np.median(np.diff(step_times[1:-1])))
        bf16_losses = state["logger_data"]["loss"]

        resume = train_config(container, MODEL, precision="bfloat16", max_iterations=iters + 1,
                              **common)
        resume.model_config.checkpoint = os.path.join("models", f"{iters - 1:06d}.pth")
        resumed, resume_launches = _run_train(resume)
        if resumed["iteration"] != iters or len(resumed["logger_data"]["loss"]) != iters + 1:
            fail(f"resume ran to iteration {resumed['iteration']}")

        f32 = train_config(container, MODEL, max_iterations=f32_iters, **common)
        f32_times = []
        f32_state, f32_launches = _run_train(f32, f32_times)
        if f32_launches != 6 * f32_iters:
            fail(f"float32: conv3x3_dw launched {f32_launches} times in {f32_iters} steps")
        f32_ms = 1e3 * (f32_times[-1] - f32_times[0]) / (f32_iters - 1)

        results = cellulus_tpu_torch.infer(infer_config(
            container, os.path.join("models", f"{iters:06d}.pth"), MODEL, device=DEVICE))
    if results is None or not all(0.0 <= results[0][k] <= 1.0 for k in ("F1", "SEG")):
        fail(f"infer on the trained checkpoint: results {results}")
    print(f"[train] bf16 {iters} steps in {wall:.2f}s (build and data start included), "
          f"median step {step_ms:.1f} ms (steady steps, the first excluded), K2 {k2_step_ms:.2f} ms a step "
          f"= {100 * k2_step_ms / step_ms:.0f}% (K2 times of the [K2] phase), peak memory "
          f"{peak:.2f} GiB; K2 launches {launches} = 6 x {iters}")
    print(f"[train] bf16 losses first/last {bf16_losses[0]:.1f} / {bf16_losses[-1]:.1f}; resume "
          f"ran iteration {resumed['iteration']} ({resume_launches} K2 launches); float32 "
          f"{f32_iters} steps, mean of steps 1-{f32_iters - 1} {f32_ms:.1f} ms, losses "
          f"{[round(v, 1) for v in f32_state['logger_data']['loss']]}")
    print(f"[train] infer on the resumed bf16 checkpoint: F1 {results[0]['F1']:.4f}, "
          f"SEG {results[0]['SEG']:.4f} (after {iters + 1} steps)")
    return launches, f32_launches


def phase_learn(work):
    """A small recipe (the sizes of tests/test_quality_gate.py, pair loss)
    trains on the card. It must learn: ``best_loss.pth`` (the lowest mean
    loss over a 50-step window) comes from after step 0, and infer on it
    scores a higher F1 than infer on the step-0 checkpoint.

    The learning rate is 1e-4, not the gate's 1e-3: with pair loss and Adam
    the embeddings of this recipe run away at 1e-3 and 3e-4 (the loss
    doubles within 100-200 steps, gradient clipping does not stop it, and
    the JAX package's own grid-loss gate run does the same late in its 400
    steps), which makes the run chaotic from one machine to the next. At
    1e-4 the loss falls for most of the run; its end may still rise, so the
    loss curve is printed, not gated."""
    size, iters = 128, 400
    learn = os.path.join(work, "learn")
    os.makedirs(learn)
    # the data of tests/test_quality_gate.py: 12 disks of radius 0.04-0.09 x size
    container = write_blob_container(os.path.join(learn, "data.zarr"), 2, size, seed=11,
                                     dtype=np.uint8, num_blobs=12, radius=(0.04, 0.09))
    model = dict(num_fmaps=16, fmap_inc_factor=2, features_in_last_layer=24,
                 downsampling_factors=[[2, 2]])
    config = train_config(
        container, model, batch_size=4, kappa=5.0, density=0.2, crop_size=[76, 76],
        max_iterations=iters, initial_learning_rate=1e-4, num_workers=0,
        elastic_deform=False, save_model_every=iters - 1, save_snapshot_every=10**9,
        save_best_model_every=50)
    config.object_size = int(size * 0.13)
    with contextlib.chdir(learn), logged(os.path.join(learn, "train.log")):
        t0 = time.perf_counter()
        state, _ = _run_train(config)
        train_s = time.perf_counter() - t0
        results = {}
        for name in ("000000.pth", "best_loss.pth"):
            ic = infer_config(container, os.path.join("models", name), model,
                              device=DEVICE, crop_size=[76, 76], tile_batch_size=4)
            ic.object_size = config.object_size
            results[name] = cellulus_tpu_torch.infer(ic)[0]
        best_iteration = torch.load(os.path.join("models", "best_loss.pth"),
                                    weights_only=True)["iteration"]
    windows = np.asarray(state["logger_data"]["loss"]).reshape(-1, 50).mean(axis=1)
    f1_start, f1 = results["000000.pth"]["F1"], results["best_loss.pth"]["F1"]
    if not (best_iteration > 0 and f1 > f1_start):
        fail(f"learn: did not learn (50-step mean losses {windows.round(1).tolist()}, "
             f"best_loss.pth from iteration {best_iteration}, F1 {f1:.4f} vs {f1_start:.4f} "
             "at step 0)")
    print(f"[learn] {iters} steps in {train_s:.1f}s; 50-step mean losses "
          f"{windows.round(1).tolist()}; best_loss.pth (iteration {best_iteration}): "
          f"F1 {f1:.4f}, SEG {results['best_loss.pth']['SEG']:.4f}; step-0 checkpoint: "
          f"F1 {f1_start:.4f}, SEG {results['000000.pth']['SEG']:.4f}")


def phase_wide_main(work):
    """The model of examples/real-data/infer.toml (256 fmaps, factor 3) with
    its inference settings (bf16, crop 252, tile batch 4) through
    ``cellulus_tpu_torch.infer`` on one synthetic 512^2 sample, seeded
    weights, ``pipelined`` off (pipelined inference is not ported): K1 runs
    every pass, the bottom one (256 -> 768) by its staged route. Returns the
    launches."""
    wide = os.path.join(work, "wide")
    os.makedirs(wide)
    container = write_blob_container(os.path.join(wide, "data.zarr"), 1, IMAGE_SIZE, seed=15)
    checkpoint = os.path.join(wide, "weights.pth")
    save_random_checkpoint(checkpoint, seed=16, **MODEL_WIDE)
    config = ExperimentConfig.from_toml(os.path.join(REPO, "examples", "real-data", "infer.toml"))
    mc, ic = config.model_config, config.inference_config
    if ({k: getattr(mc, k) for k in MODEL_WIDE} != MODEL_WIDE or ic.precision != "bfloat16"
            or ic.crop_size != [CROP, CROP] or ic.tile_batch_size != TILE_BATCH):
        fail("examples/real-data/infer.toml differs from the settings this script assumes")
    mc.checkpoint = checkpoint
    ic.pipelined = False
    ic.device = DEVICE
    for dc, name in ((ic.dataset_config, "raw"), (ic.prediction_dataset_config, "embeddings"),
                     (ic.detection_dataset_config, "detection"),
                     (ic.segmentation_dataset_config, "segmentation")):
        dc.container_path, dc.dataset_name = container, name
    conv_pass_2d.launches = mean_shift_fit.launches = 0
    torch.cuda.reset_peak_memory_stats()
    stage_seconds = {}
    t0 = time.perf_counter()
    with contextlib.chdir(wide), logged(os.path.join(wide, "infer.log")):
        cellulus_tpu_torch.infer(config, stage_seconds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"conv_pass_2d": conv_pass_2d.launches, "mean_shift_fit": mean_shift_fit.launches}
    f = zarr.open(container, "r")
    emb, seg = f["embeddings"][...], f["segmentation"][...]
    if emb.shape != (1, 3, IMAGE_SIZE, IMAGE_SIZE) or not np.isfinite(emb).all():
        fail(f"[wide-main]: embeddings {emb.shape}, finite={np.isfinite(emb).all()}")
    if seg.shape != (1, 1, IMAGE_SIZE, IMAGE_SIZE):
        fail(f"[wide-main]: segmentation shape {seg.shape}")
    out_tile = compute_geometry((CROP, CROP), MODEL_WIDE["downsampling_factors"]).output_size
    tiles = math.prod(len(tile_origins(max(IMAGE_SIZE, o), o)) for o in out_tile)
    expected = 3 * math.ceil(tiles / TILE_BATCH)  # 3 passes per tile batch
    if launches != {"conv_pass_2d": expected, "mean_shift_fit": 1}:
        fail(f"[wide-main]: launches {launches}, expected {expected} K1 and 1 fit")
    plans = [f"{name} {conv_pass.conv_pass_2d_plan(shape, c, torch.bfloat16)}"
             for name, shape, c in pass_shapes(TILE_BATCH * 2 * NUM_INFER_ITERATIONS, MODEL_WIDE)]
    print(f"[wide-main] examples/real-data/infer.toml's model and settings (bf16, pipelined "
          f"off) on 1 x {IMAGE_SIZE}^2: stages (s) "
          f"{json.dumps({k: round(v, 3) for k, v in stage_seconds.items()})}, total {wall:.2f}s; "
          f"K1 plans {plans}; launches {json.dumps(launches)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
          f"{int(len(np.unique(seg)) - 1)} instances", flush=True)
    return launches


# -- the detect variants ---------------------------------------------------------------

VARIANTS = {
    "meanshift": {},  # the host path, the yardstick of device detect
    "greedy": dict(clustering="greedy"),
    "seeds": dict(use_seeds=True),
    "sweep": dict(vectorized_bandwidth_sweep=True, num_bandwidths=2),
    "device_detect": dict(device_detect=True),
}
# the fit input each mean-shift variant prepares (device detect: the host
# path's)
_FIT_KIND = {"meanshift": "meanshift", "seeds": "seeds", "sweep": "sweep",
             "device_detect": "meanshift"}
# a fit of the card and one of the CPU may part ways at this share of the
# seeds at most, each at a seed whose trajectory meets a point within
# rounding of a ball's boundary
MAX_PARTED_SHARE = 0.02


def _explain_fit(mine, theirs, fit_input, ic, device):
    """Card against CPU detections of one mean-shift fit input: the seeds
    whose ends part ways (the kernel's against the plain version's), each
    of which must meet a point within rounding of a ball's boundary on its
    trajectory, and every disagreeing pixel explained by those or by
    predict rounding. Returns the parted seeds."""
    mask, X, X_fit, seeds, bandwidth = fit_input
    bw2, stop = msops.fit_thresholds(bandwidth)
    max_iter = ic.mean_shift_max_iterations
    card = _fit_problem(X_fit, seeds, bandwidth, device)
    ends_card, n_card, _, _ = mean_shift_fit(*card, max_iter)
    cpu = _fit_problem(X_fit, seeds, bandwidth, "cpu")
    trajectory = []

    def recorded(c, p, b):
        trajectory.append(c.clone())
        return ball_stats_plain(c, p, b)

    ends_cpu, n_cpu, _, _ = mean_shift_fit_plain(*cpu, max_iter, recorded)
    parted = np.flatnonzero((ends_card.cpu() - ends_cpu).norm(dim=1).numpy() > 1e-3)
    for i in parted:
        if not any(bool(near_boundary(c[i:i + 1], cpu[1], bw2)[0]) for c in trajectory):
            fail(f"[variants] seed {i} parts ways between card and CPU with no point within "
                 "rounding of a ball's boundary on its trajectory")
    if len(parted) > MAX_PARTED_SHARE * len(seeds):
        fail(f"[variants] {len(parted)} of {len(seeds)} seeds part ways between card and CPU")
    bad, _, _ = unexplained_mean_shift(
        mine, theirs, mask, X, msops._dedupe(ends_card, n_card, bw2).cpu().numpy(),
        msops._dedupe(ends_cpu, n_cpu, bw2).numpy(), bw2)
    if bad:
        fail(f"[variants] {len(bad)} pixels differ between card and CPU beyond rounding")
    return len(parted)


def phase_variants(container, device):
    """Each 2D detect variant (greedy, seeded mean shift, the bandwidth
    sweep over 2 bandwidths, device detect, and the default host path as
    device detect's yardstick) on the [main] bf16 run's embeddings, sample by sample on the card and on the CPU. The card's
    detections must be the CPU's partition, or differ only where rounding
    explains it: for mean shift, fit seeds that part ways at a point within
    rounding of a ball's boundary (``near_boundary``) and predict rounding;
    for greedy, pixels whose affinity to a seed lies within rounding of 0.5.
    Returns per variant the fit launches and sample 0's first fit input."""
    f = zarr.open(container, "r")
    embs = [np.asarray(f["embeddings"][s], dtype=np.float32) for s in range(2)]
    out = {}
    for variant, settings in VARIANTS.items():
        ic = infer_config(container, "unused.pth", MODEL, device=DEVICE, **settings).inference_config
        ic.bandwidth = 0.5 * OBJECT_SIZE
        ic.min_size = int(0.1 * np.pi * (OBJECT_SIZE**2) / 4)
        mean_shift_fit.launches = 0
        seconds, results, stats = [], [], []
        for s in range(2):
            stat = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results.append(detect_sample(embs[s], ic, 2, sample_rng(ic.seed, s), device, stat))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            stats.append(stat)
        launches = mean_shift_fit.launches
        parted, differing, same = 0, 0, 0
        for s in range(2):
            cpu_stat = {}
            cpu = detect_sample(embs[s], ic, 2, sample_rng(ic.seed, s), "cpu", cpu_stat)
            if cpu[0] != results[s][0] or not np.array_equal(cpu[1], results[s][1]):
                fail(f"[variants] {variant} sample {s}: threshold {results[s][0]} on the card, "
                     f"{cpu[0]} on the CPU, or their masks differ")
            fits = None
            for k in range(ic.num_bandwidths):
                mine, theirs = results[s][3][k], cpu[3][k]
                if _same_partition(mine.ravel(), theirs.ravel()):
                    same += 1
                    continue
                differing += 1
                if variant == "greedy":
                    emb = msops.add_coordinate_grid(embs[s][:2]).reshape(2, -1).T
                    bad = unexplained_greedy(mine, theirs, emb, stats[s]["greedy"][k]["seeds"],
                                             cpu_stat["greedy"][k]["seeds"], ic.bandwidth / 2**k)
                    if bad:
                        fail(f"[variants] greedy sample {s}: {len(bad)} pixels differ between "
                             "card and CPU beyond rounding")
                    continue
                fits = fits or mean_shift_fit_inputs(_FIT_KIND[variant], embs[s], ic, s)
                parted += _explain_fit(mine, theirs, fits[k], ic, device)
        expected = {"meanshift": 2, "greedy": 0, "seeds": 2, "sweep": 4,
                    "device_detect": 2}[variant]
        if launches != expected:
            fail(f"[variants] {variant}: the fit kernel launched {launches} times, expected "
                 f"{expected}")
        extra = ""
        if variant == "greedy":
            g = [st["greedy"][0] for st in stats]
            if any(x["iterations"] > 64 and x["host_syncs"] >= x["iterations"] for x in g):
                fail(f"[variants] greedy synced with the host once an iteration or more: {g}")
            extra = "; greedy " + ", ".join(
                f"{x['iterations']} iterations, {x['host_syncs']} host syncs, "
                f"{x['instances']} instances" for x in g)
        print(f"[variants] {variant}: {', '.join(f'{t:.3f}' for t in seconds)} s a sample on the "
              f"card; fit launches {launches}; card vs CPU: {same} (sample, bandwidth) the same "
              f"partition, {differing} differing only where rounding explains it ({parted} fit "
              f"seeds parted at a ball's boundary){extra}", flush=True)
        fit0 = None
        if variant != "greedy":
            fit0 = mean_shift_fit_inputs(_FIT_KIND[variant], embs[0], ic, 0)[0]
        out[variant] = {"launches": launches, "fit_input": fit0, "ic": ic}
    return out


# -- the 3D main path ----------------------------------------------------------------


def phase_3d_checks(device):
    """The full-width 3D U-Net, and transposed-conv upsampling
    (``constant_upsample=False``) in 3D and in 2D, on the card against the
    CPU: forward, and every gradient of the training path. A weight's
    gradient sums over every output voxel of a batch (77,000 at this input)
    in float32 in other orders on the two (cuDNN with TF32 off, and the
    CPU's), so the limit is 5e-4 x max|grad| of each tensor (9.1e-5 at the
    worst tensor in a first run)."""
    gen = torch.Generator().manual_seed(12)
    x3 = torch.rand((2, 20, 44, 44, 1), generator=gen)
    x2 = torch.rand((2, 92, 92, 1), generator=gen)
    for name, net, x in (
        ("3D", random_unet(3, num_spatial_dims=3, **MODEL_3D), x3),
        ("3D transposed-conv", random_unet(4, num_spatial_dims=3, constant_upsample=False,
                                           **MODEL_3D), x3),
        ("2D transposed-conv", random_unet(5, constant_upsample=False, **MODEL), x2),
    ):
        forward_err, (worst, worst_name), zero, n = _card_vs_cpu(net, x, device)
        if not forward_err <= 1e-4:
            fail(f"{name} U-Net forward on the card differs from the CPU: max abs err "
                 f"{forward_err:.3g} x max(1, max|out|)")
        if zero:
            fail(f"{name} U-Net: training path left these gradients zero on the card: {zero}")
        if not worst <= 5e-4:
            fail(f"{name} U-Net gradients card vs CPU: max abs err / max|grad| {worst:.3g} "
                 f"at {worst_name} (limit 5e-4)")
        print(f"[3d-check] {name} U-Net at full width, input {tuple(x.shape)}: forward card "
              f"vs CPU max abs err {forward_err:.3g} x max(1, max|out|) (limit 1e-4); "
              f"training-path gradients of all {n} tensors non-zero, card vs CPU max abs err "
              f"/ max|grad| {worst:.3g} at {worst_name} (limit 5e-4)", flush=True)


def _train_3d_config(container, max_iterations, checkpoint=None):
    """examples/3d/train.toml, on ``container``, on the card, with cadences
    only at the first and the last step."""
    config = ExperimentConfig.from_toml(os.path.join(REPO, "examples", "3d", "train.toml"))
    tc = config.train_config
    tc.train_data_config.container_path = str(container)
    tc.train_data_config.dataset_name = "raw"
    tc.device = DEVICE
    tc.max_iterations = max_iterations
    tc.save_best_model_every = tc.save_model_every = tc.save_snapshot_every = 10**6
    config.model_config.checkpoint = checkpoint
    return config


def phase_train_3d(work):
    """The 3D train main path: examples/3d/train.toml's settings on a
    synthetic 2 x 128^3 uint16 blob container (examples/3d/01-data.py's
    sizes) for TRAIN_STEPS_3D bf16 steps, then a 1-step resume. Returns the
    container and the resumed checkpoint."""
    train_dir = os.path.join(work, "train3d")
    os.makedirs(train_dir)
    container = write_blob_container(os.path.join(train_dir, "data.zarr"), 2, VOLUME_SIZE,
                                     seed=42, ndim=3, num_blobs=12, radius=(0.04, 0.09))
    steps = TRAIN_STEPS_3D
    config = _train_3d_config(container, steps)
    tc, mc = config.train_config, config.model_config
    if ((tc.crop_size, tc.batch_size, tc.precision, tc.kappa, tc.density, tc.pair_count_mode,
         tc.elastic_deform, tc.loss_mode, tc.device_pair_sampling, config.object_size)
            != (CROP_3D, 2, "bfloat16", 6.0, 0.05, "all_dims", False, "pairs", True,
                OBJECT_SIZE_3D)
            or {k: getattr(mc, k) for k in MODEL_3D} != MODEL_3D):
        fail("examples/3d/train.toml differs from the settings this script assumes")
    with contextlib.chdir(train_dir), logged(os.path.join(train_dir, "train.log")):
        step_times = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, k2_launches = _run_train(config, step_times)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        resumed, _ = _run_train(_train_3d_config(
            container, steps + 1, os.path.join("models", f"{steps - 1:06d}.pth")))
    if k2_launches:
        fail(f"3D training launched the 2D filter-gradient kernel {k2_launches} times")
    losses = np.asarray(state["logger_data"]["loss"])
    if len(losses) != steps or not losses.max() < 3 * losses[0]:
        fail(f"3D training diverged: {len(losses)} losses, first {losses[0]:.4g}, max "
             f"{losses.max():.4g} (limit 3 x the first)")
    if resumed["iteration"] != steps or len(resumed["logger_data"]["loss"]) != steps + 1:
        fail(f"3D resume ran to iteration {resumed['iteration']}")
    step_ms = 1e3 * float(np.median(np.diff(step_times[1:-1])))
    print(f"[3d-train] examples/3d/train.toml (bf16, batch 2, crop {tc.crop_size}, all_dims "
          f"pairs on the card) on 2 x {VOLUME_SIZE}^3: {steps} steps in {wall:.2f}s (build and "
          f"data start included), median step {step_ms:.2f} ms (steady steps, the first "
          f"excluded), peak memory {peak:.2f} GiB; no K1 or K2 launch (3D convs are library "
          "convolutions)")
    print(f"[3d-train] losses first/last {losses[0]:.4f} / {losses[-1]:.4f}, max "
          f"{losses.max():.4f} < 3 x first, all finite; resume ran iteration "
          f"{resumed['iteration']} (loss {resumed['logger_data']['loss'][-1]:.4f})", flush=True)
    return container, os.path.join(train_dir, "models", f"{steps:06d}.pth")


def _segment_parts(container, ic, device):
    """Sample 0's segment in parts: halo removal on the card (two 3D
    convolutions), then the host connected components, size filter and
    relabel, in ms."""
    det = np.asarray(zarr.open(container, "r")["detection"][0, 0])
    torch.cuda.synchronize()
    t = [time.perf_counter()]
    seg = torch.from_numpy(det.astype(np.int32)).to(device)
    halo = halo_removal(seg, float(ic.grow_distance), float(ic.shrink_distance)).cpu().numpy()
    t.append(time.perf_counter())
    filter_relabel(halo, ic.min_size)
    t.append(time.perf_counter())
    return 1e3 * (t[1] - t[0]), 1e3 * (t[2] - t[1])


def _infer_main_3d(work, container, checkpoint, precision):
    """One run of the 3D infer main path at ``precision``, with every
    kernel count set to 0 just before it; returns its launches."""
    config = infer_config(container, checkpoint, MODEL_3D, object_size=OBJECT_SIZE_3D,
                          device=DEVICE, crop_size=CROP_3D, precision=precision)
    conv_pass_2d.launches = conv3x3_dw.launches = 0
    ball_stats.launches = mean_shift_fit.launches = 0
    torch.cuda.reset_peak_memory_stats()
    stage_seconds = {}
    t0 = time.perf_counter()
    with contextlib.chdir(work):
        results = cellulus_tpu_torch.infer(config, stage_seconds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"conv_pass_2d": conv_pass_2d.launches, "conv3x3_dw": conv3x3_dw.launches,
                "mean_shift_fit": mean_shift_fit.launches, "ball_stats": ball_stats.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30

    f = zarr.open(container, "r")
    emb = f["embeddings"][...]
    seg = f["segmentation"][...]
    spatial = (VOLUME_SIZE,) * 3
    if emb.shape != (2, 4, *spatial) or not np.isfinite(emb).all() or emb[:, 3].min() < 0:
        fail(f"3D {precision}: embeddings {emb.shape}, finite={np.isfinite(emb).all()}")
    if seg.shape != (2, 1, *spatial):
        fail(f"3D {precision}: segmentation shape {seg.shape}")
    instances = []
    for s in range(2):
        ids = np.unique(seg[s, 0])
        ids = ids[ids > 0]
        if len(ids) and not np.array_equal(ids, np.arange(1, len(ids) + 1)):
            fail(f"3D {precision}: segmentation labels are not consecutive from 1")
        instances.append(len(ids))
    if results is None or not all(0.0 <= results[0][k] <= 1.0 for k in ("F1", "SEG")):
        fail(f"3D {precision}: evaluate results {results}")
    # one fit per (sample, bandwidth), no 2D kernel, the one-iteration kernel never
    if launches != {"conv_pass_2d": 0, "conv3x3_dw": 0, "mean_shift_fit": 2, "ball_stats": 0}:
        fail(f"3D {precision}: launches {launches}, expected 2 mean_shift_fit and no other")
    g = compute_geometry(CROP_3D, MODEL_3D["downsampling_factors"])
    tiles = math.prod(math.ceil(VOLUME_SIZE / o) for o in g.output_size)
    print(f"[3d-main] {precision} stages (s): "
          f"{json.dumps({k: round(v, 3) for k, v in stage_seconds.items()})}, total {wall:.2f}s; "
          f"{tiles} tiles of {CROP_3D} (output {list(g.output_size)}) a sample, "
          f"{math.ceil(tiles / TILE_BATCH)} forwards of {TILE_BATCH} x "
          f"{2 * NUM_INFER_ITERATIONS} volumes; peak memory {peak:.1f} GiB")
    print(f"[3d-main] {precision} instances per sample {instances}, F1 {results[0]['F1']:.4f}, "
          f"SEG {results[0]['SEG']:.4f} (after {TRAIN_STEPS_3D + 1} steps; no bar), launches "
          f"{json.dumps(launches)}", flush=True)
    return launches, config.inference_config


def phase_detect_3d(container, ic, device):
    """Sample 0's 3D detect in parts (median of 3), labels on a small 3D
    fixture against the plain version, the fit kernel at d = 3 on a long
    fit at the JAX package's 3D bench scale (~10k bin seeds), then timed on
    sample 0's fit input (``[K3-fit]``)."""
    median, _, X, X_fit, seeds_np, kept, problem = _detect_in_parts(container, ic, 3, device, 3)
    seeds, points, _, _ = problem
    plan = mean_shift_fit_plan(seeds.shape[0], points.x.shape[0], 3)
    print(f"[3d-detect] sample 0 in parts, median of 3 (ms): "
          f"{json.dumps({k: round(v, 3) for k, v in median.items()})}, sum "
          f"{sum(median.values()):.2f} ms; {len(X)} foreground voxels, N = {len(X_fit)} fitted, "
          f"S = {len(seeds_np)} bin seeds, {len(kept)} clusters; fit plan (seeds a group, "
          f"clusters, resident points a block, shared bytes) {plan}", flush=True)

    rng = np.random.default_rng(13)
    Xc = np.concatenate([rng.normal(c, 0.8, size=(200, 3)) for c in
                         rng.uniform(0, 40, size=(5, 3))]).astype(np.float32)
    mean_shift_fit.launches = 0
    gpu = mean_shift_fit_predict(Xc, 3.0, None, device=device)
    launches = mean_shift_fit.launches
    cpu = mean_shift_fit_predict(Xc, 3.0, None, device="cpu")
    if launches != 1 or not _same_partition(gpu, cpu):
        fail(f"mean_shift_fit 3D few clusters: labels differ from the plain version's "
             f"({launches} launches)")
    print(f"[K3-fit] 3D, few clusters: labels equal the plain version's as a partition "
          f"({len(set(gpu.tolist()) - {-1})} clusters, ids equal: {np.array_equal(gpu, cpu)})")

    # a long 3D fit: LONG_FIT_POINTS_3D uniform points in a VOLUME_SIZE^3
    # volume at bw = 0.5 x OBJECT_SIZE_3D, so bin seeds fill the volume
    X = np.random.default_rng(14).uniform(0, VOLUME_SIZE, (LONG_FIT_POINTS_3D, 3))
    X = X.astype(np.float32)
    time_fit("3D long fit", *_fit_problem(X, msops.bin_seeds(X, ic.bandwidth), ic.bandwidth,
                                          device), ic.mean_shift_max_iterations)
    return time_fit("3D main input (sample 0), d = 3", *problem, ic.mean_shift_max_iterations)


def phase_main_3d(work, container, checkpoint):
    """The 3D infer main path on the [3d-train] checkpoint in float32 (the
    default) and bfloat16 (examples/3d/infer.toml's precision), with the
    default mean-shift clustering; sample 0's detect and segment in parts
    and the fit kernel at d = 3 after the float32 run. Returns the launches
    of each run, by precision, and the fit's timing."""
    launches, ic = _infer_main_3d(work, container, checkpoint, "float32")
    launches = {"float32": launches}
    halo_ms, cc_ms = _segment_parts(container, ic, torch.device(DEVICE))
    print(f"[3d-main] segment, sample 0 in parts: halo removal on the card (grow "
          f"{ic.grow_distance}, shrink {ic.shrink_distance}) {halo_ms:.1f} ms with the "
          f"transfers, host connected components + "
          f"size filter (min_size {ic.min_size}) + relabel on {VOLUME_SIZE}^3 {cc_ms:.1f} ms",
          flush=True)
    fit = phase_detect_3d(container, ic, torch.device(DEVICE))
    launches["bfloat16"] = _infer_main_3d(work, container, checkpoint, "bfloat16")[0]
    return launches, fit


def phase_3d_greedy(work, container, checkpoint):
    """examples/3d/infer.toml as it is (greedy clustering, bf16) on the
    [3d-main] bf16 run's embeddings: detect, segment and evaluate through
    ``cellulus_tpu_torch.infer``; greedy's iterations, host syncs,
    instances and seconds a sample; then greedy on a 48^3 crop of sample 0,
    the card against the CPU."""
    config = ExperimentConfig.from_toml(os.path.join(REPO, "examples", "3d", "infer.toml"))
    ic = config.inference_config
    if ic.clustering != "greedy" or config.object_size != OBJECT_SIZE_3D:
        fail("examples/3d/infer.toml differs from the settings this script assumes")
    out = os.path.join(work, "greedy3d.zarr")
    src = zarr.open(container, "r")
    dst = zarr.open(out, "a")
    for name in ("embeddings", "groundtruth"):
        dst[name] = src[name][...]
        dst[name].attrs.update(src[name].attrs.asdict())
    config.model_config.checkpoint = checkpoint
    ic.device = DEVICE
    ic.dataset_config.container_path, ic.dataset_config.dataset_name = container, "raw"
    ic.prediction_dataset_config = None
    for dc in (ic.detection_dataset_config, ic.segmentation_dataset_config,
               ic.evaluation_dataset_config):
        dc.container_path = out
    stage_seconds = {}
    mean_shift_fit.launches = 0
    with contextlib.chdir(work), logged(os.path.join(work, "greedy3d.log")):
        results = cellulus_tpu_torch.infer(config, stage_seconds)
    if results is None or not all(0.0 <= results[0][k] <= 1.0 for k in ("F1", "SEG")):
        fail(f"[3d-greedy] evaluate results {results}")
    if mean_shift_fit.launches:
        fail(f"[3d-greedy] greedy clustering launched the fit kernel {mean_shift_fit.launches} "
             "times")
    seg = zarr.open(out, "r")["segmentation"][...]
    instances = [int(len(np.unique(seg[s, 0])) - 1) for s in range(2)]
    per_sample = []
    for s in range(2):
        emb = np.asarray(src["embeddings"][s], dtype=np.float32)
        stat = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        detect_sample(emb, ic, 3, sample_rng(ic.seed, s), DEVICE, stat)
        torch.cuda.synchronize()
        g = stat["greedy"][0]
        if g["iterations"] > 64 and g["host_syncs"] >= g["iterations"]:
            fail(f"[3d-greedy] greedy synced with the host once an iteration or more: {g}")
        per_sample.append(f"{time.perf_counter() - t0:.3f} s, {g['iterations']} iterations, "
                          f"{g['host_syncs']} host syncs, {g['instances']} instances")
    print(f"[3d-greedy] examples/3d/infer.toml (greedy, bf16) on the [3d-main] bf16 embeddings: "
          f"stages (s) {json.dumps({k: round(v, 3) for k, v in stage_seconds.items()})}; "
          f"instances per sample {instances}, F1 {results[0]['F1']:.4f}, SEG "
          f"{results[0]['SEG']:.4f}; detect_sample on the card per sample: "
          f"{'; '.join(per_sample)}", flush=True)

    crop = np.asarray(src["embeddings"][0, :, :48, :48, :48], dtype=np.float32)
    mask = crop[-1] < threshold_otsu(crop[-1])
    got, ref = {}, {}
    card = greedy_cluster(crop, mask, ic.bandwidth, ic.min_size, device=DEVICE, stats=got)
    cpu = greedy_cluster(crop, mask, ic.bandwidth, ic.min_size, device="cpu", stats=ref)
    same = _same_partition(card.ravel(), cpu.ravel())
    if not same:
        emb = msops.add_coordinate_grid(crop[:3]).reshape(3, -1).T
        bad = unexplained_greedy(card, cpu, emb, got["seeds"], ref["seeds"], ic.bandwidth)
        if bad:
            fail(f"[3d-greedy] 48^3 crop: {len(bad)} voxels differ between card and CPU beyond "
                 "rounding")
    print(f"[3d-greedy] 48^3 crop of sample 0 (bw {ic.bandwidth}, min size {ic.min_size}): card "
          f"and CPU {'the same partition' if same else 'differ only where rounding explains'} "
          f"({got['instances']} and {ref['instances']} instances, {got['iterations']} and "
          f"{ref['iterations']} iterations)", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    phase_card()
    phase_build()
    k1 = phase_conv_pass(device)
    phase_k1_plans()
    k1_wide = phase_conv_pass(device, MODEL_WIDE, K1_WIDE_BATCH, "K1-wide")
    k2 = phase_conv_dw(device)
    k3 = phase_ball_stats(device)
    phase_fit(device)
    with tempfile.TemporaryDirectory() as work:
        phase_reference_checks(work, device)
        torch.cuda.reset_peak_memory_stats()
        infer_launches, k3_fit = phase_main_path(work)
        variants = phase_variants(os.path.join(work, "data.zarr"), device)
        variant_fits = {
            v: time_fit(f"{v} input (sample 0, bf16 embeddings)",
                        *_fit_problem(*r["fit_input"][2:], device),
                        r["ic"].mean_shift_max_iterations)
            for v, r in variants.items() if r["fit_input"] is not None and v != "meanshift"}
        wide_launches = phase_wide_main(work)
        k2_bf16, k2_f32 = phase_train(work, k2[torch.bfloat16]["ms"])
        phase_learn(work)
        phase_3d_checks(device)
        container_3d, checkpoint_3d = phase_train_3d(work)
        infer_3d_launches, k3_fit_3d = phase_main_3d(work, container_3d, checkpoint_3d)
        phase_3d_greedy(work, container_3d, checkpoint_3d)
    k1_launches = {torch.float32: infer_launches["float32"]["conv_pass_2d"],
                   torch.bfloat16: infer_launches["bfloat16"]["conv_pass_2d"]}
    k2_launches = {torch.bfloat16: k2_bf16, torch.float32: k2_f32}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        rows.append({"name": "conv_pass_2d", "dtype": str(dtype).removeprefix("torch."),
                     "route": "cuda", "source": "cellulus_tpu_torch/csrc/conv_pass.cu",
                     "replaces": "cellulus_tpu/ops/pallas_conv.py:55",
                     "launches": k1_launches[dtype], **k1[dtype]})
    for dtype in (torch.float32, torch.bfloat16):
        # the 256-fmap model: [wide-main] runs it in bfloat16 only
        rows.append({"name": "conv_pass_2d", "dtype": str(dtype).removeprefix("torch."),
                     "model": "examples/real-data (256 fmaps)", "route": "cuda",
                     "source": "cellulus_tpu_torch/csrc/conv_pass.cu",
                     "replaces": "cellulus_tpu/ops/pallas_conv.py:55",
                     "launches": wide_launches["conv_pass_2d"] if dtype == torch.bfloat16 else 0,
                     **k1_wide[dtype]})
    for dtype in (torch.bfloat16, torch.float32):
        rows.append({"name": "conv3x3_dw", "dtype": str(dtype).removeprefix("torch."),
                     "route": "cuda", "source": "cellulus_tpu_torch/csrc/conv_dw.cu",
                     "replaces": "cellulus_tpu/ops/pallas_dw.py:64",
                     "launches": k2_launches[dtype], **k2[dtype]})
    rows.append({"name": "ball_stats", "route": "cuda",
                 "source": "cellulus_tpu_torch/csrc/ball_stats.cu",
                 "replaces": "cellulus_tpu/ops/pallas_mean_shift.py:39",
                 "launches": infer_launches["float32"]["ball_stats"], **k3})
    for d, fit, launches in ((2, k3_fit, infer_launches), (3, k3_fit_3d, infer_3d_launches)):
        fit.pop("out")
        rows.append({"name": "mean_shift_fit", "d": d, "route": "cuda",
                     "source": "cellulus_tpu_torch/csrc/ball_stats.cu",
                     "replaces": "cellulus_tpu/ops/pallas_mean_shift.py:39",
                     "launches": launches["float32"]["mean_shift_fit"], **fit})
    for variant, fit in variant_fits.items():
        fit.pop("out")
        rows.append({"name": "mean_shift_fit", "d": 2, "path": variant, "route": "cuda",
                     "source": "cellulus_tpu_torch/csrc/ball_stats.cu",
                     "replaces": "cellulus_tpu/ops/pallas_mean_shift.py:39",
                     "launches": variants[variant]["launches"], **fit})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
