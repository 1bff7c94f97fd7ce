"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) if it fails:

1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. the build: every kernel of ``cellulus_tpu_torch/csrc`` built by ``nvcc``
   for ``sm_90a``, all at once, timed;
3. K1, the fused conv pass: the kernel against its plain version at the
   three pass shapes of the full-width 2D model's tile batch, in float32
   (TF32 off) and bfloat16, two launches bit-identical, with the design
   each shape takes, its TFLOP/s and its plain, cuDNN and bound times; then
   ``[K1-wide]``: the wrapper's Python mirrors of the kernel's size and cost
   formulas against the library's, and K1 at the passes of
   ``examples/real-data``'s 256-fmap model (tile batch 16), whose bottom
   pass takes the staged route (in bf16 the persistent implicit GEMM: the
   ptxas report of ``conv_stage_kernel_persistent``, which must show no
   spill and no serialised wgmma, and each of its four stages timed beside
   its bound); then ``[K1-ragged]``: the same checks at
   ragged and narrow shapes (partial edge tiles, 24 and 72 channels, three
   input channels, B = 1);
4. K2, the 3x3 filter gradient: the kernel against its plain version at the
   six dw shapes of the full-width train step, float32 and bfloat16, two
   launches bit-identical, with the design each shape takes (taps or
   (tap, ci) folded into wgmma's M, TMA or element copies), its TFLOP/s and
   its plain, cuDNN (``conv2d_weight``) and bound times; then
   ``[K2-ragged]``: the same checks at the gate model's shapes (16 fmaps,
   x2, 24 last, 4 x 76^2), the ``[sweep]`` and ``[mc]`` widths (24, 72,
   three input channels), B = 1 and sizes that are no multiple of a chunk,
   and channel counts TMA cannot stride;
5. K3, the mean-shift ball statistics: the kernel against its plain version
   on random points and on points lying exactly on the ball boundary;
6. K3-fit, the whole mean-shift fit in one launch: the launch plan's
   Python mirror (``ops/mean_shift_fit.fit_plan``) against the library's at
   every d and 17 point counts; bit-identical over two launches, over a fit
   of every other seed (a seed's sums do not depend on the other seeds) and
   to ``tests/mean_shift_fit_emu.py`` on seven fixtures (d = 2, 3, 5; each
   cluster size the plan takes, 1, 2, 4 and 8 blocks; points beyond shared
   memory); one step against the plain version; labels against the plain
   version on two clustered fixtures; timed against the one-iteration route
   (``mean_shift_fit_plain`` over ``ball_stats``) and the plain version on a
   long fit (87,000 uniform points, 300 iterations at most) and on K3's
   input run as a fit, each timed input with its plan, S, N, the ``n_iter``
   maximum and sum, and the wrapper's host time a call;
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
   ``[wide-main]``: ``cellulus_tpu_torch.infer`` on
   ``examples/real-data/infer.toml`` as written (256 fmaps, bf16,
   ``pipelined = true``, its ``models/best_loss.ckpt`` read by the rule as
   the port's ``models/best_loss.pth``) on four 512^2 samples, then staged on the same
   inputs: the five stage datasets bit-equal, some sample's detect+segment
   (a worker thread) overlapping a later sample's predict (the calling
   thread), the pipelined wall time against the staged sum, K1 and the fit
   launched four times one sample's count on each path; ``[trace]``: (a)
   the 2D main path pipelined (examples/2d's model, f32, 4 x 512^2) under
   ``CELLULUS_TPU_PROFILE`` and ``CELLULUS_TPU_DEVICE_TIMERS=1``, the
   ``{predict,detect,segment}.device`` sums, the ten device ops that took
   most time, the device's idle share, K1's and the fit kernel's symbols in
   the trace, then staged with timers on (detect's host share); (b) 20
   steps of ``train()`` at examples/2d/train.toml's settings inside
   ``torch.profiler``: the device's idle share over the steady steps, the
   training thread's spans and the longest device-idle stretches;
9. the train main path: ``cellulus_tpu_torch.train`` at the full width of
   ``examples/2d/train.toml`` (bf16, elastic on, device pairs) for 20 steps,
   K2 launched 6 times a step, a resume, 3 float32 steps, then infer on the
   trained checkpoint; ``[ckpt]``: ``examples/2d/infer.toml`` as written
   (``checkpoint = "models/best_loss.ckpt"``) where [train] left only the
   port's ``models/best_loss.pth`` (read by the rule, its line printed),
   then where the same weights are a ``best_loss.ckpt`` in the JAX
   package's layout: every stage's output bit-equal; ``[export]``:
   examples/2d's model exported by ``torch.export`` on the card in float32
   and bf16, served by a fresh process (``chip_smoke.py --serve``) on the
   same draws as ``tta_embeddings`` here: max abs difference, K1's
   launches a call (one per 2D conv pass) and ms a call against the live
   forward; ``[mc]``: K1's first pass at cin = 3 and K2 at Ci = 3 against
   their plain versions, then a 3-channel infer and 3 train steps with the
   launches counted;
10. learn: a small recipe trains 400 steps and must beat its step-0 F1;
    ``[grid]``/``[dense]``: one step of each loss mode at the full width of
    examples/2d, float32 and bfloat16, card against CPU on the same weights
    and draws (loss, every gradient and parameter), then pairs, grid, dense
    and pairs/grid with remat timed at batch 8 in bf16 with peak memory and
    K2's launches; ``[learn-grid]``: the port's learning gate
    (``gate_recipe``: tests/test_quality_gate.py's data and model, grid loss,
    lr 1.5e-3, temperature 5, regularizer 2e-3, 1000 steps), hard bar F1 >=
    0.9, and the step-0 checkpoint must read below it; ``[spd]``:
    ``steps_per_dispatch = 4`` as one CUDA graph of 4 steps against eager
    steps at examples/2d's width (float32 and bfloat16; grid, device pairs,
    host pairs; grid on uint16 crops warped on the card; the draws step by
    step; a stale-generator control) and at examples/3d's (with and without
    the warp), bit-equal with cuDNN off and each step's gradients with
    cuDNN on within an eager step's distance from a cuDNN-off one,
    ``train()`` at K = 4 against K = 1 and resumes across K,
    step ms and peak memory graphed and eager; ``[native]``: native
    transfer with the warp on the card at examples/2d's width, and the
    normalized native crops against the float32 path's;
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
    no other kernel; after the float32 run sample 0's detect in parts
    (``[3d-detect]``), labels on a small 3D fixture against the plain
    version, and the fit kernel timed at d = 3 on sample 0's fit input
    (``[K3-fit]``); ``[cc]``: cell segment (halo removal, connected
    components, size filter, relabel) on the card against the CPU and the
    scipy oracle on every sample of ``[main]``'s and ``[3d-main]``'s
    detections, spirals card against CPU with their rounds, and a 128^3
    sample's device route timed against the host route; ``[stream]``: one
    224^3 sample through examples/3d's model in bf16, the staged predict
    streamed (tiles read from the zarr, written by one thread) against
    ``predict_sample`` in memory, each in its own process
    (``chip_smoke.py --stream``): bit-equal, seconds and peak RSS;
14. ``[3d-greedy]``: ``examples/3d/infer.toml`` as it is (greedy clustering)
    on the bf16 3D embeddings through detect, segment and evaluate, greedy's
    iterations, host syncs and seconds a sample, and a 48^3 crop card
    against CPU; ``[pipelined-greedy]``: its settings pipelined on the
    [3d-train] container (predict included), equal to the staged run;
15. ``[3d-elastic]``: tests/test_quality_3d_gate.py's bundle as written
    (the warp on the card, device pairs, all_dims, 60 steps), its losses
    and the pipeline on its checkpoint, and the warp for given parameters,
    card against CPU; ``[hela]``: scripts/run_real_hela.py's recipe through
    the port (scripts/torch_real_hela.py), nucleus mode on the host and on
    the card (``device_nucleus``) and cell mode against the vendored silver
    truth, nucleus F1 >= 0.8 and above cell mode's, the device partition
    equal to the host's but at nested instances and moved thresholds;
    ``[sweep]``: ``checkpoint_sweep`` (pipelined, nucleus) over the
    checkpoints [hela] left and a truncated copy: an error row for the copy,
    best_loss.pth's row equal to [hela]'s nucleus F1 and SEG;
16. multi-GPU and the last training options, on the one card:
    ``[m13-predict]`` after ``[wide-main]`` (examples/2d's model in bf16 on
    ``[main]``'s samples over the device list ``["cuda:0", "cuda:0"]``: the
    tile batch split over it bit-equal to one device, ``spatial_shards = 2``
    against the tiled path at ``p_salt_pepper = 0``, detect round-robin
    equal to serial); ``[resume-ckpt]`` after ``[ckpt]`` (``[train]``'s
    state as a flax-format ``.ckpt`` with its Adam state as optax leaves, 3
    steps resumed from it and from the ``.pth``: ``loss.csv`` bit-equal);
    ``[dense-spd]`` after ``[spd]`` (dense loss at examples/2d's width as a
    K = 4 CUDA graph against eager steps, ``[spd]``'s bars, ms a step, and
    ``train()`` in dense chunks); ``[dp]`` (two gloo ranks on ``cuda:0``
    against one rank on the whole batch; one NCCL rank whose K = 4 graph
    holds the all_reduce, against eager steps and against no group);
17. the kernels line (JSON, one row per kernel and input type; K1 at both
    widths and at cin = 3, with its launches by path (main, pipelined,
    sweep, ckpt, export, mc, m13-predict); K2 at Ci = 3 and K2's
    launches by path (dense-spd, resume-ckpt and dp among them),
    ``[spd]``'s graphed runs counted as warm-up launches plus captured
    calls times replays; the fit at d = 2 and d = 3 with its launches by
    path (m13-predict's round-robin detect among them) and on each new
    detect path), then the last line
    ``{"ok": true, "device": {...}}``.

Needs CUDA: without it the script exits non-zero and prints no result.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import importlib.util
import json
import math
import os
import re
import resource
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

import cellulus_tpu_torch
from cellulus_tpu_torch.configs import DatasetConfig, ExperimentConfig, InferenceConfig
from cellulus_tpu_torch.datasets import (
    PairSampler,
    elastic_device,
    get_dataset,
    normalization_factor_for,
)
from cellulus_tpu_torch.datasets.elastic import required_margin
from cellulus_tpu_torch.datasets.elastic_device import (
    deformation_grid,
    draw_deformations,
    elastic_deform_batch,
    map_coordinates_linear,
)
from cellulus_tpu_torch.export import artifact_name as export_artifact_name
from cellulus_tpu_torch.export import draw_uniform, export_predictor, load_predictor
from cellulus_tpu_torch.io import zarr
from cellulus_tpu_torch.train import (
    StepChunks,
    _prep_raw,
    make_optimizer,
    make_train_step,
    make_train_step_dense,
    make_train_step_fused,
    make_train_step_grid,
)
from cellulus_tpu_torch.models import UNet, compute_geometry, load_checkpoint, tta_embeddings
from cellulus_tpu_torch.models.geometry import conv_pass_inputs
from cellulus_tpu_torch.detect import detect as detect_stage
from cellulus_tpu_torch.detect import detect_sample, mean_center_embeddings, sample_rng
from cellulus_tpu_torch.infer import PIPELINED_STAGE, checkpoint_sweep
from cellulus_tpu_torch.ops import mean_shift as msops
from cellulus_tpu_torch.ops.ball_stats import ball_stats, ball_stats_plain, point_set
from cellulus_tpu_torch.ops.conv_dw import conv3x3_dw, conv3x3_dw_design, conv3x3_dw_plain
from cellulus_tpu_torch.ops import conv_dw, conv_pass
from cellulus_tpu_torch.ops.conv_pass import conv_pass_2d, conv_pass_2d_design, conv_pass_2d_plain
from cellulus_tpu_torch.ops.mean_shift import mean_shift_fit_predict
from cellulus_tpu_torch.ops.mean_shift_fit import (
    fit_plan,
    mean_shift_fit,
    mean_shift_fit_plain,
    mean_shift_fit_plan,
    near_boundary,
)
from cellulus_tpu_torch.ops.components import cc_parents, filter_relabel
from cellulus_tpu_torch.ops.greedy_cluster import greedy_cluster
from cellulus_tpu_torch.utils.parity import (
    mean_shift_fit_inputs,
    unexplained_greedy,
    unexplained_mean_shift,
)
from cellulus_tpu_torch.ops.morphology import halo_removal
from cellulus_tpu_torch.ops.nucleus import nucleus_partition_device, otsu_per_id
from cellulus_tpu_torch.ops.otsu import threshold_otsu
from cellulus_tpu_torch.predict import predict, predict_sample, tile_origins
from cellulus_tpu_torch.segment import cell_segment_sample, nucleus_partition
from cellulus_tpu_torch.parallel import distributed as dist_mod
from cellulus_tpu_torch.utils import kernels
from cellulus_tpu_torch.utils.profiling import perf_report, reset_perf

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


def pass_shapes(batch, model=MODEL, in_channels=1, crop=CROP):
    """``(name, NHWC input shape, C_out)`` of every conv pass of a tile
    batch of ``batch`` images at ``model``'s width."""
    return [(name, (batch, *size, c_in), c_out) for name, size, c_in, c_out in conv_pass_inputs(
        (crop, crop), model["downsampling_factors"], in_channels, model["num_fmaps"],
        model["fmap_inc_factor"], model["features_in_last_layer"])]


def _k1_shape(name, shape, c_out, dtype, gen, device, tag):
    """K1 against its plain version at one pass shape; its times (kernel,
    plain, cuDNN, bound), operations and bytes."""
    params = _pass_params(shape[-1], c_out, gen, device)
    x = torch.rand(shape, generator=gen).to(device)
    got = conv_pass_2d(x, params, dtype)
    if not torch.equal(got, conv_pass_2d(x, params, dtype)):
        fail(f"conv_pass_2d {name} {dtype}: two launches differ")
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
          f"max_abs_err {max_err:.3g} ({tol_text}), two launches bit-identical; kernel {ms:.2f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.2f} ms, "
          f"cuDNN {library_ms:.2f} ms, bound {bound_ms:.3f} ms")
    del x
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "max_abs_err": max_err, "flops": flops, "nbytes": nbytes}


def _summed(rows, dtype):
    """The sum of per-shape rows of one kernel: times summed, the largest
    error, and what bounds the sum."""
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    total["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    by_ops = (sum(r["flops"] for r in rows) / PEAK_OPS[dtype]
              >= sum(r["nbytes"] for r in rows) / HBM_BYTES_PER_S)
    total["bound_by"] = "operations" if by_ops else "bytes"
    return total


def phase_conv_pass(device, model=MODEL, batch=TILE_BATCH * 2 * NUM_INFER_ITERATIONS,
                    tag="K1"):
    """K1 against its plain version at the pass shapes of a tile batch of
    ``batch`` images at ``model``'s width, in both compute types; returns
    the sums per type."""
    gen = torch.Generator().manual_seed(1)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        total = _summed([_k1_shape(name, shape, c_out, dtype, gen, device, tag)
                         for name, shape, c_out in pass_shapes(batch, model)], dtype)
        print(f"[{tag}] per tile batch of {batch} images, {dtype}: kernel {total['ms']:.2f} ms, "
              f"plain {total['plain_ms']:.2f} ms, cuDNN {total['library_ms']:.2f} ms, bound "
              f"{total['bound_ms']:.3f} ms ({total['bound_by']})", flush=True)
        out[dtype] = total
    return out


# ragged and narrow K1 shapes: image sizes that leave partial tiles at the
# right and bottom edge, the 24-fmap model's widths (24, 72) and three input
# channels, B = 1
K1_RAGGED = (((1, 37, 41, 3), 24), ((2, 29, 33, 24), 72), ((3, 45, 45, 96), 24))


def phase_k1_ragged(device):
    """K1 at the ragged shapes, both types, through the checks of ``[K1]``."""
    gen = torch.Generator().manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        for i, (shape, c_out) in enumerate(K1_RAGGED):
            _k1_shape(f"r{i}", shape, c_out, dtype, gen, device, "K1-ragged")


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
    buf = (ctypes.c_longlong * 11)()
    keys = ("bh", "bw", "tiles_y", "tiles_x", "m_tiles", "n_tiles", "tiles", "n_cb", "chunks",
            "slots", "smem")
    cases = [(B, s, s, k, ci, 768) for B in (1, K1_WIDE_BATCH, 128)
             for s, k, ci in ((122, 3, 256), (122, 1, 768), (120, 3, 768))]
    cases += [(1, 33, 37, 3, 24, 72), (2, 41, 41, 3, 96, 24), (1, 62, 62, 3, 256, 4640)]
    for c in cases:
        lib.conv_pass_2d_staged_plan(*c, buf)
        want = conv_pass.staged_plan(*c)
        if list(buf) != [want[k] for k in keys]:
            fail(f"K1 staged plan mirror differs from the library at {c}: library {list(buf)}, "
                 f"mirror {want}")
    print(f"[K1-wide] the bf16 staged route's plan mirror equals the library's at {len(cases)} "
          f"stage shapes", flush=True)


def ptxas_entry(log, symbol):
    """The ptxas report (``-Xptxas -v``) of the kernel whose mangled name
    holds ``symbol``: ``{"registers", "spill_stores", "spill_loads",
    "serialized"}``, the last the C7512 notes naming it; None if the log has
    no entry for it (a library built by an earlier process)."""
    entry, found = None, None
    serialized = [line for line in log.splitlines() if "C7512" in line and symbol in line]
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None or symbol not in entry:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            found = {"spill_stores": int(m.group(1)), "spill_loads": int(m.group(2))}
        m = re.search(r"Used (\d+) registers", line)
        if m and found is not None:
            found.update(registers=int(m.group(1)), serialized=serialized)
            return found
    return None


def phase_k1_staged(device, batch=K1_WIDE_BATCH):
    """The bf16 staged route of the 256-fmap bottom pass: the persistent
    kernel's ptxas report (no spill, no wgmma serialised), then each of the
    four stages launched alone at tile batch ``batch``, against its plain
    stage and timed beside its bound. Returns the stages' rows."""
    log = kernels.BUILD_LOG.get("conv_pass")
    rep = ptxas_entry(log, "conv_stage_kernel_persistent") if log else None
    if rep is None:
        print("[K1-wide] conv_stage_kernel_persistent: no ptxas report (library built earlier)")
    else:
        print(f"[K1-wide] ptxas conv_stage_kernel_persistent: {rep['registers']} registers, "
              f"spill stores {rep['spill_stores']} B, spill loads {rep['spill_loads']} B, "
              f"C7512 {'yes' if rep['serialized'] else 'no'}", flush=True)
        if rep["spill_stores"] or rep["spill_loads"] or rep["serialized"]:
            fail(f"conv_stage_kernel_persistent: ptxas spills or serialises its wgmmas: {rep}")
    lib = kernels.load("conv_pass", conv_pass._SIGNATURES)
    (_, (_, H, W, c_in), c_out), = [p for p in pass_shapes(1, MODEL_WIDE) if p[0] == "bottom"]
    gen = torch.Generator().manual_seed(4)
    rows = []
    for i, (k, ci, h) in enumerate(((3, c_in, H), (1, c_out, H - 2), (1, c_out, H - 2),
                                    (3, c_out, H - 2))):
        x = torch.rand((batch, h, h, ci), generator=gen).to(device).bfloat16()
        w = (torch.randn((k, k, ci, c_out), generator=gen) / math.sqrt(k * k * ci)).to(device)
        b = ((torch.rand((c_out,), generator=gen) * 2 - 1) / math.sqrt(k * k * ci)).to(device)
        packed = conv_pass.pack_stage_persistent(w.bfloat16())
        out = torch.empty((batch, h - k + 1, h - k + 1, c_out), dtype=torch.bfloat16,
                          device=device)
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            kernels.check_launch(lib.conv_pass_2d_stage_launch(
                x.data_ptr(), packed.data_ptr(), b.data_ptr(), out.data_ptr(), batch, h, h, k,
                ci, c_out, stream), "conv_pass_2d stage")

        run()
        ref = torch.relu(torch.nn.functional.conv2d(
            x.float().permute(0, 3, 1, 2), w.bfloat16().float().permute(3, 2, 0, 1), b))
        ref = ref.bfloat16().permute(0, 2, 3, 1)
        err = float((out.float() - ref.float()).abs().max())
        atol = 2e-2 * float(ref.float().abs().max())
        if not err <= atol:
            fail(f"[K1-wide] bottom stage {i + 1}: max abs err {err:.3g} > {atol:.3g}")
        ms = cuda_ms(run, reps=10)
        flops = 2 * batch * (h - k + 1) ** 2 * k * k * ci * c_out
        nbytes = 2 * (x.numel() + out.numel() + w.numel()) + 4 * c_out
        bound_ms = 1e3 * max(flops / PEAK_OPS[torch.bfloat16], nbytes / HBM_BYTES_PER_S)
        plan = conv_pass.staged_plan(batch, h - k + 1, h - k + 1, k, ci, c_out)
        print(f"[K1-wide] bottom stage {i + 1} {k}x{k} {ci}->{c_out} at {h}^2 "
              f"({plan['bh']}x{plan['bw']} boxes, {plan['tiles']} tiles of {plan['chunks']} "
              f"chunks): max_abs_err {err:.3g} (atol {atol:.3g}); {ms:.3f} ms, bound "
              f"{bound_ms:.3f} ms, {100 * bound_ms / ms:.1f}% of it", flush=True)
        rows.append({"stage": i + 1, "ms": ms, "bound_ms": bound_ms, "max_abs_err": err})
        del x, out, ref
    torch.cuda.empty_cache()
    return rows


def dw_shapes(batch, in_channels=1, model=MODEL, crop=CROP):
    """``(name, x shape, g shape)`` of every 3x3 filter gradient of a train
    step: the first and last conv of each pass."""
    shapes = []
    for name, (B, H, W, c_in), c in pass_shapes(batch, model, in_channels, crop):
        shapes.append((f"{name} c0", (B, H, W, c_in), (B, H - 2, W - 2, c)))
        shapes.append((f"{name} c3", (B, H - 2, W - 2, c), (B, H - 4, W - 4, c)))
    return shapes


def _k2_shape(name, xs, gs, dtype, gen, device, tag="K2"):
    """K2 against its plain version at one dw shape, bit-identical over two
    launches; its times (kernel, plain, cuDNN, bound), operations and bytes."""
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
    print(f"[{tag}] {name:9s} {str(dtype):14s} x{tuple(xs)} g{tuple(gs)}: "
          f"{conv3x3_dw_design(c_in, c_out, dtype)}; bit-identical over two launches; "
          f"max_abs_err {max_err:.3g} ({tol_text}); kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
          f"cuDNN {library_ms:.3f} ms, bound {bound_ms:.3f} ms")
    del x, g, x_nchw, g_nchw
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "max_abs_err": max_err, "flops": flops, "nbytes": nbytes}


def phase_conv_dw(device):
    """K2 against its plain version at the train step's six dw shapes."""
    gen = torch.Generator(device=device).manual_seed(6)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        total = _summed([_k2_shape(name, xs, gs, dtype, gen, device)
                         for name, xs, gs in dw_shapes(TRAIN_BATCH)], dtype)
        print(f"[K2] per train step, {dtype}: kernel {total['ms']:.3f} ms, plain "
              f"{total['plain_ms']:.3f} ms, cuDNN {total['library_ms']:.3f} ms, bound "
              f"{total['bound_ms']:.3f} ms ({total['bound_by']})")
        out[dtype] = total
    return out


# ragged and narrow K2 shapes beside the gate model's: the [sweep] model's
# widths (24, 72) and its first conv at three input channels, [mc]'s at 64,
# B = 1 at sizes that are no multiple of a chunk, and channel counts TMA
# cannot stride (12 bf16 inputs, 7 and 20 outputs)
K2_RAGGED = (("sweep c0", (1, 37, 45, 3), (1, 35, 43, 24)),
             ("sweep bottom", (1, 29, 33, 24), (1, 27, 31, 72)),
             ("sweep up", (2, 27, 31, 96), (2, 25, 29, 24)),
             ("mc c0", (1, 41, 39, 3), (1, 39, 37, 64)),
             ("B1 odd", (1, 53, 47, 72), (1, 51, 45, 24)),
             ("odd Co", (1, 15, 14, 3), (1, 13, 12, 7)),
             ("odd Ci", (1, 11, 12, 12), (1, 9, 10, 20)))


def phase_k2_ragged(device):
    """K2's plan mirrors (``ops/conv_dw.py``) against the library's at every
    ``[K2]`` and ``[K2-ragged]`` shape, then K2 through ``[K2]``'s checks at
    the gate model's shapes (4 x 76^2) and at ``K2_RAGGED``, both types;
    returns the sums per type."""
    gen = torch.Generator(device=device).manual_seed(7)
    shapes = [(f"gate {n}", xs, gs) for n, xs, gs in dw_shapes(4, model=GATE_MODEL, crop=76)]
    lib = kernels.load("conv_dw", conv_dw._SIGNATURES)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n = 0
    for _, (B, H, W, c_in), gs in dw_shapes(TRAIN_BATCH) + shapes + list(K2_RAGGED):
        for e in (2, 4):
            c_out = gs[-1]
            folded = conv_dw.fold(c_in)
            got = (lib.conv3x3_dw_plan(c_in, c_out, e), lib.conv3x3_dw_smem_bytes(e, folded),
                   lib.conv3x3_dw_splits(B, H, W, c_in, c_out, e))
            want = (conv_dw.conv3x3_dw_plan(c_in, c_out, e), conv_dw.layout(e, folded)["total"],
                    conv_dw.splits(B, H, W, c_in, c_out, e, sms))
            if got != want:
                fail(f"K2 plan mirrors differ from the library at x {(B, H, W, c_in)} -> {c_out}, "
                     f"{e} B: library {got}, mirror {want}")
            n += 1
    print(f"[K2-ragged] the wrapper's mirrors of the plan, shared memory and splits equal the "
          f"library's at {n} (shape, type) cases", flush=True)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        total = _summed([_k2_shape(name, xs, gs, dtype, gen, device, "K2-ragged")
                         for name, xs, gs in shapes + list(K2_RAGGED)], dtype)
        print(f"[K2-ragged] all {len(shapes) + len(K2_RAGGED)} shapes, {dtype}: kernel "
              f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, cuDNN "
              f"{total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms", flush=True)
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


def long_fit_input(device):
    """The long fit: LONG_FIT_POINTS uniform points in the image, bin seeds
    at bw = 0.5 x OBJECT_SIZE: ``(seeds, points, bw2, stop)``."""
    X = np.random.default_rng(9).uniform(0, IMAGE_SIZE, (LONG_FIT_POINTS, 2)).astype(np.float32)
    bw = 0.5 * OBJECT_SIZE
    return _fit_problem(X, msops.bin_seeds(X, bw), bw, device)


def k3_fit_input(device):
    """K3's input (K3_FIT_SHAPE uniform seeds and points, 5% invalid) as a
    fit at bw = 0.5 x OBJECT_SIZE."""
    rng = np.random.default_rng(2)
    S, N = K3_FIT_SHAPE
    c = rng.uniform(0, IMAGE_SIZE, (S, 2)).astype(np.float32)
    X = rng.uniform(0, IMAGE_SIZE, (N, 2)).astype(np.float32)
    return _fit_problem(X, c, 0.5 * OBJECT_SIZE, device, valid=rng.random(N) > 0.05)


def long_fit_3d_input(bandwidth, device):
    """The long 3D fit: LONG_FIT_POINTS_3D uniform points in a VOLUME_SIZE^3
    volume at ``bandwidth`` (the 3D main path's), so bin seeds fill it."""
    X = np.random.default_rng(14).uniform(0, VOLUME_SIZE, (LONG_FIT_POINTS_3D, 3))
    X = X.astype(np.float32)
    return _fit_problem(X, msops.bin_seeds(X, bandwidth), bandwidth, device)


def _fit_step_check(name, seeds, points, bw2, stop, fit=mean_shift_fit):
    """One fit step (max_iter = 1, then the recount) of ``fit`` against the
    plain version. A seed is left out when a point lies within rounding of
    its ball at the start or at the end, or its shift within 1e-4 bw of the
    stop threshold: there the two may decide differently, since they sum c.x
    and the coordinates in other orders. The rest must agree: counts and
    frozen exactly, centers within rtol 1e-5, atol 1e-4."""
    got = fit(seeds, points, bw2, stop, 1)
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
    host_us = fit_host_us(seeds, points, bw2, stop, max_iter)
    bound_ms, bound_by = _fit_bound(S, N, d, n_iter, frozen, inball)
    plan, clusters = mean_shift_fit_plan(points.x.shape[0], d)
    print(f"[K3-fit] {name}: S={S} N={N} d={d} max_iter={max_iter}; plan {dict(plan._asdict())}, "
          f"{min(clusters, S)} clusters launched; iterations max {int(n_iter.max())}, sum over "
          f"seeds {int(n_iter.sum())}, frozen {int(frozen.sum())}/{S}; bit-identical over two "
          f"launches; one step vs plain: max center err {max_err:.3g} (rtol 1e-5, atol 1e-4; "
          f"{undecided} seeds at the boundary left out); kernel {ms:.3f} ms a fit "
          f"({host_us:.1f} us of host time a call), one-iteration route {route_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), {len(calls) - 1} "
          f"route iterations", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "route_ms": route_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": max_err,
            "host_us": host_us, "S": S, "N": N, "n_iter_max": int(n_iter.max()),
            "n_iter_sum": int(n_iter.sum()), "out": out}


def fit_host_us(seeds, points, bw2, stop, max_iter, calls=20, fit=mean_shift_fit):
    """The wrapper's host time a call: ``calls`` fits enqueued back to back
    on the host clock, after the card has drained (a fit on the card takes
    longer than its enqueue, so the queue never pushes back)."""
    fit(seeds, points, bw2, stop, max_iter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fit(seeds, points, bw2, stop, max_iter)
    host_us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return host_us


def _same_partition(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not ((a == -1) == (b == -1)).all():
        return False
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


# point counts at which the fit's plan mirror is held against the library's:
# each cluster size's edges, the paths' inputs, shares beyond shared memory
FIT_PLAN_N = (1, 100, 1024, 1025, 2048, 2049, 4096, 4097, 8192, 8193, 9854, 13594, 16384, 87000,
              100000, 200000, 1000003)
# the fit's fixtures against its emulation: (N, d, S, extent, bandwidth,
# max_iter, share of valid points): one block of 128 threads, the plan's
# cluster of 1, 2 (d = 3 and d = 5, 8-seed slots), 4 and 8 blocks (the main
# input's size), and more points than the cluster's shared memory holds
# (the rest read from L2)
FIT_FIXTURES = ((700, 2, 40, 40, 4.0, 50, 1.0), (2048, 2, 64, 64, 4.0, 50, 1.0),
                (3000, 3, 100, 30, 4.0, 30, 1.0), (3000, 5, 50, 30, 6.0, 20, 1.0),
                (6000, 2, 120, 128, 5.0, 40, 0.95), (13000, 2, 200, 256, 8.0, 30, 1.0),
                (200000, 2, 40, 512, 20.0, 5, 0.9))


def phase_fit(device):
    """K3-fit: the whole mean-shift fit in one launch."""
    for d in range(1, 9):
        for N in FIT_PLAN_N:
            plan, _ = mean_shift_fit_plan(N, d)
            if plan != fit_plan(N, d):
                fail(f"the fit's plan mirror {fit_plan(N, d)} differs from the library's {plan} "
                     f"at N={N} d={d}")
    print(f"[K3-fit] the plan mirror (ops/mean_shift_fit.fit_plan) equals the library's at "
          f"{8 * len(FIT_PLAN_N)} (N, d) cases", flush=True)
    emu = _load_fit_emulation()
    rng = np.random.default_rng(8)
    clusters_seen = set()
    for N, d, S, extent, bw, max_iter, p_valid in FIT_FIXTURES:
        X = rng.uniform(0, extent, (N, d)).astype(np.float32)
        valid = rng.random(N) < p_valid
        seeds, points, bw2, stop = _fit_problem(X, X[rng.choice(N, S, replace=False)], bw, device,
                                                valid=valid)
        got = [t.cpu().numpy() for t in mean_shift_fit(seeds, points, bw2, stop, max_iter)]
        want = emu.fit(seeds.cpu().numpy(), X, points.x_norm.cpu().numpy(), valid, bw2, stop,
                       max_iter)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            fail(f"mean_shift_fit differs from tests/mean_shift_fit_emu.py at N={N} d={d}")
        plan, clusters = mean_shift_fit_plan(N, d)
        clusters_seen.add(plan.cluster)
        print(f"[K3-fit] S={S} N={N} d={d} max_iter={max_iter}, {valid.mean():.0%} valid: "
              f"bit-identical to the emulation (iterations max {got[3].max()}, frozen "
              f"{int(got[2].sum())}/{S}; plan {dict(plan._asdict())}, {min(clusters, S)} "
              f"clusters)", flush=True)
    if clusters_seen != {1, 2, 4, 8}:
        fail(f"the fit's fixtures took cluster sizes {sorted(clusters_seen)}, not 1, 2, 4 and 8")

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
    seeds, points, bw2, stop = long_fit_input(device)
    long_fit = time_fit("long fit", seeds, points, bw2, stop, 300)
    half = mean_shift_fit(seeds[::2].contiguous(), points, bw2, stop, 300)
    if not all(torch.equal(h, f[::2]) for h, f in zip(half, long_fit["out"])):
        fail("mean_shift_fit: a fit of every other seed differs from the full fit")
    print("[K3-fit] long fit: every other seed fitted alone is bit-identical to the full fit")

    # K3's input, run as a fit
    seeds, points, bw2, stop = k3_fit_input(device)
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
    counts set to 0 just before it; returns its launches, stage seconds and
    inference config (with the settings infer derived)."""
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
    return launches, stage_seconds, config.inference_config


def phase_main_path(work):
    """The infer main path with the default inference settings (float32),
    sample 0's detect in parts, then the main path again at
    examples/2d/infer.toml's ``precision = "bfloat16"``. Returns the launches
    of each run, by precision, the fit kernel's timing on sample 0 and the
    float32 run's inference config."""
    container = write_blob_container(os.path.join(work, "data.zarr"), 2, IMAGE_SIZE, seed=5)
    checkpoint = os.path.join(work, "weights.pth")
    save_random_checkpoint(checkpoint, seed=0, **MODEL)
    ic = infer_config(container, checkpoint, MODEL, device="cuda:0").inference_config
    if (ic.crop_size, ic.tile_batch_size, ic.num_infer_iterations, ic.p_salt_pepper,
            ic.precision) != ([CROP, CROP], TILE_BATCH, NUM_INFER_ITERATIONS, 0.01, "float32"):
        fail("the default inference settings differ from the ones this script assumes")
    launches, stage_seconds, ic = _infer_main(work, container, checkpoint, "float32")
    launches = {"float32": launches}
    fit = phase_detect(container, torch.device("cuda:0"), stage_seconds["detect"])
    launches["bfloat16"] = _infer_main(work, container, checkpoint, "bfloat16")[0]
    return launches, fit, ic


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


def _run_train(config, step_times=None, k1_launches=0):
    """``cellulus_tpu_torch.train`` with the K2 count set to 0 just before;
    returns ``(state, K2 launches)``. K1 (inference only) may launch just
    ``k1_launches`` times: the no-grad snapshot forwards of a run that warps
    on the card."""
    conv3x3_dw.launches = 0
    conv_pass_2d.launches = 0
    state = cellulus_tpu_torch.train(config, step_times)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if conv_pass_2d.launches != k1_launches:
        fail(f"the train loop launched the inference-only K1 {conv_pass_2d.launches} times, "
             f"not {k1_launches}")
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


# -- the training recipes of the JAX package's gates (loss modes, device elastic,
# native transfer, remat, nucleus mode) -----------------------------------------

LOSS_MODE_LR = 1e-3
LOSS_MODE_STEPS = 12
# tests/test_quality_gate.py's sizes, and the HeLa recipe's length
GATE_SIZE, GATE_STEPS = 128, 1000
GATE_STEPS_3D = 60
HELA_STEPS = 5000


def _loss_mode_step(kind, net, dtype, device, batch, remat=False):
    """A step of ``kind`` ("pairs" with device pairs, "grid", "dense") on
    ``net`` at the 2D crop of examples/2d (kappa 10, density 0.1)."""
    out = tuple(compute_geometry((CROP, CROP), MODEL["downsampling_factors"]).output_size)
    sampler = PairSampler(out, density=0.1, kappa=10.0)
    net.remat = remat
    make = {"pairs": make_train_step_fused, "grid": make_train_step_grid,
            "dense": make_train_step_dense}[kind]
    return make(net, make_optimizer(net.parameters(), LOSS_MODE_LR), 10.0, 1e-5, sampler, batch,
                dtype, device)


def _grad_distances(a, b):
    """Per tensor, the relative L2 distance of ``a``'s gradient from
    ``b``'s; and the share of parameter entries more than 0.05 x lr apart."""
    rel = {k: float((a[k][1] - g).norm()) / max(float(g.norm()), 1e-30)
           for k, (_, g) in b.items()}
    apart = sum(int(((a[k][0] - p).abs() > 0.05 * LOSS_MODE_LR).sum()) for k, (p, _) in b.items())
    return rel, apart / sum(p.numel() for p, _ in b.values())


def phase_loss_modes(device):
    """``[grid]`` and ``[dense]``: one step of each loss mode at the full
    width of examples/2d, float32 and bfloat16, from the same weights and the
    same draws, on the card against the CPU (batch 2); then the step time
    (median of LOSS_MODE_STEPS after 3 warm-up steps, the card synchronised
    after each) and peak memory of pairs, grid, dense and each with remat,
    at examples/2d/train.toml's batch 8 in bf16, K2 counted in each run.

    The bars: loss and OCE term within rtol 1e-4 (float32) and 1e-2 (bf16).
    Each tensor's gradient, as a relative L2 distance: the card's float32
    within 3% of the distance between the CPU's bf16 and float32 gradients
    (TF32's 2^-11 would sit near 1/8 of it; a first-layer filter gradient
    sums 125k products whose sum cancels, so its float32 rounding shows at
    a few 1e-3 there), the card's bf16
    within twice that distance plus 1e-3 (the card's bf16 no farther from
    the CPU's than bf16 lies from float32). A first Adam step moves each
    entry by about lr times the sign of its gradient, so parameters land
    apart only where a gradient's sign differs: at most 0.1% of the entries
    in float32, 5% in bf16. A control shows that the float32 bar rejects a
    lower precision: the card's float32 step with TF32 allowed in cuDNN and
    matmul must fail it. Returns the K2 launches of each timed run and its
    step times."""
    raw = torch.rand((2, CROP, CROP, 1), generator=torch.Generator().manual_seed(21))
    bars = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (1e-2, 5e-2)}

    def one_step(kind, net, dtype, dev, draws):
        copy = random_unet(7, **MODEL).to(dev)
        copy.load_state_dict(net.state_dict())
        step = _loss_mode_step(kind, copy, dtype, dev, 2)
        loss, oce, _ = step(raw.to(dev), None, draws=tuple(t.to(dev) for t in draws))
        return float(loss), float(oce), {
            k: (p.detach().cpu(), p.grad.cpu()) for k, p in copy.named_parameters()}

    def judge(dtype, got, want, floor):
        """``(message or None, report)``: the card's step ``got`` against the
        CPU's ``want`` under ``dtype``'s bars."""
        loss_tol, moved_tol = bars[dtype]
        (l_gpu, o_gpu, gpu), (l_cpu, o_cpu, cpu) = got, want
        if not (abs(l_gpu - l_cpu) <= loss_tol * abs(l_cpu)
                and abs(o_gpu - o_cpu) <= loss_tol * abs(o_cpu)):
            return (f"loss {l_gpu} / OCE {o_gpu} on the card, {l_cpu} / {o_cpu} on the CPU "
                    f"(rtol {loss_tol})"), ""
        rel, apart = _grad_distances(gpu, cpu)
        if dtype == torch.float32:
            limit = {k: 0.03 * f for k, f in floor.items()}
        else:
            limit = {k: 2 * f + 1e-3 for k, f in floor.items()}
        over = [k for k in rel if rel[k] > limit[k]]
        worst = max(rel, key=lambda k: rel[k] / limit[k])
        report = (f"loss {l_gpu:.6g} vs {l_cpu:.6g} (rtol {loss_tol}); gradients' relative L2 "
                  f"distance, worst against its bar at {worst}: {rel[worst]:.3g} (bar "
                  f"{limit[worst]:.3g}; CPU bf16 vs f32 {floor[worst]:.3g}), largest "
                  f"{max(rel.values()):.3g}; {apart:.3%} of the parameters apart by more than "
                  f"0.05 x lr (limit {moved_tol:.1%})")
        if over or apart > moved_tol:
            return f"gradients of {over} beyond their bar: {report}", report
        return None, report

    for kind in ("grid", "dense"):
        net = random_unet(7, **MODEL)
        states, seconds = {}, {}
        draws = _loss_mode_step(kind, net, torch.float32, "cpu", 2).draw(
            torch.Generator().manual_seed(22))
        for dtype in (torch.float32, torch.bfloat16):
            for dev in ("cpu", str(device)):
                t0 = time.perf_counter()
                states[dtype, dev] = one_step(kind, net, dtype, dev, draws)
                seconds[dtype, dev] = time.perf_counter() - t0
        floor, _ = _grad_distances(states[torch.bfloat16, "cpu"][2], states[torch.float32, "cpu"][2])
        for dtype in (torch.float32, torch.bfloat16):
            message, report = judge(dtype, states[dtype, str(device)], states[dtype, "cpu"], floor)
            if message:
                fail(f"[{kind}] {dtype} card vs CPU: {message}")
            print(f"[{kind}] {str(dtype):14s} one step at full width, batch 2, card vs CPU: "
                  f"{report}; CPU step {seconds[dtype, 'cpu']:.1f}s", flush=True)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = one_step(kind, net, torch.float32, str(device), draws)
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        message, report = judge(torch.float32, tf32, states[torch.float32, "cpu"], floor)
        if message is None:
            fail(f"[{kind}] the float32 bar passes the card's step with TF32 allowed: {report}")
        print(f"[{kind}] control: float32 with TF32 allowed fails the float32 bar as it must: "
              f"{report}", flush=True)

    raw = torch.rand((TRAIN_BATCH, CROP, CROP, 1), generator=torch.Generator().manual_seed(23),
                     device="cpu").to(device)
    runs = {}
    for name, kind, remat in (("pairs", "pairs", False), ("grid", "grid", False),
                              ("dense", "dense", False), ("pairs+remat", "pairs", True),
                              ("grid+remat", "grid", True)):
        net = random_unet(7, **MODEL).to(device)
        step = _loss_mode_step(kind, net, torch.bfloat16, device, TRAIN_BATCH, remat)
        gen = torch.Generator(device=device).manual_seed(24)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        conv3x3_dw.launches = 0
        times = []
        for i in range(3 + LOSS_MODE_STEPS):
            t0 = time.perf_counter()
            loss = step(raw, gen)[0]
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        if not math.isfinite(float(loss)):
            fail(f"[{name}] loss {float(loss)}")
        launches = conv3x3_dw.launches
        if launches != 6 * (3 + LOSS_MODE_STEPS):
            fail(f"[{name}] conv3x3_dw launched {launches} times in {3 + LOSS_MODE_STEPS} steps")
        runs[name] = {"ms": float(np.median(times[3:])), "peak_gib":
                      torch.cuda.max_memory_allocated() / 2**30, "launches": launches}
        del net, step
    base = runs["pairs"]
    print("[grid] bf16 steps at examples/2d/train.toml's width and batch "
          f"({TRAIN_BATCH} x {CROP}^2), median of {LOSS_MODE_STEPS}: " + "; ".join(
              f"{name} {r['ms']:.2f} ms ({r['ms'] / base['ms']:.2f}x pairs), peak "
              f"{r['peak_gib']:.2f} GiB, K2 {r['launches']}" for name, r in runs.items()),
          flush=True)
    return runs


def _gate_container(work, name, ndim=2, size=GATE_SIZE):
    """The data of tests/test_quality_gate.py (2D) or test_quality_3d_gate.py
    (3D): 12 disks or balls of radius 0.04-0.09 x size, uint8, seed 11."""
    os.makedirs(work, exist_ok=True)
    return write_blob_container(os.path.join(work, name), 2 if ndim == 2 else 1, size, seed=11,
                                dtype=np.uint8, ndim=ndim, num_blobs=12, radius=(0.04, 0.09))


GATE_MODEL = dict(num_fmaps=16, fmap_inc_factor=2, features_in_last_layer=24,
                  downsampling_factors=[[2, 2]])


def gate_recipe(container, seed=0, iters=GATE_STEPS):
    """The port's 2D learning gate as a plain dict, for either package's
    ``ExperimentConfig``: tests/test_quality_gate.py's data, model, crop and
    pipeline (grid loss, every stage in ``container``, which holds the
    ground truth), trained ``iters`` steps at lr 1.5e-3 with temperature 5
    and regularizer weight 2e-3. The one copy of the recipe: ``[learn-grid]``,
    the port's CPU gate (tests/test_torch_quality_gate.py) and
    tests/gate_seeds.py read it.

    tests/test_quality_gate.py's own recipe (temperature 10, regularizer
    1e-5, 400 steps) lets the embeddings run away after 100-200 steps: its
    outcome at one seed moved with the host's arithmetic (seed table in
    ROADMAP.md section 3). The stronger regularizer stops the runaway, and
    temperature 5 sharpens the instances' borders enough that the small
    ones reach IoU 0.5 within 1000 steps."""

    def ds(name, secondary=None):
        d = {"container_path": str(container), "dataset_name": name}
        if secondary:
            d["secondary_dataset_name"] = secondary
        return d

    return {
        "object_size": int(GATE_SIZE * 0.13),
        "model_config": dict(GATE_MODEL),
        "train_config": {
            "batch_size": 4, "kappa": 5.0, "loss_mode": "grid", "density": 0.2,
            "crop_size": [76, 76], "max_iterations": iters, "initial_learning_rate": 1.5e-3,
            "temperature": 5.0, "regularizer_weight": 2e-3, "num_workers": 0,
            "elastic_deform": False, "save_model_every": iters - 1,
            "save_snapshot_every": 10**9, "save_best_model_every": 50, "seed": seed,
            "train_data_config": ds("raw"),
        },
        "inference_config": {
            "crop_size": [76, 76], "tile_batch_size": 4,
            "dataset_config": ds("raw"),
            "prediction_dataset_config": ds("embeddings"),
            "detection_dataset_config": ds("detection", "embeddings"),
            "segmentation_dataset_config": ds("segmentation", "detection"),
            "evaluation_dataset_config": ds("groundtruth", "segmentation"),
        },
    }


def learn_grid(work, seed=0, device=None, iters=None, overrides=None):
    """The gate's recipe (:func:`gate_recipe`, with the train settings
    ``overrides``) through the port at training seed ``seed``, then infer on
    best_loss.pth. Returns ``(F1, SEG, best iteration, K2 launches, train
    seconds, 50-step mean losses)``."""
    cfg = gate_recipe(_gate_container(work, "data.zarr"), seed, iters or GATE_STEPS)
    cfg["train_config"].update(overrides or {})
    cfg["train_config"]["device"] = cfg["inference_config"]["device"] = device or DEVICE
    config = ExperimentConfig(**cfg)
    with contextlib.chdir(work), logged(os.path.join(work, "train.log")):
        t0 = time.perf_counter()
        state, launches = _run_train(config)
        seconds = time.perf_counter() - t0
        config.model_config.checkpoint = os.path.join("models", "best_loss.pth")
        results = cellulus_tpu_torch.infer(config)
        best = torch.load(os.path.join("models", "best_loss.pth"), weights_only=True)["iteration"]
    f1 = max(r["F1"] for r in results.values())
    seg = max(r["SEG"] for r in results.values())
    windows = np.asarray(state["logger_data"]["loss"]).reshape(-1, 50).mean(axis=1)
    return f1, seg, int(best), launches, seconds, windows


def gate_f1(work, checkpoint, device=None):
    """F1 of the gate's pipeline (:func:`gate_recipe`) on the container a
    :func:`learn_grid` run left in ``work``, inferring with
    ``models/<checkpoint>`` (the step-0 checkpoint is the control)."""
    cfg = gate_recipe(os.path.join(work, "data.zarr"))
    cfg["inference_config"]["device"] = device or DEVICE
    config = ExperimentConfig(**cfg)
    config.model_config.checkpoint = os.path.join("models", checkpoint)
    with contextlib.chdir(work), logged(os.path.join(work, "infer.log")):
        results = cellulus_tpu_torch.infer(config)
    return max(r["F1"] for r in results.values())


# The gate's training seeds, judged in turn: the first to reach F1 >= 0.9
# passes. F1 on 12 blobs a sample moves by about 0.07 an object, so a sound
# port misses the bar at some seeds (ROADMAP.md section 3): at the rate p
# measured a seed, it fails all n with probability (1 - p)^n, the binomial
# sum P(X < 1); GATE_FALSE_FAILURE holds that sum at p = 0.8, at or below
# the rate measured where the gate runs (CPU: 10/10 seeds at 1 thread,
# 27/30 at 8, 8/10 of them over seeds 0-9; the card: 13/15).
GATE_SEEDS = (0, 1, 2, 3, 4)
GATE_RATE = 0.8
GATE_FALSE_FAILURE = (1 - GATE_RATE) ** len(GATE_SEEDS)


def gate_over_seeds(work, device=None, iters=None):
    """The learning gate: :func:`learn_grid` at each of :data:`GATE_SEEDS`
    in turn until one reaches F1 >= 0.9, with the control that the first
    seed's step-0 checkpoint (``000000.pth``) reads F1 < 0.9. Returns
    ``(passed, runs, f1_start)``: ``runs`` one dict a seed tried."""
    runs = []
    for seed in GATE_SEEDS:
        seed_work = os.path.join(work, f"seed{seed}")
        f1, seg, best, launches, seconds, windows = learn_grid(seed_work, seed, device, iters)
        runs.append(dict(seed=seed, f1=f1, seg=seg, best=best, launches=launches,
                         seconds=seconds, windows=windows.round(1).tolist()))
        if seed == GATE_SEEDS[0]:
            f1_start = gate_f1(seed_work, "000000.pth", device)
        if f1 >= 0.9:
            return True, runs, f1_start
    return False, runs, f1_start


def gate_summary(passed, runs, f1_start):
    """One line: the seeds tried, the share that reached the bar, each
    seed's F1, and the control."""
    share = f"{sum(r['f1'] >= 0.9 for r in runs)}/{len(runs)}"
    seeds = ", ".join(f"seed {r['seed']} F1 {r['f1']:.4f} (SEG {r['seg']:.4f}, best_loss.pth "
                      f"from iteration {r['best']}, {r['seconds']:.1f}s)" for r in runs)
    return (f"{'passed' if passed else 'failed'}: {share} of the seeds tried reached F1 >= 0.9 "
            f"(the first of {len(GATE_SEEDS)} to reach it passes; a port that learns at p = "
            f"{GATE_RATE} a seed fails all with probability {GATE_FALSE_FAILURE:.2g}); {seeds}; "
            f"control: the step-0 checkpoint of seed {GATE_SEEDS[0]} reads F1 {f1_start:.4f}")


def phase_learn_grid(work):
    """``[learn-grid]``: the port's learning gate (:func:`gate_recipe`: grid
    loss, lr 1.5e-3, temperature 5, regularizer 2e-3, 1000 steps, infer on
    best_loss.pth) on the card, by the rule of :func:`gate_over_seeds`: the
    first of :data:`GATE_SEEDS` to reach F1 >= 0.9 passes, and the step-0
    checkpoint must read below the bar. Returns K2's launches."""
    passed, runs, f1_start = gate_over_seeds(os.path.join(work, "learn_grid"))
    if not f1_start < 0.9:
        fail(f"[learn-grid] the step-0 checkpoint reads F1 {f1_start:.4f}: the bar does not "
             "tell an untrained model apart")
    for r in runs:
        if r["launches"] != 6 * GATE_STEPS:
            fail(f"[learn-grid] conv3x3_dw launched {r['launches']} times in {GATE_STEPS} steps "
                 f"(seed {r['seed']})")
    if not passed:
        fail(f"[learn-grid] {gate_summary(passed, runs, f1_start)}; 50-step mean losses by "
             f"seed {[r['windows'] for r in runs]}")
    print(f"[learn-grid] the gate's recipe (grid, lr 1.5e-3, temperature 5, regularizer 2e-3, "
          f"{GATE_STEPS} steps) {gate_summary(passed, runs, f1_start)}; 50-step mean losses of "
          f"the passing seed {runs[-1]['windows']}; K2 launches {6 * GATE_STEPS} a seed",
          flush=True)
    return sum(r["launches"] for r in runs)


# -- [spd]: steps_per_dispatch = K as one CUDA graph of K steps ----------------------

SPD_K, SPD_STEPS, SPD_SEED = 4, 8, 3
# the warp's control points, as examples/2d/train.toml and train()'s defaults
SPD_CP_SPACING, SPD_CP_JITTER = 64, 2.0


class _RecordedPairs:
    """A pair sampler whose device draws are kept: each step's anchors and
    references, in the order the steps drew them."""

    def __init__(self, sampler):
        self.sampler, self.draws = sampler, []

    def __getattr__(self, name):
        return getattr(self.sampler, name)

    def device_sampler_grouped(self, device):
        sample = self.sampler.device_sampler_grouped(device)

        def recorded(generator, batch):
            out = sample(generator, batch)
            self.draws.append(out)
            return out

        return recorded


def _spd_setup(kind, net, dtype, device, batch, crop, model, density, kappa,
               count_mode="reference", elastic=False, input_scale=None, record=False,
               data_parallel=False, rows=slice(None)):
    """A step of ``kind`` ("pairs" with host pairs, "device_pairs", "grid",
    "dense") on ``net`` with a fresh optimizer (Adam capturable on the card,
    as in ``train``; with ``data_parallel`` it sums the gradients over the
    process group first, and a device-pairs step keeps ``rows`` of the
    batch's draws); returns ``(step, optimizer, key_driven, draws,
    trace)``.
    ``draws`` receives each step's draws (the pair sampler's, or grid's
    (jitter, idx), then the warp's (rotation, scale, control points)).
    ``elastic``: the warp runs on the card in front of the step, drawing
    from its generator, as ``train`` runs ``elastic_on_device`` (raw is a
    padded crop); ``input_scale``: raw ships in source units (native
    transfer). ``record``: ``trace`` receives, at each update, the
    parameters the step started from and its gradients (clones, so a
    captured step writes them at every replay)."""
    out = tuple(compute_geometry(crop, model["downsampling_factors"]).output_size)
    sampler = PairSampler(out, density=density, kappa=kappa, count_mode=count_mode)
    opt = make_optimizer(net.parameters(), LOSS_MODE_LR, data_parallel=data_parallel)
    trace = []
    if record:
        update = opt.step

        def step_and_record(*totals):
            params = [p.detach().clone() for p in opt.params]
            totals = update(*totals)
            # the gradients the update used (summed over the group's ranks)
            trace.append((params, [p.grad.detach().clone() for p in opt.params]))
            return totals

        opt.step = step_and_record
    if kind == "pairs":
        return make_train_step(net, opt, 10.0, 1e-5, dtype, input_scale), opt, False, [], trace
    if kind == "device_pairs":
        recorded = _RecordedPairs(sampler)
        step = make_train_step_fused(net, opt, 10.0, 1e-5, recorded, batch, dtype, device,
                                     input_scale, rows)
        draws = recorded.draws
    else:
        make = make_train_step_dense if kind == "dense" else make_train_step_grid
        inner = make(net, opt, 10.0, 1e-5, sampler, batch, dtype, device, input_scale)
        draws = []

        def step(raw, generator):
            d = inner.draw(generator)
            draws.append(d)
            return inner(raw, generator, draws=d)

    if elastic:
        deform = elastic_deform_batch(tuple(crop), SPD_CP_SPACING, SPD_CP_JITTER)
        warp_draws, loss_step = [], step

        def recorded_draw(*a, **k):
            out = draw_deformations(*a, **k)
            warp_draws.append(tuple(t for t in out if t is not None))
            return out

        def step(raw, generator):
            # the warp looks the draw up in its module at each call
            elastic_device.draw_deformations = recorded_draw
            try:
                warped = deform(raw, generator)
            finally:
                elastic_device.draw_deformations = draw_deformations
            result = loss_step(warped, generator)
            draws[-1] = tuple(draws[-1]) + warp_draws[-1]
            return result

    return step, opt, True, draws, trace


def _spd_batches(kind, batch, crop, model, density, kappa, count_mode="reference", n=SPD_STEPS,
                 seed=0, elastic=False, native=False):
    """``n`` loader-format batches ``(raw (B, 1, *crop), anchors, references)``
    of seeded random crops and host pairs; ``elastic``: padded crops, as the
    loader ships them for the warp on the card; ``native``: uint16."""
    rng = np.random.default_rng(seed)
    out = tuple(compute_geometry(crop, model["downsampling_factors"]).output_size)
    sampler = PairSampler(out, density=density, kappa=kappa, count_mode=count_mode)
    shape = tuple(crop)
    if elastic:
        shape = tuple(c + 2 * required_margin(tuple(crop), SPD_CP_JITTER) for c in crop)
    batches = []
    for _ in range(n):
        raw = rng.random((batch, 1, *shape), dtype=np.float32)
        if native:
            raw = (raw * 65535).astype(np.uint16)
        if kind == "pairs":
            pairs = [sampler.sample(rng) for _ in range(batch)]
            batches.append((raw, np.stack([a for a, _ in pairs]), np.stack([r for _, r in pairs])))
        else:
            batches.append((raw,))
    return batches


def _spd_run(kind, dtype, graphed, model, state, batches, crop, density, kappa,
             count_mode="reference", elastic=False, stale=False, record=False,
             data_parallel=False):
    """SPD_STEPS steps in chunks of SPD_K from ``state``; returns ``(losses,
    parameters, draws by step, chunks, K2 calls, trace by step)``, the trace
    (each step's starting parameters and gradients) when ``record``.
    ``stale``: every replay reuses the first chunk's generator seeds (the
    control)."""
    device = torch.device(DEVICE)
    net = random_unet(0, num_spatial_dims=len(crop), **model).to(device)
    net.load_state_dict(state)
    input_scale = _spd_input_scale(batches)
    step, opt, key_driven, draws, trace = _spd_setup(
        kind, net, dtype, device, batches[0][0].shape[0], crop, model, density, kappa,
        count_mode, elastic, input_scale, record, data_parallel)
    chunks = StepChunks(step, net, opt, device, key_driven, SPD_SEED, graphed=graphed)
    if stale:
        seed = chunks._seed
        chunks._seed = lambda it_start, k: seed(0, k)
    conv3x3_dw.launches = 0
    losses, drawn, traced = [], [], []
    for start in range(0, len(batches), SPD_K):
        chunk = batches[start:start + SPD_K]
        loss, _, _ = chunks.run(start, chunk)
        losses.append(loss.cpu())
        drawn += [tuple(t.clone() for t in d) for d in draws[-len(chunk):]]
        traced += [tuple([t.clone() for t in ts] for ts in entry)
                   for entry in trace[-len(chunk):]] if record else []
    torch.cuda.synchronize()
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    return torch.cat(losses), params, drawn, chunks, conv3x3_dw.launches, traced


def _spd_input_scale(batches):
    """Native transfer's scale when the batches hold source units."""
    dtype = batches[0][0].dtype
    return None if dtype == np.float32 else normalization_factor_for(dtype)


def _spd_step_gradients(kind, dtype, model, params, batch, iteration, crop, density, kappa,
                        count_mode, elastic, data_parallel=False):
    """The gradients of one eager step (iteration ``iteration``, its draws
    from the loop's generator) from the parameters ``params``."""
    device = torch.device(DEVICE)
    net = random_unet(0, num_spatial_dims=len(crop), **model).to(device)
    with torch.no_grad():
        for p, v in zip(net.parameters(), params):
            p.copy_(v)
    step, opt, key_driven, _, trace = _spd_setup(
        kind, net, dtype, device, batch[0].shape[0], crop, model, density, kappa, count_mode,
        elastic, _spd_input_scale([batch]), record=True, data_parallel=data_parallel)
    StepChunks(step, net, opt, device, key_driven, SPD_SEED, graphed=False).run(iteration, [batch])
    return trace[0][1]


def _relative_l2(a, b):
    """``|a - b| / |b|`` over lists of tensors taken as one vector."""
    diff = torch.cat([(x - y).float().reshape(-1) for x, y in zip(a, b)])
    return float(diff.norm()) / float(torch.cat([y.float().reshape(-1) for y in b]).norm())


def _spd_distance(a, b):
    """How far apart two runs end: the larger of the losses' largest
    relative difference and the parameters' relative L2 distance (all
    tensors as one vector)."""
    (la, pa), (lb, pb) = a, b
    loss = float(((la - lb).abs() / lb.abs()).max())
    return max(loss, _relative_l2([pa[k] for k in pb], list(pb.values())))


@contextlib.contextmanager
def _deterministic():
    """cuDNN off, and torch's deterministic kernels where it has them (the
    gather's backward sums in a fixed order), warning where it has none."""
    torch.backends.cudnn.enabled = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.enabled = True


def _spd_check(name, kind, dtype, model, crop, batch, density, kappa, count_mode="reference",
               control=False, elastic=False, native=False, data_parallel=False, tag="[spd]"):
    """The graphed chunk (SPD_K steps, two chunks) against eager steps from
    one state, with the same optimizer (Adam capturable in both, as train()
    runs it on the card at every K). Two bars:

    1. cuDNN off and torch's deterministic kernels on: the eager run goes
       three times; where it is bit-equal to itself the graph must be
       bit-equal to it; where not (atomic adds in a gather's backward), the
       graph's median distance from the three must stay within twice the
       largest distance between two of them. Key-driven steps also draw the
       same pairs (or grid (jitter, idx), and the warp's parameters) step by
       step. ``control``: a graph whose replays reuse the first chunk's
       seeds must fail the bar.
    2. cuDNN on, as training runs: there the graph's conv backward rounds
       apart from eager's (graph runs equal each other, eager runs equal
       each other), so each of the graph's steps is held to an eager step
       from the graph's own parameters before it, on the same batch and
       draws: the gradients' relative L2 distance must not exceed that
       eager step's distance from one with cuDNN off and the deterministic
       kernels (another algorithm on the same inputs). A buffer or
       workspace that a captured step reused wrongly would part the
       gradients by far more than rounding.

    ``elastic``/``native``: padded crops (uint16 when ``native``) warped on
    the card in front of the step; ``data_parallel``: every optimizer sums
    its gradients over this process's group (``[dp]``), so the graph holds
    the all_reduce. Returns the graphed run's K2 launches (warm-up steps and
    the captured calls times the replays)."""
    torch.manual_seed(SPD_SEED)
    state = random_unet(SPD_SEED, num_spatial_dims=len(crop), **model).state_dict()
    batches = _spd_batches(kind, batch, crop, model, density, kappa, count_mode,
                           elastic=elastic, native=native)
    args = (model, state, batches, crop, density, kappa, count_mode, elastic)
    dp = {"data_parallel": data_parallel}
    with _deterministic():
        eager = [_spd_run(kind, dtype, False, *args, **dp) for _ in range(3)]
        graph = _spd_run(kind, dtype, True, *args, **dp)
        stale = _spd_run(kind, dtype, True, *args, stale=True, **dp) if control else None
    own = max(_spd_distance(a[:2], b[:2]) for i, a in enumerate(eager) for b in eager[i + 1:])
    dist = float(np.median([_spd_distance(graph[:2], e[:2]) for e in eager]))
    bar = 2 * own
    if dist > bar:
        fail(f"{tag} {name}: the graph is {dist:.3g} from eager steps, eager {own:.3g} from "
             f"itself (bar {bar:.3g}; cuDNN off, deterministic kernels)")
    same_draws = len(graph[2]) == len(eager[0][2]) == SPD_STEPS and all(
        len(g) == len(e) and all(torch.equal(x, y) for x, y in zip(g, e))
        for g, e in zip(graph[2], eager[0][2]))
    if kind != "pairs" and not same_draws:
        fail(f"{tag} {name}: the graph's draws differ from the eager steps'")

    on_eager = _spd_run(kind, dtype, False, *args, **dp)
    on_graph = _spd_run(kind, dtype, True, *args, record=True, **dp)
    cudnn_dist = _spd_distance(on_graph[:2], on_eager[:2])
    step_args = (crop, density, kappa, count_mode, elastic, data_parallel)
    worst = (0.0, 0, 0.0, 0.0)  # (graph / other, step, graph, other)
    for j, (params_j, grads_j) in enumerate(on_graph[5]):
        eager_j = _spd_step_gradients(kind, dtype, model, params_j, batches[j], j, *step_args)
        with _deterministic():
            other_j = _spd_step_gradients(kind, dtype, model, params_j, batches[j], j, *step_args)
        d_graph, d_other = _relative_l2(grads_j, eager_j), _relative_l2(other_j, eager_j)
        if not d_graph <= d_other:
            fail(f"{tag} {name}, cuDNN on: step {j}'s gradients in the graph are {d_graph:.3g} "
                 f"from an eager step's from the same parameters, above that step's "
                 f"{d_other:.3g} from one with cuDNN off")
        ratio = d_graph / d_other if d_other else 0.0
        worst = max(worst, (ratio, j, d_graph, d_other))
    if len(on_graph[5]) != SPD_STEPS:
        fail(f"{tag} {name}: {len(on_graph[5])} steps traced, not {SPD_STEPS}")
    chunks, calls = on_graph[3], on_graph[4]
    per_step = on_eager[4] // SPD_STEPS
    launches = calls + per_step * SPD_K * (sum(chunks.replays.values()) - len(chunks.replays))
    line = (f"{tag} {name}: K = {SPD_K} graph vs eager over {SPD_STEPS} steps, cuDNN off and "
            f"deterministic kernels: "
            f"distance {dist:.3g} (median over 3 eager runs), eager vs eager {own:.3g} "
            f"({'bit-equal' if own == 0 else 'atomics'}), bar {bar:.3g}; "
            + (f"draws equal step by step ({len(graph[2])} steps"
               + (", the warp's too" if elastic else "") + "); " if kind != "pairs"
               else "host pairs; ")
            + f"cuDNN on: graph vs eager after {SPD_STEPS} steps {cudnn_dist:.3g}, each step's "
            f"gradients vs an eager step from the graph's parameters at most "
            f"{worst[0]:.3g} x that step's cuDNN-off distance (step {worst[1]}: {worst[2]:.3g} "
            f"vs {worst[3]:.3g}); K2 {per_step} a step, {launches} launches in the graphed run "
            f"with cuDNN ({StepChunks.WARMUP} warm-up steps + {per_step * SPD_K} captured x "
            f"{sum(chunks.replays.values())} replays)")
    if control:
        stale_dist = float(np.median([_spd_distance(stale[:2], e[:2]) for e in eager]))
        if stale_dist <= bar:
            fail(f"{tag} {name}: the stale-generator control passes the bar ({stale_dist:.3g})")
        line += f"; control (replays reuse the first chunk's seeds): {stale_dist:.3g} > bar, fails"
    print(line, flush=True)
    return launches


def _spd_time(name, kind, dtype, model, crop, batch, density, kappa, chunks_n=6,
              data_parallel=False, tag="[spd]"):
    """Step ms and peak GiB of eager steps (as at K = 1) and of the graphed
    chunk at SPD_K, on one state: the chunks after the first (the capture)
    timed on the host clock, each ending in its loss fetch."""
    device = torch.device(DEVICE)
    out = {}
    for graphed in (False, True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        net = random_unet(SPD_SEED, num_spatial_dims=len(crop), **model).to(device)
        step, opt, key_driven, _, _ = _spd_setup(kind, net, dtype, device, batch, crop, model,
                                                 density, kappa, data_parallel=data_parallel)
        chunks = StepChunks(step, net, opt, device, key_driven, SPD_SEED, graphed=graphed)
        batches = _spd_batches(kind, batch, crop, model, density, kappa, n=SPD_K)
        times = []
        for c in range(chunks_n):
            t0 = time.perf_counter()
            chunks.run(c * SPD_K, batches)[0].cpu()
            times.append(time.perf_counter() - t0)
        out[graphed] = {"ms": 1e3 * float(np.median(times[1:])) / SPD_K,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del net, step, opt, chunks
    print(f"{tag} {name} ({dtype}, {kind}, batch {batch} x {crop}): step eager "
          f"{out[False]['ms']:.3f} ms, graphed (K = {SPD_K}) {out[True]['ms']:.3f} ms "
          f"({out[False]['ms'] / out[True]['ms']:.2f}x); peak memory eager "
          f"{out[False]['peak_gib']:.3f} GiB, graphed {out[True]['peak_gib']:.3f} GiB", flush=True)
    return out


def _spd_train(work):
    """``train()`` at K = 4 against K = 1 on the gate's recipe (float32,
    grid): loss.csv rows within rtol 1e-5 over the first 8 rows; then
    resumes from chunk-boundary checkpoints across K."""
    container = _gate_container(work, "data.zarr")

    def run(k, iters, workdir, checkpoint=None):
        cfg = gate_recipe(container, 0, iters)
        cfg["train_config"].update(device=DEVICE, steps_per_dispatch=k, save_model_every=6,
                                   save_best_model_every=4)
        config = ExperimentConfig(**cfg)
        config.model_config.checkpoint = checkpoint
        os.makedirs(workdir, exist_ok=True)
        # a chunked run's snapshot at iteration 0 is a no-grad forward: K1
        # launches once a conv pass (3 in the gate's model)
        k1 = 3 if k > 1 and checkpoint is None else 0
        with contextlib.chdir(workdir), logged(os.path.join(workdir, "train.log")):
            state, _ = _run_train(config, k1_launches=k1)
        return np.asarray(state["logger_data"]["loss"]), workdir

    one, d1 = run(1, 12, os.path.join(work, "k1"))
    four, d4 = run(SPD_K, 12, os.path.join(work, "k4"))
    if not np.allclose(four[:8], one[:8], rtol=1e-5, atol=0):
        fail(f"[spd] train(): K = {SPD_K} losses {four[:8]} vs K = 1 {one[:8]}")
    names = sorted(p for p in os.listdir(os.path.join(d4, "models")) if p[0].isdigit())
    if names != ["000003.pth", "000007.pth", "000011.pth"]:
        fail(f"[spd] train(): K = {SPD_K} checkpoints {names}, expected the chunk ends 3, 7, 11")
    # a resume restarts the crop stream (as the JAX package's does) and
    # keys the draws by iteration: from one checkpoint, a resume at K = 1
    # and one at K = 4 must agree; a K = 4 checkpoint and a K = 1 one
    resumed = {}
    for label, ckpt, start in (("K=4 ckpt", os.path.join(d4, "models", "000007.pth"), 8),
                               ("K=1 ckpt", os.path.join(d1, "models", "000006.pth"), 7)):
        runs = {k: run(k, 12, os.path.join(work, f"{label[:3]}_resumed_at_{k}".replace("=", "")),
                       ckpt)[0] for k in (1, SPD_K)}
        history = four if label == "K=4 ckpt" else one
        for k, losses in runs.items():
            if len(losses) != 12 or not np.array_equal(losses[:start], history[:start]):
                fail(f"[spd] resume of the {label} at K = {k}: {len(losses)} rows, or a "
                     "history that is not the checkpoint's")
        a, b = runs[1][start:], runs[SPD_K][start:]
        if not np.allclose(b, a, rtol=1e-5, atol=0):
            fail(f"[spd] resume of the {label}: K = {SPD_K} losses {b} vs K = 1 {a}")
        resumed[label] = float(np.abs(b / a - 1).max())
    print(f"[spd] train() on the gate's recipe (f32 grid): K = {SPD_K} vs K = 1 loss.csv, first "
          f"8 rows, largest relative difference {np.abs(four[:8] / one[:8] - 1).max():.3g} "
          f"(bar 1e-5); K = {SPD_K} checkpoints at the chunk ends {names}; resumed at K = 1 and "
          f"at K = {SPD_K} from each checkpoint (12 rows, history carried), largest relative "
          f"difference of the resumed rows (bar 1e-5): "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in resumed.items()})}", flush=True)


def phase_spd(work):
    """``[spd]``: ``steps_per_dispatch = 4`` as one CUDA graph of 4 steps.
    The graphed chunk against eager steps at examples/2d's width (float32
    and bfloat16; grid, device pairs, host pairs; a stale-generator control;
    grid on uint16 crops warped on the card) and at examples/3d's (bf16,
    all_dims device pairs, with and without the warp on the card); ``train()`` at K = 4
    against K = 1 and resumes across K; step ms and peak memory graphed and
    eager at the gate's small model and at examples/2d's width. Returns K2's
    launches by input type."""
    spd = os.path.join(work, "spd")
    launches = {torch.float32: 0, torch.bfloat16: 0}
    crop2, crop3 = [CROP, CROP], list(CROP_3D)
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("grid", "device_pairs", "pairs"):
            launches[dtype] += _spd_check(
                f"2d {kind} {str(dtype).removeprefix('torch.')}", kind, dtype, MODEL, crop2,
                2, 0.1, 10.0, control=(kind == "grid" and dtype == torch.float32))
    # elastic_on_device in the graph: the warp's draws from the step's
    # generator, uint16 crops normalized by the step (native transfer)
    launches[torch.bfloat16] += _spd_check(
        "2d grid bfloat16, native uint16 + elastic on the card", "grid", torch.bfloat16, MODEL,
        crop2, 2, 0.1, 10.0, elastic=True, native=True)
    for elastic in (False, True):
        _spd_check("3d device_pairs bfloat16" + (", elastic on the card" if elastic else ""),
                   "device_pairs", torch.bfloat16, MODEL_3D, crop3, 2, 0.05, 6.0,
                   count_mode="all_dims", elastic=elastic)
    _spd_train(spd)
    _spd_time("gate model", "grid", torch.float32, GATE_MODEL, [76, 76], 4, 0.2, 5.0)
    _spd_time("examples/2d width", "device_pairs", torch.bfloat16, MODEL, crop2, TRAIN_BATCH,
              0.1, 10.0)
    return launches


# -- slice 12: dense in chunks, resume from a JAX .ckpt, multi-GPU (M13) -------------------


def phase_dense_spd(work):
    """``[dense-spd]``: ``loss_mode = "dense"`` at examples/2d's width (bf16,
    batch 8 x 252^2) as a K = 4 CUDA graph against eager steps, held by
    ``[spd]``'s bars (its R reference slices are one gather indexed on the
    card, so the step reads nothing on the host), with ms a step each way;
    then ``train()`` with ``steps_per_dispatch = 4`` in dense mode for two
    chunks. Returns K2's launches (the graphed check's, counted as ``[spd]``
    counts them, and the train run's: warm-up steps plus the captured calls
    times the replays)."""
    crop = [CROP, CROP]
    launches = _spd_check("2d dense bfloat16, batch 8", "dense", torch.bfloat16, MODEL, crop,
                          TRAIN_BATCH, 0.1, 10.0, tag="[dense-spd]")
    _spd_time("examples/2d width", "dense", torch.bfloat16, MODEL, crop, TRAIN_BATCH, 0.1, 10.0,
              tag="[dense-spd]")
    d = os.path.join(work, "dense-spd")
    os.makedirs(d)
    iters = 2 * SPD_K
    with contextlib.chdir(d), logged(os.path.join(d, "train.log")):
        config = train_config(os.path.join(work, "data.zarr"), MODEL, precision="bfloat16",
                              batch_size=TRAIN_BATCH, crop_size=crop, elastic_deform=False,
                              loss_mode="dense", steps_per_dispatch=SPD_K, max_iterations=iters,
                              save_best_model_every=10**6, save_model_every=10**6,
                              save_snapshot_every=10**6)
        t0 = time.perf_counter()
        # a chunk's snapshot is a forward of its own (K1's 3 passes): the
        # first chunk holds iteration 0
        state, calls = _run_train(config, k1_launches=3)
        wall = time.perf_counter() - t0
    # one capture: its warm-up steps launch, its captured calls run at each replay
    per_step = calls // (StepChunks.WARMUP + SPD_K)
    if calls != per_step * (StepChunks.WARMUP + SPD_K) or per_step != 6:
        fail(f"[dense-spd] train(): {calls} K2 calls, not 6 x ({StepChunks.WARMUP} warm-up + "
             f"{SPD_K} captured)")
    train_launches = per_step * (StepChunks.WARMUP + SPD_K * iters // SPD_K)
    print(f"[dense-spd] train(), loss_mode dense, steps_per_dispatch {SPD_K}: {iters} steps in "
          f"{wall:.2f}s (capture included), losses "
          f"{[round(v, 1) for v in state['logger_data']['loss']]}; K2 {calls} calls, "
          f"{train_launches} launches ({StepChunks.WARMUP} warm-up steps + {SPD_K} captured x "
          f"{iters // SPD_K} replays)", flush=True)
    return launches + train_launches


def _sorted_leaves(tree):
    """A nested dict's leaves in ``jax.tree_util.tree_leaves`` order: keys
    sorted at every level."""
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for key in sorted(tree) for leaf in _sorted_leaves(tree[key])]


def jax_train_state(state, names):
    """A port ``.pth`` train state in the JAX package's ``.ckpt`` layout
    (``cellulus_tpu/train.py:pack_state``): ``params`` by :func:`jax_params`,
    and ``opt_leaves`` as ``jax.tree_util.tree_leaves`` of the optax chain
    that examples/2d/train.toml configures (no grad-norm recorder, no
    schedule): ``scale_by_adam``'s count, then its mu and its nu over the
    params in sorted-key order. ``names`` are the parameters' names in the
    optimizer's order. The inverse of the port's ``adam_moments_from_jax``."""
    adam = state["optim_state_dict"]["state"]

    def moments(key):
        return _sorted_leaves(jax_params({n: adam[i][key] for i, n in enumerate(names)}))

    count = np.asarray(int(adam[0]["step"]), dtype=np.int32)
    return {"iteration": int(state["iteration"]), "lowest_loss": float(state["lowest_loss"]),
            "params": jax_params(state["model_state_dict"]),
            "opt_leaves": [count] + moments("exp_avg") + moments("exp_avg_sq"),
            "logger_data": {k: [float(v) for v in vs] for k, vs in state["logger_data"].items()}}


def phase_resume_ckpt(work, pth="000020.pth"):
    """``[resume-ckpt]``: ``[train]``'s last bf16 state (``models/000020.pth``,
    21 steps of examples/2d/train.toml's settings) written as a flax-format
    ``.ckpt`` with its Adam state as optax leaves (:func:`jax_train_state`),
    then 3 steps resumed from the ``.ckpt`` and 3 from the ``.pth``, with
    cuDNN off and torch's deterministic kernels: the two ``loss.csv`` files
    equal byte for byte, and so the final weights. Returns K2's launches."""
    pth = os.path.join(work, "models", pth)
    state = torch.load(pth, map_location="cpu", weights_only=True)
    names = [n for n, _ in random_unet(0, **MODEL).named_parameters()]
    ckpt = os.path.join(work, "resume-ckpt.ckpt")
    with open(ckpt, "wb") as f:
        f.write(flax_msgpack(jax_train_state(state, names)))
    runs, launches = {}, 0
    for kind, path in (("pth", pth), ("ckpt", ckpt)):
        d = os.path.join(work, f"resume-{kind}")
        os.makedirs(d)
        with contextlib.chdir(d), logged(os.path.join(d, "train.log")), _deterministic():
            config = train_config(os.path.join(work, "data.zarr"), MODEL, precision="bfloat16",
                                  max_iterations=int(state["iteration"]) + 4,
                                  crop_size=[CROP, CROP], batch_size=TRAIN_BATCH,
                                  elastic_deform=True, save_best_model_every=10**6,
                                  save_model_every=10**6, save_snapshot_every=10**6)
            config.model_config.checkpoint = path
            result, k2 = _run_train(config)
            with open("loss.csv") as f:
                runs[kind] = (f.read(), result)
        launches += k2
        if k2 != 6 * 3 or result["iteration"] != int(state["iteration"]) + 3:
            fail(f"[resume-ckpt] {kind}: iteration {result['iteration']}, {k2} K2 launches")
    if runs["pth"][0] != runs["ckpt"][0]:
        fail("[resume-ckpt] loss.csv after the resume from the .ckpt differs from the .pth's")
    weights = [k for k, v in runs["pth"][1]["model_state_dict"].items()
               if not torch.equal(v, runs["ckpt"][1]["model_state_dict"][k])]
    if weights:
        fail(f"[resume-ckpt] the final weights differ: {weights[:4]}")
    rows = runs["ckpt"][0].splitlines()
    count = int(state["optim_state_dict"]["state"][0]["step"])
    print(f"[resume-ckpt] [train]'s {os.path.basename(pth)} as a flax-format .ckpt "
          f"({os.path.getsize(ckpt)} bytes, {1 + 2 * len(names)} optax leaves, count {count}): "
          f"3 steps resumed from each, "
          f"cuDNN off, deterministic kernels: loss.csv bit-equal ({len(rows) - 1} rows, the last "
          f"{rows[-1]}), final weights bit-equal; K2 {launches} launches", flush=True)
    return launches


DP_STEPS = 3


def _dp_batches():
    """[dp]'s global batches: examples/2d/train.toml's batch of 8 crops of
    252^2 (device pairs drawn on the card)."""
    return _spd_batches("device_pairs", TRAIN_BATCH, [CROP, CROP], MODEL, 0.1, 10.0, n=DP_STEPS)


def dp_gloo_rank(rank, world, port, out):
    """A rank of ``[dp]`` (a): a gloo group of ``world`` ranks on ``cuda:0``,
    each stepping on its rows of the global batch (device pairs, bf16,
    examples/2d/train.toml's width) ``DP_STEPS`` times, eagerly; rank 0
    saves its losses, each step's starting parameters and summed gradients,
    and K2's launches to ``out``."""
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=world, rank=rank)
    try:
        device = torch.device(DEVICE)
        local = TRAIN_BATCH // world
        rows = slice(rank * local, (rank + 1) * local)
        net = random_unet(SPD_SEED, **MODEL).to(device)
        dist_mod.broadcast_parameters(net)
        step, opt, _, _, trace = _spd_setup(
            "device_pairs", net, torch.bfloat16, device, TRAIN_BATCH, [CROP, CROP], MODEL, 0.1,
            10.0, record=True, data_parallel=True, rows=rows)
        chunks = StepChunks(step, net, opt, device, True, SPD_SEED, graphed=False)
        conv3x3_dw.launches = 0
        losses = []
        t0 = time.perf_counter()
        for j, batch in enumerate(_dp_batches()):
            losses.append(chunks.run(j, [(batch[0][rows],)])[0].cpu())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if rank == 0:
            torch.save({"losses": torch.cat(losses), "trace": [([t.cpu() for t in p],
                                                                [t.cpu() for t in g])
                                                               for p, g in trace],
                        "k2": conv3x3_dw.launches, "seconds": seconds}, out)
    finally:
        torch.distributed.destroy_process_group()


def dp_nccl_rank(rank, port, out):
    """``[dp]`` (b): one NCCL rank on ``cuda:0``. ``[spd]``'s check of a K = 4
    graph against eager steps with every optimizer summing its gradients
    over the group (so each captured step holds the all_reduce), then ms a
    step graphed and eager in the group and with no group."""
    torch.distributed.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                         world_size=1, rank=0)
    try:
        calls = []
        reduce = dist_mod.reduce_gradients

        def counted(params, totals):
            calls.append(torch.cuda.is_current_stream_capturing())
            return reduce(params, totals)

        dist_mod.reduce_gradients = counted
        crop = [CROP, CROP]
        launches = _spd_check("2d device_pairs bfloat16, NCCL group of 1", "device_pairs",
                              torch.bfloat16, MODEL, crop, 2, 0.1, 10.0, data_parallel=True,
                              tag="[dp] (b)")
        captured = sum(calls)
        times = {name: _spd_time(f"examples/2d width, {name}", "device_pairs", torch.bfloat16,
                                 MODEL, crop, TRAIN_BATCH, 0.1, 10.0, data_parallel=dp,
                                 tag="[dp] (b)")
                 for name, dp in (("NCCL group of 1", True), ("no group", False))}
        if not captured:
            fail("[dp] (b): no all_reduce was called under graph capture")
        torch.save({"k2": launches, "captured": captured, "calls": len(calls),
                    "times": times}, out)
    finally:
        dist_mod.reduce_gradients = reduce
        torch.distributed.destroy_process_group()


def phase_dp(work):
    """``[dp]``: data-parallel training on the one card. (a) Two gloo ranks on
    ``cuda:0`` (gloo reduces CUDA tensors through the host; NCCL refuses
    two ranks on one GPU), examples/2d/train.toml's batch of 8 split 4 a
    rank, 3 eager steps: each step's summed gradients against one rank's
    eager step on the whole batch from the same parameters, held to
    ``[spd]``'s cuDNN bar (no farther than that step's gradients with
    cuDNN off and deterministic kernels). (b) One NCCL rank:
    ``steps_per_dispatch = 4`` as a CUDA graph holding the all_reduce,
    against eager steps, and ms a step against no group. NCCL across cards
    and peer copies stay unverified on a one-GPU card. Returns K2's
    launches by path."""
    import torch.multiprocessing as mp

    torch.cuda.empty_cache()
    out_a, out_b = os.path.join(work, "dp-gloo.pt"), os.path.join(work, "dp-nccl.pt")
    t0 = time.perf_counter()
    mp.spawn(dp_gloo_rank, args=(2, dist_mod.free_port(), out_a), nprocs=2, join=True)
    wall_a = time.perf_counter() - t0
    gloo = torch.load(out_a, weights_only=False)
    batches = _dp_batches()
    crop = [CROP, CROP]
    step_args = (crop, 0.1, 10.0, "reference", False)
    worst = (0.0, 0, 0.0, 0.0)
    for j, (params_j, grads_j) in enumerate(gloo["trace"]):
        params_j = [t.to(DEVICE) for t in params_j]
        grads_j = [t.to(DEVICE) for t in grads_j]
        eager_j = _spd_step_gradients("device_pairs", torch.bfloat16, MODEL, params_j,
                                      batches[j], j, *step_args)
        with _deterministic():
            other_j = _spd_step_gradients("device_pairs", torch.bfloat16, MODEL, params_j,
                                          batches[j], j, *step_args)
        d_dp, d_other = _relative_l2(grads_j, eager_j), _relative_l2(other_j, eager_j)
        if not d_dp <= d_other:
            fail(f"[dp] (a) step {j}: the 2 ranks' summed gradients are {d_dp:.3g} from one "
                 f"rank's on the whole batch, above that step's {d_other:.3g} with cuDNN off")
        worst = max(worst, (d_dp / d_other if d_other else 0.0, j, d_dp, d_other))
    # the losses of one rank on the whole batch from the same start
    net = random_unet(SPD_SEED, **MODEL).to(DEVICE)
    step, opt, _, _, _ = _spd_setup("device_pairs", net, torch.bfloat16, torch.device(DEVICE),
                                    TRAIN_BATCH, crop, MODEL, 0.1, 10.0)
    chunks = StepChunks(step, net, opt, torch.device(DEVICE), True, SPD_SEED, graphed=False)
    one_losses = torch.cat([chunks.run(j, [b])[0].cpu() for j, b in enumerate(batches)])
    loss_diff = float(((gloo["losses"] - one_losses).abs() / one_losses.abs()).max())
    print(f"[dp] (a) 2 gloo ranks on cuda:0, batch {TRAIN_BATCH} (4 a rank), bf16 device pairs, "
          f"{DP_STEPS} eager steps in {gloo['seconds']:.2f}s ({wall_a:.1f}s with the ranks' "
          f"start): losses {[round(float(v), 1) for v in gloo['losses']]} vs one rank "
          f"{[round(float(v), 1) for v in one_losses]} (largest relative difference "
          f"{loss_diff:.3g}); each step's summed gradients vs one rank's eager step from the "
          f"same parameters at most {worst[0]:.3g} x that step's cuDNN-off distance (step "
          f"{worst[1]}: {worst[2]:.3g} vs {worst[3]:.3g}); K2 {gloo['k2']} launches on rank 0",
          flush=True)
    t0 = time.perf_counter()
    mp.spawn(dp_nccl_rank, args=(dist_mod.free_port(), out_b), nprocs=1, join=True)
    wall_b = time.perf_counter() - t0
    nccl = torch.load(out_b, weights_only=False)
    group, none = nccl["times"]["NCCL group of 1"], nccl["times"]["no group"]
    print(f"[dp] (b) NCCL group of 1 ({wall_b:.1f}s with the rank's start): the all_reduce "
          f"called {nccl['calls']} times, {nccl['captured']} of them under graph capture; ms a "
          f"step graphed {group[True]['ms']:.3f} in the group vs {none[True]['ms']:.3f} with no "
          f"group, eager {group[False]['ms']:.3f} vs {none[False]['ms']:.3f}", flush=True)
    return {"dp (a) gloo, rank 0": gloo["k2"], "dp (b) nccl graphed": nccl["k2"]}


# [m13-predict]: the share of pixels the sharded-vs-tiled comparison may
# leave out (a zero draw's receptive field; 324 of 524,288 in a full run)
EXCLUDED_MAX = 0.005


def phase_m13_predict(work):
    """``[m13-predict]``: examples/2d's model (``[main]``'s weights) in bf16 on
    ``[main]``'s 2 x 512^2 samples over the device list ``["cuda:0",
    "cuda:0"]``: (1) the tile batch split over it, bit-equal to one device;
    (2) ``spatial_shards = 2`` over it against the tiled path at
    ``p_salt_pepper = 0``, no farther apart than the tiled path in bf16 is
    from itself in float32; (3) detect with samples round-robin over it,
    equal to serial. Seconds of each. Returns the launches by path."""
    container = os.path.join(work, "data.zarr")
    checkpoint = os.path.join(work, "weights.pth")
    two = [torch.device(DEVICE)] * 2
    net = UNet(1, 2, **MODEL)
    load_checkpoint(checkpoint, net)
    net = net.to(DEVICE).eval()
    raw_ds = zarr.open(container, "r")["raw"]
    nf = normalization_factor_for(raw_ds.dtype)
    raws = [np.asarray(raw_ds[s], np.float32) for s in range(2)]
    config = infer_config(container, checkpoint, MODEL, device=DEVICE, precision="bfloat16")
    ic = config.inference_config

    def run(settings, dtype=torch.bfloat16, devices=None):
        conv_pass_2d.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [predict_sample(net, raws[s], settings, nf, s, DEVICE, dtype, devices=devices)
                for s in range(2)]
        torch.cuda.synchronize()
        return np.stack(outs), time.perf_counter() - t0, conv_pass_2d.launches

    one, s_one, k1_one = run(ic)
    split, s_split, k1_split = run(ic, devices=two)
    if not np.array_equal(one, split):
        fail(f"[m13-predict] the tile batch split over 2 devices differs from one device: max "
             f"abs {np.abs(one - split).max():.3g}")
    # 3 passes a forward: a tile batch a forward on one device, a non-empty
    # chunk of it a forward on each of two
    batches = [len(c) for c in np.array_split(np.arange(9), range(TILE_BATCH, 9, TILE_BATCH))]
    want_one = 2 * 3 * len(batches)
    want_split = 2 * 3 * sum(min(2, b) for b in batches)
    if (k1_one, k1_split) != (want_one, want_split):
        fail(f"[m13-predict] K1 launched {k1_one} (one device) and {k1_split} (split) times, "
             f"expected {want_one} and {want_split}")
    # p_salt_pepper = 0: every TTA copy is the input, so both paths compute
    # one function of the same pixels, whole or in tiles
    quiet = dataclasses.replace(ic, p_salt_pepper=0.0)
    halves = dataclasses.replace(quiet, spatial_shards=2)
    tiled, s_tiled, _ = run(quiet)
    sharded, s_sharded, k1_sharded = run(halves, devices=two)
    tiled32, _, _ = run(quiet, torch.float32)
    sharded32, _, _ = run(halves, torch.float32, devices=two)

    # A draw of exactly 0 (2**-24 a draw: about one a sample here) is <= 0,
    # so it puts noise in one copy of one pixel even at p_salt_pepper = 0,
    # and the two paths draw apart: compare where every output's std channel
    # reads 0, i.e. where all the copies the pixel's receptive field saw
    # were the input; the mask comes from the outputs under test, so it may
    # leave out at most EXCLUDED_MAX of the pixels (a few draws' reach)
    clean = np.ones(tiled.shape[:1] + tiled.shape[2:], bool)
    for out in (tiled, sharded, tiled32, sharded32):
        clean &= out[:, -1] == 0
    excluded = int(clean.size - clean.sum())
    if excluded > EXCLUDED_MAX * clean.size:
        fail(f"[m13-predict] spatial_shards = 2 against the tiled path: {excluded} of "
             f"{clean.size} pixels have a std channel above 0 (bar {EXCLUDED_MAX:.1%})")

    def rel_l2(a, b):
        a, b = np.moveaxis(a, 1, -1)[clean], np.moveaxis(b, 1, -1)[clean]
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    # float32 (K1 as 3xTF32, TF32 off elsewhere): the library's GEMMs and
    # reductions sum in other orders at other shapes, nothing more
    d32 = rel_l2(sharded32, tiled32)
    # bf16: each path rounds the same f32 function on its own; the sharded
    # output no farther from float32's than twice the tiled one is
    d16, bar16 = rel_l2(sharded, tiled32), 2 * rel_l2(tiled, tiled32)
    if (not np.isfinite(sharded).all() or sharded.shape != tiled.shape
            or not np.isfinite([d32, d16, bar16]).all() or d32 > 1e-5 or d16 > bar16):
        fail(f"[m13-predict] spatial_shards = 2 against the tiled path: float32 relative L2 "
             f"{d32:.3g} (bar 1e-5), bf16 {d16:.3g} from the float32 tiled output (bar "
             f"{bar16:.3g}, twice the bf16 tiled output's)")
    if k1_sharded != 2 * 2 * 3:
        fail(f"[m13-predict] the sharded forward launched K1 {k1_sharded} times, not 12")

    ic.bandwidth = 0.5 * config.object_size
    ic.min_size = int(0.1 * np.pi * (config.object_size**2) / 4)
    detected, seconds, fits = {}, {}, {}
    for name, devices in (("serial", None), ("round-robin", two)):
        copy = os.path.join(work, f"m13-{name}.zarr")
        shutil.copytree(container, copy)
        zarr.open(copy, "a")["embeddings"] = one
        ic_copy = infer_config(copy, checkpoint, MODEL, device=DEVICE, precision="bfloat16",
                               bandwidth=ic.bandwidth, min_size=ic.min_size).inference_config
        mean_shift_fit.launches = 0
        t0 = time.perf_counter()
        with logged(os.path.join(work, f"m13-{name}.log")):
            detect_stage(ic_copy, DEVICE, devices=devices)
        seconds[name] = time.perf_counter() - t0
        fits[name] = mean_shift_fit.launches
        f = zarr.open(copy, "r")
        detected[name] = {n: f[n][...] for n in ("detection", "binary-segmentation",
                                                  "centered-embeddings")}
    differing = [n for n, v in detected["serial"].items()
                 if not np.array_equal(v, detected["round-robin"][n])]
    if differing or fits != {"serial": 2, "round-robin": 2}:
        fail(f"[m13-predict] round-robin detect: {differing} differ from serial, fits {fits}")
    print(f"[m13-predict] examples/2d's model bf16, 2 x {IMAGE_SIZE}^2: tile batch over "
          f"['cuda:0', 'cuda:0'] bit-equal to one device, {s_split:.3f}s vs {s_one:.3f}s (K1 "
          f"{k1_split} vs {k1_one} launches); spatial_shards = 2 at p_salt_pepper 0 "
          f"{s_sharded:.3f}s vs tiled {s_tiled:.3f}s (bf16, K1 {k1_sharded}), relative L2 from "
          f"tiled {d32:.3g} in float32, bf16 {d16:.3g} from float32's vs tiled bf16's "
          f"{bar16 / 2:.3g}, over the {clean.sum()} pixels no draw of exactly 0 reached "
          f"({excluded} excluded); detect round-robin "
          f"{seconds['round-robin']:.3f}s vs serial "
          f"{seconds['serial']:.3f}s, the three datasets bit-equal, {fits['round-robin']} fits",
          flush=True)
    return {"tile split": k1_split, "spatial_shards 2": k1_sharded,
            "round-robin detect": fits["round-robin"]}


def _warp_check(device):
    """The warp for given parameters (rotation, scale, control points) on
    the card against the CPU, 2D and 3D: grid within 1e-4 (coordinates
    below 200; the two ``cos``/``sin`` and resize sums may round apart), and
    the sampled crop within 1e-4 x max|input| (a grid coordinate 1e-4 apart
    moves a linear sample by at most that times the local slope)."""
    worst = {}
    for ndim, crop in ((2, (252, 252)), (3, (24, 44, 44))):
        margin = required_margin(crop, 2.0)
        padded_shape = tuple(c + 2 * margin for c in crop)
        gen = torch.Generator().manual_seed(25 + ndim)
        padded = torch.rand((2, *padded_shape, 1), generator=gen)
        params = draw_deformations(gen, 2, crop, 64, 2.0, "cpu")
        grids, crops = {}, {}
        for dev in ("cpu", device):
            p = [t.to(dev) for t in params]
            grids[dev] = deformation_grid(crop, padded_shape, *p).cpu()
            crops[dev] = map_coordinates_linear(padded.to(dev), grids[dev].to(dev)).cpu()
        grid_err = float((grids[device] - grids["cpu"]).abs().max())
        crop_err = float((crops[device] - crops["cpu"]).abs().max())
        if not (grid_err <= 1e-4 and crop_err <= 1e-4):
            fail(f"[3d-elastic] {ndim}D warp card vs CPU: grid err {grid_err:.3g}, crop err "
                 f"{crop_err:.3g} (limits 1e-4)")
        worst[ndim] = (grid_err, crop_err)
    return worst


def phase_3d_elastic(work):
    """``[3d-elastic]``: tests/test_quality_3d_gate.py's bundle as written
    (on-device elastic, device pairs, all_dims, density 0.025, lr 4e-4, 60
    steps, 12 fmaps) on the card: every loss finite and below 3 x the first,
    then predict -> detect -> segment on best_loss.pth, embeddings finite
    and instances found; and the warp itself, card against CPU."""
    warp = _warp_check(DEVICE)
    gate = os.path.join(work, "gate3d")
    size, steps = 48, GATE_STEPS_3D
    container = _gate_container(gate, "data.zarr", ndim=3, size=size)
    model = dict(num_fmaps=12, fmap_inc_factor=2, features_in_last_layer=24,
                 downsampling_factors=[[1, 2, 2]])
    config = train_config(
        container, model, batch_size=2, kappa=5.0, loss_mode="pairs",
        pair_count_mode="all_dims", density=0.025, crop_size=[24, 44, 44],
        max_iterations=steps, initial_learning_rate=4e-4, num_workers=0, elastic_deform=True,
        elastic_on_device=True, device_pair_sampling=True, steps_per_dispatch=1,
        save_model_every=steps - 1, save_snapshot_every=10**9, save_best_model_every=20)
    config.object_size = int(size * 0.13)
    # the 3D density envelope warns for the gate's recipe, as in the JAX
    # package; the phase checks its outcome instead
    with contextlib.chdir(gate), logged(os.path.join(gate, "train.log")), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        t0 = time.perf_counter()
        state, _ = _run_train(config)
        seconds = time.perf_counter() - t0
        losses = np.asarray(state["logger_data"]["loss"])
        if len(losses) != steps or not losses.max() < 3 * losses[0]:
            fail(f"[3d-elastic] {len(losses)} losses, first {losses[0]:.4g}, max "
                 f"{losses.max():.4g} (limit 3 x the first)")
        ic = infer_config(container, os.path.join("models", "best_loss.pth"), model,
                          device=DEVICE, crop_size=[24, 44, 44], tile_batch_size=4,
                          num_infer_iterations=2, object_size=config.object_size)
        ic.inference_config.evaluation_dataset_config = None
        cellulus_tpu_torch.infer(ic)
    f = zarr.open(container, "r")
    emb, seg = f["embeddings"][...], f["segmentation"][...]
    if emb.shape != (1, 4, size, size, size) or not np.isfinite(emb).all() or seg.max() < 1:
        fail(f"[3d-elastic] embeddings {emb.shape} finite {np.isfinite(emb).all()}, "
             f"instances {int(seg.max())}")
    print(f"[3d-elastic] warp card vs CPU for given parameters: 2D (252^2, 2 crops) grid "
          f"{warp[2][0]:.3g}, crop {warp[2][1]:.3g}; 3D (24x44x44) grid {warp[3][0]:.3g}, crop "
          f"{warp[3][1]:.3g} (limits 1e-4)", flush=True)
    print(f"[3d-elastic] tests/test_quality_3d_gate.py's bundle, {steps} steps in "
          f"{seconds:.1f}s: losses first/max/last {losses[0]:.4g} / {losses.max():.4g} / "
          f"{losses[-1]:.4g}, all finite, max < 3 x first; infer on best_loss.pth: embeddings "
          f"{emb.shape} finite, {int(seg.max())} instances", flush=True)


def phase_native(work):
    """``[native]``: a 2D run at the full width of examples/2d with
    ``transfer_precision="native"`` and ``elastic_on_device`` (grid loss,
    bf16, batch 8); then its padded crops, which ship as uint16, warped on
    the card and normalized by the step's multiply, against the float32
    path's crops warped with the same parameters (float32, rtol 1e-6: four
    non-negative products summed and a scale, in either order, round apart
    by a few ulps); and the upload of a batch of padded crops in either
    dtype, timed as the train loop does it."""
    container = os.path.join(work, "data.zarr")  # uint16, written by [main]
    steps = 10
    with contextlib.chdir(work), logged(os.path.join(work, "native.log")):
        config = train_config(container, MODEL, precision="bfloat16", max_iterations=steps,
                              crop_size=[CROP, CROP], batch_size=TRAIN_BATCH, loss_mode="grid",
                              elastic_deform=True, elastic_on_device=True,
                              transfer_precision="native", save_best_model_every=10**6,
                              save_model_every=10**6, save_snapshot_every=10**6)
        step_times = []
        # the snapshot at iteration 0 runs the padded crop through K1's 3 passes
        state, launches = _run_train(config, step_times, k1_launches=3)
    if launches != 6 * steps:
        fail(f"[native] conv3x3_dw launched {launches} times in {steps} steps")
    step_ms = 1e3 * float(np.median(np.diff(step_times[1:-1])))

    kw = dict(crop_size=(CROP, CROP), elastic_deform=True, control_point_spacing=64,
              control_point_jitter=2.0, density=0.1, kappa=10.0, normalization_factor=None,
              seed=3, sample_pairs=False, elastic_device=True)
    cfg = DatasetConfig(container_path=container, dataset_name="raw")
    native = get_dataset(cfg, normalize=False, **kw)
    plain = get_dataset(cfg, **kw)
    n_it, p_it = native.iterate(5), plain.iterate(5)
    batch_n = torch.from_numpy(np.stack([next(n_it)[0] for _ in range(4)])).movedim(1, -1)
    batch_p = torch.from_numpy(np.stack([next(p_it)[0] for _ in range(4)])).movedim(1, -1)
    if batch_n.dtype != torch.uint16 or batch_p.dtype != torch.float32:
        fail(f"[native] crops ship as {batch_n.dtype}, the float32 path's as {batch_p.dtype}")

    def upload_ms(batch):
        """Median ms of the train loop's upload of one batch (channels-last
        copy on the host, then to the card), over 20."""
        times = []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.from_numpy(np.ascontiguousarray(np.moveaxis(batch, 1, -1))).to(DEVICE)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times[1:]))

    full_n = np.stack([next(n_it)[0] for _ in range(TRAIN_BATCH)])
    full_p = np.stack([next(p_it)[0] for _ in range(TRAIN_BATCH)])
    upload = {"native": (full_n.nbytes, upload_ms(full_n)),
              "float32": (full_p.nbytes, upload_ms(full_p))}
    params = [t.to(DEVICE) for t in draw_deformations(
        torch.Generator().manual_seed(26), 4, (CROP, CROP), 64, 2.0, "cpu")]
    grid = deformation_grid((CROP, CROP), tuple(batch_n.shape[1:-1]), *params)
    got = _prep_raw(map_coordinates_linear(batch_n.to(DEVICE), grid),
                    native.normalization_factor, torch.float32)
    want = map_coordinates_linear(batch_p.to(DEVICE), grid)
    err = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
    if not err <= 1e-6:
        fail(f"[native] normalized native crops vs the float32 path's: max rel err {err:.3g}")
    print(f"[native] examples/2d width, native transfer + elastic on the card (grid, bf16, "
          f"batch {TRAIN_BATCH}): {steps} steps, median step {step_ms:.1f} ms, losses first/last "
          f"{state['logger_data']['loss'][0]:.1f} / {state['logger_data']['loss'][-1]:.1f}, K2 "
          f"launches {launches}; 4 padded crops ({tuple(batch_n.shape[1:3])}, uint16 source "
          f"units) warped on the card and normalized by the step's multiply vs the float32 "
          f"path's warped crops: max rel err {err:.3g} (rtol 1e-6); upload of a batch of "
          f"{TRAIN_BATCH} padded crops: " + ", ".join(
              f"{k} {b / 2**20:.2f} MiB in {ms:.3f} ms" for k, (b, ms) in upload.items()),
          flush=True)
    return launches


def _load_script(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _nucleus_differences(det, raw, host, card, card_thr):
    """Where the host and device nucleus partitions of detections ``det``
    differ: ``(differing pixels, nested instances, instances whose card
    threshold is not the host's, details of the pixels neither explains)``.
    Nesting (``ops/nucleus.py``) explains a pixel in a cavity the device
    path left empty (an interior axis-connected component of its zeros whose
    neighbours carry two ids or more) or in an instance bordering one, and a
    pixel the host's fill of one instance wrote over another's (both labels
    non-zero, unequal). ``card_thr`` are the card's per-id thresholds
    (``otsu_per_id``): an instance whose card threshold differs from the
    host's (float32 sums that land on another bin at a near-tie of Otsu's
    variance, against the host's float64) explains the differences at its
    pixels and at the pixels either side labels with it."""
    from scipy import ndimage as ndi

    diff = host != card
    zero = card == 0
    comp, _ = ndi.label(zero)
    border = np.zeros(zero.shape, bool)
    for axis in range(zero.ndim):
        border[(slice(None),) * axis + (0,)] = border[(slice(None),) * axis + (-1,)] = True
    on_border = set(np.unique(comp[border]).tolist())
    nested = set()
    explained = diff & (host != 0) & (card != 0)
    for a, b in set(zip(host[explained].tolist(), card[explained].tolist())):
        nested |= {a, b}
    for c in np.unique(comp[diff & zero]).tolist():
        if c == 0 or c in on_border:
            continue
        cavity = comp == c
        ids = set(np.unique(card[ndi.binary_dilation(cavity) & ~cavity]).tolist()) - {0}
        if len(ids) >= 2:
            explained |= cavity
            nested |= ids
    if nested:
        explained |= np.isin(card, list(nested)) | np.isin(host, list(nested))
    rest = diff & ~explained
    moved = [i for i in set(np.concatenate([det[rest], host[rest], card[rest]]).tolist()) - {0}
             if abs(threshold_otsu(raw[det == i]) - float(card_thr[i])) > 1e-6]
    left = rest & ~(np.isin(det, moved) | np.isin(host, moved) | np.isin(card, moved))
    details = [(tuple(int(v) for v in p), int(det[tuple(p)]), float(raw[tuple(p)]),
                int(host[tuple(p)]), int(card[tuple(p)])) for p in np.argwhere(left)[:5]]
    return int(diff.sum()), len(nested), len(moved), details


def phase_hela(work):
    """``[hela]``: scripts/run_real_hela.py's recipe on the vendored panels
    through the port (scripts/torch_real_hela.py): HELA_STEPS bf16 steps with
    host elastic, infer on best_loss.pth in nucleus mode against the silver
    truth, then the same detections in nucleus mode on the card
    (``device_nucleus``) and in cell mode. At the full 5,000 steps nucleus
    must beat cell mode on F1 and reach F1 >= 0.8. The device nucleus
    partition of every bandwidth's detections must equal the host's but at
    nested instances and at instances whose card threshold is not the
    host's, both counted."""
    hela = _load_script("torch_real_hela")
    with open(os.path.join(work, "hela.log"), "w") as log:
        r = hela.run_hela(os.path.join(work, "hela"), HELA_STEPS, DEVICE, log=log)
    nucleus, device_nucleus, cell = r["nucleus"], r["nucleus_device"], r["cell"]
    full = HELA_STEPS == 5000
    if full and not (nucleus["F1"] > cell["F1"] and nucleus["F1"] >= 0.8):
        fail(f"[hela] nucleus F1 {nucleus['F1']:.4f} (cell {cell['F1']:.4f}): the bar is "
             "nucleus > cell and nucleus >= 0.8")
    out = zarr.open(os.path.join(work, "hela", "out.zarr"), "r")
    det = np.asarray(out["detection"][0])
    raw = np.asarray(zarr.open(os.path.join(work, "hela", "panel.zarr"), "r")["train"][0, 0])
    counts = []
    for k in range(det.shape[0]):
        host = nucleus_partition(det[k], raw)
        seg = torch.from_numpy(det[k].astype(np.int64)).to(DEVICE)
        card = nucleus_partition_device(seg, torch.from_numpy(raw).to(DEVICE)).cpu().numpy()
        card_thr = otsu_per_id(seg.reshape(-1), torch.from_numpy(raw).to(DEVICE).reshape(-1),
                               int(det[k].max()) + 1)[0].cpu().numpy()
        differing, nested, moved, left = _nucleus_differences(det[k], raw,
                                                              host.astype(np.int64), card,
                                                              card_thr)
        if left:
            fail(f"[hela] bandwidth {k}: the device nucleus partition differs from the host's "
                 f"outside nested instances and moved thresholds, at (pixel, id, raw, host, "
                 f"card) {left}")
        counts.append([differing, nested, moved])
    print(f"[hela] {'full recipe' if full else 'cut recipe (no F1 bar)'}: {HELA_STEPS} steps in "
          f"{r['train_seconds']:.1f}s, best_loss.pth from iteration {r['best_iteration']}; "
          f"nucleus F1 {nucleus['F1']:.4f} SEG {nucleus['SEG']:.4f} (bandwidth "
          f"{nucleus['bandwidth']}), device nucleus F1 {device_nucleus['F1']:.4f} SEG "
          f"{device_nucleus['SEG']:.4f}, cell F1 {cell['F1']:.4f} SEG {cell['SEG']:.4f} "
          f"(bandwidth {cell['bandwidth']}); per bandwidth (F1, SEG) nucleus "
          f"{json.dumps(nucleus['per_bandwidth'])}, device nucleus "
          f"{json.dumps(device_nucleus['per_bandwidth'])}, cell "
          f"{json.dumps(cell['per_bandwidth'])}", flush=True)
    print(f"[hela] device vs host nucleus partition per bandwidth [differing pixels, nested "
          f"instances, instances whose card threshold is not the host's]: {counts} (nothing "
          f"else differs)", flush=True)
    return r


STAGE_OUTPUTS = ("embeddings", "detection", "binary-segmentation", "centered-embeddings",
                 "segmentation")
WIDE_SAMPLES = 4


def _route(ic, container, out):
    """Raw data from ``container``'s ``raw``; every stage's output to ``out``."""
    ic.dataset_config.container_path, ic.dataset_config.dataset_name = container, "raw"
    for dc in (ic.prediction_dataset_config, ic.detection_dataset_config,
               ic.segmentation_dataset_config, ic.evaluation_dataset_config):
        if dc is not None:
            dc.container_path = out


def _stage_groundtruth(container, out):
    src = zarr.open(container, "r")["groundtruth"]
    dst = zarr.open(out, "a")
    dst["groundtruth"] = src[...]
    dst["groundtruth"].attrs.update(src.attrs.asdict())


def _differing_outputs(a, b):
    """The stage datasets that differ between containers ``a`` and ``b``,
    with the largest difference of each."""
    fa, fb = zarr.open(a, "r"), zarr.open(b, "r")
    out = {}
    for name in STAGE_OUTPUTS:
        x, y = fa[name][...], fb[name][...]
        if x.shape != y.shape or not np.array_equal(x, y):
            out[name] = (float(np.abs(x.astype(np.float64) - y).max())
                         if x.shape == y.shape else f"shapes {x.shape} {y.shape}")
    return out


def _run_both_paths(config, work, name, container, launched=(),
                    modes=("pipelined", "staged")):
    """``cellulus_tpu_torch.infer`` by each of ``modes`` in turn
    (``"pipelined"``, ``"staged"``, or ``"pipelined again"``) on the same
    inputs (outputs in ``<name>-<mode>.zarr``, ground truth staged in when
    the config evaluates), each with the kernel counts of ``launched`` set
    to 0 just before it. Returns per mode its results, stage seconds, wall
    time, sample intervals and launches."""
    import copy

    runs = {}
    for mode in modes:
        cfg = copy.deepcopy(config)
        ic = cfg.inference_config
        ic.pipelined = mode.startswith("pipelined")
        out = os.path.join(work, f"{name}-{mode.replace(' ', '-')}.zarr")
        _route(ic, container, out)
        if ic.evaluation_dataset_config is not None:
            _stage_groundtruth(container, out)
        for fn in launched:
            fn.launches = 0
        stage_seconds, intervals = {}, {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.chdir(work), logged(os.path.join(work, f"{name}-{mode}.log")):
            results = cellulus_tpu_torch.infer(cfg, stage_seconds, intervals)
        torch.cuda.synchronize()
        runs[mode] = dict(results=results, seconds=stage_seconds, wall=time.perf_counter() - t0,
                          intervals=intervals, out=out,
                          launches={fn.__name__: fn.launches for fn in launched})
    return runs


def _overlaps(intervals):
    """``(s, t)`` where sample s's detect+segment (worker) overlaps the
    predict of a later sample t (calling thread)."""
    pairs = []
    for s, (d0, _) in intervals["detect"].items():
        g1 = intervals["segment"][s][1]
        for t, (p0, p1) in intervals["predict"].items():
            if t > s and d0 < p1 and p0 < g1:
                pairs.append((s, t))
    return pairs


def _interval_table(intervals):
    """Each sample's predict and detect+segment intervals (s) from the first
    predict's start."""
    origin = min(p0 for p0, _ in intervals["predict"].values())
    rows = []
    for s in sorted(intervals["predict"]):
        p0, p1 = intervals["predict"][s]
        d0, g1 = intervals["detect"][s][0], intervals["segment"][s][1]
        rows.append(f"{s}: predict {p0 - origin:.3f}-{p1 - origin:.3f}, detect+segment "
                    f"{d0 - origin:.3f}-{g1 - origin:.3f}")
    return "; ".join(rows)


def phase_wide_main(work):
    """``[wide-main]``: examples/real-data/infer.toml as written (256 fmaps,
    factor 3, bf16, crop 252, tile batch 4, ``pipelined = true``, its
    checkpoint line read by the rule as the port's ``models/best_loss.pth``;
    only the datasets and the device are set) on WIDE_SAMPLES
    synthetic 512^2 samples with seeded weights, then the staged path on the
    same inputs: the five stage datasets bit-equal, some sample's
    detect+segment (a worker) overlapping a later sample's predict (the
    calling thread), K1 and fit launches WIDE_SAMPLES times one sample's
    (K1 every pass, the bottom one by its staged route). Returns each path's
    launches."""
    wide = os.path.join(work, "wide")
    os.makedirs(wide)
    container = write_blob_container(os.path.join(wide, "data.zarr"), WIDE_SAMPLES, IMAGE_SIZE,
                                     seed=15)
    # the TOML's checkpoint line, models/best_loss.ckpt, is kept: infer reads
    # the port's models/best_loss.pth beside it by the rule
    os.makedirs(os.path.join(wide, "models"))
    save_random_checkpoint(os.path.join(wide, "models", "best_loss.pth"), seed=16, **MODEL_WIDE)
    config = ExperimentConfig.from_toml(os.path.join(REPO, "examples", "real-data", "infer.toml"))
    mc, ic = config.model_config, config.inference_config
    if ({k: getattr(mc, k) for k in MODEL_WIDE} != MODEL_WIDE or ic.precision != "bfloat16"
            or ic.crop_size != [CROP, CROP] or ic.tile_batch_size != TILE_BATCH
            or not ic.pipelined or str(mc.checkpoint) != "models/best_loss.ckpt"):
        fail("examples/real-data/infer.toml differs from the settings this script assumes")
    ic.device = DEVICE
    torch.cuda.reset_peak_memory_stats()
    # pipelined, staged, pipelined again: the first run pays the stage
    # workers' first CUDA calls in new threads, the second is warm as the
    # staged run is
    runs = _run_both_paths(config, wide, "wide", container, (conv_pass_2d, mean_shift_fit),
                           modes=("pipelined", "staged", "pipelined again"))
    piped, staged, again = runs["pipelined"], runs["staged"], runs["pipelined again"]
    for mode in runs:
        with open(os.path.join(wide, f"wide-{mode}.log")) as f:
            rule = [line.strip() for line in f if RULE_LINE in line]
        if len(rule) != 1:
            fail(f"[wide-main] {mode}: {len(rule)} lines of the .ckpt rule, expected 1")
    print(f"[wide-main] the checkpoint line kept; the rule's line: {rule[0]!r}", flush=True)
    for run in (piped, again):
        differing = _differing_outputs(run["out"], staged["out"])
        if differing:
            fail(f"[wide-main] pipelined and staged outputs differ (dataset: max abs "
                 f"difference) {differing}")
    f = zarr.open(piped["out"], "r")
    emb, seg = f["embeddings"][...], f["segmentation"][...]
    if emb.shape != (WIDE_SAMPLES, 3, IMAGE_SIZE, IMAGE_SIZE) or not np.isfinite(emb).all():
        fail(f"[wide-main]: embeddings {emb.shape}, finite={np.isfinite(emb).all()}")
    if seg.shape != (WIDE_SAMPLES, 1, IMAGE_SIZE, IMAGE_SIZE):
        fail(f"[wide-main]: segmentation shape {seg.shape}")
    out_tile = compute_geometry((CROP, CROP), MODEL_WIDE["downsampling_factors"]).output_size
    tiles = math.prod(len(tile_origins(max(IMAGE_SIZE, o), o)) for o in out_tile)
    expected = {"conv_pass_2d": WIDE_SAMPLES * 3 * math.ceil(tiles / TILE_BATCH),
                "mean_shift_fit": WIDE_SAMPLES}  # 3 passes a tile batch, 1 fit a sample
    for mode, run in runs.items():
        if run["launches"] != expected:
            fail(f"[wide-main] {mode}: launches {run['launches']}, expected {expected}")
    overlaps = _overlaps(piped["intervals"])
    for label, run in (("pipelined", piped), ("pipelined again", again)):
        print(f"[wide-main] {label}, per sample on one host clock (s): "
              f"{_interval_table(run['intervals'])}", flush=True)
    if not overlaps:
        fail("[wide-main] no sample's detect+segment overlapped a later sample's predict")
    plans = [f"{name} {conv_pass.conv_pass_2d_plan(shape, c, torch.bfloat16)}"
             for name, shape, c in pass_shapes(TILE_BATCH * 2 * NUM_INFER_ITERATIONS, MODEL_WIDE)]
    staged_sum = sum(staged["seconds"][k] for k in ("predict", "detect", "segment"))
    print(f"[wide-main] examples/real-data/infer.toml as written (bf16, pipelined) on "
          f"{WIDE_SAMPLES} x {IMAGE_SIZE}^2: predict+detect+segment pipelined "
          f"{piped['seconds'][PIPELINED_STAGE]:.3f}s, again "
          f"{again['seconds'][PIPELINED_STAGE]:.3f}s, against the staged stages' sum "
          f"{staged_sum:.3f}s "
          f"({json.dumps({k: round(v, 3) for k, v in staged['seconds'].items()})}); the five "
          f"datasets bit-equal; detect+segment of sample s overlaps predict of sample t at "
          f"(s, t) {overlaps}; K1 plans {plans}; launches a path {json.dumps(piped['launches'])}"
          f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
          f"{int(len(np.unique(seg[0])) - 1)} instances in sample 0", flush=True)
    return {mode: run["launches"] for mode, run in runs.items()}


# -- [ckpt]: the example TOML's checkpoint line as written -------------------------------

RULE_LINE = "does not exist: reading"


def jax_params(state_dict):
    """The JAX package's params tree (``{"down": {"level<l>": {"conv<i>":
    {"w", "b"}}}, "up": .., "up_tconv": .., "head": ..}``, weights ``(*K,
    C_in, C_out)``) of a funlib-named state dict: the inverse of
    ``cellulus_tpu_torch.models.state_dict_from_jax_params``."""
    tree = {"down": {}, "up": {}, "head": {}}
    patterns = ((r"backbone\.l_conv\.(\d+)\.conv_pass\.(\d+)", "down"),
                (r"backbone\.r_conv\.0\.(\d+)\.conv_pass\.(\d+)", "up"),
                (r"backbone\.r_up\.0\.(\d+)\.up", "up_tconv"), (r"head\.(\d+)", "head"))
    for key, weight in state_dict.items():
        if not key.endswith(".weight"):
            continue
        prefix = key[: -len(".weight")]
        for pattern, part in patterns:
            m = re.fullmatch(pattern, prefix)
            if m:
                break
        w = weight.detach().float().cpu().numpy()
        k = w.ndim - 2
        # (C_out, C_in, *K) -> (*K, C_in, C_out); transposed (C_in, C_out, *K) -> (*K, C_in, C_out)
        perm = tuple(range(2, 2 + k)) + ((0, 1) if part == "up_tconv" else (1, 0))
        conv = {"w": np.ascontiguousarray(w.transpose(perm)),
                "b": state_dict[f"{prefix}.bias"].detach().float().cpu().numpy()}
        if part == "head":
            tree["head"][f"conv{int(m.group(1)) // 2}"] = conv
        elif part == "up_tconv":
            tree.setdefault("up_tconv", {})[f"level{m.group(1)}"] = conv
        else:
            tree[part].setdefault(f"level{m.group(1)}", {})[f"conv{int(m.group(2)) // 2}"] = conv
    return tree


def flax_msgpack(obj) -> bytes:
    """``obj`` (dicts, lists, str, bytes, bool, int, float, None, numpy
    arrays) in the layout ``flax.serialization.msgpack_serialize`` writes:
    msgpack, big-endian lengths, each array ext type 1 whose payload is
    msgpack ``(shape, dtype name, C-order bytes)``. The JAX package writes
    its checkpoints so; the CPU tests hold this against flax's reader."""
    out = bytearray()

    def sized(n, fix, fix_limit, marker32):
        if n < fix_limit:
            out.append(fix | n)
        else:
            out.extend(bytes([marker32]) + struct.pack(">I", n))

    def put(o):
        if o is None:
            out.append(0xC0)
        elif isinstance(o, bool):
            out.append(0xC3 if o else 0xC2)
        elif isinstance(o, int):
            if -32 <= o < 128:
                out.extend(struct.pack(">b", o) if o < 0 else bytes([o]))
            else:
                out.extend(b"\xd3" + struct.pack(">q", o) if o < 0 else b"\xcf" + struct.pack(">Q", o))
        elif isinstance(o, float):
            out.extend(b"\xcb" + struct.pack(">d", o))
        elif isinstance(o, str):
            raw = o.encode()
            sized(len(raw), 0xA0, 32, 0xDB)
            out.extend(raw)
        elif isinstance(o, bytes):
            out.extend(b"\xc6" + struct.pack(">I", len(o)) + o)
        elif isinstance(o, dict):
            sized(len(o), 0x80, 16, 0xDF)
            for k, v in o.items():
                put(k)
                put(v)
        elif isinstance(o, (list, tuple)):
            sized(len(o), 0x90, 16, 0xDD)
            for v in o:
                put(v)
        elif isinstance(o, np.ndarray):
            payload = flax_msgpack([list(o.shape), o.dtype.name, o.tobytes("C")])
            out.extend(b"\xc9" + struct.pack(">I", len(payload)) + b"\x01" + payload)
        else:
            raise TypeError(f"flax_msgpack: {type(o).__name__}")

    put(obj)
    return bytes(out)


def _example_2d_dir(path, container, checkpoint_kind, state):
    """A directory laid out as examples/2d expects after its 01-data.py and
    train: ``data_2d.zarr`` (``train``: [main]'s raw), ``out_2d.zarr`` with
    the ground truth staged in, and ``models/best_loss.pth`` (the port's) or
    ``models/best_loss.ckpt`` (the JAX package's train-state layout)."""
    os.makedirs(os.path.join(path, "models"))
    if checkpoint_kind == "pth":
        torch.save(state, os.path.join(path, "models", "best_loss.pth"))
    else:
        with open(os.path.join(path, "models", "best_loss.ckpt"), "wb") as f:
            f.write(flax_msgpack({
                "iteration": int(state["iteration"]), "lowest_loss": float(state["lowest_loss"]),
                "params": jax_params(state["model_state_dict"]), "opt_leaves": [],
                "logger_data": {k: [float(v) for v in vs]
                                for k, vs in state["logger_data"].items()}}))
    src = zarr.open(container, "r")
    for target, name, dst in (("data_2d.zarr", "raw", "train"),
                              ("out_2d.zarr", "groundtruth", "groundtruth")):
        f = zarr.open(os.path.join(path, target), "a")
        f[dst] = src[name][...]
        f[dst].attrs.update(src[name].attrs.asdict())


def phase_ckpt(work):
    """``[ckpt]``: examples/2d/infer.toml as written (``checkpoint =
    "models/best_loss.ckpt"``, bf16, the default device), run where [train]
    left only the port's ``models/best_loss.pth``: infer reads it by the
    rule and prints the rule's line. Then run where the same weights are a
    ``models/best_loss.ckpt`` in the JAX package's layout: the port reads
    the file itself, prints no such line, and every stage's output is
    bit-equal. Returns the first run's launches."""
    toml = os.path.join(REPO, "examples", "2d", "infer.toml")
    state = torch.load(os.path.join(work, "models", "best_loss.pth"), weights_only=True)
    runs = {}
    for kind in ("pth", "ckpt"):
        d = os.path.join(work, f"ckpt-{kind}")
        _example_2d_dir(d, os.path.join(work, "data.zarr"), kind, state)
        config = ExperimentConfig.from_toml(toml)
        mc, ic = config.model_config, config.inference_config
        if (str(mc.checkpoint) != "models/best_loss.ckpt" or ic.device != DEVICE
                or ic.precision != "bfloat16"
                or {k: getattr(mc, k) for k in MODEL} != MODEL):
            fail("examples/2d/infer.toml differs from the settings this script assumes")
        conv_pass_2d.launches = mean_shift_fit.launches = 0
        stage_seconds = {}
        log = os.path.join(d, "infer.log")
        with contextlib.chdir(d), logged(log):
            results = cellulus_tpu_torch.infer(config, stage_seconds)
        torch.cuda.synchronize()
        with open(log) as f:
            rule = [line.strip() for line in f if RULE_LINE in line]
        launches = {"conv_pass_2d": conv_pass_2d.launches,
                    "mean_shift_fit": mean_shift_fit.launches}
        want_rule = 1 if kind == "pth" else 0
        if len(rule) != want_rule:
            fail(f"[ckpt] {kind}: {len(rule)} lines of the .ckpt rule, expected {want_rule}")
        if launches != {"conv_pass_2d": 18, "mean_shift_fit": 2}:
            fail(f"[ckpt] {kind}: launches {launches}, expected 18 K1 and 2 fits")
        if results is None or not all(0.0 <= results[0][k] <= 1.0 for k in ("F1", "SEG")):
            fail(f"[ckpt] {kind}: evaluate results {results}")
        runs[kind] = dict(out=os.path.join(d, "out_2d.zarr"), rule=rule, results=results,
                          seconds=stage_seconds, launches=launches)
        print(f"[ckpt] examples/2d/infer.toml as written, models/ holding best_loss.{kind}: "
              f"stages (s) {json.dumps({k: round(v, 3) for k, v in stage_seconds.items()})}, "
              f"F1 {results[0]['F1']:.4f}, launches {json.dumps(launches)}"
              + (f"; the rule's line: {rule[0]!r}" if rule else ""), flush=True)
    differing = _differing_outputs(runs["pth"]["out"], runs["ckpt"]["out"])
    if differing:
        fail(f"[ckpt] the .pth and .ckpt runs differ (dataset: max abs difference) {differing}")
    print("[ckpt] the runs from best_loss.pth (by the rule) and best_loss.ckpt: the five "
          "stage datasets bit-equal", flush=True)
    return runs["pth"]["launches"]


# -- [export]: the tile predictor as a torch.export program, served in a new process ------

def _export_inputs(path, precision):
    return os.path.join(path, precision, "inputs.pt")


def serve_worker(path):
    """The serving process of ``[export]``: for each precision, load the
    artifact (``load_predictor``), run it on the saved draws, count K1's
    launches in one call and time a call; one JSON line each."""
    device = torch.device(DEVICE)
    for precision in ("float32", "bfloat16"):
        predict_fn, meta = load_predictor(os.path.join(path, precision))
        inputs = torch.load(_export_inputs(path, precision), weights_only=True)
        tiles, uniform = inputs["tiles"].to(device), inputs["uniform"].to(device)
        conv_pass_2d.launches = 0
        t0 = time.perf_counter()
        out = predict_fn(tiles, uniform)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = conv_pass_2d.launches
        torch.save(out.cpu(), os.path.join(path, precision, "served.pt"))
        ms = cuda_ms(lambda: predict_fn(tiles, uniform))
        print(json.dumps({"precision": precision, "launches": launches, "ms": ms,
                          "first_call_s": first_s, "platforms": meta["platforms"]}), flush=True)


def phase_export(work):
    """``[export]``: examples/2d's model (64 fmaps, tile batch 4, 16 TTA
    iterations, seeded weights) exported on the card in float32 and bf16,
    each graph's conv-pass nodes counted; a fresh process loads each
    artifact and runs it on draws from ``draw_uniform``; its output against
    ``tta_embeddings`` here on the same draws (max abs difference, and
    whether bit-equal), K1's launches in the serving process in one call
    (one per 2D conv pass) and the ms a call against the live forward's.
    Returns the serving process's launches a call, by type."""
    device = torch.device(DEVICE)
    path = os.path.join(work, "export")
    model = random_unet(21, **MODEL)
    live_net = model.to(device).eval()
    passes = len(pass_shapes(1))
    live, stats = {}, {}
    for precision in ("float32", "bfloat16"):
        ic = InferenceConfig(crop_size=[CROP, CROP], tile_batch_size=TILE_BATCH,
                             num_infer_iterations=NUM_INFER_ITERATIONS, precision=precision,
                             device=DEVICE)
        t0 = time.perf_counter()
        out = export_predictor(model, ic, os.path.join(path, precision),
                               platforms=(device.type,))
        export_s = time.perf_counter() - t0
        meta = json.loads(open(os.path.join(out, "predictor.json")).read())
        program = torch.export.load(os.path.join(out, export_artifact_name(device.type)))
        nodes = sum(1 for n in program.graph.nodes if n.op == "call_function"
                    and "cellulus_tpu_torch.conv_pass_2d" in str(n.target))
        if nodes != passes:
            fail(f"[export] {precision}: {nodes} conv_pass_2d nodes, expected {passes}")
        gen = torch.Generator(device=device).manual_seed(22)
        tiles = torch.rand((TILE_BATCH, *meta["in_tile"], 1), generator=gen, device=device)
        uniform = draw_uniform(gen, tiles.shape, NUM_INFER_ITERATIONS, device)
        torch.save({"tiles": tiles.cpu(), "uniform": uniform.cpu()},
                   _export_inputs(path, precision))
        dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
        with torch.no_grad():
            live[precision] = tta_embeddings(live_net, tiles, uniform, ic.p_salt_pepper,
                                             NUM_INFER_ITERATIONS, dtype).cpu()
            live_ms = cuda_ms(lambda: tta_embeddings(live_net, tiles, uniform, ic.p_salt_pepper,
                                                     NUM_INFER_ITERATIONS, dtype))
        stats[precision] = dict(export_s=export_s, nodes=nodes, live_ms=live_ms)
        del program, tiles, uniform
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve", path],
                          capture_output=True, text=True, timeout=600, cwd=REPO)
    if proc.returncode != 0:
        fail(f"[export] the serving process failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    served_launches = {}
    for line in proc.stdout.splitlines():
        if not line.startswith("{"):
            continue
        r = json.loads(line)
        precision = r["precision"]
        served = torch.load(os.path.join(path, precision, "served.pt"), weights_only=True)
        ref = live[precision]
        diff = float((served - ref).abs().max())
        scale = float(ref.abs().max())
        tol = 1e-4 * scale if precision == "float32" else 2e-2 * scale
        if served.shape != ref.shape or not torch.isfinite(served).all() or diff > tol:
            fail(f"[export] {precision}: served output {tuple(served.shape)} differs from "
                 f"tta_embeddings by {diff:.3g} (bar {tol:.3g})")
        if r["launches"] != passes:
            fail(f"[export] {precision}: K1 launched {r['launches']} times in one served call, "
                 f"expected {passes} (one per 2D conv pass)")
        served_launches[precision] = r["launches"]
        st = stats[precision]
        print(f"[export] {precision}: exported on the card in {st['export_s']:.1f}s "
              f"({st['nodes']} conv_pass_2d nodes); a fresh process served {TILE_BATCH} tiles "
              f"x {2 * NUM_INFER_ITERATIONS} copies: max abs diff {diff:.3g} against "
              f"tta_embeddings on the same draws (bit-equal: {bool(torch.equal(served, ref))}), "
              f"K1 launches a call {r['launches']}, {r['ms']:.2f} ms a call against the live "
              f"forward's {st['live_ms']:.2f} ms (first call {r['first_call_s']:.2f}s)",
              flush=True)
    if set(served_launches) != {"float32", "bfloat16"}:
        fail(f"[export] the serving process printed {proc.stdout[-2000:]}")
    return served_launches


# -- [stream]: the staged predict streamed, against the sample in memory -------------------

STREAM_SIZE = 224


def _rss_mib():
    """The process's resident memory now, MiB (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


def _peak_rss_during(fn):
    """``(fn(), peak resident MiB while it ran)``, sampled every 2 ms."""
    peak, done = [_rss_mib()], threading.Event()

    def sample():
        while not done.wait(0.002):
            peak[0] = max(peak[0], _rss_mib())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        out = fn()
    finally:
        done.set()
        sampler.join()
    return out, max(peak[0], _rss_mib())


def stream_worker(mode, path):
    """One ``[stream]`` run in a process of its own: ``stream``, the staged
    predict (tiles read from the zarr, tiles written by one thread), or
    ``memory``, ``predict_sample`` on the whole sample as float32; prints its
    seconds, the resident memory before it and its peak while it ran, and
    the process's peak (``ru_maxrss``, which also counts the start-up)."""
    device = torch.device(DEVICE)
    model = UNet(1, 3, num_spatial_dims=3, **MODEL_3D)
    load_checkpoint(os.path.join(path, "weights.pth"), model)
    model = model.to(device).eval()
    ic = InferenceConfig(
        crop_size=CROP_3D, precision="bfloat16", device=DEVICE,
        dataset_config=DatasetConfig(container_path=os.path.join(path, "data.zarr"),
                                     dataset_name="raw"),
        prediction_dataset_config=DatasetConfig(
            container_path=os.path.join(path, "out.zarr"), dataset_name="embeddings"))
    nf = normalization_factor_for(np.uint16)

    def run():
        if mode == "stream":
            return predict(model, ic, nf, device, torch.bfloat16)
        raw = np.asarray(zarr.open(ic.dataset_config.container_path, "r")["raw"][0], np.float32)
        return predict_sample(model, raw, ic, nf, 0, device, torch.bfloat16)

    torch.cuda.synchronize()
    before = _rss_mib()
    t0 = time.perf_counter()
    emb, peak = _peak_rss_during(run)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if mode == "memory":
        np.save(os.path.join(path, "memory.npy"), emb)
    max_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024  # KiB -> MiB
    print(json.dumps({"mode": mode, "seconds": seconds, "rss_before_mib": before,
                      "rss_peak_mib": peak, "max_rss_mib": max_rss}), flush=True)


def phase_stream(work):
    """``[stream]``: one STREAM_SIZE^3 uint16 sample through examples/3d's
    model (seeded weights) in bf16, the staged predict streamed against
    ``predict_sample`` on the sample in memory, each in a process of its
    own: the embeddings bit-equal, the seconds of each, the resident memory
    each run added at its peak and each process's ``ru_maxrss``."""
    path = os.path.join(work, "stream")
    os.makedirs(path)
    rng = np.random.default_rng(41)
    f = zarr.open(os.path.join(path, "data.zarr"), "a")
    f["raw"] = rng.integers(0, 65536, (1, 1, *(STREAM_SIZE,) * 3), dtype=np.uint16)
    f["raw"].attrs.update({"axis_names": ["s", "c", "z", "y", "x"], "resolution": [1, 1, 1]})
    save_random_checkpoint(os.path.join(path, "weights.pth"), 42, num_spatial_dims=3,
                           **MODEL_3D)
    runs = {}
    for mode in ("stream", "memory"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--stream", mode, path],
                              capture_output=True, text=True, timeout=300, cwd=REPO)
        if proc.returncode != 0:
            fail(f"[stream] {mode} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        runs[mode] = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    streamed = zarr.open(os.path.join(path, "out.zarr"), "r")["embeddings"][0]
    in_memory = np.load(os.path.join(path, "memory.npy"))
    if streamed.shape != (4, *(STREAM_SIZE,) * 3) or not np.array_equal(streamed, in_memory):
        fail(f"[stream] streamed and in-memory embeddings differ: shapes {streamed.shape} "
             f"{in_memory.shape}")
    g = compute_geometry(CROP_3D, MODEL_3D["downsampling_factors"])
    tiles = math.prod(len(tile_origins(max(STREAM_SIZE, o), o)) for o in g.output_size)
    text = "; ".join(
        f"{label} {r['seconds']:.3f}s, resident {r['rss_before_mib']:.0f} MiB before it, peak "
        f"{r['rss_peak_mib']:.0f} MiB while it ran (+{r['rss_peak_mib'] - r['rss_before_mib']:.0f}"
        f"), ru_maxrss {r['max_rss_mib']:.0f} MiB"
        for label, r in (("streamed staged predict", runs["stream"]),
                         ("in memory", runs["memory"])))
    print(f"[stream] one {STREAM_SIZE}^3 uint16 sample, examples/3d's model, bf16, {tiles} "
          f"tiles: embeddings bit-equal; {text} (the sample as float32 "
          f"{4 * STREAM_SIZE**3 / 2**20:.0f} MiB, its embeddings {16 * STREAM_SIZE**3 / 2**20:.0f}"
          f" MiB)", flush=True)


# -- [mc]: multi-channel raw data ---------------------------------------------------------

def phase_mc(work):
    """``[mc]``: three input channels. K1's first pass at cin = 3 and K2's
    first conv at Ci = 3 (the CUDA-core plan) against their plain versions
    in float32 and bf16; then examples/2d's model with 3 input channels
    (seeded weights) infers in bf16 on a 2 x 512^2 uint8 3-channel container
    and trains 3 bf16 steps on it, with each kernel's launches counted.
    Returns the kernel rows and the launches."""
    device = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(31)
    name, shape, c_out = pass_shapes(TILE_BATCH * 2 * NUM_INFER_ITERATIONS, in_channels=3)[0]
    k1 = {dtype: _summed([_k1_shape(name, shape, c_out, dtype, gen, device, "mc")], dtype)
          for dtype in (torch.float32, torch.bfloat16)}
    gen = torch.Generator(device=device).manual_seed(32)
    name, xs, gs = dw_shapes(TRAIN_BATCH, in_channels=3)[0]
    k2 = {dtype: _summed([_k2_shape(name, xs, gs, dtype, gen, device, "mc")], dtype)
          for dtype in (torch.float32, torch.bfloat16)}

    path = os.path.join(work, "mc")
    os.makedirs(path)
    raw, labels = make_blobs(2, IMAGE_SIZE, seed=33, dtype=np.uint8)
    noise = np.random.default_rng(33).integers(0, 64, raw.shape, dtype=np.uint8)
    raw = np.concatenate([raw, raw[:, :, ::-1], noise], axis=1)
    f = zarr.open(os.path.join(path, "data.zarr"), "a")
    for key, data in (("raw", raw), ("groundtruth", labels)):
        f[key] = data
        f[key].attrs.update({"axis_names": ["s", "c", "y", "x"], "resolution": [1, 1]})
    checkpoint = os.path.join(path, "weights.pth")
    save_random_checkpoint(checkpoint, seed=34, in_channels=3, **MODEL)
    config = infer_config(os.path.join(path, "data.zarr"), checkpoint, MODEL, device=DEVICE,
                          precision="bfloat16", crop_size=[CROP, CROP])
    conv_pass_2d.launches = mean_shift_fit.launches = 0
    with contextlib.chdir(path), logged(os.path.join(path, "infer.log")):
        results = cellulus_tpu_torch.infer(config)
    torch.cuda.synchronize()
    infer_launches = {"conv_pass_2d": conv_pass_2d.launches,
                      "mean_shift_fit": mean_shift_fit.launches}
    emb = zarr.open(os.path.join(path, "data.zarr"), "r")["embeddings"][...]
    if emb.shape != (2, 3, IMAGE_SIZE, IMAGE_SIZE) or not np.isfinite(emb).all():
        fail(f"[mc] embeddings {emb.shape}, finite={np.isfinite(emb).all()}")
    if infer_launches != {"conv_pass_2d": 18, "mean_shift_fit": 2} or results is None:
        fail(f"[mc] infer launches {infer_launches}, results {results}")
    steps = 3
    with contextlib.chdir(path), logged(os.path.join(path, "train.log")):
        _, k2_launches = _run_train(train_config(
            os.path.join(path, "data.zarr"), MODEL, precision="bfloat16", max_iterations=steps,
            crop_size=[CROP, CROP], batch_size=2, elastic_deform=False,
            save_best_model_every=10**6, save_model_every=10**6, save_snapshot_every=10**6))
    if k2_launches != 6 * steps:
        fail(f"[mc] K2 launched {k2_launches} times in {steps} steps, expected {6 * steps}")
    print(f"[mc] 3-channel infer (bf16, 2 x {IMAGE_SIZE}^2 uint8): F1 {results[0]['F1']:.4f}, "
          f"launches {json.dumps(infer_launches)}; {steps} bf16 train steps: K2 launches "
          f"{k2_launches} = 6 x {steps}", flush=True)
    return k1, k2, infer_launches["conv_pass_2d"], k2_launches


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
    plan, clusters = mean_shift_fit_plan(points.x.shape[0], 3)
    print(f"[3d-detect] sample 0 in parts, median of 3 (ms): "
          f"{json.dumps({k: round(v, 3) for k, v in median.items()})}, sum "
          f"{sum(median.values()):.2f} ms; {len(X)} foreground voxels, N = {len(X_fit)} fitted, "
          f"S = {len(seeds_np)} bin seeds, {len(kept)} clusters; fit plan "
          f"{dict(plan._asdict())}, {min(clusters, len(seeds_np))} clusters launched", flush=True)

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

    # a long 3D fit at the 3D main path's bandwidth, bin seeds filling the volume
    time_fit("3D long fit", *long_fit_3d_input(ic.bandwidth, device),
             ic.mean_shift_max_iterations)
    return time_fit("3D main input (sample 0), d = 3", *problem, ic.mean_shift_max_iterations)


def phase_main_3d(work, container, checkpoint):
    """The 3D infer main path on the [3d-train] checkpoint in float32 (the
    default) and bfloat16 (examples/3d/infer.toml's precision), with the
    default mean-shift clustering; sample 0's detect in parts and the fit
    kernel at d = 3 after the float32 run. Returns the launches of each run,
    by precision, the fit's timing and the inference config."""
    launches, ic = _infer_main_3d(work, container, checkpoint, "float32")
    launches = {"float32": launches}
    fit = phase_detect_3d(container, ic, torch.device(DEVICE))
    launches["bfloat16"] = _infer_main_3d(work, container, checkpoint, "bfloat16")[0]
    return launches, fit, ic


# -- [cc]: connected components, the size filter and the relabel on the card ---------

def _spiral(size):
    """A one-pixel-wide square spiral, rings 2 pixels apart: one component
    that turns at every ring (the worst case for the rounds)."""
    out = np.zeros((size, size), np.int32)
    t, l, b, r = 0, 0, size - 1, size - 1
    while r - l >= 2 and b - t >= 2:
        out[t, l:r + 1] = 1
        out[t:b + 1, r] = 1
        out[b, l:r + 1] = 1
        out[t + 2:b + 1, l] = 1
        out[t + 2, l:l + 3] = 1
        t, l, b, r = t + 2, l + 2, b - 2, r - 2
    return out


def phase_cc(container_2d, container_3d, ic_2d, ic_3d, device):
    """``[cc]``: cell mode's halo removal, connected components, size filter
    and relabel (``segment.cell_segment_sample``) on the card against the
    CPU on every sample of ``[main]``'s and ``[3d-main]``'s detections, and
    against the host oracle (scipy, ``filter_relabel``): identical labels.
    ``cc_parents`` on spirals, card against CPU, with its rounds. Then the
    device route's milliseconds for a 128^3 sample against the host route
    (halo removal on the card, scipy on the host) on the same sample."""
    for name, container, ic in (("main", container_2d, ic_2d), ("3d-main", container_3d, ic_3d)):
        det = np.asarray(zarr.open(container, "r")["detection"][:, 0])
        args = (float(ic.grow_distance), float(ic.shrink_distance), int(ic.min_size))
        instances = []
        for s in range(det.shape[0]):
            card = cell_segment_sample(det[s], *args, device)
            cpu = cell_segment_sample(det[s], *args, "cpu")
            halo = halo_removal(torch.from_numpy(det[s].astype(np.int32)), *args[:2]).numpy()
            oracle = filter_relabel(halo, args[2])
            if not (np.array_equal(card, cpu) and np.array_equal(card.astype(np.int64), oracle)):
                fail(f"[cc] {name} sample {s}: card, CPU and host oracle labels differ "
                     f"({int((card != cpu).sum())} and {int((card != oracle).sum())} pixels)")
            instances.append(int(card.max()))
        print(f"[cc] {name}: cell segment on the card equals the CPU and the scipy oracle on "
              f"{det.shape[0]} samples of {list(det.shape[1:])} (instances {instances}, "
              f"min_size {args[2]})", flush=True)
    for size in (129, 513):
        values = torch.from_numpy(_spiral(size))
        stats_card, stats_cpu = {}, {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = cc_parents(values.to(device), stats=stats_card)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        cpu = cc_parents(values, stats=stats_cpu)
        if not torch.equal(card.cpu(), cpu) or int(cpu[values > 0].max()) != 0:
            fail(f"[cc] spiral {size}^2: the card's parents differ from the CPU's")
        print(f"[cc] spiral {size}^2 ({int(values.sum())} pixels, one component): card = CPU, "
              f"{stats_card['rounds']} rounds ({ms:.1f} ms on the card)", flush=True)
    det = np.asarray(zarr.open(container_3d, "r")["detection"][0, 0])
    args = (float(ic_3d.grow_distance), float(ic_3d.shrink_distance), int(ic_3d.min_size))
    cell_segment_sample(det, *args, device)  # warm-up
    stats = {}
    times = {"device": [], "host": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = cell_segment_sample(det, *args, device)
        times["device"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        seg = torch.from_numpy(det.astype(np.int32)).to(device)
        halo = halo_removal(seg, *args[:2]).cpu().numpy()
        host = filter_relabel(halo, args[2])
        times["host"].append(time.perf_counter() - t0)
    if not np.array_equal(labels.astype(np.int64), host):
        fail("[cc] 128^3: device and host routes differ")
    cc_parents(torch.from_numpy(halo).to(device), stats=stats)
    ms = {k: 1e3 * float(np.median(v)) for k, v in times.items()}
    print(f"[cc] cell segment of a {VOLUME_SIZE}^3 sample ([3d-main] sample 0, "
          f"{int(labels.max())} instances), median of 3, upload to labels on the host: device "
          f"route (halo, CC in {stats['rounds']} rounds, filter, relabel; uint16 down) "
          f"{ms['device']:.1f} ms, host route (halo on the card, scipy) {ms['host']:.1f} ms",
          flush=True)
    return ms


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


def phase_pipelined_greedy(work, container, checkpoint):
    """``[pipelined-greedy]``: examples/3d/infer.toml's settings (greedy,
    bf16) pipelined on the [3d-train] container (2 x 128^3), then staged on
    the same inputs: the five stage datasets and the scores equal. Greedy's
    CUDA-graph capture runs in a stage worker while the calling thread
    predicts the next sample."""
    config = ExperimentConfig.from_toml(os.path.join(REPO, "examples", "3d", "infer.toml"))
    ic = config.inference_config
    if ic.clustering != "greedy" or config.object_size != OBJECT_SIZE_3D:
        fail("examples/3d/infer.toml differs from the settings this script assumes")
    config.model_config.checkpoint = checkpoint
    ic.device = DEVICE
    runs = _run_both_paths(config, work, "pgreedy", container, (mean_shift_fit,))
    piped, staged = runs["pipelined"], runs["staged"]
    differing = _differing_outputs(piped["out"], staged["out"])
    if differing:
        fail(f"[pipelined-greedy] pipelined and staged outputs differ {differing}")
    if piped["results"] != staged["results"]:
        fail(f"[pipelined-greedy] scores {piped['results']} vs {staged['results']}")
    if any(run["launches"]["mean_shift_fit"] for run in runs.values()):
        fail(f"[pipelined-greedy] greedy launched the fit kernel: {runs}")
    staged_sum = sum(staged["seconds"][k] for k in ("predict", "detect", "segment"))
    print(f"[pipelined-greedy] examples/3d/infer.toml (greedy, bf16) pipelined on 2 x "
          f"{VOLUME_SIZE}^3: the five datasets and F1 {piped['results'][0]['F1']:.4f} SEG "
          f"{piped['results'][0]['SEG']:.4f} equal the staged run's; pipelined "
          f"{piped['seconds'][PIPELINED_STAGE]:.3f}s against the staged sum {staged_sum:.3f}s; "
          f"per sample (s): {_interval_table(piped['intervals'])}; overlaps (s, t) "
          f"{_overlaps(piped['intervals'])}", flush=True)


SWEEP_TRUNCATED = "007500.pth"


def phase_sweep(work, hela_result):
    """``[sweep]``: ``checkpoint_sweep`` over the checkpoints [hela] left
    (000000.pth, the untrained control, 002500.pth, 004999.pth, the last
    step's, and best_loss.pth) plus a
    truncated copy of best_loss.pth as a numbered fourth candidate, against
    the silver truth, nucleus mode, ``pipelined = true``. The truncated one
    gives an error row while the others score, and best_loss.pth's row
    equals [hela]'s nucleus F1 and SEG (rounded to 4 places, as the sweep
    rounds). Returns the sweep's launches."""
    import shutil
    from pathlib import Path

    hela = _load_script("torch_real_hela")
    hela_dir = Path(work) / "hela"
    models = Path(work) / "sweep_models"
    models.mkdir()
    for p in sorted((hela_dir / "models").glob("*.pth")):
        shutil.copy2(p, models / p.name)
    left = sorted(p.name for p in models.iterdir())
    if "000000.pth" not in left or "best_loss.pth" not in left or len(left) < 3:
        fail(f"[sweep] [hela] left {left}")
    data = (models / "best_loss.pth").read_bytes()
    (models / SWEEP_TRUNCATED).write_bytes(data[: len(data) // 2])
    config = hela.hela_config(hela_dir, HELA_STEPS, DEVICE)
    config.inference_config.pipelined = True
    conv_pass_2d.launches = mean_shift_fit.launches = 0
    t0 = time.perf_counter()
    with contextlib.chdir(hela_dir), logged(os.path.join(work, "sweep.log")):
        rows = checkpoint_sweep(config, checkpoint_dir=models)
    seconds = time.perf_counter() - t0
    launches = {"conv_pass_2d": conv_pass_2d.launches, "mean_shift_fit": mean_shift_fit.launches}
    selected = json.loads((models / "checkpoint_sweep.json").read_text())["selected"]
    if "error" not in rows.get(SWEEP_TRUNCATED, {}):
        fail(f"[sweep] the truncated checkpoint scored: {rows.get(SWEEP_TRUNCATED)}")
    scored = [name for name, row in rows.items() if "F1" in row]
    if sorted(scored) != sorted(set(rows) - {SWEEP_TRUNCATED}):
        fail(f"[sweep] rows {rows}")
    nucleus = hela_result["nucleus"]
    best = rows["best_loss.pth"]
    if (best["F1"], best["SEG"]) != (round(nucleus["F1"], 4), round(nucleus["SEG"], 4)):
        fail(f"[sweep] best_loss.pth scores F1 {best['F1']} SEG {best['SEG']}, [hela] "
             f"{nucleus['F1']:.4f} / {nucleus['SEG']:.4f}")
    if not all(launches.values()):
        fail(f"[sweep] launches {launches}")
    print(f"[sweep] checkpoint_sweep over [hela]'s checkpoints + a truncated {SWEEP_TRUNCATED} "
          f"(nucleus, pipelined) in {seconds:.1f}s: "
          + "; ".join(f"{name} " + (f"F1 {row['F1']:.4f} SEG {row['SEG']:.4f} (bandwidth "
                                    f"{row['bandwidth_index']})" if "F1" in row else "error")
                      for name, row in rows.items())
          + f"; selected {selected}; best_loss.pth equals [hela]'s nucleus scores; launches "
          f"{json.dumps(launches)}", flush=True)
    return launches


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_events(path):
    """The complete events (``ph == "X"``) of a ``torch.profiler`` Chrome trace."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]


def trace_summary(events, host_tid=None, top=10, gaps=5, window=None):
    """Of a Chrome trace's events within ``window`` (µs; first to last event
    if None): its length (ms), the device's busy time (kernels, copies and
    sets merged over streams) and idle share of it, the ``top`` device ops
    by total time, and the ``gaps`` longest stretches with nothing on the
    device, each with the innermost host events of thread ``host_tid`` (any
    thread if None) running at its middle."""
    t0, t1 = window or (min(e["ts"] for e in events), max(e["ts"] + e["dur"] for e in events))
    device = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1), e) for e in events
                    if e.get("cat") in DEVICE_CATEGORIES and e["ts"] < t1
                    and e["ts"] + e["dur"] > t0)
    merged = []
    for start, end, _ in device:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy = sum(end - start for start, end in merged)
    edges = [t0] + [x for interval in merged for x in interval] + [t1]
    idle = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)),
                  reverse=True)[:gaps]
    by_name = {}
    for start, end, e in device:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + (end - start) / 1e3, n + 1)
    host = [e for e in events if e.get("cat") not in DEVICE_CATEGORIES
            and (host_tid is None or e.get("tid") == host_tid)]
    gap_rows = []
    for dur, start in idle:
        mid = start + dur / 2
        inner = sorted((e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]),
                       key=lambda e: e["dur"])
        gap_rows.append({"ms": dur / 1e3, "at_ms": (start - t0) / 1e3,
                         "host": [e["name"][:60] for e in inner[:3]] or ["(no op recorded)"]})
    return {"window_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / max(t1 - t0, 1e-9),
            "top": sorted(((n[:90], ms, c) for n, (ms, c) in by_name.items()),
                          key=lambda r: -r[1])[:top],
            "gaps": gap_rows, "names": set(by_name)}


def host_self_ms(events, main_tid, window, top=12):
    """Self time (ms) by thread and name of the host events that start in
    ``window``: each event's duration less its direct children's. Threads
    are named ``main`` (``main_tid``) or by their order of appearance (the
    autograd engine runs a CUDA backward on a thread of its own)."""
    threads, totals = {main_tid: "main"}, {}
    for tid in sorted({e.get("tid") for e in events if e.get("cat") not in DEVICE_CATEGORIES},
                      key=str):
        threads.setdefault(tid, f"thread {len(threads)}")
    for tid, label in threads.items():
        host = sorted((e for e in events if e.get("tid") == tid
                       and e.get("cat") not in DEVICE_CATEGORIES
                       and window[0] <= e["ts"] < window[1]),
                      key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in host:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            if stack:
                parent = (label, stack[-1]["name"][:60])
                totals[parent] = totals.get(parent, 0.0) - e["dur"] / 1e3
            key = (label, e["name"][:60])
            totals[key] = totals.get(key, 0.0) + e["dur"] / 1e3
            stack.append(e)
    return sorted(totals.items(), key=lambda kv: -kv[1])[:top]


@contextlib.contextmanager
def _env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


TRACE_SAMPLES, TRACE_TRAIN_STEPS = 4, 20


def phase_trace(work):
    """``[trace]``: (a) the 2D main path pipelined (examples/2d's model,
    float32, TRACE_SAMPLES x 512^2, seeded weights) under
    ``CELLULUS_TPU_PROFILE`` and ``CELLULUS_TPU_DEVICE_TIMERS=1``: the
    ``{predict,detect,segment}.device`` sums, detect's host share, the ten
    device ops that took most time and the device's idle share; the trace
    must hold K1's and the fit kernel's symbols. (b) TRACE_TRAIN_STEPS steps
    of ``train()`` at examples/2d/train.toml's settings (bf16, batch 8,
    crop 252, elastic, device pairs) inside ``torch.profiler``: the device's
    idle share and the longest stretches with the device idle, with what the
    training thread ran then. Returns the launches of (a) and K2's of (b)."""
    import threading
    from torch._C._profiler import _ExperimentalConfig

    trace = os.path.join(work, "trace")
    os.makedirs(trace)
    container = write_blob_container(os.path.join(trace, "data.zarr"), TRACE_SAMPLES,
                                     IMAGE_SIZE, seed=21)
    checkpoint = os.path.join(trace, "weights.pth")
    save_random_checkpoint(checkpoint, seed=22, **MODEL)
    config = infer_config(container, checkpoint, MODEL, device=DEVICE, pipelined=True)
    trace_dir = os.path.join(trace, "infer-trace")
    conv_pass_2d.launches = mean_shift_fit.launches = 0
    reset_perf()
    intervals = {}
    with _env(CELLULUS_TPU_PROFILE=trace_dir, CELLULUS_TPU_DEVICE_TIMERS="1"), \
            contextlib.chdir(trace), logged(os.path.join(trace, "infer.log")):
        results = cellulus_tpu_torch.infer(config, None, intervals)
    launches = {"conv_pass_2d": conv_pass_2d.launches, "mean_shift_fit": mean_shift_fit.launches}
    report = perf_report()
    reset_perf()
    if results is None or not launches["conv_pass_2d"] or launches["mean_shift_fit"] != 4:
        fail(f"[trace] results {results}, launches {launches}")
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    if len(files) != 1:
        fail(f"[trace] expected one trace file, found {files}")
    summary = trace_summary(trace_events(files[0]))
    k1 = sorted(n for n in summary["names"] if "conv_pass_kernel" in n or "conv_stage_kernel" in n)
    fit = sorted(n for n in summary["names"] if "mean_shift_fit_kernel" in n)
    if not k1 or not fit:
        fail(f"[trace] K1 {k1} or the fit kernel {fit} missing from the trace")
    sums = {k: round(report[k]["seconds"], 4) for k in
            ("predict.device", "detect.device", "segment.device") if k in report}
    if len(sums) != 3:
        fail(f"[trace] device timers {sorted(report)}")
    detect_wall = sum(d1 - d0 for d0, d1 in intervals["detect"].values())
    print(f"[trace] (a) examples/2d's model, f32, pipelined on {TRACE_SAMPLES} x {IMAGE_SIZE}^2, "
          f"device timers on (they sync each timed call): device sums (s) {json.dumps(sums)}; "
          f"detect {detect_wall:.4f}s on the host clock, host share "
          f"{1 - report['detect.device']['seconds'] / detect_wall:.3f}; traced window "
          f"{summary['window_ms']:.1f} ms, device busy {summary['busy_ms']:.1f} ms, idle share "
          f"{summary['idle_share']:.3f}; K1 symbols {len(k1)}, fit symbol present", flush=True)
    print("[trace] (a) top 10 device ops [name, ms, calls]: "
          + json.dumps([[n, round(ms, 3), c] for n, ms, c in summary["top"]]), flush=True)
    # the same inputs staged, timers on and no trace: each stage has the card
    # to itself, so its device sum is not inflated by the other thread's work
    config.inference_config.pipelined = False
    reset_perf()
    staged_seconds = {}
    with _env(CELLULUS_TPU_DEVICE_TIMERS="1"), contextlib.chdir(trace), \
            logged(os.path.join(trace, "infer-staged.log")):
        cellulus_tpu_torch.infer(config, staged_seconds)
    staged = perf_report()
    reset_perf()
    print(f"[trace] (a) staged on the same inputs, timers on, no trace: stage (s) "
          f"{json.dumps({k: round(v, 4) for k, v in staged_seconds.items()})}, device sums (s) "
          f"{json.dumps({k: round(staged[k + '.device']['seconds'], 4) for k in ('predict', 'detect', 'segment')})}"
          f"; detect's host share "
          f"{1 - staged['detect.device']['seconds'] / staged_seconds['detect']:.3f}, "
          f"segment's {1 - staged['segment.device']['seconds'] / staged_seconds['segment']:.3f}",
          flush=True)

    # (b) the train loop, profiled by this script (train() runs no maybe_trace)
    common = dict(crop_size=[CROP, CROP], batch_size=TRAIN_BATCH, elastic_deform=True,
                  precision="bfloat16", max_iterations=TRACE_TRAIN_STEPS,
                  save_best_model_every=10**6, save_model_every=10**6, save_snapshot_every=10**6)
    train_dir = os.path.join(trace, "train")
    os.makedirs(train_dir)
    path = os.path.join(trace, "train-trace.json")
    step_times = []
    from torch.profiler import ProfilerActivity, profile

    with contextlib.chdir(train_dir), logged(os.path.join(trace, "train.log")):
        cfg = train_config(container, MODEL, **common)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            _, k2_launches = _run_train(cfg, step_times)
        prof.export_chrome_trace(path)
    if k2_launches != 6 * TRACE_TRAIN_STEPS:
        fail(f"[trace] (b) conv3x3_dw launched {k2_launches} times")
    events = trace_events(path)
    whole = trace_summary(events)
    # steady steps: from the third batch fetch to the end of the last one
    fetches = sorted(e["ts"] for e in events if e["name"] == "train: next batch")
    if len(fetches) != TRACE_TRAIN_STEPS:
        fail(f"[trace] (b) {len(fetches)} batch fetches in the trace")
    steady = (fetches[2], fetches[-1])
    train_summary = trace_summary(events, host_tid=threading.get_native_id(),
                                  window=steady)
    spans = {}
    for e in events:
        if e["name"].startswith("train: ") and steady[0] <= e["ts"] < steady[1]:
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e3
    step_ms = 1e3 * float(np.median(np.diff(step_times[1:-1])))
    steps = TRACE_TRAIN_STEPS - 3
    print(f"[trace] (b) train() at examples/2d/train.toml's settings, {TRACE_TRAIN_STEPS} steps "
          f"in torch.profiler: median step {step_ms:.1f} ms (profiled); whole window "
          f"{whole['window_ms']:.1f} ms, idle share {whole['idle_share']:.3f}; {steps} steady "
          f"steps {train_summary['window_ms'] / steps:.1f} ms a step, device busy "
          f"{train_summary['busy_ms'] / steps:.1f} ms a step, idle share "
          f"{train_summary['idle_share']:.3f}; the training thread's spans a step (ms) "
          f"{json.dumps({k: round(v / steps, 2) for k, v in spans.items()})}; longest "
          f"device-idle stretches [ms, at ms, the training thread's innermost ops at their "
          f"middle]: {json.dumps([[round(g['ms'], 2), round(g['at_ms'], 1), g['host']] for g in train_summary['gaps']])}",
          flush=True)
    self_ms = host_self_ms(events, threading.get_native_id(), steady)
    print(f"[trace] (b) host self time a steady step (ms) by [thread, op], top 12: "
          f"{json.dumps([[t, n, round(ms / steps, 2)] for (t, n), ms in self_ms])}; the rest "
          f"of a step is Python outside any recorded op", flush=True)
    print("[trace] (b) top 10 device ops [name, ms, calls]: "
          + json.dumps([[n, round(ms, 3), c] for n, ms, c in train_summary["top"]]), flush=True)
    return launches, k2_launches


class PhaseClock:
    """Seconds of each phase: a call records the time since the last one."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.seconds = {}

    def __call__(self, name):
        now = time.perf_counter()
        self.seconds[name] = round(now - self.last, 1)
        self.last = now

    def total(self):
        return time.perf_counter() - self.start


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--serve"]:  # [export]'s serving process
        serve_worker(sys.argv[2])
        return
    if sys.argv[1:2] == ["--stream"]:  # one of [stream]'s runs
        stream_worker(sys.argv[2], sys.argv[3])
        return
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # predict's and segment's progress lines would fill the error stream
    os.environ.setdefault("CELLULUS_TPU_NO_PROGRESS", "1")
    device = torch.device("cuda:0")
    clock = PhaseClock()
    phase_card()
    clock("card")
    phase_build()
    clock("build")
    k1 = phase_conv_pass(device)
    clock("K1")
    phase_k1_plans()
    clock("K1 plans")
    k1_wide = phase_conv_pass(device, MODEL_WIDE, K1_WIDE_BATCH, "K1-wide")
    phase_k1_staged(device)
    clock("K1-wide")
    phase_k1_ragged(device)
    clock("K1-ragged")
    k2 = phase_conv_dw(device)
    clock("K2")
    k2_ragged = phase_k2_ragged(device)
    clock("K2-ragged")
    k3 = phase_ball_stats(device)
    clock("K3")
    phase_fit(device)
    clock("K3-fit")
    with tempfile.TemporaryDirectory() as work:
        phase_reference_checks(work, device)
        clock("check")
        torch.cuda.reset_peak_memory_stats()
        infer_launches, k3_fit, ic_2d = phase_main_path(work)
        clock("main")
        variants = phase_variants(os.path.join(work, "data.zarr"), device)
        variant_fits = {
            v: time_fit(f"{v} input (sample 0, bf16 embeddings)",
                        *_fit_problem(*r["fit_input"][2:], device),
                        r["ic"].mean_shift_max_iterations)
            for v, r in variants.items() if r["fit_input"] is not None and v != "meanshift"}
        clock("variants")
        wide_launches = phase_wide_main(work)
        clock("wide-main")
        m13_launches = phase_m13_predict(work)
        clock("m13-predict")
        trace_launches, k2_trace = phase_trace(work)
        clock("trace")
        k2_bf16, k2_f32 = phase_train(work, k2[torch.bfloat16]["ms"])
        clock("train")
        ckpt_launches = phase_ckpt(work)
        clock("ckpt")
        k2_resume = phase_resume_ckpt(work)
        clock("resume-ckpt")
        export_launches = phase_export(work)
        clock("export")
        k1_mc, k2_mc, k1_mc_launches, k2_mc_launches = phase_mc(work)
        clock("mc")
        phase_learn(work)
        clock("learn")
        loss_modes = phase_loss_modes(device)
        clock("grid/dense")
        k2_learn_grid = phase_learn_grid(work)
        clock("learn-grid")
        k2_spd = phase_spd(work)
        clock("spd")
        k2_dense_spd = phase_dense_spd(work)
        clock("dense-spd")
        k2_dp = phase_dp(work)
        clock("dp")
        k2_native = phase_native(work)
        clock("native")
        phase_3d_checks(device)
        clock("3d-check")
        container_3d, checkpoint_3d = phase_train_3d(work)
        clock("3d-train")
        infer_3d_launches, k3_fit_3d, ic_3d = phase_main_3d(work, container_3d, checkpoint_3d)
        clock("3d-main")
        phase_cc(os.path.join(work, "data.zarr"), container_3d, ic_2d, ic_3d, device)
        clock("cc")
        phase_stream(work)
        clock("stream")
        phase_3d_greedy(work, container_3d, checkpoint_3d)
        clock("3d-greedy")
        phase_pipelined_greedy(work, container_3d, checkpoint_3d)
        clock("pipelined-greedy")
        phase_3d_elastic(work)
        clock("3d-elastic")
        hela = phase_hela(work)
        clock("hela")
        sweep_launches = phase_sweep(work, hela)
        clock("sweep")
    k1_launches = {torch.float32: infer_launches["float32"]["conv_pass_2d"],
                   torch.bfloat16: infer_launches["bfloat16"]["conv_pass_2d"]}
    # K2 launches of each path that ran it, by input type (the learn-grid
    # gate trains in float32, the loss-mode runs and [native] in bf16)
    k2_paths = {torch.bfloat16: {"train": k2_bf16, "native": k2_native, "trace": k2_trace,
                                 "spd": k2_spd[torch.bfloat16],
                                 **{name: r["launches"] for name, r in loss_modes.items()}},
                torch.float32: {"train": k2_f32, "learn-grid": k2_learn_grid,
                                "spd": k2_spd[torch.float32]}}
    k2_paths[torch.bfloat16]["mc (3 channels)"] = k2_mc_launches
    k2_paths[torch.bfloat16].update({"dense-spd": k2_dense_spd, "resume-ckpt": k2_resume,
                                     **k2_dp})
    # K1 and the fit by path: the main paths, the pipelined paths ([wide-main]
    # both ways, [trace] (a) in f32) and [sweep] (HeLa's 24-fmap model, f32)
    k1_paths = {torch.float32: {"main": k1_launches[torch.float32],
                                "trace (pipelined)": trace_launches["conv_pass_2d"],
                                "sweep (24 fmaps)": sweep_launches["conv_pass_2d"],
                                "export (served, a call)": export_launches["float32"]},
                torch.bfloat16: {"main": k1_launches[torch.bfloat16],
                                 "ckpt (examples/2d/infer.toml)": ckpt_launches["conv_pass_2d"],
                                 "export (served, a call)": export_launches["bfloat16"],
                                 "mc (3 channels)": k1_mc_launches,
                                 "m13-predict (tile split, 2 devices)": m13_launches["tile split"],
                                 "m13-predict (spatial_shards 2)":
                                     m13_launches["spatial_shards 2"]}}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        rows.append({"name": "conv_pass_2d", "dtype": str(dtype).removeprefix("torch."),
                     "route": "cuda", "source": "cellulus_tpu_torch/csrc/conv_pass.cu",
                     "replaces": "cellulus_tpu/ops/pallas_conv.py:55",
                     "launches": k1_launches[dtype], "launches_by_path": k1_paths[dtype],
                     **k1[dtype]})
    for dtype in (torch.float32, torch.bfloat16):
        # the 256-fmap model: [wide-main] runs it in bfloat16 only
        by_path = ({f"wide-main {mode}": n["conv_pass_2d"] for mode, n in wide_launches.items()}
                   if dtype == torch.bfloat16 else {})
        rows.append({"name": "conv_pass_2d", "dtype": str(dtype).removeprefix("torch."),
                     "model": "examples/real-data (256 fmaps)", "route": "cuda",
                     "source": "cellulus_tpu_torch/csrc/conv_pass.cu",
                     "replaces": "cellulus_tpu/ops/pallas_conv.py:55",
                     "launches": by_path.get("wide-main pipelined", 0),
                     "launches_by_path": by_path, **k1_wide[dtype]})
    for dtype in (torch.float32, torch.bfloat16):
        # [mc]: the first pass at cin = 3; launches: the 3-channel infer's (bf16, every pass)
        rows.append({"name": "conv_pass_2d", "dtype": str(dtype).removeprefix("torch."),
                     "input": "first pass, cin = 3 ([mc])", "route": "cuda",
                     "source": "cellulus_tpu_torch/csrc/conv_pass.cu",
                     "replaces": "cellulus_tpu/ops/pallas_conv.py:55",
                     "launches": k1_mc_launches if dtype == torch.bfloat16 else 0, **k1_mc[dtype]})
        # [mc]: the first conv's filter gradient at Ci = 3; launches: the 3-channel train's
        rows.append({"name": "conv3x3_dw", "dtype": str(dtype).removeprefix("torch."),
                     "input": "first conv, Ci = 3 ([mc])", "route": "cuda",
                     "source": "cellulus_tpu_torch/csrc/conv_dw.cu",
                     "replaces": "cellulus_tpu/ops/pallas_dw.py:64",
                     "launches": k2_mc_launches if dtype == torch.bfloat16 else 0, **k2_mc[dtype]})
    for dtype in (torch.bfloat16, torch.float32):
        rows.append({"name": "conv3x3_dw", "dtype": str(dtype).removeprefix("torch."),
                     "route": "cuda", "source": "cellulus_tpu_torch/csrc/conv_dw.cu",
                     "replaces": "cellulus_tpu/ops/pallas_dw.py:64",
                     "launches": sum(k2_paths[dtype].values()),
                     "launches_by_path": k2_paths[dtype], **k2[dtype]})
        # [K2-ragged]: the gate model trains in float32 in [learn-grid]
        ragged_paths = {"learn-grid (gate model)": k2_learn_grid} if dtype == torch.float32 else {}
        rows.append({"name": "conv3x3_dw", "dtype": str(dtype).removeprefix("torch."),
                     "input": "gate model at 4 x 76^2 and ragged shapes ([K2-ragged])",
                     "route": "cuda", "source": "cellulus_tpu_torch/csrc/conv_dw.cu",
                     "replaces": "cellulus_tpu/ops/pallas_dw.py:64",
                     "launches": sum(ragged_paths.values()), "launches_by_path": ragged_paths,
                     **k2_ragged[dtype]})
    rows.append({"name": "ball_stats", "route": "cuda",
                 "source": "cellulus_tpu_torch/csrc/ball_stats.cu",
                 "replaces": "cellulus_tpu/ops/pallas_mean_shift.py:39",
                 "launches": infer_launches["float32"]["ball_stats"], **k3})
    fit_paths = {2: {"main": infer_launches["float32"]["mean_shift_fit"],
                     **{f"wide-main {mode}": n["mean_shift_fit"]
                        for mode, n in wide_launches.items()},
                     "trace (pipelined)": trace_launches["mean_shift_fit"],
                     "sweep": sweep_launches["mean_shift_fit"],
                     "m13-predict (round-robin detect)": m13_launches["round-robin detect"]},
                 3: {"main": infer_3d_launches["float32"]["mean_shift_fit"]}}
    for d, fit, launches in ((2, k3_fit, infer_launches), (3, k3_fit_3d, infer_3d_launches)):
        fit.pop("out")
        rows.append({"name": "mean_shift_fit", "d": d, "route": "cuda",
                     "source": "cellulus_tpu_torch/csrc/ball_stats.cu",
                     "replaces": "cellulus_tpu/ops/pallas_mean_shift.py:39",
                     "launches": launches["float32"]["mean_shift_fit"],
                     "launches_by_path": fit_paths[d], **fit})
    for variant, fit in variant_fits.items():
        fit.pop("out")
        rows.append({"name": "mean_shift_fit", "d": 2, "path": variant, "route": "cuda",
                     "source": "cellulus_tpu_torch/csrc/ball_stats.cu",
                     "replaces": "cellulus_tpu/ops/pallas_mean_shift.py:39",
                     "launches": variants[variant]["launches"], **fit})
    print(f"[time] seconds by phase: {json.dumps(clock.seconds)}, total {clock.total():.1f}",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
