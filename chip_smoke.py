"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) if it fails:

1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. the build: every kernel of ``cellulus_tpu_torch/csrc`` built by ``nvcc``
   for ``sm_90a``, timed;
3. K1, the fused conv pass: the kernel against its plain version at the
   three pass shapes of the full-width 2D model's tile batch, in float32
   (TF32 off) and bfloat16, with timings;
4. K3, the mean-shift ball statistics: the kernel against its plain version
   on random points and on points lying exactly on the ball boundary;
5. the main path: ``cellulus_tpu_torch.infer`` with the default inference
   settings, on a synthetic 2-sample 512x512 uint16 container and seeded
   random weights at the full width of ``examples/2d``, through predict ->
   detect -> segment -> evaluate; every kernel must have launched;
6. the kernels line (JSON), then the last line
   ``{"ok": true, "device": {...}}``.

Needs CUDA: without it the script exits non-zero and prints no result.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

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
from cellulus_tpu_torch.ops.ball_stats import ball_stats, ball_stats_plain, point_set
from cellulus_tpu_torch.ops.conv_pass import conv_pass_2d, conv_pass_2d_plain
from cellulus_tpu_torch.ops.mean_shift import mean_shift_fit_predict
from cellulus_tpu_torch.utils import kernels

# H100 SXM published peaks (dense): HBM bytes/s, float32 on the CUDA cores,
# bfloat16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# the full-width 2D model of examples/2d/infer.toml and the default
# inference settings
MODEL = dict(num_fmaps=64, fmap_inc_factor=3, features_in_last_layer=64,
             downsampling_factors=[[2, 2]])
CROP = 252
TILE_BATCH = 4
NUM_INFER_ITERATIONS = 16
OBJECT_SIZE = 40
IMAGE_SIZE = 512


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def make_blobs(num_samples, size, seed, dtype=np.uint16, num_blobs=40):
    """Bright disks on a dark noisy background: ``(raw (s, 1, H, W),
    labels (s, 1, H, W) uint16)``."""
    rng = np.random.default_rng(seed)
    raw = np.zeros((num_samples, 1, size, size), np.float32)
    labels = np.zeros((num_samples, 1, size, size), np.uint16)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    for s in range(num_samples):
        next_id = 1
        for _ in range(num_blobs):
            radius = rng.uniform(0.025, 0.045) * size
            cy, cx = rng.uniform(radius, size - radius, size=2)
            dist2 = (yy - cy) ** 2 + (xx - cx) ** 2
            mask = dist2 < radius**2
            if (labels[s, 0][mask] != 0).any():
                continue
            labels[s, 0][mask] = next_id
            raw[s, 0][mask] = rng.uniform(0.6, 1.0) * np.exp(
                -dist2[mask] / (2 * (radius / 1.5) ** 2)
            )
            next_id += 1
        raw[s, 0] += rng.normal(0, 0.02, (size, size)).clip(0)
    scale = np.iinfo(dtype).max
    return (raw.clip(0, 1) * scale).astype(dtype), labels


def write_blob_container(path, num_samples, size, seed, dtype=np.uint16):
    raw, labels = make_blobs(num_samples, size, seed, dtype)
    f = zarr.open(path, "a")
    for name, data in (("raw", raw), ("groundtruth", labels)):
        f[name] = data
        f[name].attrs.update({"axis_names": ["s", "c", "y", "x"], "resolution": [1, 1]})
    return path


def save_random_checkpoint(path, seed, in_channels=1, **model):
    """Seeded Kaiming-normal weights as a reference-format ``.pth``."""
    torch.manual_seed(seed)
    net = UNet(in_channels, 2, **model)
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            torch.nn.init.kaiming_normal_(m.weight)
    torch.save({"iteration": 0, "lowest_loss": 0.0, "model_state_dict": net.state_dict(),
                "optim_state_dict": {}, "logger_data": {}}, path)
    return net


def infer_config(container, checkpoint, model, **inference):
    """All stages read and write one container, which holds the ground truth."""

    def ds(name, secondary=None):
        d = {"container_path": str(container), "dataset_name": name}
        if secondary:
            d["secondary_dataset_name"] = secondary
        return d

    return ExperimentConfig(**{
        "object_size": OBJECT_SIZE,
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


def pass_shapes(batch):
    g = compute_geometry((CROP, CROP), MODEL["downsampling_factors"])
    f, inc = MODEL["num_fmaps"], MODEL["fmap_inc_factor"]
    (skip,), bottom_in = g.skip_sizes, tuple(s // 2 for s in g.skip_sizes[0])
    up_in = tuple(s * 2 for s in g.bottom_size)
    return [
        ("down", (batch, CROP, CROP, 1), f),
        ("bottom", (batch, *bottom_in, f), f * inc),
        ("up", (batch, *up_in, f + f * inc), MODEL["features_in_last_layer"]),
    ]


def phase_conv_pass(device):
    """K1 against its plain version at the tile batch's pass shapes."""
    batch = TILE_BATCH * 2 * NUM_INFER_ITERATIONS
    gen = torch.Generator().manual_seed(1)
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
             "max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, c_out in pass_shapes(batch):
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
            by_ops = flops / PEAK_OPS[dtype] >= nbytes / HBM_BYTES_PER_S
            print(f"[K1] {name:6s} {str(dtype):14s} {tuple(shape)}->{c_out}: "
                  f"max_abs_err {max_err:.3g} ({tol_text}); kernel {ms:.2f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.2f} ms, "
                  f"cuDNN {library_ms:.2f} ms, bound {bound_ms:.3f} ms")
            if dtype == torch.float32:  # the main path's dtype
                total["ms"] += ms
                total["plain_ms"] += plain_ms
                total["library_ms"] += library_ms
                total["bound_ms"] += bound_ms
                total["max_abs_err"] = max(total["max_abs_err"], max_err)
                total["bound_by"] = "operations" if by_ops else "bytes"
            del x
            torch.cuda.empty_cache()
    return total


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
    bound_ms = 1e3 * max(ops / PEAK_OPS[torch.float32], nbytes / HBM_BYTES_PER_S)
    bound_by = "operations" if ops / PEAK_OPS[torch.float32] >= nbytes / HBM_BYTES_PER_S else "bytes"
    print(f"[K3] kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": float(sum_err[exact].max())}


def phase_reference_checks(work, device):
    """Small inputs where the card must agree with the port's CPU path."""
    net = save_random_checkpoint(os.path.join(work, "small.pth"), seed=3, **MODEL)
    x = torch.rand((2, 92, 92, 1), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref = net.eval()(x)
        got = net.to(device)(x.to(device)).cpu()
    err = float((got - ref).abs().max())
    if not err <= 1e-4 * max(1.0, float(ref.abs().max())):
        fail(f"U-Net forward on the card differs from the CPU: max abs err {err:.3g}")
    rng = np.random.default_rng(1)
    centers = np.array([[0.0, 0.0], [8.0, 8.0], [0.0, 9.0]])
    X = np.concatenate([rng.normal(c, 0.6, size=(60, 2)) for c in centers]).astype(np.float32)
    cpu = mean_shift_fit_predict(X, 2.0, None, device="cpu")
    gpu = mean_shift_fit_predict(X, 2.0, None, device=device)
    if not np.array_equal(cpu, gpu):
        fail("mean shift labels on the card differ from the CPU")
    print(f"[check] U-Net forward card vs CPU max abs err {err:.3g}; "
          f"mean-shift labels equal ({len(set(gpu.tolist()))} clusters)")


def phase_main_path(work):
    container = write_blob_container(os.path.join(work, "data.zarr"), 2, IMAGE_SIZE, seed=5)
    checkpoint = os.path.join(work, "weights.pth")
    save_random_checkpoint(checkpoint, seed=0, **MODEL)
    config = infer_config(container, checkpoint, MODEL, device="cuda:0")
    ic = config.inference_config
    if (ic.crop_size, ic.tile_batch_size, ic.num_infer_iterations, ic.p_salt_pepper) != (
            [CROP, CROP], TILE_BATCH, NUM_INFER_ITERATIONS, 0.01):
        fail("the default inference settings differ from the ones this script assumes")

    conv_pass_2d.launches = 0
    ball_stats.launches = 0
    stage_seconds = {}
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(work)  # evaluate writes its results files to the working directory
    try:
        results = cellulus_tpu_torch.infer(config, stage_seconds)
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"conv_pass_2d": conv_pass_2d.launches, "ball_stats": ball_stats.launches}

    f = zarr.open(container, "r")
    emb = f["embeddings"][...]
    seg = f["segmentation"][...]
    if emb.shape != (2, 3, IMAGE_SIZE, IMAGE_SIZE) or not np.isfinite(emb).all():
        fail(f"embeddings {emb.shape}, finite={np.isfinite(emb).all()}")
    if emb[:, 2].min() < 0:
        fail("negative uncertainty channel")
    if seg.shape != (2, 1, IMAGE_SIZE, IMAGE_SIZE):
        fail(f"segmentation shape {seg.shape}")
    instances = [int(len(np.unique(seg[s, 0])) - (seg[s, 0] == 0).any()) for s in range(2)]
    for s in range(2):
        ids = np.unique(seg[s, 0])
        ids = ids[ids > 0]
        if len(ids) and not np.array_equal(ids, np.arange(1, len(ids) + 1)):
            fail("segmentation labels are not consecutive from 1")
    if results is None or not all(0.0 <= results[0][k] <= 1.0 for k in ("F1", "SEG")):
        fail(f"evaluate results {results}")
    expected_k1 = 3 * math.ceil(9 / TILE_BATCH) * 2  # 3 passes per tile batch
    if launches["conv_pass_2d"] != expected_k1:
        fail(f"conv_pass_2d launched {launches['conv_pass_2d']} times, expected {expected_k1}")
    if launches["ball_stats"] <= 0:
        fail("ball_stats never launched on the main path")
    print(f"[main] stages (s): {json.dumps({k: round(v, 3) for k, v in stage_seconds.items()})}, "
          f"total {wall:.2f}s")
    print(f"[main] instances per sample {instances}, F1 {results[0]['F1']:.4f}, "
          f"SEG {results[0]['SEG']:.4f} (random weights), launches {json.dumps(launches)}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches


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
    k3 = phase_ball_stats(device)
    with tempfile.TemporaryDirectory() as work:
        phase_reference_checks(work, device)
        torch.cuda.reset_peak_memory_stats()
        launches = phase_main_path(work)
    rows = [
        {"name": "conv_pass_2d", "route": "cuda", "source": "cellulus_tpu_torch/csrc/conv_pass.cu",
         "replaces": "cellulus_tpu/ops/pallas_conv.py:55", "launches": launches["conv_pass_2d"],
         **k1},
        {"name": "ball_stats", "route": "cuda", "source": "cellulus_tpu_torch/csrc/ball_stats.cu",
         "replaces": "cellulus_tpu/ops/pallas_mean_shift.py:39", "launches": launches["ball_stats"],
         **k3},
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
