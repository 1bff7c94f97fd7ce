"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) if it fails:

1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. the build: every kernel of ``cellulus_tpu_torch/csrc`` built by ``nvcc``
   for ``sm_90a``, all at once, timed;
3. K1, the fused conv pass: the kernel against its plain version at the
   three pass shapes of the full-width 2D model's tile batch, in float32
   (TF32 off) and bfloat16, with timings;
4. K2, the 3x3 filter gradient: the kernel against its plain version at the
   six dw shapes of the full-width train step, float32 and bfloat16, with
   its plain, cuDNN (``conv2d_weight``) and bound times;
5. K3, the mean-shift ball statistics: the kernel against its plain version
   on random points and on points lying exactly on the ball boundary;
6. reference checks: the full-width U-Net on the card against the CPU
   (forward, and every gradient of the training path), mean-shift labels,
   and ``conv_pass_2d`` refusing to run under autograd;
7. the infer main path: ``cellulus_tpu_torch.infer`` with the default
   inference settings, on a synthetic 2-sample 512x512 uint16 container and
   seeded random weights at the full width of ``examples/2d``, through
   predict -> detect -> segment -> evaluate; K1 and K3 must have launched;
8. the train main path: ``cellulus_tpu_torch.train`` at the full width of
   ``examples/2d/train.toml`` (bf16, elastic on, device pairs) for 20 steps,
   K2 launched 6 times a step, a resume, 3 float32 steps, then infer on the
   trained checkpoint;
9. learn: a small recipe trains 400 steps and must beat its step-0 F1;
10. the kernels line (JSON), then the last line
    ``{"ok": true, "device": {...}}``.

Needs CUDA: without it the script exits non-zero and prints no result.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
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
from cellulus_tpu_torch.ops.conv_dw import conv3x3_dw, conv3x3_dw_plain
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
TRAIN_BATCH = 8
DEVICE = "cuda:0"
OBJECT_SIZE = 40
IMAGE_SIZE = 512


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def make_blobs(num_samples, size, seed, dtype=np.uint16, num_blobs=40, radius=(0.025, 0.045)):
    """Bright disks on a dark noisy background: ``(raw (s, 1, H, W),
    labels (s, 1, H, W) uint16)``; radii are ``radius`` times ``size``."""
    rng = np.random.default_rng(seed)
    raw = np.zeros((num_samples, 1, size, size), np.float32)
    labels = np.zeros((num_samples, 1, size, size), np.uint16)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    for s in range(num_samples):
        next_id = 1
        for _ in range(num_blobs):
            r = rng.uniform(radius[0] * size, radius[1] * size)
            cy, cx = rng.uniform(r, size - r, size=2)
            dist2 = (yy - cy) ** 2 + (xx - cx) ** 2
            mask = dist2 < r**2
            if (labels[s, 0][mask] != 0).any():
                continue
            labels[s, 0][mask] = next_id
            raw[s, 0][mask] = rng.uniform(0.6, 1.0) * np.exp(
                -dist2[mask] / (2 * (r / 1.5) ** 2)
            )
            next_id += 1
        raw[s, 0] += rng.normal(0, 0.02, (size, size)).clip(0)
    scale = np.iinfo(dtype).max
    return (raw.clip(0, 1) * scale).astype(dtype), labels


def write_blob_container(path, num_samples, size, seed, dtype=np.uint16, **blobs):
    raw, labels = make_blobs(num_samples, size, seed, dtype, **blobs)
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
            ref = conv3x3_dw_plain(x, g)
            torch.cuda.synchronize()
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
            del got, ref, err
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
    grads = {}
    for dev in ("cpu", device):
        net.to(dev).zero_grad()
        net(x.to(dev)).square().sum().backward()
        # clone: moving the module later rewrites .grad in place
        grads[str(dev)] = {k: p.grad.cpu().clone() for k, p in net.named_parameters()}
    cpu_g, gpu_g = grads["cpu"], grads[str(device)]
    zero = [k for k, g in gpu_g.items() if not bool(g.abs().sum() > 0)]
    if zero:
        fail(f"training path left these gradients zero on the card: {zero}")
    worst = max(float((gpu_g[k] - cpu_g[k]).abs().max() / cpu_g[k].abs().max()) for k in cpu_g)
    if not worst <= 1e-4:
        fail(f"U-Net gradients card vs CPU: max abs err / max|grad| {worst:.3g} (limit 1e-4)")
    print(f"[check] conv_pass_2d raises under autograd; training-path gradients of all "
          f"{len(gpu_g)} tensors non-zero, card vs CPU max abs err / max|grad| {worst:.3g} "
          f"(limit 1e-4)")


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


def train_config(container, model, **train):
    return ExperimentConfig(**{
        "object_size": OBJECT_SIZE,
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
    return launches


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
    k2 = phase_conv_dw(device)
    k3 = phase_ball_stats(device)
    with tempfile.TemporaryDirectory() as work:
        phase_reference_checks(work, device)
        torch.cuda.reset_peak_memory_stats()
        launches = phase_main_path(work)
        launches["conv3x3_dw"] = phase_train(work, k2[torch.bfloat16]["ms"])
        phase_learn(work)
    rows = [
        {"name": "conv_pass_2d", "route": "cuda", "source": "cellulus_tpu_torch/csrc/conv_pass.cu",
         "replaces": "cellulus_tpu/ops/pallas_conv.py:55", "launches": launches["conv_pass_2d"],
         **k1},
        {"name": "conv3x3_dw", "route": "cuda", "source": "cellulus_tpu_torch/csrc/conv_dw.cu",
         "replaces": "cellulus_tpu/ops/pallas_dw.py:64", "launches": launches["conv3x3_dw"],
         **k2[torch.bfloat16]},
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
