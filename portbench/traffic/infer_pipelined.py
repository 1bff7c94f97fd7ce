"""Inference through the port's pipelined path, a closed loop over passes.

Set-up writes ``staged_passes`` zarr containers of ``images_per_pass``
seeded images each and one of ``warmup_images`` more, builds the port's
U-Net with the seeded weights and runs
``cellulus_tpu_torch.pipeline.infer_pipelined`` once over the last (every
shape the window uses). The window runs ``infer_pipelined`` over the
staged containers in turn, each pass into an output container of its own,
until ``--seconds`` have passed. Every image of a window is new to the
program, as in a stream of acquisitions: no cache keyed by an image's
size or content (the fit's plan by point count, the zarr chunk cache)
serves it from an earlier pass. One producer
(predict in the calling thread) and the pipeline's two stage workers
(detect and segment). It reports the input pixels (voxels) of the passes
over their time, and the 90th percentile over every image of the window
of its time from the start of its predict to the end of its segment.

The check draws ``judge_images`` images of the window from the seed and
holds each stage's output to the reference: the embeddings against the
reference's tiled TTA forward in float32, the detections against the
reference's detection of the program's embeddings, the segmentation
against the reference's segmentation of the program's detections.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import flops, inputs
from ..reference import infer as ref
from ..reference import judge
from ..reference.unet import fp8_quantize, no_tf32

# the three per-sample streams of a run's seed: images, weights, the check's draw
IMAGES, WEIGHTS, CHECK = 1, 2, 3


def derived(config: dict) -> dict:
    """The inference keys the port derives from ``object_size`` (``infer.py``)."""
    ic = dict(config["infer"])
    ndim = len(ic["crop_size"])
    size = ic["object_size"]
    ic.setdefault("bandwidth", 0.5 * size)
    if ndim == 2:
        ic.setdefault("min_size", int(0.1 * np.pi * (size**2) / 4))
    else:
        ic.setdefault("min_size", int(0.1 * 4.0 / 3.0 * np.pi * (size**3) / 8))
    return ic


def tile_batches(image_size, out_tile, tile_batch_size: int):
    """The number of tiles of each tile batch of one image."""
    n = math.prod(len(ref.tile_origins(max(s, o), o)) for s, o in zip(image_size, out_tile))
    return [min(tile_batch_size, n - i) for i in range(0, n, tile_batch_size)]


def _write_images(path: Path, images: np.ndarray) -> None:
    from cellulus_tpu_torch.io import zarr

    ndim = images.ndim - 2
    f = zarr.open(path, "a")
    f["raw"] = images
    f["raw"].attrs.update({"axis_names": ["s", "c"] + ["z", "y", "x"][-ndim:],
                           "resolution": [1] * ndim})


def _config(ic: dict, seed: int, data: Path, out: Path, device):
    from cellulus_tpu_torch.configs import InferenceConfig

    keys = ("crop_size", "tile_batch_size", "num_infer_iterations", "p_salt_pepper",
            "clustering", "reduction_probability", "mean_shift_max_iterations",
            "num_bandwidths", "post_processing", "grow_distance", "shrink_distance",
            "precision", "pipelined", "bandwidth", "min_size")
    return InferenceConfig(
        dataset_config={"container_path": str(data), "dataset_name": "raw"},
        prediction_dataset_config={"container_path": str(out), "dataset_name": "embeddings"},
        detection_dataset_config={"container_path": str(out), "dataset_name": "detection",
                                  "secondary_dataset_name": "embeddings"},
        segmentation_dataset_config={"container_path": str(out),
                                     "dataset_name": "segmentation",
                                     "secondary_dataset_name": "detection"},
        seed=seed, device=str(device), **{k: ic[k] for k in keys})


def quiet():
    """The program's progress prints go to standard error: standard output
    ends with the result line."""
    return contextlib.redirect_stdout(sys.stderr)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, workdir: Path,
                 timings: dict):
        from cellulus_tpu_torch.models import UNet

        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device, self.workdir = torch.device(device), workdir
        self.model_cfg = config["model"]
        self.ic = derived(config)
        self.size = tuple(traffic["image_size"])
        self.ndim = len(self.size)
        crop = tuple(self.ic["crop_size"])
        factors = self.model_cfg["downsampling_factors"]
        self.out_tile = flops.output_size(crop, factors)
        self.context = flops.context(crop, factors)
        self.batch_tiles = tile_batches(self.size, self.out_tile, self.ic["tile_batch_size"])
        self.dtype = torch.bfloat16 if self.ic["precision"] == "bfloat16" else torch.float32
        if self.dtype == torch.float32:
            no_tf32()

        t = time.perf_counter()
        n = int(traffic["images_per_pass"])
        gen = inputs.generator(self.device, self.seed, IMAGES)
        # (staged passes, images, C, *size), drawn a pass at a time
        self.images = np.stack([inputs.nuclei(n, self.size, self.device, gen)
                                for _ in range(int(traffic["staged_passes"]))])
        self.data = [workdir / f"in-{j}.zarr" for j in range(len(self.images))]
        for path, images in zip(self.data, self.images):
            _write_images(path, images)
        warm = workdir / "warm.zarr"
        _write_images(warm, inputs.nuclei(int(traffic["warmup_images"]), self.size,
                                          self.device, gen))
        self.weights = inputs.weights(self.model_cfg, self.ndim, self.device,
                                      inputs.generator(self.device, self.seed, WEIGHTS))
        timings["data_s"] = time.perf_counter() - t

        t = time.perf_counter()
        m = self.model_cfg
        self.model = UNet(m["in_channels"], self.ndim, m["num_fmaps"], m["fmap_inc_factor"],
                          m["features_in_last_layer"], factors, self.ndim,
                          m["constant_upsample"])
        self.model.load_state_dict({k: v.clone() for k, v in self.weights.items()})
        self.model.to(self.device).eval()
        with quiet():
            self._pass(warm, workdir / "out-warm.zarr", {})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timings["warmup_s"] = time.perf_counter() - t
        self.passes = []

    def _pass(self, data: Path, out: Path, intervals: dict) -> None:
        from cellulus_tpu_torch.pipeline import infer_pipelined

        ic = _config(self.ic, self.seed, data, out, self.device)
        infer_pipelined(self.model, ic, None, self.device, self.dtype, intervals=intervals)

    def window(self, seconds: float) -> dict:
        """Passes back to back until ``seconds`` have passed."""
        t0 = time.perf_counter()
        with quiet():
            while True:
                iv = {}
                out = self.workdir / f"out-{len(self.passes)}.zarr"
                with torch.profiler.record_function("portbench: pass"):
                    self._pass(self.data[len(self.passes) % len(self.data)], out, iv)
                self.passes.append((out, iv))
                if time.perf_counter() - t0 >= seconds:
                    break
        t1 = time.perf_counter()
        latency, predict_s, detect_s, segment_s = [], [], [], []
        for _, iv in self.passes:
            for s, (p0, p1) in iv["predict"].items():
                d0, d1 = iv["detect"][s]
                s0, s1 = iv["segment"][s]
                latency.append(s1 - p0)
                predict_s.append(p1 - p0)
                detect_s.append(d1 - d0)
                segment_s.append(s1 - s0)
        images = len(latency)
        mpx = images * math.prod(self.size) / 1e6
        return {
            "end_to_end": {"infer_mpx_s": mpx / (t1 - t0),
                           "infer_p90_s": float(np.percentile(latency, 90))},
            "attempted": images, "failed": 0, "window_s": t1 - t0,
            "images": images, "passes": len(self.passes), "latency_s": latency,
            "predict_s": predict_s, "detect_s": detect_s, "segment_s": segment_s,
        }

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.model
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def outputs(self, p: int, s: int):
        from cellulus_tpu_torch.io import zarr

        f = zarr.open(self.passes[p][0], "r")
        return (np.asarray(f["embeddings"][s], np.float32),
                np.asarray(f["binary-segmentation"][s, 0]).astype(bool),
                np.asarray(f["detection"][s, 0]).astype(np.int64),
                np.asarray(f["segmentation"][s, 0]).astype(np.int64))

    def judge(self, mode: str = "program") -> dict:
        """The compared numbers over ``judge_images`` images drawn from the
        seed. ``mode="control"`` puts the reference in the program's place,
        computed a precision lower (fp8 convolutions, a bfloat16 detect)."""
        restore = no_tf32()
        try:
            return self._judge(mode)
        finally:
            restore()

    def _judge(self, mode: str) -> dict:
        rng = np.random.default_rng([self.seed, CHECK])
        n = self.images.shape[1]
        k = min(int(self.traffic["judge_images"]), n)
        picks = [(int(rng.integers(len(self.passes))), int(s))
                 for s in rng.choice(n, size=k, replace=False)]
        ic = self.ic
        norm = 1.0 / 255.0
        numbers = {"offset_px": 0.0, "std_gap": 0.0, "mask_px": 0, "detect_gap": 0.0,
                   "segment_px": 0}
        for p, s in picks:
            image = self.images[p % len(self.data)][s]
            want = ref.tta_sample(self.weights, self.model_cfg, ic, image, norm,
                                  self.seed, s, self.out_tile, self.context, self.device)
            if mode == "control":
                emb = ref.tta_sample(self.weights, self.model_cfg, ic, image, norm,
                                     self.seed, s, self.out_tile, self.context, self.device,
                                     quantize=fp8_quantize)
                mask, det = ref.detect(emb, ic, self.seed, s, self.device, torch.bfloat16)
                seg = ref.segment(det, ic)
            else:
                emb, mask, det, seg = self.outputs(p, s)
            ref_mask, ref_det = ref.detect(emb, ic, self.seed, s, self.device)
            numbers["offset_px"] = max(numbers["offset_px"], judge.rms_gap(emb[:-1], want[:-1]))
            numbers["std_gap"] = max(numbers["std_gap"], judge.rel_gap(emb[-1], want[-1]))
            numbers["mask_px"] += int((mask != ref_mask).sum())
            numbers["detect_gap"] = max(numbers["detect_gap"],
                                        judge.partition_gap(det, ref_det))
            numbers["segment_px"] += judge.label_px(seg, ref.segment(det, ic))
        return numbers

    def work(self, details: dict) -> dict:
        """What the window's forwards computed, for the per-layer readers."""
        copies = 2 * int(self.ic["num_infer_iterations"])
        crop = tuple(self.ic["crop_size"])
        return {
            "flops": details["images"] * copies * sum(self.batch_tiles)
            * flops.model_flops(self.model_cfg, crop, self.ndim),
            "k1_batches": [copies * t for t in self.batch_tiles] * details["images"],
            "passes": flops.conv_passes(self.model_cfg, crop),
            "dtype": self.dtype,
        }
