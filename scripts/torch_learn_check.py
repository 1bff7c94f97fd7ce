"""The port's learning gates over several training seeds, on one GPU.

    python3 scripts/torch_learn_check.py [grid] [3d] [hela] [--seeds 0,1,2,3,4] [--out PATH]

- ``grid``: ``chip_smoke.py``'s ``[learn-grid]`` (the gate's recipe,
  ``chip_smoke.gate_recipe``: grid loss, lr 1.5e-3, temperature 5,
  regularizer 2e-3, 1000 steps, infer on best_loss.pth) at each training
  seed of ``--seeds``; the gate's bar is F1 >= 0.9.
- ``3d``: tests/test_quality_3d.py's recipe (scripts/validate_quality.py
  ``--ndim 3 --iters 2500 --pair-count-mode all_dims``: 2 x 128^3 synthetic
  blobs, 24 fmaps, factor 3, [1, 2, 2], crop 40x76x76, batch 2, kappa 8,
  density 0.05, lr 4e-4, bf16, host elastic; infer in float32 with float16
  transfer) at each training seed; its bar is F1 >= 0.85 and SEG >= 0.6,
  and the rate of seeds that pass is reported. The fit input (sample 0) of
  the seed with the best F1 then runs through ``[K3-fit]``.
- ``hela``: scripts/torch_real_hela.py's full recipe (5,000 steps), nucleus
  and cell mode against the silver truth.

Each result prints as one line with its seed and goes into the JSON file
``--out`` (default ``chiprun_out/learn_check.json``), with the card's name
and power limit. Exits non-zero when CUDA is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402
import cellulus_tpu_torch  # noqa: E402

RECIPE_3D_STEPS = 2500
MODEL_3D = dict(num_fmaps=24, fmap_inc_factor=3, downsampling_factors=[[1, 2, 2]])
CROP_3D = [40, 76, 76]


def run_3d(work, seed, steps=RECIPE_3D_STEPS):
    """tests/test_quality_3d.py's recipe at training seed ``seed``; returns
    its scores, train seconds, loss extremes and the container."""
    os.makedirs(work, exist_ok=True)
    size = 128
    container = smoke.write_blob_container(os.path.join(work, "data.zarr"), 2, size, seed=11,
                                           dtype=np.uint8, ndim=3, num_blobs=12,
                                           radius=(0.04, 0.09))
    config = smoke.train_config(
        container, MODEL_3D, seed=seed, batch_size=2, kappa=8.0, loss_mode="pairs",
        pair_count_mode="all_dims", density=0.05, crop_size=CROP_3D, max_iterations=steps,
        initial_learning_rate=4e-4, num_workers=4, elastic_deform=True, precision="bfloat16",
        save_model_every=max(500, steps // 2), save_snapshot_every=10**9,
        save_best_model_every=100)
    object_size = int(size * 0.13)
    config.object_size = object_size
    with contextlib.chdir(work), smoke.logged(os.path.join(work, "train.log")):
        t0 = time.perf_counter()
        state = cellulus_tpu_torch.train(config)
        seconds = time.perf_counter() - t0
        ic = smoke.infer_config(container, os.path.join("models", "best_loss.pth"), MODEL_3D,
                                object_size=object_size, device=smoke.DEVICE,
                                crop_size=CROP_3D, tile_batch_size=4,
                                transfer_precision="float16")
        results = cellulus_tpu_torch.infer(ic)
        best = torch.load(os.path.join("models", "best_loss.pth"), weights_only=True)["iteration"]
    losses = np.asarray(state["logger_data"]["loss"])
    return {"seed": seed, "F1": float(results[0]["F1"]), "SEG": float(results[0]["SEG"]),
            "best_iteration": int(best), "train_seconds": seconds,
            "loss_first": float(losses[0]), "loss_max": float(losses.max()),
            "loss_last": float(losses[-1]), "container": container, "ic": ic.inference_config}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checks", nargs="*", default=["grid", "3d", "hela"])
    ap.add_argument("--seeds", default="0,1,2,3,4",
                    help="comma-separated training seeds")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "learn_check.json"))
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    if not torch.cuda.is_available():
        print("torch_learn_check: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    with tempfile.TemporaryDirectory() as work:
        if "grid" in args.checks:
            rows = []
            for seed in seeds:
                f1, seg, best, launches, seconds, windows = smoke.learn_grid(
                    os.path.join(work, f"grid_{seed}"), seed=seed)
                rows.append({"seed": seed, "F1": f1, "SEG": seg, "best_iteration": best,
                             "train_seconds": seconds, "k2_launches": launches,
                             "loss_windows": windows.round(2).tolist()})
                print(f"[learn-grid] seed {seed}: F1 {f1:.4f} SEG {seg:.4f} (bar F1 >= 0.9: "
                      f"{'pass' if f1 >= 0.9 else 'FAIL'}), best_loss.pth from iteration "
                      f"{best}, {seconds:.1f}s", flush=True)
            f1s = np.array([r["F1"] for r in rows])
            print(f"[learn-grid] {int((f1s >= 0.9).sum())}/{len(rows)} seeds reach F1 >= 0.9 "
                  f"(the same recipe on the CPU, tests/gate_seeds.py: the JAX package 10/10 "
                  f"over seeds 0-9, the port 10/10 at 1 thread and 27/30 at 8 over seeds "
                  f"0-29); F1 min "
                  f"{f1s.min():.4f}, median {np.median(f1s):.4f}, max "
                  f"{f1s.max():.4f}", flush=True)
            report["learn_grid"] = rows
        if "3d" in args.checks:
            rows, best = [], None
            for seed in seeds:
                r = run_3d(os.path.join(work, f"q3d_{seed}"), seed)
                passed = r["F1"] >= 0.85 and r["SEG"] >= 0.6
                print(f"[3d-learn] seed {seed}: F1 {r['F1']:.4f} SEG {r['SEG']:.4f} "
                      f"({'pass' if passed else 'fail'} at F1 >= 0.85, SEG >= 0.6), best_loss.pth "
                      f"from iteration {r['best_iteration']}, loss first/max/last "
                      f"{r['loss_first']:.4g} / {r['loss_max']:.4g} / {r['loss_last']:.4g}, "
                      f"{r['train_seconds']:.1f}s", flush=True)
                if best is None or r["F1"] > best["F1"]:
                    best = r
                rows.append({k: v for k, v in r.items() if k not in ("container", "ic")}
                            | {"pass": passed})
            print(f"[3d-learn] {sum(r['pass'] for r in rows)}/{len(rows)} seeds pass "
                  f"(the JAX package's rate at steps_per_dispatch 1: 3/5)", flush=True)
            report["learn_3d"] = rows
            # the best-trained 3D fit input through the fit kernel
            _, _, _, X_fit, seeds_np, _, problem = smoke._detect_in_parts(
                best["container"], best["ic"], 3, torch.device(smoke.DEVICE), 1)
            fit = smoke.time_fit(f"trained 3D input (seed {best['seed']}, F1 {best['F1']:.4f}, "
                                 "sample 0)", *problem, best["ic"].mean_shift_max_iterations)
            fit.pop("out")
            report["fit_trained_3d"] = fit | {"S": len(seeds_np), "N": len(X_fit),
                                              "seed": best["seed"]}
        if "hela" in args.checks:
            hela = smoke._load_script("torch_real_hela")
            with open(os.path.join(work, "hela.log"), "w") as log:
                r = hela.run_hela(os.path.join(work, "hela"), 5000, smoke.DEVICE, log=log)
            print(f"[hela] 5000 steps in {r['train_seconds']:.1f}s, best_loss.pth from "
                  f"iteration {r['best_iteration']}: nucleus F1 {r['nucleus']['F1']:.4f} SEG "
                  f"{r['nucleus']['SEG']:.4f}, cell F1 {r['cell']['F1']:.4f} SEG "
                  f"{r['cell']['SEG']:.4f}", flush=True)
            report["hela"] = r
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=float)
    print(json.dumps({"ok": True, "card": card}))


if __name__ == "__main__":
    main()
