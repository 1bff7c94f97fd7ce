"""The 2D learning gate's recipe at several training seeds, on the CPU, for
either package: how often each reaches the gate's bar (F1 >= 0.9).

    python tests/gate_seeds.py torch 0 1 2 --torch-threads 8
    python tests/gate_seeds.py jax 0 1 2 3 4
    python tests/gate_seeds.py jax 0 1 2 --recipe jax-gate

``--recipe gate`` (the default) trains the port's gate recipe
(``chip_smoke.gate_recipe``: grid loss, lr 1.5e-3, temperature 5,
regularizer 2e-3, 1000 steps on 2 x 128^2 synthetic blobs, seed 11 data);
``--recipe jax-gate`` trains ``tests/test_quality_gate.py``'s own recipe
(the same with lr 1e-3, temperature 10, regularizer 1e-5 and 400 steps). Each run
sets ``train_config.seed``, infers on the best-loss checkpoint, and prints
one ``RESULT`` line a seed with the F1, the seconds it took and the 50-step
mean losses; the last line counts the seeds that reach the bar.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
# tests/test_quality_gate.py's recipe, as changes to the gate's
JAX_GATE = {"initial_learning_rate": 1e-3, "temperature": 10.0, "regularizer_weight": 1e-5,
            "max_iterations": 400, "save_model_every": 399}


def run(package: str, seed: int, work: str, recipe: str) -> float:
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    overrides = JAX_GATE if recipe == "jax-gate" else {}
    t0 = time.perf_counter()
    if package == "torch":
        with contextlib.redirect_stdout(io.StringIO()):
            f1, _, _, _, _, windows = smoke.learn_grid(
                work, seed, device="cpu", iters=overrides.get("max_iterations"),
                overrides=overrides)
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        import cellulus_tpu
        from cellulus_tpu.configs import ExperimentConfig

        cfg = smoke.gate_recipe(smoke._gate_container(work, "data.zarr"), seed)
        cfg["train_config"].update(overrides)
        config = ExperimentConfig(**cfg)
        with contextlib.chdir(work), contextlib.redirect_stdout(io.StringIO()):
            state = cellulus_tpu.train(config)
            config.model_config.checkpoint = str(Path("models") / "best_loss.ckpt")
            results = cellulus_tpu.infer(config)
        f1 = max(r["F1"] for r in results.values())
        windows = np.asarray(state["logger_data"]["loss"]).reshape(-1, 50).mean(axis=1)
    print(f"RESULT {package} {recipe} seed {seed}: F1 {f1:.4f} in "
          f"{time.perf_counter() - t0:.1f}s windows {windows.round(0).tolist()}", flush=True)
    return f1


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("package", choices=("jax", "torch"))
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--recipe", choices=("gate", "jax-gate"), default="gate")
    ap.add_argument("--torch-threads", type=int, default=None)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if args.torch_threads and args.package == "torch":
        import torch

        torch.set_num_threads(args.torch_threads)
    f1s = []
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as work:
            f1s.append(run(args.package, seed, work, args.recipe))
    print(f"{args.package} {args.recipe}: {sum(f >= 0.9 for f in f1s)}/{len(f1s)} seeds reach "
          "F1 >= 0.9")


if __name__ == "__main__":
    main()
