"""The 2D learning gate's recipe at several training seeds, on the CPU, for
either package: how often each reaches the gate's bar.

    python tests/gate_seeds.py jax 0 1 2 3 4
    python tests/gate_seeds.py torch 0 1 2 --torch-threads 2

Trains ``tests/test_quality_gate.py``'s recipe (``chip_smoke.gate_recipe``:
grid loss, lr 1e-3, 400 steps on 2 x 128^2 synthetic blobs, seed 11 data)
with ``train_config.seed`` set to each seed, infers on the best-loss
checkpoint, and prints one ``RESULT`` line a seed with the F1 and the
50-step mean losses. The outcome moves with the arithmetic (thread counts,
the package's reduction order), so compare packages over many seeds.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def run(package: str, seed: int, work: str) -> float:
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    if package == "torch":
        with contextlib.redirect_stdout(io.StringIO()):
            f1, _, _, _, _, windows = smoke.learn_grid(work, seed, device="cpu")
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        import cellulus_tpu
        from cellulus_tpu.configs import ExperimentConfig

        config = ExperimentConfig(**smoke.gate_recipe(smoke._gate_container(work, "data.zarr"),
                                                      seed))
        with contextlib.chdir(work), contextlib.redirect_stdout(io.StringIO()):
            state = cellulus_tpu.train(config)
            config.model_config.checkpoint = str(Path("models") / "best_loss.ckpt")
            results = cellulus_tpu.infer(config)
        f1 = max(r["F1"] for r in results.values())
        windows = np.asarray(state["logger_data"]["loss"]).reshape(-1, 50).mean(axis=1)
    print(f"RESULT {package} seed {seed}: F1 {f1:.4f} windows {windows.round(0).tolist()}",
          flush=True)
    return f1


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("package", choices=("jax", "torch"))
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--torch-threads", type=int, default=None)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if args.torch_threads and args.package == "torch":
        import torch

        torch.set_num_threads(args.torch_threads)
    f1s = []
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as work:
            f1s.append(run(args.package, seed, work))
    print(f"{args.package}: {sum(f >= 0.9 for f in f1s)}/{len(f1s)} seeds reach F1 >= 0.9")


if __name__ == "__main__":
    main()
