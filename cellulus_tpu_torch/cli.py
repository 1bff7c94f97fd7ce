"""Command line of the port (``cellulus_tpu/cli.py``'s commands).

    python -m cellulus_tpu_torch train <config.toml>
    python -m cellulus_tpu_torch infer <config.toml> [--checkpoint-sweep] [--keep-sweep-outputs]
    python -m cellulus_tpu_torch geometry <crop...> [--factors '2,2;2,2']
    python -m cellulus_tpu_torch export <config.toml> <out_dir> [--platforms P] [--tile-batch N]
    python -m cellulus_tpu_torch --version

``train(argv)``, ``infer(argv)``, ``geometry(argv)`` and ``export(argv)``
also run alone, as the JAX package's console scripts do. ``export`` writes
the tile predictor as a ``torch.export`` program (``export.py``).
"""

from __future__ import annotations

import argparse
import sys

from .configs import ExperimentConfig


def _load(config_file: str) -> ExperimentConfig:
    print(f"Reading config from {config_file}")
    return ExperimentConfig.from_toml(config_file)


def train(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Train a cellulus-tpu model (PyTorch port)")
    parser.add_argument("config_file")
    args = parser.parse_args(argv)
    from .train import train as run

    run(_load(args.config_file))


def infer(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Run cellulus-tpu inference (PyTorch port)")
    parser.add_argument("config_file")
    parser.add_argument(
        "--checkpoint-sweep",
        action="store_true",
        help="score EVERY retained checkpoint (numbered + best_loss) "
        "against the configured ground truth and select by measured F1 — "
        "the unsupervised training loss can anti-select on real data; "
        "requires evaluation_dataset_config",
    )
    parser.add_argument(
        "--keep-sweep-outputs",
        action="store_true",
        help="keep each checkpoint's stage outputs instead of deleting "
        "the throwaway sweep containers after scoring",
    )
    args = parser.parse_args(argv)
    if args.checkpoint_sweep:
        from .infer import checkpoint_sweep as run_sweep

        run_sweep(_load(args.config_file), keep_outputs=args.keep_sweep_outputs)
        return
    from .infer import infer as run

    run(_load(args.config_file))


def export(argv=None) -> None:
    """Serialize the trained tile predictor as a serving artifact
    (``torch.export``; see :mod:`cellulus_tpu_torch.export`)."""
    parser = argparse.ArgumentParser(
        description="Export a trained cellulus-tpu model for serving (PyTorch port)"
    )
    parser.add_argument("config_file", help="infer-style TOML naming the checkpoint")
    parser.add_argument("output_dir")
    parser.add_argument(
        "--platforms",
        default=None,
        help="comma-separated platforms, 'cpu' and/or 'cuda', one artifact each "
        "(default: the platform of inference_config.device)",
    )
    parser.add_argument("--tile-batch", type=int, default=None)
    args = parser.parse_args(argv)
    from .export import export_from_experiment

    platforms = args.platforms.split(",") if args.platforms else None
    out = export_from_experiment(
        _load(args.config_file),
        args.output_dir,
        tile_batch_size=args.tile_batch,
        platforms=platforms,
    )
    print(f"Serving artifact written to {out}")


def geometry(argv=None) -> None:
    """Print the U-Net input/output geometry for a crop size, and nearby
    valid alternatives."""
    parser = argparse.ArgumentParser(
        description="Inspect valid-conv U-Net geometry for a crop size"
    )
    parser.add_argument("crop_size", type=int, nargs="+")
    parser.add_argument(
        "--factors",
        default="2,2",
        help="downsampling factors: semicolon-separated levels of "
        "comma-separated per-dim factors, e.g. '2,2;2,2' or '1,2,2'",
    )
    args = parser.parse_args(argv)
    factors = [[int(f) for f in level.split(",")] for level in args.factors.split(";")]

    from .models.geometry import compute_geometry

    crop = tuple(args.crop_size)
    try:
        g = compute_geometry(crop, factors)
        print(f"input  {g.input_size}")
        print(f"output {g.output_size}")
        print(f"context (halo per side) {g.context}")
    except ValueError as e:
        print(f"invalid crop size {crop}: {e}")
    # nearby valid sizes along each dim (isotropic probe)
    valid = []
    for delta in range(0, 32):
        for sign in (1, -1) if delta else (1,):
            cand = tuple(c + sign * delta for c in crop)
            if any(c <= 0 for c in cand):
                continue
            try:
                valid.append((cand, compute_geometry(cand, factors).output_size))
            except ValueError:
                pass
        if len(valid) >= 5:
            break
    print("nearby valid sizes:")
    for cand, out in valid[:5]:
        print(f"  input {cand} -> output {out}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser(prog="cellulus_tpu_torch")
    parser.add_argument("--version", action="version", version=_version())
    sub = parser.add_subparsers(dest="command", required=True)
    for name, help_text in (
        ("train", "train the model; writes models/*.pth"),
        ("infer", "run predict -> detect -> segment -> evaluate"),
    ):
        p = sub.add_parser(name, help=help_text)
        p.add_argument("config_file")
        if name == "infer":
            p.add_argument("--checkpoint-sweep", action="store_true")
            p.add_argument("--keep-sweep-outputs", action="store_true")
    e = sub.add_parser("export", help="serving export (torch.export program)")
    e.add_argument("config_file")
    e.add_argument("output_dir")
    e.add_argument("--platforms", default=None)
    e.add_argument("--tile-batch", type=int, default=None)
    g = sub.add_parser("geometry", help="U-Net geometry of a crop size")
    g.add_argument("crop_size", type=int, nargs="+")
    g.add_argument("--factors", default="2,2")
    args = parser.parse_args(argv)
    if args.command == "train":
        train([args.config_file])
    elif args.command == "infer":
        rest = [args.config_file]
        if args.checkpoint_sweep:
            rest.append("--checkpoint-sweep")
        if args.keep_sweep_outputs:
            rest.append("--keep-sweep-outputs")
        infer(rest)
    elif args.command == "export":
        rest = [args.config_file, args.output_dir]
        if args.platforms:
            rest += ["--platforms", args.platforms]
        if args.tile_batch is not None:
            rest += ["--tile-batch", str(args.tile_batch)]
        export(rest)
    else:
        geometry([str(c) for c in args.crop_size] + ["--factors", args.factors])


def _version() -> str:
    from . import __version__

    return __version__
