"""Command line: ``python -m cellulus_tpu_torch {train,infer} <config.toml>``."""

from __future__ import annotations

import argparse

from .configs import ExperimentConfig


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="cellulus_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, help_text in (
        ("train", "train the model; writes models/*.pth"),
        ("infer", "run predict -> detect -> segment -> evaluate"),
    ):
        sub.add_parser(name, help=help_text).add_argument("config_file")
    args = parser.parse_args(argv)
    print(f"Reading config from {args.config_file}")
    config = ExperimentConfig.from_toml(args.config_file)
    if args.command == "train":
        from .train import train

        train(config)
    else:
        from .infer import infer

        infer(config)
