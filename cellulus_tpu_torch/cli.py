"""Command line: ``python -m cellulus_tpu_torch infer <config.toml>``."""

from __future__ import annotations

import argparse

from .configs import ExperimentConfig


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="cellulus_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("infer", help="run predict -> detect -> segment -> evaluate")
    p.add_argument("config_file")
    args = parser.parse_args(argv)
    print(f"Reading config from {args.config_file}")
    config = ExperimentConfig.from_toml(args.config_file)
    from .infer import infer

    infer(config)
