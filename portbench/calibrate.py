"""Readings for the limits of a cell's check, many seeds in one process.

    python3 -m portbench.calibrate --workload <name> --seeds 11,12,13 --mode program

For each seed: the cell's set-up, a window of ``--seconds`` (0: one pass
of the traffic, or no step past the checked ones), then the check in
``--mode``: ``program`` (the port, as a run checks it), ``control`` (the
reference a precision lower in the program's place: fp8 convolutions and a
bfloat16 detect for inference, TF32 for float32 training) or, for
training, a fault planted in the reference put in the program's place
(``half``, ``altered``). One JSON line a seed: the compared numbers and
the window's end-to-end metrics. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--mode", default="program")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    files = run.cell_files(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = run.run_cell(files, seed, args.seconds, False, mode=args.mode)
        bad = run.forbidden_modules()
        if bad:
            print(f"portbench: modules loaded that a run must not load: {bad}",
                  file=sys.stderr)
            return 3
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "numbers": out["numbers"],
                          "end_to_end": out["details"]["end_to_end"],
                          "check_s": out["check_s"], "peak": out["peak"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
