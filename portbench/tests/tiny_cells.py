"""The benchmark's cells at sizes a CPU test run holds: the same
configurations, traffic and limits, with the widths, crops and images cut
so that a run takes seconds on the CPU with the port's plain kernels."""

from __future__ import annotations

import copy

from portbench import run


def tiny(name: str) -> dict:
    files = copy.deepcopy(run.cell_files(name))
    config, traffic = files["config"], files["traffic"]
    config["model"]["num_fmaps"] = 4
    if traffic["kind"] == "train_step":
        config["train"].update(crop_size=[60, 60], batch_size=2, kappa=4.0)
        traffic.update(images=2, image_size=[96, 96], pool_batches=2)
    elif len(config["infer"]["crop_size"]) == 2:
        config["infer"].update(crop_size=[44, 44], object_size=8)
        traffic.update(image_size=[56, 56], images_per_pass=3, staged_passes=2,
                       warmup_images=1, judge_images=2)
    else:
        config["infer"].update(crop_size=[20, 28, 28], object_size=6)
        traffic.update(image_size=[16, 24, 24], images_per_pass=2, staged_passes=2,
                       warmup_images=1, judge_images=1)
    return files


def run_tiny(name: str, seed: int = 2**31 + 11, mode: str = "program", fault=None,
             trace: bool = False) -> dict:
    files = tiny(name)
    out = run.run_cell(files, seed, 0.0, trace, device="cpu", require_card=False,
                       mode=mode, fault=fault)
    return run.report(files, out, trace, device="cpu")
