"""cellulus_tpu_torch: the PyTorch/CUDA port of cellulus-tpu, for NVIDIA Hopper.

A second package beside the JAX package ``cellulus_tpu``, which stays the
reference. It imports ``torch``, ``numpy`` and ``scipy`` and nothing of JAX
or of ``cellulus_tpu``. Entry points run on CUDA unless the caller asks for
the CPU; on the card the hot operations are hand-written CUDA kernels
(``csrc/``), on the CPU their plain PyTorch versions.

    import cellulus_tpu_torch
    cellulus_tpu_torch.train(experiment_config)   # writes models/*.pth
    cellulus_tpu_torch.infer(experiment_config)
"""

import importlib

__version__ = "0.1.0"


def train(experiment_config, step_times=None):
    # imported on first use; the import rebinds this attribute to the
    # module, which is callable (see train.py)
    mod = importlib.import_module(".train", __name__)
    return mod.train(experiment_config, step_times)


def infer(experiment_config, stage_seconds=None, intervals=None):
    # imported on first use (it imports torch); the import rebinds this
    # attribute to the module, which is callable (see infer.py)
    mod = importlib.import_module(".infer", __name__)
    return mod.infer(experiment_config, stage_seconds, intervals)


__all__ = ["infer", "train", "__version__"]
