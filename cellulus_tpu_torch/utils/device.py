"""The device the port runs on.

Entry points run on CUDA unless the caller asks for the CPU. A CUDA device
that is asked for but missing is an error: the port never carries on
silently on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but CUDA is not "
                "available; pass device='cpu' to run on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(device)!r} (use 'cuda:N' or 'cpu')")


def compute_dtype_for(precision: str) -> torch.dtype:
    if precision == "bfloat16":
        return torch.bfloat16
    if precision == "float32":
        return torch.float32
    raise ValueError(f"precision must be 'float32' or 'bfloat16', got {precision!r}")


def generator_seed(*entropy: int) -> int:
    """The seed :func:`seeded_generator` gives its generator: a
    ``SeedSequence`` hash of the integers ``entropy``, so ``(s, 1)`` and
    ``(s + 1, 0)`` give unrelated streams."""
    return int(np.random.SeedSequence([int(e) for e in entropy]).generate_state(1, np.uint64)[0])


def seeded_generator(device, *entropy: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by :func:`generator_seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(generator_seed(*entropy))
    return gen
