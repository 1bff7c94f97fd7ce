"""The model FLOPs of the traced window (every TTA forward of inference;
three forwards a training step: forward, input and filter gradients), over
the window, as a share of the card's peak in the configuration's type
(bfloat16 989 TFLOP/s; float32 the TF32 rate of 495 TFLOP/s, the highest at
which the card takes float32 inputs), in %."""

import torch

from portbench import flops


def read(ctx):
    trace, work = ctx["trace"], ctx["work"]
    if trace is None or trace.window_s <= 0 or not work["flops"]:
        return None
    peak = flops.PEAK_BF16 if work["dtype"] == torch.bfloat16 else flops.PEAK_TF32
    return 100.0 * work["flops"] / trace.window_s / peak
