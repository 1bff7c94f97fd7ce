"""K2, the 3x3 filter gradient (``csrc/conv_dw.cu``): the least time the
window's filter gradients need on the card (per gradient the larger of its
FLOPs over the peak and its bytes over HBM's bandwidth,
``flops.k2_cost``; float32 against the TF32 rate of 495 TFLOP/s) over the
device time of K2's kernels in the trace, in %. Silent where no K2 kernel
ran."""

import torch

from portbench import flops

KERNELS = r"conv_dw_kernel|conv_dw_reduce_kernel"


def read(ctx):
    trace, work = ctx["trace"], ctx["work"]
    if trace is None or "k2_shapes" not in work:
        return None
    seconds = trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    bf16 = work["dtype"] == torch.bfloat16
    peak, elem = (flops.PEAK_BF16, 2) if bf16 else (flops.PEAK_TF32, 4)
    least = work["steps"] * sum(flops.least_seconds(*flops.k2_cost(xs, gs, elem), peak)
                                for xs, gs in work["k2_shapes"])
    return 100.0 * least / seconds
