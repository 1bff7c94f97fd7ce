"""K1, the fused conv pass (``csrc/conv_pass.cu``): the least time the
window's conv passes need on the card (per pass the larger of its FLOPs
over the peak and its bytes over HBM's bandwidth, ``flops.k1_pass_cost``,
for every pass of every TTA tile batch) over the device time of K1's
kernels in the trace, in %. Silent where no K1 kernel ran."""

import torch

from portbench import flops

KERNELS = r"conv_pass_kernel|conv_stage_kernel"


def read(ctx):
    trace, work = ctx["trace"], ctx["work"]
    if trace is None or "k1_batches" not in work:
        return None
    seconds = trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    bf16 = work["dtype"] == torch.bfloat16
    peak, elem = (flops.PEAK_BF16, 2) if bf16 else (flops.PEAK_TF32, 4)
    least = 0.0
    for B in work["k1_batches"]:
        for _, (H, W), c_in, c_out in work["passes"]:
            least += flops.least_seconds(*flops.k1_pass_cost(B, H, W, c_in, c_out, elem), peak)
    return 100.0 * least / seconds
