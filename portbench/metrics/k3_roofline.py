"""K3, the mean-shift fit (``csrc/ball_stats.cu``): the least time the
window's fits need on the card over the device time of
``mean_shift_fit_kernel`` in the trace, in %.

The least time is 2d + 4 operations a live (seed, point) pair an
iteration, ``k3.pair_iterations`` of them, at the card's float32 CUDA-core
peak of 67 TFLOP/s: PERF.md's K3 bound (the table of TPU kernels) without
its d + 1 operations a point inside a ball, so a lower bound. The counters
come from the port's registry (``cellulus_tpu_torch.utils.profiling``),
which counts only while a profiler records: in a run, the window. Silent
where no fit kernel ran or the program counts no fit."""

PEAK_F32 = 67e12  # FLOP/s, CUDA cores, float32
KERNELS = r"mean_shift_fit_kernel"


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    try:
        from cellulus_tpu_torch.utils.profiling import counters
    except ImportError:  # a program that counts nothing
        return None
    counted = counters()
    fits, pairs = counted.get("k3.fits", 0), counted.get("k3.pair_iterations", 0)
    seconds = trace.kernel_seconds(KERNELS)
    if not fits or not pairs or seconds <= 0:
        return None
    d = len(ctx["config"]["infer"]["crop_size"])
    # csrc/ball_stats.cu's count: about 2d + 4 operations a live pair
    return 100.0 * pairs * (2 * d + 4) / PEAK_F32 / seconds
