"""Check and time the port's kernels on one GPU, without the rest of
``chip_smoke.py``: a short run for kernel work.

    python3 scripts/torch_kernel_check.py          # K1 and K2
    python3 scripts/torch_kernel_check.py k1       # or k2
    python3 scripts/torch_kernel_check.py k2-ragged  # K2 at narrow and ragged shapes
    python3 scripts/torch_kernel_check.py fit      # K3 and the one-launch fit
    python3 scripts/torch_kernel_check.py tiles    # K1 at every tile that fits
    python3 scripts/torch_kernel_check.py tiles-wide  # the same at the 256-fmap passes
    python3 scripts/torch_kernel_check.py wide     # K1 at the 256-fmap model's passes
    python3 scripts/torch_kernel_check.py greedy   # greedy clustering, card vs CPU

``k1`` and ``k2`` are ``chip_smoke.py``'s ``[K1]`` and ``[K2]`` phases (each
kernel against its plain version at the full-width shapes, timed beside its
plain version, cuDNN and its bound); ``k2-ragged`` is its ``[K2-ragged]``
phase (the gate model's shapes, the sweep and 3-channel widths, B = 1, odd
sizes and channel counts TMA cannot stride); ``fit`` is its ``[K3]`` and
``[K3-fit]`` phases (without the main path's input). ``tiles`` launches
K1's fused route through its C entry point at every square tile of 6 or more that fits shared memory
(``tiles-wide``: at the 256-fmap model's passes), with the cost its
tile choice assigns, to see how the tile size sets its speed; every tile must
give the bits of the tile the wrapper picks. ``wide`` is ``[K1-wide]``:
the plan mirrors against the library, K1 at the passes of
``examples/real-data``'s model, its bf16 staged passes stage by stage and
each pass on the parent commit's route against the new one. ``greedy`` clusters synthetic blob
embeddings (512^2 and 128^3) on the card, timed, against the CPU.
Exits non-zero on a failure.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from cellulus_tpu_torch.ops import conv_pass as k1  # noqa: E402
from cellulus_tpu_torch.utils import kernels  # noqa: E402


def sweep_tiles(device, model=smoke.MODEL, batch=smoke.TILE_BATCH * 2 * smoke.NUM_INFER_ITERATIONS):
    lib = kernels.load("conv_pass", k1._SIGNATURES)
    gen = torch.Generator().manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        code = k1._DTYPE_CODES[dtype]
        for name, shape, c_out in smoke.pass_shapes(batch, model):
            if k1.conv_pass_2d_plan(shape, c_out, dtype)[0] != "fused":
                continue
            params = smoke._pass_params(shape[-1], c_out, gen, device)
            x = torch.rand(shape, generator=gen).to(device).to(dtype).contiguous()
            B, H, W, c_in = shape
            ws = k1.pack_pass([params[f"conv{i}"]["w"].to(dtype) for i in range(4)], "fused",
                              c_in, c_out)
            bs = [params[f"conv{i}"]["b"].float().contiguous() for i in range(4)]
            out = torch.empty((B, H - 4, W - 4, c_out), dtype=dtype, device=device)
            want = k1.conv_pass_2d(x, params, dtype)
            for tile in k1.TILE_CANDIDATES:
                smem = lib.conv_pass_2d_smem_bytes(c_in, c_out, tile, tile, x.element_size())
                if smem > k1.MAX_SHARED_BYTES or tile < 6:
                    continue

                def run():
                    args = [x.data_ptr()]
                    for w, b in zip(ws, bs):
                        args += [w.data_ptr(), b.data_ptr()]
                    kernels.check_launch(lib.conv_pass_2d_launch(
                        *args, out.data_ptr(), B, H, W, c_in, c_out, tile, tile, code,
                        torch.cuda.current_stream().cuda_stream), "conv_pass_2d")

                ms = smoke.cuda_ms(run, reps=2)
                cost = lib.conv_pass_2d_cost(c_in, c_out, tile, tile, H, W, x.element_size())
                print(f"[tiles] {name} {dtype} {tile}x{tile} ({smem / 1024:.0f} KB, model cost "
                      f"{cost / 1e6:.3f}): {ms:.2f} ms", flush=True)
                if not torch.equal(out, want):
                    smoke.fail(f"conv_pass_2d {name} {dtype}: tile {tile} changes the output")


def greedy_check(device):
    import time

    import numpy as np

    from cellulus_tpu_torch.ops import greedy_cluster as gc
    from cellulus_tpu_torch.ops.greedy_cluster import greedy_cluster

    for ndim, size, bw in ((2, 512, 20.0), (3, 128, 6.0)):
        _, labels = smoke.make_blobs(1, size, 21, ndim=ndim, num_blobs=40 if ndim == 2 else 60,
                                     radius=(0.02, 0.04) if ndim == 2 else (0.04, 0.08))
        labels = labels[0, 0]
        rng = np.random.default_rng(ndim)
        grid = np.stack(np.meshgrid(*[np.arange(size)] * ndim, indexing="ij"))
        emb = np.zeros((ndim + 1, *labels.shape), np.float32)
        for i in np.unique(labels[labels > 0]):
            m = labels == i
            for axis in range(ndim):
                emb[ndim - 1 - axis][m] = grid[axis][m].mean() - grid[axis][m] + rng.normal(
                    0, 0.5, m.sum())
        emb[ndim] = np.where(labels > 0, rng.uniform(0, 0.1, labels.shape),
                             rng.uniform(0.4, 1.0, labels.shape))
        fg = emb[ndim] < 0.3
        cpu = greedy_cluster(emb, fg, bw, 10, device="cpu")
        # the default batch, and batches of 8 iterations (more graph replays)
        for per_batch in (gc.ITERATIONS_PER_BATCH, 8):
            default, gc.ITERATIONS_PER_BATCH = gc.ITERATIONS_PER_BATCH, per_batch
            try:
                for _ in range(2):
                    stats = {}
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    card = greedy_cluster(emb, fg, bw, 10, device=device, stats=stats)
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
            finally:
                gc.ITERATIONS_PER_BATCH = default
            same = np.array_equal(card, cpu)
            print(f"[greedy] {size}^{ndim}, {per_batch} iterations a batch: {seconds:.3f} s on "
                  f"the card, {stats['iterations']} iterations, {stats['host_syncs']} host "
                  f"syncs, {stats['instances']} instances; card equals CPU: {same}", flush=True)
            if not same:
                smoke.fail("greedy: the card's instance map differs from the CPU's")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_check: CUDA is not available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    what = sys.argv[1] if len(sys.argv) > 1 else "all"
    device = torch.device("cuda:0")
    smoke.phase_card()
    smoke.phase_build()
    if what in ("all", "k1"):
        smoke.phase_conv_pass(device)
    if what in ("all", "k2"):
        smoke.phase_conv_dw(device)
    if what in ("all", "k2-ragged"):
        smoke.phase_k2_ragged(device)
    if what == "fit":
        smoke.phase_ball_stats(device)
        smoke.phase_fit(device)
    if what == "tiles":
        sweep_tiles(device)
    if what == "tiles-wide":
        sweep_tiles(device, smoke.MODEL_WIDE, smoke.K1_WIDE_BATCH)
    if what == "wide":
        smoke.phase_k1_plans()
        smoke.phase_conv_pass(device, smoke.MODEL_WIDE, smoke.K1_WIDE_BATCH, "K1-wide")
        smoke.phase_k1_staged(device)
    if what == "greedy":
        greedy_check(device)


if __name__ == "__main__":
    main()
