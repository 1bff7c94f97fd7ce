"""Check and time the port's kernels on one GPU, without the rest of
``chip_smoke.py``: a short run for kernel work.

    python3 scripts/torch_kernel_check.py          # K1 and K2
    python3 scripts/torch_kernel_check.py k1       # or k2
    python3 scripts/torch_kernel_check.py fit      # K3 and the one-launch fit
    python3 scripts/torch_kernel_check.py tiles    # K1 at every tile that fits

``k1`` and ``k2`` are ``chip_smoke.py``'s ``[K1]`` and ``[K2]`` phases (each
kernel against its plain version at the full-width shapes, timed beside its
plain version, cuDNN and its bound); ``fit`` is its ``[K3]`` and ``[K3-fit]``
phases (without the main path's input). ``tiles`` launches K1 through its C
entry point at every square tile that fits shared memory, with the cost its
tile choice assigns, to see how the tile size sets its speed; every tile must
give the bits of the tile the wrapper picks. Exits non-zero on a failure.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from cellulus_tpu_torch.ops import conv_pass as k1  # noqa: E402
from cellulus_tpu_torch.utils import kernels  # noqa: E402


def sweep_tiles(device):
    lib = kernels.load("conv_pass", k1._SIGNATURES)
    gen = torch.Generator().manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        code = k1._DTYPE_CODES[dtype]
        for name, shape, c_out in smoke.pass_shapes(smoke.TILE_BATCH * 2 * smoke.NUM_INFER_ITERATIONS):
            params = smoke._pass_params(shape[-1], c_out, gen, device)
            x = torch.rand(shape, generator=gen).to(device).to(dtype).contiguous()
            ws = [params[f"conv{i}"]["w"].to(dtype).contiguous() for i in range(4)]
            bs = [params[f"conv{i}"]["b"].float().contiguous() for i in range(4)]
            B, H, W, c_in = shape
            out = torch.empty((B, H - 4, W - 4, c_out), dtype=dtype, device=device)
            want = k1.conv_pass_2d(x, params, dtype)
            for tile in k1.TILE_CANDIDATES:
                smem = lib.conv_pass_2d_smem_bytes(c_in, c_out, tile, tile, x.element_size())
                if smem > k1.MAX_SHARED_BYTES or tile < 4:
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
    if what == "fit":
        smoke.phase_ball_stats(device)
        smoke.phase_fit(device)
    if what == "tiles":
        sweep_tiles(device)


if __name__ == "__main__":
    main()
