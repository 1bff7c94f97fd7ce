"""Time K2 (``cellulus_tpu_torch/csrc/conv_dw.cu``) against an earlier design
of it in one process on one GPU, shape by shape.

    git archive <commit> cellulus_tpu_torch/csrc cellulus_tpu_torch/ops/conv_dw.py \\
        | tar -x -C .archive/k2_old
    python3 scripts/torch_k2_compare.py --old .archive/k2_old [--reps 3]

``--old`` holds the earlier commit's ``cellulus_tpu_torch/csrc/conv_dw.cu``
(with the headers it includes) and ``cellulus_tpu_torch/ops/conv_dw.py``; the
directory should be one that ``.gitignore`` lists. Its kernel is built with
the package's ``nvcc`` flags into ``build/k2_old/`` and launched through its
own C entry points (splits, workspace, launch). At the six filter gradients
of ``chip_smoke.py``'s train step (``dw_shapes(TRAIN_BATCH)``) and at
``[mc]``'s first conv (three input channels), in float32 (TF32 off) and
bfloat16, both kernels are held against ``conv3x3_dw_plain`` with ``[K2]``'s
tolerances and two launches bit-equal, and timed in turns (earlier, current,
current, earlier), beside cuDNN (``torch.nn.grad.conv2d_weight``) and the
bound. Prints one line per shape and per train-step sum, and writes them to
``chiprun_out/k2_compare.json``. Exits non-zero if either kernel misses its
tolerance or its bit-equality, or the card is missing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from cellulus_tpu_torch.ops.conv_dw import (  # noqa: E402
    conv3x3_dw,
    conv3x3_dw_design,
    conv3x3_dw_plain,
)
from cellulus_tpu_torch.utils import kernels  # noqa: E402

_CODES = {torch.float32: 0, torch.bfloat16: 1}


def load_old(old: Path):
    """The earlier design's library, its entry points typed from its own
    wrapper module's ``_SIGNATURES``."""
    src = old / "cellulus_tpu_torch" / "csrc" / "conv_dw.cu"
    out = ROOT / "build" / "k2_old" / "conv_dw_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{r.stdout}\n{r.stderr}")
    for line in (r.stdout + r.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[old build] {line.strip()}")
    text = (old / "cellulus_tpu_torch" / "ops" / "conv_dw.py").read_text()
    namespace = {"ctypes": ctypes}
    start = text.index("_SIGNATURES = {")
    exec(text[start:text.index("\n}\n", start) + 3], namespace)
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in namespace["_SIGNATURES"].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = restype
    return lib, namespace["_SIGNATURES"]


def old_dw(lib, sigs, x, g):
    """One call of the earlier design, its workspace allocated as its wrapper
    does."""
    B, H, W, Ci = x.shape
    Co = g.shape[-1]
    size = [] if len(sigs["conv3x3_dw_splits"][0]) == 5 else [x.element_size()]
    n = lib.conv3x3_dw_splits(B, H, W, Ci, Co, *size)
    ws = torch.empty((n, 9 * Ci * Co), dtype=torch.float32, device=x.device)
    out = torch.empty((3, 3, Ci, Co), dtype=torch.float32, device=x.device)
    rc = lib.conv3x3_dw_launch(x.data_ptr(), g.data_ptr(), ws.data_ptr(), out.data_ptr(), B, H,
                               W, Ci, Co, n, _CODES[x.dtype],
                               torch.cuda.current_stream().cuda_stream)
    kernels.check_launch(rc, "conv3x3_dw (earlier design)")
    return out


def old_design(lib, sigs, c_in, c_out, dtype):
    if len(sigs["conv3x3_dw_plan"][0]) == 2:  # the mma.sync design: 1 = tensor cores
        if not lib.conv3x3_dw_plan(c_in, c_out):
            return "CUDA cores"
        return "mma.sync bf16" if dtype == torch.bfloat16 else "mma.sync 3xTF32"
    return f"plan {lib.conv3x3_dw_plan(c_in, c_out, dtype.itemsize)}"


def within(got, ref, dtype):
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    if dtype == torch.float32:
        ok = bool((err <= 1e-4 * ref.abs() + 1e-5 * scale).all())
    else:
        ok = float(err.max()) <= 2e-2 * scale
    return ok and bool(torch.isfinite(got).all()), float(err.max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k2_compare: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels.build_all()
    for line in kernels.BUILD_LOG.get("conv_dw", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[new build] {line.strip()}")
    lib, sigs = load_old(args.old)
    dev = "cuda:0"
    gen = torch.Generator(device=dev).manual_seed(6)
    shapes = [(n, xs, gs, "step") for n, xs, gs in smoke.dw_shapes(smoke.TRAIN_BATCH)]
    shapes.append(("[mc] c0",) + smoke.dw_shapes(smoke.TRAIN_BATCH, in_channels=3)[0][1:]
                  + ("mc",))
    rows, failed = [], []
    for dtype in (torch.float32, torch.bfloat16):
        for name, xs, gs, group in shapes:
            x = torch.randn(xs, generator=gen, device=dev).to(dtype)
            g = torch.randn(gs, generator=gen, device=dev).to(dtype)
            ref = conv3x3_dw_plain(x, g)
            got_old, again_old = old_dw(lib, sigs, x, g), old_dw(lib, sigs, x, g)
            got_new, again_new = conv3x3_dw(x, g), conv3x3_dw(x, g)
            torch.cuda.synchronize()
            ok_old, err_old = within(got_old, ref, dtype)
            ok_new, err_new = within(got_new, ref, dtype)
            ok_old &= torch.equal(got_old, again_old)
            ok_new &= torch.equal(got_new, again_new)
            del ref, got_old, again_old, got_new, again_new
            t = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                fn = (lambda: old_dw(lib, sigs, x, g)) if who == "old" else (lambda: conv3x3_dw(x, g))
                t[who].append(smoke.cuda_ms(fn, reps=args.reps))
            B, H, W, c_in = xs
            c_out = gs[-1]
            x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            cudnn_ms = smoke.cuda_ms(
                lambda: torch.nn.grad.conv2d_weight(x_nchw, (c_out, c_in, 3, 3), g_nchw))
            flops = 2 * B * (H - 2) * (W - 2) * 9 * c_in * c_out
            nbytes = x.element_size() * (x.numel() + g.numel()) + 4 * 9 * c_in * c_out
            bound_ms = 1e3 * max(flops / smoke.PEAK_OPS[dtype], nbytes / smoke.HBM_BYTES_PER_S)
            row = {"shape": name, "group": group, "dtype": str(dtype)[6:], "x": list(xs),
                   "g": list(gs), "old_ms": sum(t["old"]) / 2, "new_ms": sum(t["new"]) / 2,
                   "old_ms_runs": t["old"], "new_ms_runs": t["new"], "cudnn_ms": cudnn_ms,
                   "bound_ms": bound_ms, "old_design": old_design(lib, sigs, c_in, c_out, dtype),
                   "new_design": conv3x3_dw_design(c_in, c_out, dtype),
                   "old_max_abs_err": err_old, "new_max_abs_err": err_new}
            rows.append(row)
            print(f"[K2] {name:10s} {row['dtype']:8s} x{tuple(xs)} g{tuple(gs)}: earlier "
                  f"({row['old_design']}) {row['old_ms']:.3f} ms, now {row['new_ms']:.3f} ms "
                  f"({row['old_ms'] / row['new_ms']:.2f}x; {row['new_design']}), cuDNN "
                  f"{cudnn_ms:.3f} ms, bound {bound_ms:.3f} ms; max abs err {err_old:.3g} / "
                  f"{err_new:.3g}", flush=True)
            if not (ok_old and ok_new):
                failed.append(f"{name} {dtype}: earlier ok={ok_old}, now ok={ok_new}")
            del x, g, x_nchw, g_nchw
            torch.cuda.empty_cache()
    sums = []
    for dt in ("float32", "bfloat16"):
        sel = [r for r in rows if r["dtype"] == dt and r["group"] == "step"]
        s = {k: sum(r[k] for r in sel) for k in ("old_ms", "new_ms", "cudnn_ms", "bound_ms")}
        s.update(dtype=dt, what="train step (six shapes)")
        sums.append(s)
        print(f"[K2] per train step, {dt}: earlier {s['old_ms']:.3f} ms, now {s['new_ms']:.3f} ms "
              f"({s['old_ms'] / s['new_ms']:.2f}x), cuDNN {s['cudnn_ms']:.3f} ms, bound "
              f"{s['bound_ms']:.3f} ms", flush=True)
    out = ROOT / "chiprun_out" / "k2_compare.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": card, "shapes": rows, "sums": sums}, indent=1))
    if failed:
        raise SystemExit("torch_k2_compare FAILED: " + "; ".join(failed))


if __name__ == "__main__":
    main()
