"""Time K1 (``cellulus_tpu_torch/csrc/conv_pass.cu``) against an earlier
design of it in one process on one GPU, pass by pass.

    git archive <commit> cellulus_tpu_torch/csrc cellulus_tpu_torch/ops/conv_pass.py \\
        | tar -x -C .archive/k1_old
    python3 scripts/torch_k1_compare.py --old .archive/k1_old [--reps 3] \
        [--models K1,K1-wide] [--dtypes float32,bfloat16]

``--old`` holds the earlier commit's ``cellulus_tpu_torch/csrc/conv_pass.cu``
(with the headers it includes) and ``cellulus_tpu_torch/ops/conv_pass.py``;
the directory should be one that ``.gitignore`` lists. Its kernel is built
with the package's ``nvcc`` flags into ``build/k1_old/`` and launched with the
tile its own plan picks, on weights packed by its own ``pack_pass`` where it
has one, else in the compute dtype laid out ``(kh, kw, cin, C)``. At every
pass of ``[K1]`` (64 fmaps, tile batch 128) and ``[K1-wide]`` (256 fmaps,
tile batch 16) of ``chip_smoke.py`` (or those ``--models`` names), in
float32 (TF32 off) and bfloat16 (or ``--dtypes``), both kernels are held
against the plain version with ``chip_smoke.py``'s tolerances and timed in
turns (earlier, current, current, earlier), beside cuDNN (``F.conv2d`` x 4)
and the bound. Prints one line per pass and per tile-batch sum, and writes
them to ``chiprun_out/k1_compare.json``. Exits non-zero if either kernel
misses its tolerance or the card is missing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from cellulus_tpu_torch.ops.conv_pass import (  # noqa: E402
    conv_pass_2d,
    conv_pass_2d_design,
    conv_pass_2d_plain,
)
from cellulus_tpu_torch.utils import kernels  # noqa: E402


def load_old(old: Path):
    """The earlier design's library and its plan module."""
    src = old / "cellulus_tpu_torch" / "csrc" / "conv_pass.cu"
    out = ROOT / "build" / "k1_old" / "conv_pass_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{r.stdout}\n{r.stderr}")
    for line in (r.stdout + r.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[old build] {line.strip()}")
    lib = ctypes.CDLL(str(out))
    # the plan of that design: its Python module up to its wrapper (which
    # would register the custom op again), with the loader stubbed out
    text = (old / "cellulus_tpu_torch" / "ops" / "conv_pass.py").read_text()
    text = text[: text.index("\ndef conv_pass_2d(\n")]
    text = text.replace("from ..utils import kernels", "kernels = None")
    text = text.replace("from ..utils.profiling import count", "count = None")
    plan = types.ModuleType("conv_pass_old")
    exec(compile(text, "conv_pass_old.py", "exec"), plan.__dict__)
    for fn, (argtypes, restype) in plan._SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = restype
    return lib, plan


def old_pass(lib, plan, x, params, dtype):
    """One launch of the earlier design (its route and tile for the shape)."""
    B, H, W, c_in = x.shape
    c_out = params["conv0"]["w"].shape[-1]
    route, tile = plan.conv_pass_2d_plan(x.shape, c_out, dtype)
    x = x.to(dtype).contiguous()
    ws = [params[f"conv{i}"]["w"].to(dtype).contiguous() for i in range(4)]
    if hasattr(plan, "pack_pass"):
        ws = plan.pack_pass(ws, route, c_in, c_out)
    bs = [params[f"conv{i}"]["b"].float().contiguous() for i in range(4)]
    out = torch.empty((B, H - 4, W - 4, c_out), dtype=dtype, device=x.device)
    args = [x.data_ptr()]
    for w, b in zip(ws, bs):
        args += [w.data_ptr(), b.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    if route == "fused":
        rc = lib.conv_pass_2d_launch(*args, out.data_ptr(), B, H, W, c_in, c_out, tile, tile,
                                     code, stream)
    else:
        scratch = torch.empty((2, B, H - 2, W - 2, c_out), dtype=dtype, device=x.device)
        rc = lib.conv_pass_2d_staged_launch(*args, out.data_ptr(), scratch[0].data_ptr(),
                                            scratch[1].data_ptr(), B, H, W, c_in, c_out, tile,
                                            tile, code, stream)
    kernels.check_launch(rc, "conv_pass_2d (earlier design)")
    return out, f"{route} {tile}x{tile}"


def within(got, ref, dtype):
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        ok = bool((err <= 1e-5 + 1e-4 * ref.float().abs()).all())
    else:
        ok = float(err.max()) <= 2e-2 * float(ref.float().abs().max())
    return ok and bool(torch.isfinite(got.float()).all()), float(err.max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--models", default="K1,K1-wide")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    args = ap.parse_args()
    models, dtypes = args.models.split(","), args.dtypes.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_compare: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels.build_all()
    lib, plan = load_old(args.old)
    dev = "cuda:0"
    gen = torch.Generator().manual_seed(1)
    rows, failed = [], []
    for model, batch, tag in ((smoke.MODEL, smoke.TILE_BATCH * 2 * smoke.NUM_INFER_ITERATIONS,
                               "K1"), (smoke.MODEL_WIDE, smoke.K1_WIDE_BATCH, "K1-wide")):
        if tag not in models:
            continue
        for dtype in [getattr(torch, d) for d in dtypes]:
            for name, shape, c_out in smoke.pass_shapes(batch, model):
                params = smoke._pass_params(shape[-1], c_out, gen, dev)
                x = torch.rand(shape, generator=gen).to(dev)
                ref = conv_pass_2d_plain(x, params, dtype)
                got_old, old_plan = old_pass(lib, plan, x, params, dtype)
                got_new = conv_pass_2d(x, params, dtype)
                torch.cuda.synchronize()
                ok_old, err_old = within(got_old, ref, dtype)
                ok_new, err_new = within(got_new, ref, dtype)
                del ref, got_old, got_new
                t = {"old": [], "new": []}
                for who in ("old", "new", "new", "old"):
                    fn = ((lambda: old_pass(lib, plan, x, params, dtype)) if who == "old"
                          else (lambda: conv_pass_2d(x, params, dtype)))
                    t[who].append(smoke.cuda_ms(fn, reps=args.reps))
                library_ms = smoke.cuda_ms(lambda: smoke._library_pass(x, params, dtype))
                B, H, W, c_in = shape
                e = dtype.itemsize
                flops = smoke._pass_flops(B, H, W, c_in, c_out)
                nbytes = e * (B * H * W * c_in + B * (H - 4) * (W - 4) * c_out) + e * sum(
                    p["w"].numel() for p in params.values()) + 4 * 4 * c_out
                bound_ms = 1e3 * max(flops / smoke.PEAK_OPS[dtype], nbytes / smoke.HBM_BYTES_PER_S)
                row = {"model": tag, "pass": name, "dtype": str(dtype)[6:], "shape": list(shape),
                       "c_out": c_out, "old_ms": sum(t["old"]) / 2, "new_ms": sum(t["new"]) / 2,
                       "old_ms_runs": t["old"], "new_ms_runs": t["new"],
                       "cudnn_ms": library_ms, "bound_ms": bound_ms, "old_plan": old_plan,
                       "new_design": conv_pass_2d_design(shape, c_out, dtype),
                       "old_max_abs_err": err_old, "new_max_abs_err": err_new}
                rows.append(row)
                print(f"[{tag}] {name:6s} {row['dtype']:8s} {tuple(shape)}->{c_out}: earlier "
                      f"({old_plan}) {row['old_ms']:.2f} ms, now ({row['new_design']}) "
                      f"{row['new_ms']:.2f} ms, cuDNN {library_ms:.2f} ms, bound "
                      f"{bound_ms:.3f} ms; max abs err {err_old:.3g} / {err_new:.3g}", flush=True)
                if not (ok_old and ok_new):
                    failed.append(f"{tag} {name} {dtype}: earlier ok={ok_old}, now ok={ok_new}")
                del x
                torch.cuda.empty_cache()
    sums = []
    for tag in models:
        for dt in dtypes:
            sel = [r for r in rows if r["model"] == tag and r["dtype"] == dt]
            s = {k: sum(r[k] for r in sel) for k in ("old_ms", "new_ms", "cudnn_ms", "bound_ms")}
            s.update(model=tag, dtype=dt)
            sums.append(s)
            print(f"[{tag}] per tile batch, {dt}: earlier {s['old_ms']:.2f} ms, now "
                  f"{s['new_ms']:.2f} ms ({s['old_ms'] / s['new_ms']:.2f}x), cuDNN "
                  f"{s['cudnn_ms']:.2f} ms, bound {s['bound_ms']:.3f} ms", flush=True)
    out = ROOT / "chiprun_out" / "k1_compare.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": card, "passes": rows, "sums": sums}, indent=1))
    if failed:
        raise SystemExit("torch_k1_compare FAILED: " + "; ".join(failed))


if __name__ == "__main__":
    main()
