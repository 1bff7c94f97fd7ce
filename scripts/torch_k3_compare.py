"""Time the mean-shift fit kernel (``mean_shift_fit_kernel``,
``cellulus_tpu_torch/csrc/ball_stats.cu``) against an earlier design of it in
one process on one GPU, input by input.

    git archive <commit> cellulus_tpu_torch/csrc cellulus_tpu_torch/ops \\
        | tar -x -C .archive/k3_old
    python3 scripts/torch_k3_compare.py --old .archive/k3_old [--diagnose] \\
        [--inputs FILE] [--save-inputs FILE] [--reps 10]

``--old`` holds the earlier commit's ``cellulus_tpu_torch/csrc/`` (its
``ball_stats.cu`` and the headers it includes) and its
``cellulus_tpu_torch/ops/ball_stats.py`` (the entry points' signatures); the
directory should be one that ``.gitignore`` lists. Its kernel is built with
the package's ``nvcc`` flags into ``build/k3_old/`` and launched through its
own C entry point.

The inputs are ``chip_smoke.py``'s: ``[main]`` sample 0's fit input (the
float32 main path on its synthetic container and seeded weights), the seeded
and sweep inputs (the bf16 run's embeddings, as ``[variants]`` prepares
them), ``[3d-main]`` sample 0's (after ``[3d-train]``'s 200 steps), K3's
1,024 x 16,384 input, and the 2D and 3D long fits. The first four are made
here as ``chip_smoke.py`` makes them (about a minute of card time) unless
``--inputs`` names a file that ``--save-inputs`` wrote.

Each design is held to two launches bit-equal and to one step against the
plain version (``chip_smoke._fit_step_check``); the two designs to each
other up to seeds that part ways (ends more than ``utils/parity.PARTED``
apart), each of which must meet a point within rounding of a ball's boundary
on the plain version's trajectory. Both are timed in turns (earlier, current,
current, earlier), beside the bound, with their host time a call.
``--diagnose`` also times diagnostic builds of the earlier design (the
group-based kernel: clusters of 8 blocks walking groups of up to 16 seeds,
one cluster barrier an iteration): the distance removed (exchange and rounds only), the cluster
barrier and rank reads removed (compute only), the butterflies removed, and
groups of one seed; the variants that change the bits halt each seed at its
true iteration count. Writes ``chiprun_out/k3_compare.json``; exits non-zero
if a check fails or the card is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from cellulus_tpu_torch.ops.ball_stats import ball_stats  # noqa: E402
from cellulus_tpu_torch.ops.mean_shift_fit import (  # noqa: E402
    mean_shift_fit,
    mean_shift_fit_plain,
    mean_shift_fit_plan,
    near_boundary,
)
from cellulus_tpu_torch.utils import kernels  # noqa: E402
from cellulus_tpu_torch.utils.parity import PARTED  # noqa: E402

# the earlier design's diagnostic builds: macro -> (text, replacement) of its
# source; a __device__ pointer to each seed's true n_iter halts it there
_FORCED = "__device__ const int* g_forced = nullptr;\n"
_PATCHES = [
    ("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + _FORCED),
    ("      for (int i = threadIdx.x; i < len; i += kFitThreads) {\n        float xv[D], xn;",
     "#ifdef NO_DIST\n      acc[0][0] = __int_as_float(threadIdx.x & 1);\n      if (0)\n#endif\n"
     "      for (int i = threadIdx.x; i < len; i += kFitThreads) {\n        float xv[D], xn;"),
    ("            v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));",
     "#ifndef NO_BUTTERFLY\n            v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));\n"
     "#endif"),
    ("      cluster.sync();\n      for (int i = threadIdx.x; i < GM * V; i += kFitThreads) {\n"
     "        if (!(mask >> (i / V) & 1u)) continue;\n"
     "        float t = *cluster.map_shared_rank(&part[buf][i], 0);",
     "#ifdef NO_EXCHANGE\n      __syncthreads();\n"
     "      for (int i = threadIdx.x; i < GM * V; i += kFitThreads) tot[i] = part[buf][i];\n"
     "      if (0)\n#else\n      cluster.sync();\n#endif\n"
     "      for (int i = threadIdx.x; i < GM * V; i += kFitThreads) {\n"
     "        if (!(mask >> (i / V) & 1u)) continue;\n"
     "        float t = *cluster.map_shared_rank(&part[buf][i], 0);"),
    ("const bool done = empty || __fsqrt_rn(ss) < stop;",
     "const bool done = g_forced ? (it + 1 >= g_forced[s0 + s]) : "
     "(empty || __fsqrt_rn(ss) < stop);"),
    ("const bool cycle = same && !done;", "const bool cycle = g_forced ? false : (same && !done);"),
    ("  const int groups = (S + group - 1) / group;",
     "#ifdef GROUP1\n  group = 1;\n#endif\n  const int groups = (S + group - 1) / group;"),
]
DIAGNOSTICS = {"distance removed": ["-DNO_DIST"], "exchange removed": ["-DNO_EXCHANGE"],
               "butterflies removed": ["-DNO_BUTTERFLY"], "groups of 1": ["-DGROUP1"]}


def _nvcc(src: Path, out: Path, flags=()):
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *kernels.EXTRA_FLAGS["ball_stats"], *flags,
           "-I", str(src.parent), "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _typed(path: Path, sigs):
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in sigs.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = restype
    return lib


def load_old(old: Path, diagnose: bool):
    """The earlier design's library (and its diagnostic builds), typed from
    its own wrapper module's ``_SIGNATURES``; its cluster size."""
    csrc = old / "cellulus_tpu_torch" / "csrc"
    text = (old / "cellulus_tpu_torch" / "ops" / "ball_stats.py").read_text()
    namespace = {"ctypes": ctypes}
    start = text.index("_SIGNATURES = {")
    exec(text[start:text.index("\n}\n", start) + 3], namespace)
    sigs = namespace["_SIGNATURES"]
    fit_text = (old / "cellulus_tpu_torch" / "ops" / "mean_shift_fit.py").read_text()
    cluster = int(re.search(r"FIT_CLUSTER = (\d+)", fit_text).group(1))
    build = ROOT / "build" / "k3_old"
    build.mkdir(parents=True, exist_ok=True)
    jobs = {"earlier": _nvcc(csrc / "ball_stats.cu", build / "earlier.so")}
    if diagnose:
        src = (csrc / "ball_stats.cu").read_text()
        for a, b in _PATCHES:
            if src.count(a) != 1:
                raise SystemExit("--diagnose: the earlier source is not the group-based "
                                 "fit kernel")
            src = src.replace(a, b)
        src += ('\nextern "C" int diag_set_forced(const void* p) {\n'
                '  return (int)cudaMemcpyToSymbol(g_forced, &p, sizeof(p));\n}\n')
        (csrc / "ball_stats_diag.cu").write_text(src)
        for name, flags in DIAGNOSTICS.items():
            jobs[name] = _nvcc(csrc / "ball_stats_diag.cu", build / f"{name.replace(' ', '_')}.so",
                               flags)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the earlier design ({name}):\n{log}")
        if name == "earlier":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[earlier build] {line.strip()}")
        libs[name] = _typed(build / f"{name.replace(' ', '_')}.so", sigs)
        if name != "earlier":
            libs[name].diag_set_forced.argtypes = [ctypes.c_void_p]
            libs[name].diag_set_forced.restype = ctypes.c_int
    return libs, cluster


def old_fit(lib, cluster):
    """A fit through the earlier design's entry point (the group-based
    design's signature: seeds, x, x_norm, valid, bw2, stop, max_iter, S, N,
    d, cluster, outs)."""
    def fit(seeds, points, bw2, stop, max_iter):
        S, d = seeds.shape
        dev = seeds.device
        out = (torch.empty((S, d), dtype=torch.float32, device=dev),
               torch.empty((S,), dtype=torch.float32, device=dev),
               torch.empty((S,), dtype=torch.bool, device=dev),
               torch.empty((S,), dtype=torch.int32, device=dev))
        rc = lib.mean_shift_fit_launch(
            seeds.data_ptr(), points.x.data_ptr(), points.x_norm.data_ptr(),
            points.valid.data_ptr(), float(bw2), float(stop), int(max_iter), S,
            points.x.shape[0], d, cluster, *(t.data_ptr() for t in out),
            torch.cuda.current_stream().cuda_stream)
        kernels.check_launch(rc, "mean_shift_fit (earlier design)")
        return out
    return fit


def make_inputs(device):
    """The fit inputs of the trained-model paths, made as chip_smoke.py
    makes them: ``{name: (X_fit, seeds, bandwidth, max_iter)}``."""
    out = {}
    with tempfile.TemporaryDirectory() as work:
        container = smoke.write_blob_container(os.path.join(work, "data.zarr"), 2,
                                               smoke.IMAGE_SIZE, seed=5)
        checkpoint = os.path.join(work, "weights.pth")
        smoke.save_random_checkpoint(checkpoint, seed=0, **smoke.MODEL)
        with contextlib.redirect_stdout(sys.stderr):
            smoke._infer_main(work, container, checkpoint, "float32")
        ic = smoke.infer_config(container, "unused.pth", smoke.MODEL,
                                device=str(device)).inference_config
        ic.bandwidth = 0.5 * smoke.OBJECT_SIZE
        _, _, _, X_fit, seeds, _, _ = smoke._detect_in_parts(container, ic, 2, device, 1)
        out["main"] = (X_fit, seeds, ic.bandwidth, ic.mean_shift_max_iterations)
        with contextlib.redirect_stdout(sys.stderr):
            smoke._infer_main(work, container, checkpoint, "bfloat16")
        emb = np.asarray(smoke.zarr.open(container, "r")["embeddings"][0], dtype=np.float32)
        for variant in ("seeds", "sweep"):
            icv = smoke.infer_config(container, "unused.pth", smoke.MODEL, device=smoke.DEVICE,
                                     **smoke.VARIANTS[variant]).inference_config
            icv.bandwidth = 0.5 * smoke.OBJECT_SIZE
            fit0 = smoke.mean_shift_fit_inputs(smoke._FIT_KIND[variant], emb, icv, 0)[0]
            out[variant] = (fit0[2], fit0[3], fit0[4], icv.mean_shift_max_iterations)
        with contextlib.redirect_stdout(sys.stderr):
            container_3d, checkpoint_3d = smoke.phase_train_3d(work)
            _, ic3 = smoke._infer_main_3d(work, container_3d, checkpoint_3d, "float32")
        _, _, _, X_fit, seeds, _, _ = smoke._detect_in_parts(container_3d, ic3, 3, device, 1)
        out["3d main"] = (X_fit, seeds, ic3.bandwidth, ic3.mean_shift_max_iterations)
    return {k: (np.ascontiguousarray(x, np.float32), np.ascontiguousarray(s, np.float32),
                float(b), int(m)) for k, (x, s, b, m) in out.items()}


def route_trajectory(seeds, points, bw2, stop, max_iter):
    """The one-iteration route's run: ``(centers at every iteration, the
    points in a ball over the live iterations)`` for the bound."""
    trajectory, counts = [], []

    def recorded(c, p, b):
        trajectory.append(c.clone())
        n, s = ball_stats(c, p, b)
        counts.append(n)
        return n, s

    _, _, frozen, n_iter = mean_shift_fit_plain(seeds, points, bw2, stop, max_iter, recorded)
    inball = sum(float(n[n_iter > i].sum()) for i, n in enumerate(counts[:-1]))
    return trajectory, inball + float(counts[-1][~frozen].sum())


def check(name, fit, seeds, points, bw2, stop, max_iter):
    """Two launches bit-equal and one step against the plain version."""
    out = fit(seeds, points, bw2, stop, max_iter)
    again = fit(seeds, points, bw2, stop, max_iter)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        smoke.fail(f"{name}: two launches on the same inputs differ")
    max_err, undecided = smoke._fit_step_check(name, seeds, points, bw2, stop, fit)
    return out, max_err, undecided


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--inputs", type=Path)
    ap.add_argument("--save-inputs", type=Path)
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k3_compare: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.setdefault("CELLULUS_TPU_NO_PROGRESS", "1")
    device = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels.build_all()
    for line in kernels.BUILD_LOG.get("ball_stats", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[current build] {line.strip()}")
    libs, old_cluster = load_old(args.old, args.diagnose)
    earlier = old_fit(libs["earlier"], old_cluster)
    if args.inputs:
        made = torch.load(args.inputs, weights_only=False)
    else:
        made = make_inputs(device)
    if args.save_inputs:
        args.save_inputs.parent.mkdir(parents=True, exist_ok=True)
        torch.save(made, args.save_inputs)
    problems = {name: (smoke._fit_problem(X, seeds, b, device), m)
                for name, (X, seeds, b, m) in made.items()}
    problems["K3 input"] = (smoke.k3_fit_input(device), 300)
    problems["2D long fit"] = (smoke.long_fit_input(device), 300)
    b3, m3 = made["3d main"][2:]
    problems["3D long fit"] = (smoke.long_fit_3d_input(b3, device), m3)

    rows, failed = [], []
    for name, ((seeds, points, bw2, stop), max_iter) in problems.items():
        S, d = seeds.shape
        N = points.x.shape[0]
        old_out, old_err, old_undecided = check(f"{name} (earlier)", earlier, seeds, points, bw2,
                                                stop, max_iter)
        new_out, new_err, new_undecided = check(f"{name} (current)", mean_shift_fit, seeds,
                                                points, bw2, stop, max_iter)
        half = mean_shift_fit(seeds[1::2].contiguous(), points, bw2, stop, max_iter)
        if not all(torch.equal(h, f[1::2]) for h, f in zip(half, new_out)):
            failed.append(f"{name}: a fit of every other seed differs from the full fit")
        trajectory, inball = route_trajectory(seeds, points, bw2, stop, max_iter)
        parted = np.flatnonzero((old_out[0] - new_out[0]).norm(dim=1).cpu().numpy() > PARTED)
        unexplained = [int(i) for i in parted if not any(
            bool(near_boundary(c[i:i + 1], points, bw2)[0]) for c in trajectory)]
        if unexplained or len(parted) > smoke.MAX_PARTED_SHARE * S:
            failed.append(f"{name}: {len(parted)} seeds part ways between the designs, "
                          f"{len(unexplained)} with no boundary point on their trajectory")
        reps = args.reps if max_iter * S * N < 1e10 else max(2, args.reps // 4)
        t = {"earlier": [], "current": []}
        for who in ("earlier", "current", "current", "earlier"):
            fit = earlier if who == "earlier" else mean_shift_fit
            t[who].append(smoke.cuda_ms(lambda: fit(seeds, points, bw2, stop, max_iter), reps))
        host = {"earlier": smoke.fit_host_us(seeds, points, bw2, stop, max_iter, fit=earlier),
                "current": smoke.fit_host_us(seeds, points, bw2, stop, max_iter)}
        bound_ms, bound_by = smoke._fit_bound(S, int(points.valid.sum()), d, new_out[3],
                                              new_out[2], inball)
        plan, clusters = mean_shift_fit_plan(N, d)
        row = {"input": name, "S": S, "N": N, "d": d, "max_iter": max_iter,
               "n_iter_max": int(new_out[3].max()), "n_iter_sum": int(new_out[3].sum()),
               "plan": dict(plan._asdict()), "clusters": min(clusters, S),
               "earlier_ms": sum(t["earlier"]) / 2, "current_ms": sum(t["current"]) / 2,
               "earlier_ms_runs": t["earlier"], "current_ms_runs": t["current"],
               "earlier_host_us": host["earlier"], "current_host_us": host["current"],
               "bound_ms": bound_ms, "bound_by": bound_by, "parted": len(parted),
               "earlier_step_err": old_err, "current_step_err": new_err,
               "step_undecided": [old_undecided, new_undecided]}
        if args.diagnose:
            forced = old_out[3].clone()
            for diag in DIAGNOSTICS:
                lib = libs[diag]
                use = forced.data_ptr() if diag != "groups of 1" else None
                kernels.check_launch(lib.diag_set_forced(use), "diag_set_forced")
                fit = old_fit(lib, old_cluster)
                row[f"earlier, {diag} ms"] = smoke.cuda_ms(
                    lambda: fit(seeds, points, bw2, stop, max_iter), reps)
                kernels.check_launch(lib.diag_set_forced(None), "diag_set_forced")
        rows.append(row)
        print(f"[K3-fit] {name}: S={S} N={N} d={d}, n_iter max {row['n_iter_max']} sum "
              f"{row['n_iter_sum']}, plan {row['plan']}, {row['clusters']} clusters: earlier "
              f"{row['earlier_ms']:.4f} ms, now {row['current_ms']:.4f} ms "
              f"({row['earlier_ms'] / row['current_ms']:.2f}x), bound {bound_ms:.4f} ms "
              f"({bound_by}); host a call {host['earlier']:.1f} / {host['current']:.1f} us; "
              f"{len(parted)} seeds parted between the designs, all at a boundary"
              + "".join(f"; earlier, {k}: {row[f'earlier, {k} ms']:.4f} ms"
                        for k in DIAGNOSTICS if args.diagnose), flush=True)
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out" / "k3_compare.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": card, "inputs": rows}, indent=1))
    if failed:
        raise SystemExit("torch_k3_compare FAILED: " + "; ".join(failed))


if __name__ == "__main__":
    main()
