"""The port's one-launch mean-shift fit (``ops/mean_shift_fit.py``,
``csrc/ball_stats.cu``) on the CPU.

``tests/mean_shift_fit_emu.py`` emulates the kernel's float32 arithmetic in
its exact order. It shows here that seed groups that stop early give the bits
of one global loop, and that its labels agree with the JAX package's and
sklearn's; ``chip_smoke.py`` holds the kernel to the same emulation on the
card. The plain version, which the wrapper runs on CPU tensors, is held to
the fit loop of the previous port (a Python loop with a recount after it).
"""

import functools
import inspect
import os
import re
import shutil
import subprocess
import tempfile

import numpy as np
import pytest
import torch

import mean_shift_fit_emu as emu
from cellulus_tpu.ops.mean_shift import mean_shift_fit_predict as jax_fit_predict
from cellulus_tpu_torch.ops import mean_shift as ms
from cellulus_tpu_torch.ops.ball_stats import PointSet, ball_stats_plain, point_set
from cellulus_tpu_torch.ops import mean_shift_fit as msf
from cellulus_tpu_torch.ops.mean_shift_fit import mean_shift_fit, mean_shift_fit_plain
from cellulus_tpu_torch.utils import kernels


def _same_partition(a, b):
    """Equal up to a permutation of ids, with the same orphan set."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not ((a == -1) == (b == -1)).all():
        return False
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def _uniform_3d():  # tests/test_ops.py::test_cycle_shortcut_is_exact
    rng = np.random.default_rng(5)
    return rng.uniform(0, 60, size=(6000, 3)).astype(np.float32), 2.5, 50


def _clusters_40():  # tests/test_ops.py::test_phased_fit_matches_monolithic
    rng = np.random.default_rng(7)
    centers = rng.uniform(0, 100, size=(40, 3)).astype(np.float32)
    X = np.concatenate(
        [rng.normal(c, 0.8, size=(50, 3)) for c in centers]
        + [rng.uniform(-50, -40, size=(5, 3))]
    ).astype(np.float32)
    return X, 3.0, 300


def _uniform_2d():  # tests/test_ops.py::test_phased_fit_matches_monolithic_max_iter
    rng = np.random.default_rng(3)
    return rng.uniform(0, 60, size=(4000, 2)).astype(np.float32), 2.5, 3


FIXTURES = {"uniform_3d": _uniform_3d, "clusters_40": _clusters_40, "uniform_2d": _uniform_2d}


@functools.lru_cache(maxsize=None)
def _problem(name):
    """``(X, seeds, x_norm, bw2, stop, max_iter)`` as mean_shift_fit_predict
    prepares them (float32 bandwidth, bin seeds, the point set's norms)."""
    X, bandwidth, max_iter = FIXTURES[name]()
    bw = np.float32(bandwidth)
    seeds = ms.bin_seeds(X, bin_size=bandwidth)
    x_norm = point_set(torch.from_numpy(X), torch.ones(len(X), dtype=torch.bool)).x_norm.numpy()
    return X, seeds, x_norm, float(bw * bw), float(np.float32(1e-3) * bw), max_iter


@functools.lru_cache(maxsize=None)
def _global_fit(name):
    X, seeds, x_norm, bw2, stop, max_iter = _problem(name)
    return emu.fit(seeds, X, x_norm, np.ones(len(X), bool), bw2, stop, max_iter)


# (slots, claim order shuffled): seed slots refilled as their seeds finish
REFILLS = [pytest.param(("slots", 16, False), id="slots16"),
           pytest.param(("slots", 16, True), id="slots16-shuffled"),
           pytest.param(("slots", 5, True), id="slots5-shuffled"),
           pytest.param(("slots", 3, False), id="slots3")]


@pytest.mark.parametrize("group", [16, 5] + REFILLS)
@pytest.mark.parametrize("name", list(FIXTURES))
def test_seed_groups_with_early_exit_equal_the_global_loop(name, group):
    """A group that leaves its loop once its own seeds have halted, and
    computes only live seeds, gives every bit of the global loop; so do seed
    slots that take the next seed of any claim order as theirs finish, each
    seed counting its own iterations (the kernel's order)."""
    X, seeds, x_norm, bw2, stop, max_iter = _problem(name)
    valid = np.ones(len(X), bool)
    if isinstance(group, tuple):
        _, slots, shuffled = group
        order = np.random.default_rng(len(seeds)).permutation(len(seeds)) if shuffled else None
        got = emu.fit(seeds, X, x_norm, valid, bw2, stop, max_iter, slots=slots, order=order)
    else:
        got = emu.fit(seeds, X, x_norm, valid, bw2, stop, max_iter, group=group)
    for g, want in zip(got, _global_fit(name)):
        np.testing.assert_array_equal(g, want)


def test_refill_with_a_cycle_and_max_iter_zero():
    """Seeds that enter late keep their own iteration count: a period-2
    cycle's phase and the recount follow it. With a stop threshold of 0 no
    seed freezes, every seed halts on a cycle (a fixed point is one), and
    some end on a different phase at max_iter 20 and 21; at max_iter = 0
    every seed is recounted where it starts."""
    X, seeds, x_norm, bw2, stop, _ = _problem("uniform_2d")
    valid = np.ones(len(X), bool)
    order = np.random.default_rng(2).permutation(len(seeds))
    ends = {}
    for stop_thresh, max_iter in ((stop, 0), (0.0, 20), (0.0, 21)):
        want = emu.fit(seeds, X, x_norm, valid, bw2, stop_thresh, max_iter)
        got = emu.fit(seeds, X, x_norm, valid, bw2, stop_thresh, max_iter, slots=4, order=order)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        ends[max_iter] = want
    assert (ends[0][3] == 0).all() and not ends[0][2].any()
    np.testing.assert_array_equal(ends[0][0], seeds)
    cycled = ~ends[20][2] & (ends[20][3] < 20)
    assert cycled.sum() > len(seeds) // 2
    assert (ends[20][0] != ends[21][0]).any()


def test_the_fixtures_reach_every_exit():
    """Between them the fixtures freeze seeds, leave seeds live at max_iter
    (the recount), and run groups for different lengths."""
    _, _, frozen, n_iter = _global_fit("uniform_2d")
    assert (~frozen).any() and frozen.any() and n_iter.max() == 3
    _, _, frozen, n_iter = _global_fit("clusters_40")
    assert frozen.all() and n_iter.min() < n_iter.max()


def _emu_fit_predict(X, bandwidth, seeds, max_iter=300):
    """mean_shift_fit_predict with the emulated kernel as its fit."""
    X = np.asarray(X, np.float32)
    seeds = ms.bin_seeds(X, bin_size=bandwidth) if seeds is None else seeds
    seeds = np.asarray(seeds, np.float32)
    bw = np.float32(bandwidth)
    bw2, stop = float(bw * bw), float(np.float32(1e-3) * bw)
    Xt = torch.from_numpy(X)
    points = point_set(Xt, torch.ones(len(X), dtype=torch.bool))
    centers, n_final, _, _ = emu.fit(
        seeds, X, points.x_norm.numpy(), np.ones(len(X), bool), bw2, stop, max_iter
    )
    kept = ms._dedupe(torch.from_numpy(centers), torch.from_numpy(n_final), bw2)
    return ms._predict(Xt, kept, bw2).numpy().astype(np.int32)


@pytest.mark.parametrize("seeded", [False, True])
def test_emulated_kernel_labels_match_jax_and_sklearn(seeded):
    sklearn_cluster = pytest.importorskip("sklearn.cluster")
    rng = np.random.default_rng(1)
    centers = np.array([[0.0, 0.0], [8.0, 8.0], [0.0, 9.0]])
    X = np.concatenate([rng.normal(c, 0.6, size=(60, 2)) for c in centers]).astype(np.float32)
    X = np.concatenate([X, np.array([[30.0, 30.0], [-25.0, 4.0]], np.float32)])
    seeds = centers + 0.3 if seeded else None
    ref = sklearn_cluster.MeanShift(bandwidth=2.0, cluster_all=False, seeds=seeds).fit_predict(X)
    mine = _emu_fit_predict(X, 2.0, seeds)
    assert _same_partition(mine, jax_fit_predict(X, bandwidth=2.0, seeds=seeds))
    assert _same_partition(mine, ref)
    np.testing.assert_array_equal(mine, ref)


def test_emulated_kernel_labels_match_jax_on_the_clustered_fixtures():
    X, bandwidth, _ = _clusters_40()
    mine = _emu_fit_predict(X, bandwidth, None)
    assert _same_partition(mine, jax_fit_predict(X, bandwidth=bandwidth, seeds=None))
    orphans = np.array([[0.0, 0.0], [0.1, 0.0], [50.0, 50.0]], np.float32)
    one = np.array([[0.0, 0.0]], np.float32)
    np.testing.assert_array_equal(_emu_fit_predict(orphans, 1.0, one), [0, 0, -1])


def test_emulated_kernel_counts_the_boundary_inclusively():
    """tests/test_torch_ball_stats.py's boundary case: a point at exactly
    the bandwidth is inside, one just beyond is not."""
    centers = np.array([[0.0, 0.0]], np.float32)
    x = np.array([[1.0, 0.0], [1.0001, 0.0]], np.float32)
    points = point_set(torch.from_numpy(x), torch.ones(2, dtype=torch.bool))
    counts, sums = emu.ball_stats(centers, x, points.x_norm.numpy(), np.ones(2, bool), 1.0)
    plain_counts, plain_sums = ball_stats_plain(torch.from_numpy(centers), points, 1.0)
    np.testing.assert_array_equal(counts, plain_counts.numpy())
    np.testing.assert_array_equal(sums, plain_sums.numpy())
    assert counts[0] == 1.0


def test_emulated_ball_stats_skip_invalid_points():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 10, size=(700, 2)).astype(np.float32)
    valid = rng.random(700) > 0.3
    centers = rng.uniform(0, 10, size=(9, 2)).astype(np.float32)
    points = point_set(torch.from_numpy(x), torch.from_numpy(valid))
    counts, sums = emu.ball_stats(centers, x, points.x_norm.numpy(), valid, 4.0)
    plain_counts, plain_sums = ball_stats_plain(torch.from_numpy(centers), points, 4.0)
    np.testing.assert_array_equal(counts, plain_counts.numpy())
    np.testing.assert_allclose(sums, plain_sums.numpy(), rtol=1e-5)


def _fit_then_recount(points, seeds, bw2, stop_thresh, max_iter):
    """The previous port's ``_fit`` and the recount of its ``_dedupe``."""
    S = seeds.shape[0]
    centers = seeds
    prev = torch.full_like(seeds, float("inf"))
    n_final = torch.zeros((S,), dtype=torch.float32)
    frozen = torch.zeros((S,), dtype=torch.bool)
    halted = frozen.clone()
    it = 0
    while it < max_iter and not bool(halted.all()):
        counts, sums = ball_stats_plain(centers, points, bw2)
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        empty = counts == 0
        shift = torch.linalg.vector_norm(means - centers, dim=1)
        newly_done = empty | (shift < stop_thresh)
        new_centers = torch.where((halted | empty)[:, None], centers, means)
        cycle = (new_centers == prev).all(dim=1) & ~halted & ~newly_done
        final_pos = new_centers if (max_iter - (it + 1)) % 2 == 0 else centers
        new_centers = torch.where(cycle[:, None], final_pos, new_centers)
        n_final = torch.where(frozen, n_final, counts)
        frozen = frozen | newly_done
        halted = halted | newly_done | cycle
        prev, centers = centers, new_centers
        it += 1
    counts, _ = ball_stats_plain(centers, points, bw2)
    return centers, torch.where(frozen, n_final, counts), frozen


@pytest.mark.parametrize("name", ["clusters_40", "uniform_2d"])
def test_plain_fit_equals_the_previous_fit_and_recount(name):
    X, seeds, _, bw2, stop, max_iter = _problem(name)
    points = point_set(torch.from_numpy(X), torch.ones(len(X), dtype=torch.bool))
    got = mean_shift_fit_plain(torch.from_numpy(seeds), points, bw2, stop, max_iter)
    want = _fit_then_recount(points, torch.from_numpy(seeds), bw2, stop, max_iter)
    for g, w in zip(got[:3], want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_plain_fit_n_iter_is_the_iteration_a_seed_froze():
    """A frozen seed's ``n_iter`` is the first ``max_iter`` at which the
    previous fit reports it frozen; the loop ran ``max(n_iter)`` times."""
    X, seeds, _, bw2, stop, max_iter = _problem("clusters_40")
    points = point_set(torch.from_numpy(X), torch.ones(len(X), dtype=torch.bool))
    calls = []

    def counted(c, p, b):
        calls.append(1)
        return ball_stats_plain(c, p, b)

    seeds_t = torch.from_numpy(seeds)
    _, _, frozen, n_iter = mean_shift_fit_plain(seeds_t, points, bw2, stop, max_iter, counted)
    assert len(calls) == int(n_iter.max()) + 1  # the iterations, then the recount
    first = torch.full_like(n_iter, -1)
    for k in range(1, int(n_iter.max()) + 1):
        _, _, frozen_k = _fit_then_recount(points, seeds_t, bw2, stop, k)
        first = torch.where((first < 0) & frozen_k, k, first)
    assert bool(frozen.all())
    torch.testing.assert_close(n_iter, first.to(torch.int32), rtol=0, atol=0)


@pytest.mark.parametrize("max_iter", [0, 1, 300])
def test_plain_fit_by_hand(max_iter):
    """Seed 0 takes two points' mean and freezes there, seed 1's ball is
    empty, seed 2 moves onto one point and freezes."""
    X = np.array([[0.0, 0.0], [0.1, 0.0], [50.0, 50.0]], np.float32)
    seeds = torch.tensor([[0.0, 0.0], [20.0, 20.0], [50.5, 50.0]])
    points = point_set(torch.from_numpy(X), torch.ones(3, dtype=torch.bool))
    centers, n_final, frozen, n_iter = mean_shift_fit_plain(seeds, points, 1.0, 1e-3, max_iter)
    want_iter = {0: [0, 0, 0], 1: [1, 1, 1], 300: [2, 1, 2]}[max_iter]
    want_frozen = {0: [False] * 3, 1: [False, True, False], 300: [True] * 3}[max_iter]
    assert n_iter.tolist() == want_iter and frozen.tolist() == want_frozen
    assert n_final.tolist() == [2.0, 0.0, 1.0]
    if max_iter:
        torch.testing.assert_close(centers[0], torch.tensor([0.05, 0.0]))
        assert centers[2].tolist() == [50.0, 50.0]
    else:
        assert torch.equal(centers, seeds)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    X, seeds, _, bw2, stop, max_iter = _problem("uniform_2d")
    points = point_set(torch.from_numpy(X), torch.ones(len(X), dtype=torch.bool))
    before = mean_shift_fit.launches
    got = mean_shift_fit(torch.from_numpy(seeds), points, bw2, stop, max_iter)
    want = mean_shift_fit_plain(torch.from_numpy(seeds), points, bw2, stop, max_iter)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert mean_shift_fit.launches == before


def test_wrapper_rejects_other_devices_and_dimensions():
    points = point_set(torch.zeros((4, 2)), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        mean_shift_fit(torch.zeros((2, 2), device="meta"), points, 1.0, 1e-3, 10)
    wide = PointSet(torch.zeros((4, 9)), torch.zeros(4), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        mean_shift_fit(torch.zeros((2, 9)), wide, 1.0, 1e-3, 10)
    with pytest.raises(ValueError):
        mean_shift_fit(torch.zeros((2, 3)), points, 1.0, 1e-3, 10)


def test_fit_predict_fits_once_per_problem(monkeypatch):
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return mean_shift_fit(*args)

    monkeypatch.setattr(ms, "mean_shift_fit", counted)
    X, bandwidth, _ = _clusters_40()
    ms.mean_shift_fit_predict(X, bandwidth, None, device="cpu")
    assert len(calls) == 1


def test_emulation_mirrors_the_kernel_launch_shape():
    """The wrapper's plan constants are the source's, and the emulation
    takes its cluster size and threads per block from the plan's mirror."""
    src = (kernels.CSRC / "ball_stats.cu").read_text()
    for name, value in (("kFitThreads", msf.FIT_THREADS), ("kMaxCluster", msf.FIT_MAX_CLUSTER),
                        ("kPointsPerThread", msf.FIT_POINTS_PER_THREAD)):
        assert int(re.search(rf"{name} = (\d+);", src).group(1)) == value
    assert eval(re.search(r"kPointBytes = ([\d *]+);", src).group(1)) == msf.FIT_POINT_BYTES
    for N, d in ((100, 2), (2048, 2), (13594, 2), (9854, 3), (100000, 3), (3000, 5)):
        plan = msf.fit_plan(N, d)
        assert emu._launch_shape(N, d, None, None) == (plan.cluster, plan.threads)
    for fn in ("mean_shift_fit_launch", "mean_shift_fit_plan", "ball_stats_launch"):
        assert re.search(rf"\bint {fn}\(", src)


# --- the launch plan ---------------------------------------------------------

_PLAN_MAIN = r"""
#include <cstdio>
int main() {
  int N, d;
  while (std::scanf("%d %d", &N, &d) == 2) {
    FitPlan p = fit_plan_for(N, d);
    std::printf("%d %d %d %d %d %d\n", p.cluster, p.threads, p.slots, p.share, p.resident, p.smem);
  }
}
"""

# every point count the paths reach, the edges of each cluster size, and
# large ones whose share outgrows shared memory
PLAN_N = sorted({0, 1, 3, 4, 5, 100, 1023, 1024, 1025, 2047, 2048, 2049, 4096, 4097, 8192, 8193,
                 9854, 13594, 13683, 16384, 87000, 100000, 200000, 1_000_003})


@functools.lru_cache(maxsize=None)
def _source_plans():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the source's plan formulas")
    src = (kernels.CSRC / "ball_stats.cu").read_text()
    body = re.search(r"// ---- K3 plan begin.*?\n(.*)// ---- K3 plan end", src, re.S).group(1)
    work = tempfile.mkdtemp(prefix="k3plan")
    cpp, exe = os.path.join(work, "plan.cpp"), os.path.join(work, "plan")
    with open(cpp, "w") as f:
        f.write(body + _PLAN_MAIN)
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", exe, cpp], check=True, capture_output=True)
    cases = [(N, d) for d in range(1, 9) for N in PLAN_N]
    out = subprocess.run([exe], input="\n".join(f"{N} {d}" for N, d in cases),
                         capture_output=True, text=True, check=True).stdout.split("\n")
    shutil.rmtree(work)
    return {c: tuple(int(v) for v in line.split()) for c, line in zip(cases, out)}


@pytest.mark.parametrize("d", range(1, 9))
def test_plan_mirror_equals_the_source(d):
    """``fit_plan`` equals a g++ build of the source's "K3 plan" lines."""
    plans = _source_plans()
    for N in PLAN_N:
        assert tuple(msf.fit_plan(N, d)) == plans[(N, d)], (N, d)


@pytest.mark.parametrize("d", [2, 3, 8])
def test_plan_shares_cover_the_points_and_fit_shared_memory(d):
    """Each block's share covers N with 16-byte-aligned rows, its resident
    part and the exchange buffers fit a block's shared memory (227 KB, also
    the most any launch shape asks for), twice over where the share is small, and a
    thread's points an iteration stay at the plan's target until the cluster
    is at its largest."""
    for N in PLAN_N:
        p = msf.fit_plan(N, d)
        assert p.cluster in (1, 2, 4, 8) and p.threads in (128, 256) and p.slots * (d + 1) <= 128
        assert p.cluster * p.share >= N and p.share % 4 == 0 and p.resident % 4 == 0
        assert 4 <= p.resident <= p.share and p.smem <= 232448 - 1024
        assert msf.fit_smem_bytes(d, msf.FIT_MAX_CLUSTER, 256, p.resident) <= 232448 - 1024
        if p.share * 4 * (d + 1) <= 100 * 1024:
            assert 2 * (p.smem + 1024) <= 232448
        if p.cluster < msf.FIT_MAX_CLUSTER:
            assert -(-N // (p.cluster * p.threads)) <= msf.FIT_POINTS_PER_THREAD


def test_plan_is_a_function_of_n_and_d_only():
    """The plan takes no seed count, and a fit of every other seed gives the
    full fit's bits for those seeds (what chip_smoke.py checks on the card)."""
    assert list(inspect.signature(msf.fit_plan).parameters) == ["N", "d"]
    X, seeds, x_norm, bw2, stop, max_iter = _problem("clusters_40")
    valid = np.ones(len(X), bool)
    full = _global_fit("clusters_40")
    half = emu.fit(seeds[1::2], X, x_norm, valid, bw2, stop, max_iter, slots=16)
    for h, f in zip(half, full):
        np.testing.assert_array_equal(h, f[1::2])
