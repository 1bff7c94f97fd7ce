"""Numpy emulation of the float32 arithmetic of the port's mean-shift fit
kernel (``mean_shift_fit_kernel`` in ``cellulus_tpu_torch/csrc/ball_stats.cu``),
in its exact order: every operation in float32, rounded as the kernel rounds
it (no fused multiply-add).

- The distance ``(|c|^2 + |x|^2) - 2 c.x``, ``|c|^2`` and ``c.x`` summed in
  index order; an invalid point's ``|x|^2`` is +inf, so no ball holds it.
- The cluster size and threads per block are the launch plan's for ``(N,
  d)`` (``cellulus_tpu_torch.ops.mean_shift_fit.fit_plan``). Block ``r`` of a
  cluster of ``cluster`` blocks owns the points ``[r * share, (r + 1) *
  share)``, ``share = fit_share(N, cluster)``; its thread ``t`` adds the
  points of local index ``t + j * threads`` in increasing ``j``.
- Each warp reduces by the butterfly's tree (``v += v[lane ^ m]``, m = 16 ..
  1), the block sums its warps in index order, the cluster sums its blocks
  in rank order.
- The step of ``cellulus_tpu/ops/mean_shift.py:_make_step``, the shift as
  the root of the squared differences summed in index order.

:func:`fit` runs one global loop over all seeds (every seed's ball
statistics every iteration, as the JAX package's ``while_loop`` does), or
groups of seeds that each stop when their own seeds have halted, or seed
slots that take the next seed of a claim order as soon as theirs has
finished, each seed counting its own iterations, as the kernel does.
"""

import numpy as np

from cellulus_tpu_torch.ops.mean_shift_fit import fit_plan, fit_share

F32 = np.float32


def _points(x, x_norm, valid, cluster, threads):
    """Points laid out as ``(cluster, j, threads)``: ``xs (.., d)`` and
    ``xn`` (+inf where invalid or padding)."""
    x = np.asarray(x, F32)
    N, d = x.shape
    share = fit_share(N, cluster)
    nj = max(1, -(-share // threads))
    xs = np.zeros((cluster, nj * threads, d), F32)
    xn = np.full((cluster, nj * threads), np.inf, F32)
    norm = np.where(np.asarray(valid, bool), np.asarray(x_norm, F32), F32(np.inf))
    for r in range(cluster):
        lo, hi = min(N, r * share), min(N, (r + 1) * share)
        xs[r, : hi - lo] = x[lo:hi]
        xn[r, : hi - lo] = norm[lo:hi]
    return xs.reshape(cluster, nj, threads, d), xn.reshape(cluster, nj, threads)


def _ball_stats(centers, pts, bw2, chunk=256):
    xs, xn = pts
    cluster, nj, threads, d = xs.shape
    S = centers.shape[0]
    counts = np.zeros((S,), F32)
    sums = np.zeros((S, d), F32)
    bw2 = F32(bw2)
    lanes = np.arange(32)
    with np.errstate(invalid="ignore", over="ignore"):
        for s0 in range(0, S, chunk):
            c = np.asarray(centers[s0 : s0 + chunk], F32)
            cn = c[:, 0] * c[:, 0]
            for k in range(1, d):
                cn = cn + c[:, k] * c[:, k]
            acc = np.zeros((len(c), cluster, threads, d + 1), F32)
            for j in range(nj):
                xj = xs[:, j]  # (cluster, threads, d)
                cross = c[:, None, None, 0] * xj[None, ..., 0]
                for k in range(1, d):
                    cross = cross + c[:, None, None, k] * xj[None, ..., k]
                d2 = (cn[:, None, None] + xn[None, :, j]) - F32(2) * cross
                inside = d2 <= bw2
                acc[..., 0] += inside.astype(F32)
                for k in range(d):
                    acc[..., 1 + k] += np.where(inside, xj[None, ..., k], F32(0))
            v = acc.reshape(len(c), cluster, threads // 32, 32, d + 1)
            for m in (16, 8, 4, 2, 1):
                v = v + v[:, :, :, lanes ^ m]
            warps = v[:, :, :, 0]  # (s, cluster, warps, d + 1)
            block = warps[:, :, 0]
            for w in range(1, warps.shape[2]):
                block = block + warps[:, :, w]
            total = block[:, 0]
            for r in range(1, cluster):
                total = total + block[:, r]
            counts[s0 : s0 + chunk] = total[:, 0]
            sums[s0 : s0 + chunk] = total[:, 1:]
    return counts, sums


def _launch_shape(N, d, cluster, threads):
    plan = fit_plan(N, d)
    return (plan.cluster if cluster is None else cluster,
            plan.threads if threads is None else threads)


def ball_stats(centers, x, x_norm, valid, bw2, cluster=None, threads=None):
    """``(counts (S,), sums (S, d))`` as one pass of the fit kernel sums them."""
    cluster, threads = _launch_shape(*np.shape(x), cluster, threads)
    pts = _points(x, x_norm, valid, cluster, threads)
    return _ball_stats(np.asarray(centers, F32), pts, bw2)


def _step(c, prev, halted, counts, sums, it, stop, max_iter):
    """``_make_step`` at iteration ``it`` (a scalar, or one per seed):
    ``(new centers, newly done, cycle)``."""
    means = sums / np.maximum(counts, F32(1))[:, None]
    empty = counts == 0
    diff = means - c
    sq = diff[:, 0] * diff[:, 0]
    for k in range(1, c.shape[1]):
        sq = sq + diff[:, k] * diff[:, k]
    done = empty | (np.sqrt(sq) < F32(stop))
    new = np.where((halted | empty)[:, None], c, means)
    cycle = (new == prev).all(axis=1) & ~halted & ~done
    odd = (max_iter - (np.asarray(it) + 1)) % 2 != 0
    new = np.where((cycle & odd)[:, None], c, new)
    return new, done, cycle


def _refill(seeds, pts, bw2, stop, max_iter, slots, order):
    """Seed slots: each slot holds a seed until it has frozen or has been
    recounted (halted unfrozen by a cycle or by its own ``max_iter``
    iterations), then takes the next seed of ``order``; a pass computes the
    ball statistics of every held seed, as the kernel's clusters do."""
    S = len(seeds)
    c = seeds.copy()
    prev = np.full_like(c, np.inf)
    n_final = np.zeros((S,), F32)
    frozen = np.zeros((S,), bool)
    n_iter = np.zeros((S,), np.int32)
    recount = np.zeros((S,), bool)
    queue = list(range(S) if order is None else order)
    assert sorted(queue) == list(range(S))
    held = [-1] * slots
    while True:
        for m in range(slots):
            if held[m] < 0 and queue:
                held[m] = queue.pop(0)
                recount[held[m]] = max_iter <= 0
        run = np.array([s for s in held if s >= 0], np.int64)
        if not len(run):
            return c, n_final, frozen, n_iter
        counts, sums = _ball_stats(c[run], pts, bw2)
        again = recount[run]
        n_final[run[again]] = counts[again]
        live = run[~again]
        new, done, cycle = _step(c[live], prev[live], np.zeros(len(live), bool), counts[~again],
                                 sums[~again], n_iter[live], stop, max_iter)
        n_final[live] = counts[~again]
        n_iter[live] += 1
        frozen[live] = done
        prev[live], c[live] = c[live], new
        recount[live] = ~done & (cycle | (n_iter[live] >= max_iter))
        finished = set(run[again].tolist()) | set(live[done].tolist())
        held = [-1 if s in finished else s for s in held]


def fit(seeds, x, x_norm, valid, bw2, stop, max_iter, group=None, slots=None, order=None,
        cluster=None, threads=None):
    """``(centers, n_final, frozen, n_iter)`` of the fit and recount.

    Default: one global loop, every seed computed every iteration.
    ``group=G``: seeds in groups of G, each group looping until its own
    seeds have halted and computing only its live seeds.
    ``slots=M``: M seed slots refilled from ``order`` (a permutation of the
    seeds; default in index order) as their seeds finish.
    ``cluster`` and ``threads`` default to the launch plan's for ``(N, d)``.
    """
    cluster, threads = _launch_shape(*np.shape(x), cluster, threads)
    pts = _points(x, x_norm, valid, cluster, threads)
    seeds = np.asarray(seeds, F32)
    if slots is not None:
        return _refill(seeds, pts, bw2, stop, max_iter, slots, order)
    S = len(seeds)
    c = seeds.copy()
    prev = np.full_like(c, np.inf)
    n_final = np.zeros((S,), F32)
    frozen = np.zeros((S,), bool)
    halted = np.zeros((S,), bool)
    n_iter = np.zeros((S,), np.int32)
    groups = [np.arange(S)] if group is None else [
        np.arange(s0, min(S, s0 + group)) for s0 in range(0, S, group)
    ]
    for idx in groups:
        it = 0
        while it < max_iter and not halted[idx].all():
            # the global loop computes halted seeds too; a group only live ones
            run = idx if group is None else idx[~halted[idx]]
            counts, sums = _ball_stats(c[run], pts, bw2)
            new, done, cycle = _step(
                c[run], prev[run], halted[run], counts, sums, it, stop, max_iter
            )
            n_final[run] = np.where(frozen[run], n_final[run], counts)
            n_iter[run] = np.where(halted[run], n_iter[run], it + 1)
            frozen[run] |= done
            halted[run] |= done | cycle
            prev[run], c[run] = c[run], new
            it += 1
        recount = idx[~frozen[idx]]
        if len(recount):
            n_final[recount] = _ball_stats(c[recount], pts, bw2)[0]
    return c, n_final, frozen, n_iter
