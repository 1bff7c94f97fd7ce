"""Numpy emulation of the float32 arithmetic of the port's mean-shift fit
kernel (``mean_shift_fit_kernel`` in ``cellulus_tpu_torch/csrc/ball_stats.cu``),
in its exact order: every operation in float32, rounded as the kernel rounds
it (no fused multiply-add).

- The distance ``(|c|^2 + |x|^2) - 2 c.x``, ``|c|^2`` and ``c.x`` summed in
  index order; an invalid point's ``|x|^2`` is +inf, so no ball holds it.
- Block ``r`` of a cluster of ``cluster`` blocks owns the points
  ``[r * share, (r + 1) * share)``, ``share = ceil(N / cluster)``; its thread
  ``t`` adds the points of local index ``t + j * threads`` in increasing ``j``.
- Each warp reduces by butterfly (``v += v[lane ^ m]``, m = 16 .. 1), the
  block sums its warps in index order, the cluster sums its blocks in rank
  order.
- The step of ``cellulus_tpu/ops/mean_shift.py:_make_step``, the shift as
  the root of the squared differences summed in index order.

:func:`fit` runs either one global loop over all seeds (every seed's ball
statistics every iteration, as the JAX package's ``while_loop`` does) or
groups of seeds that each stop when their own seeds have halted and compute
only live seeds, as the kernel does.
"""

import numpy as np

F32 = np.float32


def _points(x, x_norm, valid, cluster, threads):
    """Points laid out as ``(cluster, j, threads)``: ``xs (.., d)`` and
    ``xn`` (+inf where invalid or padding)."""
    x = np.asarray(x, F32)
    N, d = x.shape
    share = -(-N // cluster)
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


def ball_stats(centers, x, x_norm, valid, bw2, cluster=8, threads=256):
    """``(counts (S,), sums (S, d))`` as one pass of the fit kernel sums them."""
    pts = _points(x, x_norm, valid, cluster, threads)
    return _ball_stats(np.asarray(centers, F32), pts, bw2)


def _step(c, prev, halted, counts, sums, it, stop, max_iter):
    """``_make_step``: ``(new centers, newly done, cycle)``."""
    means = sums / np.maximum(counts, F32(1))[:, None]
    empty = counts == 0
    diff = means - c
    sq = diff[:, 0] * diff[:, 0]
    for k in range(1, c.shape[1]):
        sq = sq + diff[:, k] * diff[:, k]
    done = empty | (np.sqrt(sq) < F32(stop))
    new = np.where((halted | empty)[:, None], c, means)
    cycle = (new == prev).all(axis=1) & ~halted & ~done
    if (max_iter - (it + 1)) % 2 != 0:
        new = np.where(cycle[:, None], c, new)
    return new, done, cycle


def fit(seeds, x, x_norm, valid, bw2, stop, max_iter, group=None, cluster=8, threads=256):
    """``(centers, n_final, frozen, n_iter)`` of the fit and recount.

    ``group=None``: one global loop, every seed computed every iteration.
    ``group=G``: seeds in groups of G, each group looping until its own
    seeds have halted and computing only its live seeds.
    """
    pts = _points(x, x_norm, valid, cluster, threads)
    seeds = np.asarray(seeds, F32)
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
