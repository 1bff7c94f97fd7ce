"""Inference in plain PyTorch, NumPy and SciPy: tiled test-time-augmented
embeddings, detection and cell segmentation of one sample.

The semantics are the reference's (``cellulus/predict.py``,
``cellulus/detect.py``, ``cellulus/segment.py``) with the port's
documented choices where the reference leaves one open:

- tiles: output tiles of the U-Net's output size on a grid whose last tile
  is shifted inward, each read with its context under reflect boundary
  handling (no edge repetition), ``tile_batch_size`` tiles a batch, later
  tiles overwriting earlier ones where they overlap;
- test-time augmentation: ``2 * num_infer_iterations`` copies of a batch, a
  pixel set to 0.5 (first half) or 1.0 (second half) where its uniform draw
  is ``<= p_salt_pepper``; the mean offsets and the channel-summed
  population std over the copies. The draws come from one generator a
  sample, seeded by a SeedSequence hash of ``(seed, sample)``, one
  ``torch.rand`` a batch of shape ``(copies, T, *in_tile, C)``: a frozen copy
  of the port's ``draw_uniform`` and ``seeded_generator``;
- detection: the Otsu threshold (skimage's, 256 bins) of the std channel,
  the foreground ``std < threshold``; mean shift (flat kernel, inclusive
  ball, bin seeds at the bandwidth over a ``reduction_probability``
  subsample drawn by ``numpy.random.default_rng([seed, sample])``, seeds
  stop below a shift of ``1e-3 * bandwidth``, duplicates within the
  bandwidth dropped by population, nearest centre within the bandwidth) of
  the absolute embeddings, or greedy seed-and-grow clustering;
- segmentation ("cell"): pixels within ``shrink_distance`` of the
  background of the foreground grown by ``grow_distance`` are cleared
  (thresholded Euclidean distance transforms), then connected components
  of each id (full connectivity), those under ``min_size`` dropped.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Optional

import numpy as np
import torch
from scipy import ndimage as ndi

from .unet import forward


def generator_seed(*entropy: int) -> int:
    return int(np.random.SeedSequence([int(e) for e in entropy]).generate_state(1, np.uint64)[0])


def tile_origins(extent: int, tile: int):
    if extent <= tile:
        return [0]
    origins = list(range(0, extent - tile, tile))
    origins.append(extent - tile)
    return origins


def _reflect(idx: np.ndarray, extent: int) -> np.ndarray:
    if extent == 1:
        return np.zeros_like(idx)
    period = 2 * (extent - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= extent, period - idx, idx)


def tta_sample(params: Dict[str, torch.Tensor], model: dict, ic: dict, image: np.ndarray,
               normalization: float, seed: int, sample: int, out_tile, context, device,
               copies_per_block: int = 16,
               quantize: Optional[Callable] = None) -> np.ndarray:
    """``(C, *spatial)`` raw image -> ``(D + 1, *spatial)`` float32 embeddings."""
    spatial = image.shape[1:]
    D = len(spatial)
    in_tile = tuple(o + 2 * c for o, c in zip(out_tile, context))
    nii = int(ic["num_infer_iterations"])
    n = 2 * nii
    p = float(ic["p_salt_pepper"])
    tb = int(ic["tile_batch_size"])
    norm = image.astype(np.float32) * normalization
    origins = list(itertools.product(*[tile_origins(max(s, o), o)
                                       for s, o in zip(spatial, out_tile)]))
    gen = torch.Generator(device=device)
    gen.manual_seed(generator_seed(seed, sample))
    result = np.zeros((D + 1, *spatial), np.float32)
    noise = torch.tensor([0.5] * nii + [1.0] * nii, dtype=torch.float32, device=device)
    for start in range(0, len(origins), tb):
        batch = origins[start:start + tb]
        tiles = []
        for origin in batch:
            idx = [_reflect(np.arange(o - c, o - c + s), e)
                   for o, c, s, e in zip(origin, context, in_tile, spatial)]
            tiles.append(norm[np.ix_(range(norm.shape[0]), *idx)])
        tiles = torch.from_numpy(np.stack(tiles)).to(device)  # (T, C, *in_tile)
        T = tiles.shape[0]
        tiles_cl = tiles.movedim(1, -1)  # (T, *in_tile, C): the draws' layout
        uniform = torch.rand((n, *tiles_cl.shape), generator=gen, device=device,
                             dtype=torch.float32)
        preds = []
        for c0 in range(0, n, copies_per_block):
            u = uniform[c0:c0 + copies_per_block]
            vals = noise[c0:c0 + copies_per_block].reshape((-1,) + (1,) * tiles_cl.dim())
            noisy = torch.where(u <= p, vals, tiles_cl[None]).reshape(-1, *tiles_cl.shape[1:])
            with torch.no_grad():
                out = forward(params, model, noisy.movedim(-1, 1).contiguous(), quantize)
            preds.append(out.reshape(-1, T, *out.shape[1:]).double())
        preds = torch.cat(preds)  # (n, T, D, *out_tile), float64 for the statistics
        mean = preds.mean(dim=0)
        std = preds.std(dim=0, correction=0).sum(dim=1, keepdim=True)
        outs = torch.cat([mean, std], dim=1).float().cpu().numpy()
        for tile_out, origin in zip(outs, batch):
            sel = tuple(slice(o, min(o + t, s)) for o, t, s in zip(origin, out_tile, spatial))
            data = tile_out[(slice(None),) + tuple(slice(0, sl.stop - sl.start) for sl in sel)]
            result[(slice(None),) + sel] = data
    return result


def threshold_otsu(image: np.ndarray, nbins: int = 256) -> float:
    """skimage's ``threshold_otsu``: the bin centre that maximises the
    between-class variance of a 256-bin histogram."""
    counts, edges = np.histogram(np.asarray(image).ravel(), bins=nbins)
    centers = (edges[:-1] + edges[1:]) / 2
    counts = counts.astype(np.float64)
    w1 = np.cumsum(counts)
    w2 = np.cumsum(counts[::-1])[::-1]
    m1 = np.cumsum(counts * centers) / np.maximum(w1, 1e-12)
    m2 = (np.cumsum((counts * centers)[::-1]) / np.maximum(w2[::-1], 1e-12))[::-1]
    variance12 = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return float(centers[int(np.argmax(variance12))])


def absolute_embeddings(offsets: np.ndarray) -> np.ndarray:
    """Offsets (x-first channels) plus each pixel's coordinate."""
    out = np.array(offsets, dtype=np.float32, copy=True)
    ndim = out.ndim - 1
    for channel in range(ndim):
        axis = ndim - 1 - channel
        shape = [1] * ndim
        shape[axis] = out.shape[1 + axis]
        out[channel] += np.arange(out.shape[1 + axis], dtype=np.float32).reshape(shape)
    return out


def mean_shift(X: np.ndarray, bandwidth: float, reduction_probability: float,
               max_iter: int, rng: np.random.Generator, device,
               dtype=torch.float32) -> np.ndarray:
    """Labels in ``[0, K)`` or ``-1`` for every row of ``X`` (float32
    ``(N, d)``), computed in ``dtype``."""
    n = len(X)
    X_fit = X
    if reduction_probability < 1.0:
        X_fit = X[rng.random(n) < reduction_probability]
        if len(X_fit) == 0:
            X_fit = X
    binned = np.round(X_fit / bandwidth)
    seeds = (np.unique(binned, axis=0) * bandwidth).astype(np.float32)
    if len(seeds) == 0:
        return np.full(n, -1, np.int64)
    bw = np.float32(bandwidth)
    bw2 = float(bw * bw)
    stop = float(np.float32(1e-3) * bw)
    pts = torch.from_numpy(X_fit).to(device, dtype)
    c = torch.from_numpy(seeds).to(device, dtype)
    S = len(seeds)
    live = torch.ones(S, dtype=torch.bool, device=device)
    pop = torch.zeros(S, dtype=torch.float64, device=device)
    frozen = torch.zeros(S, dtype=torch.bool, device=device)

    def ball(centers):
        d2 = ((centers[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        w = (d2 <= bw2).to(dtype)
        return w.sum(1), w @ pts

    for _ in range(max_iter):
        counts, sums = ball(c)
        means = sums / counts.clamp(min=1)[:, None]
        empty = counts == 0
        shift = torch.sqrt(((means - c) ** 2).sum(-1).double())
        done = live & (empty | (shift < stop))
        pop = torch.where(done & ~empty, counts.double(), pop)
        frozen = frozen | done
        c = torch.where((live & ~empty)[:, None], means, c)
        live = live & ~done
        if not bool(live.any()):
            break
    counts, _ = ball(c)
    pop = torch.where(frozen, pop, counts.double())
    centers = c.double().cpu().numpy()
    pop = pop.cpu().numpy()
    keep = pop > 0
    order = np.lexsort([-centers[:, k] for k in reversed(range(centers.shape[1]))]
                       + [-np.where(keep, pop, -1.0)])
    sc = centers[order]
    unique = keep[order].copy()
    for i in range(len(unique)):
        if unique[i]:
            near = ((sc - sc[i]) ** 2).sum(1) <= bw2
            unique[near] = False
            unique[i] = True
    kept = torch.from_numpy(sc[unique]).to(device, dtype)
    labels = torch.full((n,), -1, dtype=torch.int64, device=device)
    if len(kept) == 0:
        return labels.cpu().numpy()
    allx = torch.from_numpy(X).to(device, dtype)
    for s in range(0, n, 1 << 16):
        d2 = ((allx[s:s + (1 << 16), None, :] - kept[None]) ** 2).sum(-1)
        best, idx = d2.min(dim=1)
        labels[s:s + (1 << 16)] = torch.where(best <= bw2, idx, -1)
    return labels.cpu().numpy()


def greedy(embeddings: np.ndarray, fg: np.ndarray, bandwidth: float, min_object_size: float,
           device, seed_thresh: float = 0.9, max_instances: int = 8192,
           dtype=torch.float32) -> np.ndarray:
    """Greedy seed-and-grow clustering: repeatedly take the free foreground
    pixel of the highest certainty, propose every foreground pixel whose
    Gaussian affinity to it exceeds 0.5, and keep the proposal as an
    instance when it is larger than ``min_object_size`` and more than half
    free; stop when the best free pixel's certainty is below
    ``seed_thresh``. The distances are computed in ``dtype``."""
    ndim = embeddings.ndim - 1
    unc = embeddings[ndim]
    absolute = absolute_embeddings(embeddings[:ndim])
    lo, hi = unc.min(), unc.max()
    denom = lo - hi if lo != hi else 1.0
    score = torch.from_numpy(np.ascontiguousarray(((unc - hi) / denom).ravel(),
                                                  dtype=np.float32)).to(device)
    P = unc.size
    emb = torch.from_numpy(np.ascontiguousarray(absolute.reshape(ndim, P).T)).to(device, dtype)
    fgt = torch.from_numpy(np.ascontiguousarray(fg.ravel().astype(bool))).to(device)
    bw = np.float32(bandwidth)
    inv_two_bw2 = float(np.float32(1.0) / (np.float32(2.0) * bw * bw))
    free_mask = torch.ones(P, dtype=torch.bool, device=device)
    out = torch.zeros(P, dtype=torch.int32, device=device)
    count = 1
    while count <= max_instances:
        free = free_mask & fgt
        if not bool(free.any()):
            break
        masked = score * free.float()
        seed = int(torch.argmax(masked))
        if float(masked[seed]) < seed_thresh:
            break
        sq = ((emb - emb[seed]) ** 2).sum(1).float()
        proposal = (torch.exp(-sq * inv_two_bw2) > 0.5) & fgt
        size = int(proposal.sum())
        still = int((proposal & free_mask).sum())
        if size > min_object_size and still / max(size, 1) > 0.5:
            out[proposal] = count
            count += 1
        free_mask &= ~proposal
        free_mask[seed] = False
    return out.cpu().numpy().reshape(unc.shape)


def detect(embeddings: np.ndarray, ic: dict, seed: int, sample: int, device,
           dtype=torch.float32):
    """``(binary mask, detections (*spatial) int)`` of one sample, the
    clustering's distances computed in ``dtype``."""
    D = embeddings.ndim - 1
    std = embeddings[-1]
    mask = std < threshold_otsu(std)
    out = np.zeros(std.shape, np.int64)
    if not mask.any():
        return mask, out
    if ic["clustering"] == "greedy":
        return mask, greedy(embeddings, mask, ic["bandwidth"], ic["min_size"], device,
                            dtype=dtype)
    absolute = absolute_embeddings(embeddings[:D])
    X = np.ascontiguousarray(absolute.reshape(D, -1).T[mask.ravel()])
    labels = mean_shift(X, ic["bandwidth"], ic["reduction_probability"],
                        ic["mean_shift_max_iterations"],
                        np.random.default_rng([int(seed), int(sample)]), device, dtype)
    flat = np.full(mask.shape, -1, np.int64)
    flat[mask] = labels
    return mask, flat + 1


def segment(detections: np.ndarray, ic: dict) -> np.ndarray:
    """Halo removal, connected components of each id, the size filter."""
    seg = np.array(detections, dtype=np.int64, copy=True)
    expanded = ndi.distance_transform_edt(seg == 0) < ic["grow_distance"]
    near_background = ndi.distance_transform_edt(expanded) < ic["shrink_distance"]
    seg[near_background] = 0
    structure = np.ones((3,) * seg.ndim, dtype=bool)
    out = np.zeros(seg.shape, np.int64)
    nxt = 0
    for index, box in enumerate(ndi.find_objects(seg)):
        if box is None:
            continue
        comp, n = ndi.label(seg[box] == index + 1, structure=structure)
        sizes = np.bincount(comp.ravel(), minlength=n + 1)
        for k in range(1, n + 1):
            if sizes[k] >= ic["min_size"]:
                nxt += 1
                out[box][comp == k] = nxt
    return out
