"""Tiled, test-time-augmented embedding prediction.

Port of ``cellulus_tpu/predict.py``, 2D and 3D: output
tiles cover the image or volume on a shingled grid, each tile is read with
its valid-conv context under reflect boundary handling in every axis, and
``tile_batch_size`` tiles at a time run all ``2 * num_infer_iterations``
noisy copies as one batched forward. The salt-and-pepper draws come from
one ``torch.Generator`` per sample, seeded from ``(inference_config.seed,
sample)``, one draw a tile batch in batch order (:func:`draw_uniform`).

Over a list of devices each tile batch is split into one chunk a device,
each run on that device's copy of the model, with the batch's draws made
as on one device and split with it: a tile's noise does not depend on the
split. With ``spatial_shards >= 2`` each sample is instead one whole-sample
forward sharded over the devices (``parallel/spatial.py``).

The staged :func:`predict` streams: each batch's tiles, with their halos,
are read from the zarr on demand, and each output tile is written through
one writer thread (the last tile in origin order wins where shingled tiles
overlap), so no sample is held whole on the host. :func:`predict_sample`
keeps a one-batch lookahead: batch n + 1's upload and forward are launched
before batch n is fetched.

Where the lookahead has nothing to overlap, a sample held in memory whose
tile grid is one tile batch on one CUDA device (:func:`one_replay`),
:func:`predict_sample` runs the sample's whole device side as one CUDA
graph replay (:class:`_SampleGraph`): the upload, the tile cut on the card
(:func:`cut_tiles`), the noise draw, the TTA forward and the copy back.
A shape is captured when a second sample of it comes right after the
first, and replayed while the model lives and its samples keep that shape.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import threading
import weakref
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .configs import InferenceConfig
from .datasets import normalization_factor_for
from .io import DatasetMetaData, zarr
from .io.meta_data import spatial_attrs
from .io.regions import read_reflect_region, reflect_coords
from .models import UNet, compute_geometry, tta_embeddings
from .parallel.mesh import as_devices, local_devices, replicate, shard_batch
from .parallel.spatial import spatial_devices, spatial_tta_sample
from .utils import kernels
from .utils.device import generator_seed, seeded_generator
from .utils.profiling import count, span, time_device
from .utils.progress import progress


def tile_origins(extent: int, tile: int) -> List[int]:
    """Start offsets covering ``[0, extent)`` with stride ``tile``; the last
    tile is shifted inward (shingled) so every pixel is covered exactly."""
    if extent <= tile:
        return [0]
    origins = list(range(0, extent - tile, tile))
    origins.append(extent - tile)
    return origins


def draw_uniform(generator: torch.Generator, tiles_shape: Sequence[int],
                 num_infer_iterations: int, device) -> torch.Tensor:
    """The salt-and-pepper draws of one tile batch of ``tiles_shape``
    (``(T, *in_tile, C)``): ``(2 * num_infer_iterations, *tiles_shape)``
    float32 from U[0, 1), from ``generator`` on ``device``. The live path
    draws each batch so; a server that draws the same way from a generator
    in the same state reproduces it (``export.py``)."""
    return torch.rand((2 * num_infer_iterations, *tiles_shape), generator=generator,
                      device=device, dtype=torch.float32)


def tile_index(origins, context, in_tile, spatial, device=None) -> List[torch.Tensor]:
    """The source indices of each tile's input region under reflect
    boundary handling (:func:`~cellulus_tpu_torch.io.regions.reflect_coords`
    at ``origin - context``), one int64 tensor an axis, shaped to broadcast
    to ``(T, *in_tile)``: axis d's is ``(T, 1, .., in_tile[d], .., 1)``."""
    index = []
    for d, (c, size, extent) in enumerate(zip(context, in_tile, spatial)):
        rows = np.stack([reflect_coords(o[d] - c, size, extent) for o in origins])
        shape = [len(origins)] + [1] * len(in_tile)
        shape[1 + d] = size
        index.append(torch.from_numpy(rows).reshape(shape).to(device))
    return index


def cut_tiles(raw: torch.Tensor, index: Sequence[torch.Tensor],
              normalization_factor: float) -> torch.Tensor:
    """``(C, *spatial)`` float32 raw -> ``(T, *in_tile, C)`` normalized
    tiles, channels-last, gathered at :func:`tile_index`'s indices: the
    values of the host path's ``read_reflect_region(...) *
    normalization_factor``, bit for bit (one float32 product each)."""
    return (raw[(slice(None), *index)] * normalization_factor).movedim(0, -1).contiguous()


def one_replay(num_tiles: int, tile_batch_size: int, devices, spatial_shards: int,
               streaming: bool) -> bool:
    """Does :func:`predict_sample` run a sample as one CUDA graph replay?
    Where its tile grid is one tile batch (the lookahead has nothing to
    overlap), on one CUDA device, not sharded spatially, and the sample is
    held in memory (not read through a streaming ``source``)."""
    return (not streaming and int(spatial_shards) < 2 and len(devices) == 1
            and torch.device(devices[0]).type == "cuda"
            and num_tiles <= tile_batch_size)


class _HostSlots:
    """The lookahead's host side: on the card, two pinned upload buffers
    and two pinned download buffers, used in turn by even and odd batches,
    and an event a batch recorded after its copy back. A slot is refilled
    two batches later, after its batch was fetched, so after its event.

    A copy into pageable memory would hold the driver while it waits for
    the stream and block every other thread's CUDA calls (the pipelined
    path's stage workers); a wait on the whole stream would also wait for
    the batch launched after it. On the CPU the tensors pass through."""

    def __init__(self, device: torch.device, batch: int, out_tile, out_channels: int,
                 transfer_dtype):
        self.device, self.transfer_dtype = device, transfer_dtype
        self.cuda = device.type == "cuda"
        self.up: List[Optional[torch.Tensor]] = [None, None]
        if self.cuda:
            self.down = [torch.empty((batch, *out_tile, out_channels), dtype=transfer_dtype,
                                     pin_memory=True) for _ in range(2)]

    def upload(self, host_tiles: np.ndarray, slot: int) -> torch.Tensor:
        if not self.cuda:
            return torch.from_numpy(host_tiles).to(self.device)
        n = len(host_tiles)
        if self.up[slot] is None:
            batch = len(self.down[slot])
            self.up[slot] = torch.empty((batch, *host_tiles.shape[1:]), dtype=torch.float32,
                                        pin_memory=True)
        up = self.up[slot][:n]
        up.copy_(torch.from_numpy(host_tiles))
        return up.to(self.device, non_blocking=True)

    def start_fetch(self, out: torch.Tensor, slot: int):
        """Enqueue the copy of ``out`` (``(T, *out_tile, D + 1)``) to the host."""
        out = out.to(self.transfer_dtype)
        if not self.cuda:
            return out, None
        host = self.down[slot][: len(out)]
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    @staticmethod
    def finish_fetch(fetch) -> np.ndarray:
        """The batch as float32 ``(T, D + 1, *out_tile)``, copied out of its
        slot once its event has passed."""
        host, event = fetch
        if event is not None:
            event.synchronize()
        return np.moveaxis(host.numpy(), -1, 1).astype(np.float32)


class _SampleGraph:
    """A sample's device side as one CUDA graph: the raw sample's upload
    from a pinned buffer, the tile cut (:func:`cut_tiles`), the noise draw
    (:func:`draw_uniform`) from a generator registered with the graph, the
    TTA forward, the cast to the transfer dtype and the copy back into a
    pinned buffer. A replay reads the model's live parameters (K1 packs
    them inside the graph), so weights loaded in place carry over. The host
    copies the sample in, reseeds, replays and waits on one event.

    Captured after one eager warm-up on the capture stream, a side stream.
    Holds no reference to the model, which keys it weakly
    (:data:`_GRAPHS`)."""

    def __init__(self, model: UNet, raw: np.ndarray, origins, context, in_tile, out_tile,
                 out_channels: int, normalization_factor: float, nii: int, p: float,
                 compute_dtype, transfer_dtype, device: torch.device):
        self.device = device
        pinned = torch.empty(raw.shape, dtype=torch.float32, pin_memory=True)
        self.raw_host = pinned.numpy()
        np.copyto(self.raw_host, raw)
        raw_dev = torch.empty(raw.shape, dtype=torch.float32, device=device)
        index = tile_index(origins, context, in_tile, raw.shape[1:], device)
        # the graph reads and writes these by address: they live as long as it
        self._statics = (pinned, raw_dev, index)
        self.generator = torch.Generator(device=device)
        self.host_out = torch.empty((len(origins), *out_tile, out_channels),
                                    dtype=transfer_dtype, pin_memory=True)
        self.event = torch.cuda.Event()

        def device_side():
            raw_dev.copy_(pinned, non_blocking=True)
            tiles = cut_tiles(raw_dev, index, normalization_factor)
            uniform = draw_uniform(self.generator, tiles.shape, nii, device)
            out = tta_embeddings(model, tiles, uniform, p, nii, compute_dtype).to(transfer_dtype)
            self.host_out.copy_(out, non_blocking=True)
            return out

        # the warm-up, on the capture stream; the eager path's cached blocks
        # are released first, and the warm-up's by the capture
        torch.cuda.empty_cache()
        stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            device_side()
        current.wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.generator)
        # as greedy's capture: one capture at a time in the process, and
        # "thread_local", so the stage workers allocate and sync meanwhile;
        # K1's launch counts and counters are made at each replay
        with kernels.deferred_accounts() as self.accounts, kernels.CAPTURE_LOCK, \
                torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
            self.out = device_side()

    def run(self, raw: np.ndarray, seed: int):
        """Replay on ``raw`` with the generator at ``seed``; returns the
        fetch :meth:`_HostSlots.finish_fetch` reads."""
        with span("predict: upload"):
            np.copyto(self.raw_host, raw)
        with span("predict: forward"):
            self.generator.manual_seed(seed)
            time_device("predict.device", self._replay)
            self.event.record(torch.cuda.current_stream(self.device))
        count("predict.graph_replays", 1)
        return self.host_out, self.event

    def _replay(self) -> torch.Tensor:
        self.graph.replay()
        for fn, args in self.accounts:
            fn(*args)
        return self.out


class _DeviceGraphs:
    """A model's sample graph on one device: at most one, for the shape of
    the model's last samples there. A shape is captured when a second
    sample of it comes right after the first (a shape seen once is not
    worth a capture), and any other forward of the model on the device
    drops the graph first: a graph's memory pool and an eager forward's
    cached blocks do not fit on the card side by side at the widest models
    (about 41.5 GiB each at 256 fmaps, 4 tiles a batch). ``lock`` is held
    through a capture, and through a replay and its fetch (the graph's host
    buffers are reused)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.key = None
        self.graph: Optional[_SampleGraph] = None

    def get(self, key, capture: Callable[[], _SampleGraph]) -> Optional[_SampleGraph]:
        """The graph for a sample of ``key``, made by ``capture()`` if the
        last sample was of ``key`` too; None where the sample runs eagerly."""
        with self.lock:
            if key != self.key:
                self._drop()
                self.key = key
            elif self.graph is None:
                with span("predict: capture"):
                    self.graph = capture()
                count("predict.graph_captures", 1)
            return self.graph

    def drop(self) -> None:
        """Before a forward of another kind on the device."""
        with self.lock:
            self._drop()
            self.key = None

    def _drop(self) -> None:
        if self.graph is not None:
            self.graph = None
            torch.cuda.empty_cache()


# model -> {device: _DeviceGraphs}: a model's graph goes with it, and
# outlives one call (the pipelined path predicts a pass of samples a call)
_GRAPHS: "weakref.WeakKeyDictionary[UNet, dict]" = weakref.WeakKeyDictionary()
_GRAPHS_LOCK = threading.Lock()


def _device_graphs(model: UNet, device: torch.device) -> _DeviceGraphs:
    with _GRAPHS_LOCK:
        by_device = _GRAPHS.setdefault(model, {})
        return by_device.setdefault(device, _DeviceGraphs())


def _drop_graph(model: UNet, device: torch.device) -> None:
    """Drop the model's graph on ``device``, if it has one."""
    with _GRAPHS_LOCK:
        graphs = _GRAPHS.get(model, {}).get(device)
    if graphs is not None:
        graphs.drop()


def predict_sample(
    model: UNet,
    raw: Optional[np.ndarray],
    inference_config: InferenceConfig,
    normalization_factor: float,
    sample_seed: int,
    device,
    compute_dtype=torch.float32,
    write_fn: Optional[Callable[[np.ndarray, tuple], None]] = None,
    source: Optional[Callable[[tuple, tuple], np.ndarray]] = None,
    spatial: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
    replicas=None,
) -> Optional[np.ndarray]:
    """``(C, *spatial)`` raw sample -> ``(D + 1, *spatial)`` float32
    embeddings. With ``transfer_precision = "float16"`` each tile batch's
    TTA output is rounded to float16 on the device before it is copied to
    the host (stored as float32), as the JAX package does. Where
    :func:`one_replay` holds, the sample is one CUDA graph replay from the
    second of a run of samples of one shape on (:class:`_DeviceGraphs`),
    with the eager path's outputs bit for bit.

    Args:
        raw: the un-normalized sample, or None when ``source`` is given.
        write_fn: ``write_fn(tile (D + 1, *t), origin)`` receives each output
            tile, cropped to the sample, in origin order; then nothing is
            assembled and None is returned.
        source: ``source(origin, size) -> (C, *size)`` normalized float32
            region under reflect boundary handling (the streaming reader);
            ``spatial`` is then the sample's spatial extent.
        devices: the devices each tile batch is split over (default
            ``[device]``); with ``spatial_shards >= 2``, the shards' devices
            (default: that many of ``device``'s type, which raises when
            fewer GPUs are visible). ``replicas``: the model a device
            (``parallel.mesh.replicate``), made once by a caller that
            predicts many samples.
    """
    device = torch.device(device)
    shards = int(inference_config.spatial_shards)
    if shards >= 2:
        if raw is None or write_fn is not None:
            raise ValueError("spatial_shards >= 2 predicts a whole sample held in memory "
                             "(raw), not a streamed one")
        if devices is None:
            devices = spatial_devices(shards, device)
        return spatial_tta_sample(model, np.asarray(raw), inference_config,
                                  normalization_factor, sample_seed, compute_dtype, devices,
                                  replicas)
    devices = as_devices(devices) if devices is not None else [device]
    if len(devices) > 1:
        replicas = replicas or replicate(model, devices)
    streaming = source is not None
    if source is None:
        raw = np.asarray(raw)
        spatial = raw.shape[1:]

        def source(origin, size):
            return read_reflect_region(
                lambda lo, hi: raw[(slice(None),) + tuple(slice(*b) for b in zip(lo, hi))],
                spatial, origin, size,
            ) * normalization_factor
    elif spatial is None:
        raise ValueError("predict_sample: a source needs the sample's spatial extent")
    spatial = tuple(int(s) for s in spatial)
    geometry = compute_geometry(tuple(inference_config.crop_size), model.downsampling_factors)
    out_tile, context = geometry.output_size, geometry.context
    in_tile = tuple(o + 2 * c for o, c in zip(out_tile, context))
    nii = int(inference_config.num_infer_iterations)
    p = float(inference_config.p_salt_pepper)
    D = model.head[2].out_channels

    # the sample's tile grid; a sample that is one tile batch on the card is
    # one graph replay
    with span("predict: tiles"):
        origins = list(itertools.product(
            *[tile_origins(max(s, o), o) for s, o in zip(spatial, out_tile)]
        ))
        tb = max(1, int(inference_config.tile_batch_size))
        transfer_dtype = (
            torch.float16 if inference_config.transfer_precision == "float16" else torch.float32
        )
        result = None if write_fn is not None else np.zeros((D + 1, *spatial), dtype=np.float32)
        graphs = None
        if one_replay(len(origins), tb, devices, shards, streaming):
            graphs = _device_graphs(model, device)
        elif device.type == "cuda":
            _drop_graph(model, device)

    def emit(fetch, batch):
        with span("predict: wait"):
            tiles_out = _HostSlots.finish_fetch(fetch)
        with span("predict: emit"):
            for tile_out, origin in zip(tiles_out, batch):
                sel = tuple(slice(o, min(o + t, s))
                            for o, t, s in zip(origin, out_tile, spatial))
                data = tile_out[(slice(None),)
                                + tuple(slice(0, sl.stop - sl.start) for sl in sel)]
                if write_fn is not None:
                    write_fn(data, tuple(sl.start for sl in sel))
                else:
                    result[(slice(None),) + sel] = data

    if graphs is not None:
        # what a capture bakes in; parameters moved elsewhere make a new key
        key = (raw.shape, tuple(out_tile), tuple(context), nii, p,
               float(normalization_factor), compute_dtype, transfer_dtype,
               tuple(t.data_ptr() for t in model.parameters()))
        with torch.cuda.device(device), torch.no_grad():
            graph = graphs.get(key, lambda: _SampleGraph(
                model, raw, origins, context, in_tile, out_tile, D + 1,
                normalization_factor, nii, p, compute_dtype, transfer_dtype, device))
            if graph is not None:
                with graphs.lock:
                    emit(graph.run(raw, generator_seed(inference_config.seed, sample_seed)),
                         origins)
                return result

    # eagerly: the sample's generator and pinned slots, then its tile batches
    with span("predict: tiles"):
        gen = seeded_generator(device, inference_config.seed, sample_seed)
        slots = _HostSlots(device, tb, out_tile, D + 1, transfer_dtype)

    def run_batch(host_tiles, slot):
        with span("predict: upload"):
            tiles = slots.upload(host_tiles, slot)
        with span("predict: forward"), torch.no_grad():
            uniform = draw_uniform(gen, tiles.shape, nii, device)
            if len(devices) == 1:
                return tta_embeddings(model, tiles, uniform, p, nii, compute_dtype)
            # one chunk of the batch (and of its draws) a device, in order
            outs = [
                tta_embeddings(replicas[d], t, u, p, nii, compute_dtype)
                for (d, t), (_, u) in zip(shard_batch(tiles, devices),
                                          shard_batch(uniform, devices, dim=1))
            ]
            return torch.cat([o.to(device) for o in outs])

    pending = None
    starts = progress(range(0, len(origins), tb), f"predict tiles (batch of {tb})",
                      total=-(-len(origins) // tb))
    for n, start in enumerate(starts):
        batch = origins[start : start + tb]
        with span("predict: tiles"):
            host_tiles = np.stack([
                np.moveaxis(source(tuple(o - c for o, c in zip(origin, context)), in_tile),
                            0, -1)
                for origin in batch
            ]).astype(np.float32)
        # the upload and the forward; not the copy back
        out = time_device("predict.device", run_batch, host_tiles, n % 2)
        count("predict.eager_batches", 1)
        with span("predict: forward"):
            fetch = slots.start_fetch(out, n % 2)
        if pending is not None:
            emit(*pending)
        pending = (fetch, batch)
    if pending is not None:
        emit(*pending)
    return result


def predict(
    model: UNet,
    inference_config: InferenceConfig,
    normalization_factor,
    device,
    compute_dtype=torch.float32,
    devices: Optional[Sequence] = None,
) -> None:
    """Predict stage: raw zarr -> embeddings zarr ``(s, D + 1, *spatial)``,
    streamed: tiles read on demand, output tiles written as they come. Each
    tile batch is split over ``devices`` (default: every visible GPU of
    ``device``'s type, one CPU), one model copy a device made once. With
    ``spatial_shards >= 2`` each sample is read whole and predicted as one
    sharded forward (``cellulus_tpu/predict.py:375-393``)."""
    dataset_config = inference_config.dataset_config
    meta = DatasetMetaData.from_dataset_config(dataset_config)
    raw_ds = zarr.open(dataset_config.container_path, "r")[dataset_config.dataset_name]
    if normalization_factor is None:
        normalization_factor = normalization_factor_for(raw_ds.dtype)

    out_tile = compute_geometry(
        tuple(inference_config.crop_size), model.downsampling_factors
    ).output_size
    f = zarr.open(inference_config.prediction_dataset_config.container_path, "a")
    ds = f.create_dataset(
        inference_config.prediction_dataset_config.dataset_name,
        shape=(meta.num_samples, meta.num_spatial_dims + 1, *meta.spatial_array),
        dtype=np.float32,
        chunks=(1, meta.num_spatial_dims + 1, *out_tile),
        compressor=None,  # float embeddings do not compress
    )
    nf = float(normalization_factor)
    spatial = tuple(meta.spatial_array)
    shards = inference_config.spatial_shards
    if shards >= 2:
        devices = spatial_devices(shards, device, devices)
        replicas = replicate(model, devices)
        for sample in range(meta.num_samples):
            raw = np.asarray(raw_ds[sample], np.float32)
            if raw.ndim == meta.num_spatial_dims:  # no channel axis stored
                raw = raw[None]
            ds[sample] = predict_sample(model, raw, inference_config, nf, sample, device,
                                        compute_dtype, devices=devices, replicas=replicas)
        ds.attrs.update(spatial_attrs(meta))
        return
    devices = local_devices(device=device) if devices is None else as_devices(devices)
    replicas = replicate(model, devices) if len(devices) > 1 else None
    # one writer thread: overlapping (shingled) tile writes land in origin
    # order, so the last tile wins as in the assembled array
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as writer:
        writes = []
        for sample in range(meta.num_samples):
            def source(origin, size, sample=sample):
                return read_reflect_region(
                    lambda lo, hi: raw_ds[(sample, slice(None))
                                          + tuple(slice(*b) for b in zip(lo, hi))],
                    spatial, origin, size,
                ) * nf

            def write_fn(tile, origin, sample=sample):
                sel = (sample, slice(None)) + tuple(
                    slice(o, o + t) for o, t in zip(origin, tile.shape[1:]))
                writes.append(writer.submit(ds.__setitem__, sel, tile))

            predict_sample(model, None, inference_config, nf, sample, device, compute_dtype,
                           write_fn=write_fn, source=source, spatial=spatial,
                           devices=devices, replicas=replicas)
        for write in writes:
            write.result()
    ds.attrs.update(spatial_attrs(meta))
