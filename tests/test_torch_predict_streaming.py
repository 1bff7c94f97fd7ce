"""The port's streaming predict: tiles read from the zarr on demand, output
tiles written through one writer thread, and a one-batch lookahead (batch
n + 1 launched before batch n is fetched). Every result is bit-equal to
the batch-by-batch path it replaces (read, run, fetch and assemble one
batch at a time) on the CPU, in 2D and 3D at odd extents (the JAX
package's 90 x 110 case of tests/test_predict_streaming.py)."""

import itertools

import numpy as np
import pytest
import torch

from cellulus_tpu_torch.configs import DatasetConfig, InferenceConfig
from cellulus_tpu_torch.io import zarr
from cellulus_tpu_torch.io.regions import read_reflect_region
from cellulus_tpu_torch.models import compute_geometry, tta_embeddings
from cellulus_tpu_torch.predict import predict, predict_sample, tile_origins
from cellulus_tpu_torch.utils.device import seeded_generator
from tests.unet_pairs import unet_pair

NF = 1.0 / 255
CASES = {
    # ndim: (factors, crop, spatial, tile batch)
    2: (((2, 2),), [52, 52], (90, 110), 5),
    3: (((1, 2, 2),), [20, 36, 36], (13, 27, 33), 3),
}


@pytest.fixture(autouse=True)
def one_thread():
    """The runs here are tiny: one intra-op thread each keeps them from
    oversubscribing the cores when test workers run side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _setup(ndim, transfer_precision="float32"):
    factors, crop, spatial, tb = CASES[ndim]
    _, _, model = unet_pair(ndim, factors, seed=1)
    ic = InferenceConfig(crop_size=crop, num_infer_iterations=2, p_salt_pepper=0.1,
                         tile_batch_size=tb, device="cpu", seed=5,
                         transfer_precision=transfer_precision)
    raw = np.random.default_rng(ndim).integers(0, 256, (2, 1, *spatial), dtype=np.uint8)
    return model, ic, raw


def _batch_by_batch(model, raw, ic, sample_seed):
    """The path before the lookahead and the streaming: the whole sample
    as float32, each batch read, run, fetched and assembled in turn."""
    raw = np.asarray(raw, np.float32)
    spatial = raw.shape[1:]
    g = compute_geometry(tuple(ic.crop_size), model.downsampling_factors)
    in_tile = tuple(o + 2 * c for o, c in zip(g.output_size, g.context))
    origins = list(itertools.product(
        *[tile_origins(max(s, o), o) for s, o in zip(spatial, g.output_size)]))
    gen = seeded_generator(torch.device("cpu"), ic.seed, sample_seed)
    nii = ic.num_infer_iterations
    dtype = torch.float16 if ic.transfer_precision == "float16" else torch.float32
    result = np.zeros((model.head[2].out_channels + 1, *spatial), np.float32)
    for start in range(0, len(origins), ic.tile_batch_size):
        batch = origins[start : start + ic.tile_batch_size]
        tiles = np.stack([np.moveaxis(read_reflect_region(
            lambda lo, hi: raw[(slice(None),) + tuple(slice(*b) for b in zip(lo, hi))],
            spatial, tuple(o - c for o, c in zip(origin, g.context)), in_tile) * NF, 0, -1)
            for origin in batch]).astype(np.float32)
        tiles = torch.from_numpy(tiles)
        uniform = torch.rand((2 * nii, *tiles.shape), generator=gen, dtype=torch.float32)
        with torch.no_grad():
            out = tta_embeddings(model, tiles, uniform, ic.p_salt_pepper, nii).to(dtype)
        for tile, origin in zip(np.moveaxis(out.numpy(), -1, 1), batch):
            sel = tuple(slice(o, min(o + t, s)) for o, t, s in zip(origin, g.output_size, spatial))
            result[(slice(None),) + sel] = tile[(slice(None),) + tuple(
                slice(0, sl.stop - sl.start) for sl in sel)]
    return result


@pytest.mark.parametrize("ndim,transfer_precision", [(2, "float32"), (2, "float16"),
                                                     (3, "float32")])
def test_lookahead_and_streaming_equal_the_batch_by_batch_path(ndim, transfer_precision,
                                                               tmp_path):
    """In memory (the lookahead), streamed from a zarr through ``source``
    with tiles handed to ``write_fn``, and the batch-by-batch path: one
    result, bit for bit."""
    model, ic, raw = _setup(ndim, transfer_precision)
    want = _batch_by_batch(model, raw[1], ic, 1)
    in_memory = predict_sample(model, raw[1].astype(np.float32), ic, NF, 1, "cpu")
    np.testing.assert_array_equal(in_memory, want)

    f = zarr.open(tmp_path / "c.zarr", "a")
    f["raw"] = raw
    arr = f["raw"]
    spatial = raw.shape[2:]

    def source(origin, size):
        return read_reflect_region(
            lambda lo, hi: arr[(1, slice(None)) + tuple(slice(*b) for b in zip(lo, hi))],
            spatial, origin, size) * NF

    streamed = np.full_like(want, np.nan)
    written = []

    def write_fn(tile, origin):
        written.append((origin, tile.shape[1:]))
        streamed[(slice(None),) + tuple(slice(o, o + t) for o, t in zip(origin, tile.shape[1:]))] = tile

    assert predict_sample(model, None, ic, NF, 1, "cpu", write_fn=write_fn, source=source,
                          spatial=spatial) is None
    np.testing.assert_array_equal(streamed, want)
    # tiles come in origin order, cropped to the sample, and shingled ones overlap
    origins = [o for o, _ in written]
    assert origins == sorted(origins)
    assert all(o + t <= s for origin, shape in written
               for o, t, s in zip(origin, shape, spatial))
    boxes = [set(itertools.product(*[range(o, o + t) for o, t in zip(origin, shape)]))
             for origin, shape in written]
    assert any(a & b for a, b in itertools.combinations(boxes, 2))


def test_overlapping_tiles_land_in_origin_order(tmp_path):
    """Where shingled tiles overlap, the later tile in origin order wins,
    as in the assembled array: a writer that keeps the first tile instead
    gives another result."""
    model, ic, raw = _setup(2)
    want = predict_sample(model, raw[0].astype(np.float32), ic, NF, 0, "cpu")
    first_wins = np.full_like(want, np.nan)

    def write_fn(tile, origin):
        sel = (slice(None),) + tuple(slice(o, o + t) for o, t in zip(origin, tile.shape[1:]))
        first_wins[sel] = np.where(np.isnan(first_wins[sel]), tile, first_wins[sel])

    predict_sample(model, raw[0].astype(np.float32), ic, NF, 0, "cpu", write_fn=write_fn)
    assert not np.isnan(first_wins).any()
    assert not np.array_equal(first_wins, want)


@pytest.mark.parametrize("ndim", [2, 3])
def test_predict_stage_streams_each_sample(ndim, tmp_path):
    """The staged predict: per-tile zarr reads and writes through one
    writer thread equal each sample's in-memory result."""
    model, ic, raw = _setup(ndim)
    f = zarr.open(tmp_path / "c.zarr", "a")
    f["raw"] = raw
    f["raw"].attrs.update({"axis_names": ["s", "c"] + ["z", "y", "x"][-ndim:]})
    ic.dataset_config = DatasetConfig(container_path=str(tmp_path / "c.zarr"),
                                      dataset_name="raw")
    ic.prediction_dataset_config = DatasetConfig(container_path=str(tmp_path / "o.zarr"),
                                                 dataset_name="embeddings")
    predict(model, ic, NF, "cpu")
    got = zarr.open(tmp_path / "o.zarr", "r")["embeddings"]
    assert got.shape == (2, ndim + 1, *raw.shape[2:])
    for s in range(2):
        np.testing.assert_array_equal(
            got[s], predict_sample(model, raw[s].astype(np.float32), ic, NF, s, "cpu"))


@pytest.mark.parametrize("flag", [None, "1"])
def test_progress_lines_go_to_stderr_unless_silenced(flag, monkeypatch, capsys):
    model, ic, raw = _setup(2)
    if flag is None:
        monkeypatch.delenv("CELLULUS_TPU_NO_PROGRESS", raising=False)
    else:
        monkeypatch.setenv("CELLULUS_TPU_NO_PROGRESS", flag)
    predict_sample(model, raw[0].astype(np.float32), ic, NF, 0, "cpu")
    out, err = capsys.readouterr()
    assert out == ""
    if flag is None:
        assert "[predict tiles (batch of 5)] 3/3" in err
    else:
        assert err == ""
