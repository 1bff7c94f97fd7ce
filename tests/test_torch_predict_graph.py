"""The pieces of predict's graph path that the CPU can check: the tile cut
on the device (``predict.tile_index`` + ``predict.cut_tiles``) against the
host path's reflect reads, bit for bit; the rule that sends a sample to one
CUDA graph replay (``predict.one_replay``) on the benchmark's cells and the
paths that stay eager; when a shape is captured and when its graph is
dropped (``predict._DeviceGraphs``); the launch bookkeeping a capture
defers to its replays (``utils.kernels.account``). The capture and the replays themselves
run only on the card (``chip_smoke.py [graph-predict]``)."""

import itertools
import threading

import numpy as np
import pytest
import torch

from cellulus_tpu_torch.configs import InferenceConfig
from cellulus_tpu_torch.io.regions import read_reflect_region
from cellulus_tpu_torch.models import UNet, compute_geometry
from cellulus_tpu_torch.ops import conv_pass
from cellulus_tpu_torch.predict import (
    _DeviceGraphs,
    cut_tiles,
    one_replay,
    predict_sample,
    tile_index,
    tile_origins,
)
from cellulus_tpu_torch.utils import kernels
from cellulus_tpu_torch.utils.profiling import counters, reset_perf

CUT_CASES = {
    # name: (spatial, output tile, context, channels)
    "2d-cell": ((256, 256), (236, 236), (8, 8), 1),
    "smaller-than-a-tile": ((100, 120), (236, 236), (8, 8), 1),
    "extent-1": ((1, 50), (20, 20), (4, 4), 1),
    "not-a-multiple": ((301, 257), (64, 64), (8, 8), 2),
    "3d": ((9, 30, 31), (8, 16, 16), (2, 4, 4), 1),
}


def _origins(spatial, out_tile):
    return list(itertools.product(
        *[tile_origins(max(s, o), o) for s, o in zip(spatial, out_tile)]))


@pytest.mark.parametrize("case", sorted(CUT_CASES))
def test_tile_cut_equals_the_host_reads(case):
    spatial, out_tile, context, channels = CUT_CASES[case]
    rng = np.random.default_rng(len(case))
    raw = rng.integers(0, 65536, (channels, *spatial)).astype(np.float32)
    nf = 1.0 / 65535
    in_tile = tuple(o + 2 * c for o, c in zip(out_tile, context))
    origins = _origins(spatial, out_tile)
    # predict_sample's host path: each tile's reflect read times the factor
    want = np.stack([
        np.moveaxis(read_reflect_region(
            lambda lo, hi: raw[(slice(None),) + tuple(slice(*b) for b in zip(lo, hi))],
            spatial, tuple(o - c for o, c in zip(origin, context)), in_tile) * nf, 0, -1)
        for origin in origins
    ]).astype(np.float32)
    got = cut_tiles(torch.from_numpy(raw), tile_index(origins, context, in_tile, spatial), nf)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.shape == want.shape == (len(origins), *in_tile, channels)
    assert np.array_equal(got.numpy(), want)


def _tiles(spatial, crop, factors):
    g = compute_geometry(tuple(crop), factors)
    return len(_origins(spatial, g.output_size))


CUDA = torch.device("cuda:0")
# name: (tiles, tile batch, devices, spatial_shards, streaming, engages)
RULE_CASES = {
    # infer-2d-f256: a 256^2 image at crop 252, 4 tiles, tile batch 4
    "2d-one-batch": (_tiles((256, 256), (252, 252), [(2, 2)]), 4, [CUDA], 1, False, True),
    "2d-fewer-tiles-than-a-batch": (_tiles((200, 200), (252, 252), [(2, 2)]), 4, [CUDA], 1,
                                    False, True),
    # infer-3d-f24: a 128^3 volume at crop [40, 76, 76], 45 tiles
    "3d-45-tiles": (_tiles((128,) * 3, (40, 76, 76), [(1, 2, 2)]), 4, [CUDA], 1, False, False),
    "two-devices": (4, 4, [CUDA, torch.device("cuda:1")], 1, False, False),
    "spatial-shards-2": (4, 4, [CUDA], 2, False, False),
    "streaming-source": (4, 4, [CUDA], 1, True, False),
    "cpu": (4, 4, [torch.device("cpu")], 1, False, False),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_one_replay_rule(case):
    tiles, batch, devices, shards, streaming, engages = RULE_CASES[case]
    if case.startswith("3d"):
        assert tiles == 45
    elif case == "2d-one-batch":
        assert tiles == 4
    assert one_replay(tiles, batch, devices, shards, streaming) is engages


def test_cpu_predict_counts_eager_batches():
    """On the CPU every sample runs eagerly, each tile batch counted while a
    profiler records; nothing is captured or replayed."""
    model = UNet(1, 2, 2, 2, 2, [(2, 2)]).eval()
    ic = InferenceConfig(crop_size=[36, 36], num_infer_iterations=1, p_salt_pepper=0.1,
                         tile_batch_size=2, device="cpu", seed=3)
    raw = np.random.default_rng(0).random((1, 40, 30), dtype=np.float32)
    reset_perf()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        predict_sample(model, raw, ic, 1.0, 0, "cpu")
    counted = counters()
    reset_perf()
    g = compute_geometry((36, 36), model.downsampling_factors)
    batches = -(-len(_origins((40, 30), g.output_size)) // 2)
    assert counted.get("predict.eager_batches") == batches
    assert "predict.graph_captures" not in counted and "predict.graph_replays" not in counted


def test_a_shape_is_captured_at_its_second_sample_in_a_row():
    """One graph a model and device: a shape's first sample runs eagerly,
    the next of the same shape captures, later ones replay; a sample of
    another shape, or a forward of another kind (``drop``), drops the graph
    and starts the count again."""
    graphs, made = _DeviceGraphs(), []

    def capture():
        made.append(object())
        return made[-1]

    reset_perf()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run = [graphs.get(key, capture) for key in ("a", "a", "a", "b", "a", "a")]
        graphs.drop()
        run += [graphs.get(key, capture) for key in ("a", "a")]
    counted = counters()
    reset_perf()
    assert run == [None, made[0], made[0], None, None, made[1], None, made[2]]
    assert len(made) == 3 and counted.get("predict.graph_captures") == 3
    assert graphs.graph is made[2] and graphs.key == "a"


def test_accounts_deferred_while_capturing():
    """Inside ``deferred_accounts`` a thread's bookkeeping is kept for the
    replays, not made; another thread's is made as usual."""
    made = []

    def note(*args):
        made.append(args)

    kernels.account(note, 1)
    with kernels.deferred_accounts() as log:
        kernels.account(note, 2, "x")
        other = threading.Thread(target=kernels.account, args=(note, 3))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    kernels.account(note, 4)
    assert made == [(1,), (3,), (4,)]
    assert log == [(note, (2, "x"))]
    for fn, args in log:  # a replay
        fn(*args)
    assert made[-1] == (2, "x")


def test_k1_account_counts_a_launch_and_its_work():
    shape, c_out = (16, 252, 252, 1), 256
    before = conv_pass.conv_pass_2d.launches
    reset_perf()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        conv_pass._account_launch(shape, c_out, "staged", torch.bfloat16)
    counted = counters()
    reset_perf()
    assert conv_pass.conv_pass_2d.launches == before + 1
    assert counted == conv_pass.staged_work(shape, c_out)
