"""The port's serving export (``cellulus_tpu_torch/export.py``) on the CPU:
the ``torch.export`` artifact against ``tta_embeddings`` on the same draws
(bit for bit), its graph's conv-pass nodes, the CLI from a TOML naming a
JAX-package ``.ckpt``, loading in a fresh process, and the platforms."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellulus_tpu.models import tta_embeddings as jax_tta
from cellulus_tpu.train import make_optimizer, pack_state
from cellulus_tpu.utils.checkpoint import save_checkpoint
from cellulus_tpu_torch.configs import InferenceConfig
from cellulus_tpu_torch.export import (
    CALLING_CONVENTION,
    META_NAME,
    artifact_name,
    draw_uniform,
    export_predictor,
    load_predictor,
)
from cellulus_tpu_torch.io.regions import read_reflect_region
from cellulus_tpu_torch.models import compute_geometry, tta_embeddings
from cellulus_tpu_torch.predict import predict_sample
from cellulus_tpu_torch.utils.device import seeded_generator
from tests.unet_pairs import unet_pair

REPO = Path(__file__).resolve().parents[1]
# the JAX package's sidecar keys (cellulus_tpu/export.py)
JAX_META_KEYS = {"format", "calling_convention", "tile_batch_size", "in_tile", "out_tile",
                 "context", "in_channels", "out_channels", "num_spatial_dims",
                 "num_infer_iterations", "p_salt_pepper", "platforms", "normalization_factor"}


@pytest.fixture(autouse=True)
def one_thread():
    """The runs here are tiny: one intra-op thread each keeps them from
    oversubscribing the cores when test workers run side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ic(ndim=2, precision="float32", crop_size=None, **kw):
    crop = crop_size or ([52, 52] if ndim == 2 else [20, 36, 36])
    return InferenceConfig(**{"crop_size": crop, "num_infer_iterations": 2,
                              "p_salt_pepper": 0.1, "tile_batch_size": 2, "device": "cpu",
                              "precision": precision, **kw})


def _conv_pass_nodes(program):
    return sum(1 for node in program.graph.nodes if node.op == "call_function"
               and "cellulus_tpu_torch.conv_pass_2d" in str(node.target))


@pytest.mark.parametrize("ndim,factors,precision,passes", [
    (2, ((2, 2),), "float32", 3),
    (2, ((2, 2), (2, 2)), "bfloat16", 5),
    (3, ((1, 2, 2),), "float32", 0),
])
def test_round_trip_equals_tta_embeddings(tmp_path, ndim, factors, precision, passes):
    """The artifact's ``predict(tiles, uniform)`` equals ``tta_embeddings``
    on the same draws, bit for bit; each 2D conv pass is one custom-op
    node (a 3D pass is F.conv3d)."""
    _, _, model = unet_pair(ndim, factors, seed=2)
    ic = _ic(ndim, precision, crop_size=[76, 76] if len(factors) == 2 else None)
    out = export_predictor(model, ic, tmp_path / "artifact", platforms=("cpu",),
                           normalization_factor=0.5)
    meta = json.loads((out / META_NAME).read_text())
    assert JAX_META_KEYS <= set(meta)
    assert meta["format"] == "torch.export/pt2" and meta["calling_convention"] == CALLING_CONVENTION
    assert meta["platforms"] == ["cpu"] and (out / artifact_name("cpu")).exists()
    g = compute_geometry(tuple(ic.crop_size), model.downsampling_factors)
    assert meta["out_tile"] == list(g.output_size) and meta["context"] == list(g.context)
    assert meta["in_channels"] == 1 and meta["out_channels"] == ndim + 1
    assert meta["normalization_factor"] == 0.5 and meta["precision"] == precision
    assert _conv_pass_nodes(torch.export.load(out / artifact_name("cpu"))) == passes

    predict, meta2 = load_predictor(out)
    assert meta2 == meta
    gen = torch.Generator().manual_seed(4)
    tiles = torch.rand((2, *meta["in_tile"], 1), generator=gen)
    uniform = draw_uniform(gen, tiles.shape, ic.num_infer_iterations, "cpu")
    got = predict(tiles, uniform)
    assert got.shape == (2, *meta["out_tile"], ndim + 1) and got.dtype == torch.float32
    with torch.no_grad():
        want = tta_embeddings(model, tiles, uniform, ic.p_salt_pepper, ic.num_infer_iterations,
                              torch.bfloat16 if precision == "bfloat16" else torch.float32)
    assert torch.equal(got, want)


def test_a_server_with_the_same_generator_reproduces_predict(tmp_path):
    """One tile of one sample: the artifact on draws from the generator that
    ``predict_sample`` seeds for that sample gives the live result."""
    _, _, model = unet_pair(2, ((2, 2),), seed=2)
    ic = _ic(tile_batch_size=1)
    predict, meta = load_predictor(export_predictor(model, ic, tmp_path, platforms=["cpu"]))
    raw = np.random.default_rng(0).random((1, *meta["out_tile"])).astype(np.float32)
    live = predict_sample(model, raw, ic, 1.0, 3, "cpu")
    origin = tuple(-c for c in meta["context"])
    tile = read_reflect_region(lambda lo, hi: raw[(slice(None),) + tuple(
        slice(*b) for b in zip(lo, hi))], raw.shape[1:], origin, meta["in_tile"])
    tiles = torch.from_numpy(np.moveaxis(tile, 0, -1)[None].astype(np.float32))
    gen = seeded_generator(torch.device("cpu"), ic.seed, 3)
    served = predict(tiles, draw_uniform(gen, tiles.shape, meta["num_infer_iterations"], "cpu"))
    np.testing.assert_array_equal(np.moveaxis(served[0].numpy(), -1, 0), live)


def _jax_ckpt(path, seed=5):
    """A JAX-package train state at examples-style settings (8 fmaps)."""
    spec, params, _ = unet_pair(2, ((2, 2),), seed=seed)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    save_checkpoint(path, pack_state(0, 1.0, params, make_optimizer(1e-4).init(params), {}))
    return spec, params


def test_cli_exports_a_jax_ckpt_and_a_fresh_process_serves_it(tmp_path, blob_container_2d):
    """``python -m cellulus_tpu_torch export`` on a TOML naming the JAX
    package's ``.ckpt``; a new Python process loads the artifact (the ops
    module before ``torch.export.load``) and its output equals this
    process's ``tta_embeddings`` with the checkpoint's weights, bit for bit,
    and, without noise, the JAX package's ``tta_embeddings`` within the
    U-Net parity tolerance."""
    from cellulus_tpu_torch import cli
    from cellulus_tpu_torch.models import UNet, load_checkpoint

    spec, params = _jax_ckpt(tmp_path / "model.ckpt")
    (tmp_path / "infer.toml").write_text(f"""\
[model_config]
num_fmaps = 8
fmap_inc_factor = 2
features_in_last_layer = 16
checkpoint = "{tmp_path / 'model.ckpt'}"

[inference_config]
crop_size = [52, 52]
num_infer_iterations = 2
p_salt_pepper = 0.0
tile_batch_size = 3
device = "cpu"

[inference_config.dataset_config]
container_path = "{blob_container_2d}"
dataset_name = "train"
""")
    cli.main(["export", str(tmp_path / "infer.toml"), str(tmp_path / "art"), "--tile-batch", "3"])
    meta = json.loads((tmp_path / "art" / META_NAME).read_text())
    assert meta["tile_batch_size"] == 3 and meta["platforms"] == ["cpu"]
    assert meta["normalization_factor"] == pytest.approx(1 / 255)  # the fixture is uint8

    rng = np.random.default_rng(1)
    tiles = rng.random((3, 52, 52, 1)).astype(np.float32)
    uniform = rng.random((4, 3, 52, 52, 1)).astype(np.float32)
    np.save(tmp_path / "tiles.npy", tiles)
    np.save(tmp_path / "uniform.npy", uniform)
    script = (
        "import sys, numpy as np, torch\n"
        "from cellulus_tpu_torch.export import load_predictor\n"
        "predict, meta = load_predictor(sys.argv[1])\n"
        "out = predict(torch.from_numpy(np.load(sys.argv[2])), torch.from_numpy(np.load(sys.argv[3])))\n"
        "np.save(sys.argv[4], out.numpy())\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path / "art"), str(tmp_path / "tiles.npy"),
         str(tmp_path / "uniform.npy"), str(tmp_path / "served.npy")],
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    served = np.load(tmp_path / "served.npy")

    model = UNet(1, 2, 8, 2, 16, [[2, 2]], 2)
    load_checkpoint(tmp_path / "model.ckpt", model)
    with torch.no_grad():
        want = tta_embeddings(model.eval(), torch.from_numpy(tiles), torch.from_numpy(uniform),
                              0.0, 2)
    np.testing.assert_array_equal(served, want.numpy())
    ref = np.stack([np.asarray(jax_tta(spec, params, jnp.asarray(t), jax.random.PRNGKey(0),
                                       0.0, 2)) for t in tiles])
    np.testing.assert_allclose(served, ref, atol=2e-4, rtol=1e-4)


def test_platforms_the_host_cannot_reach_raise(tmp_path, monkeypatch):
    """No CUDA artifact without CUDA (and no CPU artifact in its place), an
    unknown platform refused, a platform the artifact lacks refused."""
    _, _, model = unet_pair(2, ((2, 2),))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_predictor(model, _ic(), tmp_path / "cuda", platforms=("cuda",))
    assert not (tmp_path / "cuda" / artifact_name("cpu")).exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_predictor(model, _ic(device="cuda:0"), tmp_path / "default")
    with pytest.raises(ValueError, match="unknown platform"):
        export_predictor(model, _ic(), tmp_path / "tpu", platforms=("tpu",))
    out = export_predictor(model, _ic(), tmp_path / "cpu", platforms=("cpu",))
    with pytest.raises(ValueError, match="exported for"):
        load_predictor(out, platform="cuda")
    meta = json.loads((out / META_NAME).read_text())
    meta["platforms"] = ["cuda"]
    (out / META_NAME).write_text(json.dumps(meta))
    (out / artifact_name("cpu")).rename(out / artifact_name("cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_predictor(out)
