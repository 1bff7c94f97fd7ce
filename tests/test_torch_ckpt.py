"""The JAX package's ``.ckpt`` checkpoints read by the port: its msgpack
reader against flax's writer, the weights of a JAX-written checkpoint
against the JAX forward, the rule for a configured ``.ckpt`` that exists
only as ``.pth``, the sweep over ``.ckpt`` files, and train resume from a
``.ckpt`` refused."""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from cellulus_tpu.models import forward
from cellulus_tpu.train import make_optimizer, pack_state
from cellulus_tpu.utils.checkpoint import save_checkpoint
from cellulus_tpu_torch.models import UNet, load_checkpoint
from cellulus_tpu_torch.utils import msgpack as port_msgpack
from cellulus_tpu_torch.utils.checkpoint import (
    JAX_RESUME_ITEM,
    checkpoint_format,
    load_train_state,
    resolve_checkpoint,
)
from tests.unet_pairs import unet_pair


def _assert_same_tree(mine, ref, where="root"):
    """``mine`` (the port's reader) equals ``ref`` (flax's), leaf by leaf,
    dtypes included; bfloat16 leaves compare by their bits."""
    if isinstance(ref, dict):
        assert isinstance(mine, dict) and list(mine) == list(ref), where
        for k in ref:
            _assert_same_tree(mine[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, list):
        assert isinstance(mine, list) and len(mine) == len(ref), where
        for i, (a, b) in enumerate(zip(mine, ref)):
            _assert_same_tree(a, b, f"{where}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)) and ref.dtype == jnp.bfloat16:
        assert isinstance(mine, torch.Tensor) and mine.dtype == torch.bfloat16, where
        assert tuple(mine.shape) == np.shape(ref), where
        np.testing.assert_array_equal(mine.view(torch.int16).numpy(),
                                      np.asarray(ref).view(np.int16), err_msg=where)
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(mine) is type(ref) and mine.dtype == ref.dtype, where
        np.testing.assert_array_equal(mine, ref, err_msg=where)
    else:
        assert type(mine) is type(ref) and mine == ref, where


def _real_state():
    """A JAX train state as the JAX package's train() checkpoints it: params,
    optax's Adam leaves, the logger's history."""
    spec, params, _ = unet_pair(2, ((2, 2),))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = make_optimizer(1e-4, 0.01).init(params)
    return pack_state(7, 0.25, params, opt_state,
                      {"loss": [1.5, 1.25, 0.75], "oce_loss": [1.0, 0.5, 0.25]})


def test_reader_matches_flax_on_a_training_state():
    data = serialization.msgpack_serialize(_real_state())
    ref = serialization.msgpack_restore(data)
    mine = port_msgpack.unpackb(data)
    _assert_same_tree(mine, ref)
    assert mine["iteration"] == 7 and mine["params"]["down"]["level0"]["conv0"]["w"].shape == (
        3, 3, 1, 8)


def test_reader_matches_flax_on_every_type():
    """Each msgpack width and every leaf type flax writes."""
    rng = np.random.default_rng(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, 2**64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    tree = {
        "nil": None, "true": True, "false": False, "ints": ints,
        "floats": [0.5, -1e300, float("inf")],
        "str": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "ü-µ"],
        "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
        "array16": list(range(16)), "array32": [3] * 70000,
        "map16": {f"k{i}": i for i in range(16)},
        "map32": {f"k{i}": i for i in range(70000)},
        "nested": {"a": [{"b": [[], {}]}]},
        "arrays": [rng.random((2, 3)).astype(np.float32), rng.random(4), np.arange(-3, 3, dtype=np.int8),
                   np.arange(5, dtype=np.uint16), np.arange(6, dtype=np.int64).reshape(2, 3, 1),
                   np.array([True, False]), np.zeros((0, 4), np.float32), np.array(2.5, np.float32),
                   np.asarray(rng.random((3, 5)), dtype=jnp.bfloat16)],
        "scalars": [np.float32(1.5), np.int32(-7), np.uint8(200), np.float64(0.1),
                    np.bool_(True), jnp.bfloat16(1.25)],
    }
    data = serialization.msgpack_serialize(tree)
    ref = serialization.msgpack_restore(data)
    mine = port_msgpack.unpackb(data)
    _assert_same_tree(mine, ref)
    assert mine["arrays"][-1].dtype == torch.bfloat16
    assert mine["scalars"][-1].dtype == torch.bfloat16 and mine["scalars"][-1].dim() == 0


@pytest.mark.parametrize("case", ["complex", "chunked", "bad marker", "left over", "truncated"])
def test_reader_refuses_what_it_does_not_read(case):
    if case == "complex":
        data = serialization.msgpack_serialize({"z": complex(1, 2)})
    elif case == "chunked":
        data = msgpack.packb({"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2}}})
    elif case == "bad marker":
        data = b"\x81\xa1a\xc1"
    elif case == "left over":
        data = msgpack.packb({"a": 1}) + b"\x00"
    else:
        data = serialization.msgpack_serialize(_real_state())
        # every cut of the state's first and last 300 bytes, and a few between
        for cut in [*range(300), *range(len(data) - 300, len(data)), *range(300, len(data), 997)]:
            with pytest.raises(ValueError):
                port_msgpack.unpackb(data[:cut])
        return
    with pytest.raises(ValueError):
        port_msgpack.unpackb(data)


@pytest.mark.parametrize("ndim,factors,constant_upsample", [
    (2, ((2, 2),), True), (2, ((2, 2),), False), (3, ((1, 2, 2),), True)])
def test_forward_from_a_jax_ckpt_matches_jax(tmp_path, ndim, factors, constant_upsample):
    """The JAX package writes its train state (.ckpt); the port loads it by
    content and its forward equals the JAX forward (the U-Net parity
    tolerance of tests/test_torch_unet.py)."""
    spec, params, _ = unet_pair(ndim, factors, constant_upsample=constant_upsample, seed=3)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    path = tmp_path / "best_loss.ckpt"
    save_checkpoint(path, pack_state(4, 0.5, params, make_optimizer(1e-4).init(params),
                                     {"loss": [2.0], "oce_loss": [1.5]}))
    assert checkpoint_format(path) == "jax"
    model = UNet(1, ndim, 8, 2, 16, [list(f) for f in factors], ndim,
                 constant_upsample=constant_upsample)
    state = load_checkpoint(path, model)
    assert state["iteration"] == 4 and state["lowest_loss"] == 0.5
    assert state["logger_data"] == {"loss": [2.0], "oce_loss": [1.5]}
    size = (60,) * 2 if ndim == 2 else (20, 44, 44)
    x = np.random.default_rng(1).normal(size=(2, *size, 1)).astype(np.float32)
    with torch.no_grad():
        mine = model.eval()(torch.from_numpy(x)).numpy()
    ref = np.asarray(forward(spec, params, jnp.asarray(x)))
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, atol=2e-4, rtol=1e-4)


def test_rule_reads_the_pth_beside_a_missing_ckpt(tmp_path, capsys):
    ckpt, pth = tmp_path / "best_loss.ckpt", tmp_path / "best_loss.pth"
    assert resolve_checkpoint(ckpt) == ckpt  # neither exists: the path as given
    assert resolve_checkpoint(None) is None
    pth.write_bytes(b"x")
    assert resolve_checkpoint(ckpt) == pth
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and str(ckpt) in out[0] and str(pth) in out[0]
    assert resolve_checkpoint(ckpt, announce=False) == pth
    assert capsys.readouterr().out == ""
    ckpt.write_bytes(b"y")
    assert resolve_checkpoint(ckpt) == ckpt  # the configured file exists: it is read
    assert resolve_checkpoint(pth) == pth
    assert capsys.readouterr().out == ""


def test_sweep_takes_either_suffix_once(tmp_path, monkeypatch):
    """Numbered and best_loss checkpoints of either suffix; a name with
    both is swept once, as its .ckpt (the rule's choice)."""
    import cellulus_tpu_torch.infer as infer_module
    from cellulus_tpu_torch.configs import ExperimentConfig
    from cellulus_tpu_torch.io import zarr

    models = tmp_path / "models"
    models.mkdir()
    for name in ("000000.ckpt", "000000.pth", "000002.pth", "000010.ckpt", "best_loss.ckpt",
                 "best_loss.pth", "notes.txt"):
        (models / name).write_bytes(b"")
    swept = []

    def scored(cfg, *args, **kwargs):
        swept.append(cfg.model_config.checkpoint)
        return {0: {"F1": 0.5, "SEG": 0.5}}

    monkeypatch.setattr(infer_module, "infer", scored)
    gt = {"container_path": str(tmp_path / "gt.zarr"), "dataset_name": "gt"}
    zarr.open(tmp_path / "gt.zarr", "a")["gt"] = np.zeros((1, 1, 4, 4), np.uint16)
    config = ExperimentConfig(**{
        "object_size": 10, "model_config": {"num_fmaps": 8, "fmap_inc_factor": 2},
        "inference_config": {
            "dataset_config": gt, "evaluation_dataset_config": gt,
            "prediction_dataset_config": {"container_path": str(tmp_path / "out.zarr"),
                                          "dataset_name": "embeddings"}}})
    rows = infer_module.checkpoint_sweep(config, checkpoint_dir=models)
    assert list(rows) == ["000000.ckpt", "000002.pth", "000010.ckpt", "best_loss.ckpt"]
    assert swept == [str(models / n) for n in rows]


def test_train_resume_from_a_jax_ckpt_is_refused(tmp_path):
    path = tmp_path / "best_loss.ckpt"
    save_checkpoint(path, _real_state())
    with pytest.raises(ValueError, match="train resume from a JAX .ckpt") as info:
        load_train_state(path)
    assert JAX_RESUME_ITEM in str(info.value)


@pytest.mark.parametrize("constant_upsample", [True, False])
def test_chip_smoke_writes_what_flax_reads(constant_upsample):
    """``chip_smoke.py``'s [ckpt] writes a train state in flax's layout on
    the card (``flax_msgpack`` of ``jax_params``): flax reads it back as the
    JAX package's params, and the port's reader as the same tree."""
    import chip_smoke

    spec, params, model = unet_pair(2, ((2, 2),), constant_upsample=constant_upsample)
    state = {"iteration": 3, "lowest_loss": 0.5, "opt_leaves": [],
             "params": chip_smoke.jax_params(model.state_dict()),
             "logger_data": {"loss": [1.0, 0.5]}}
    data = chip_smoke.flax_msgpack(state)
    ref = serialization.msgpack_restore(data)
    _assert_same_tree(port_msgpack.unpackb(data), ref)
    flat = jax.tree_util.tree_leaves_with_path(ref["params"])
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat) == len(want)
    for path, leaf in flat:
        np.testing.assert_array_equal(leaf, np.asarray(want[path]))
    assert ref["iteration"] == 3 and ref["logger_data"] == {"loss": [1.0, 0.5]}
