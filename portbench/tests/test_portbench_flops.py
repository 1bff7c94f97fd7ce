"""The yardstick's arithmetic against hand counts and the published totals."""

import json
from pathlib import Path

import pytest

from portbench import flops

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


def test_k1_pass_cost_by_hand():
    # B=1, 6x6 input, 2 -> 3 channels: the 3x3 conv gives 4x4, the 1x1s keep
    # 4x4, the last 3x3 gives 2x2
    f, b = flops.k1_pass_cost(1, 6, 6, 2, 3, 2)
    assert f == 2 * 16 * 9 * 2 * 3 + 2 * 2 * 16 * 3 * 3 + 2 * 4 * 9 * 3 * 3
    assert b == 2 * (36 * 2 + 4 * 3) + 2 * (9 * 2 * 3 + 2 * 9 + 9 * 9) + 4 * 4 * 3
    f, b = flops.k1_pass_cost(2, 10, 8, 1, 4, 4)
    assert f == 2 * 2 * 48 * 9 * 4 + 2 * 2 * 2 * 48 * 16 + 2 * 2 * 24 * 9 * 16
    assert b == 4 * (2 * 80 + 2 * 24 * 4) + 4 * (9 * 4 + 2 * 16 + 9 * 16) + 16 * 4


def test_k2_cost_by_hand():
    f, b = flops.k2_cost((1, 5, 5, 2), (1, 3, 3, 3), 4)
    assert f == 2 * 9 * 9 * 2 * 3
    assert b == 4 * (50 + 27) + 4 * 9 * 2 * 3
    f, b = flops.k2_cost((2, 4, 6, 1), (2, 2, 4, 8), 2)
    assert (f, b) == (2 * 2 * 8 * 9 * 8, 2 * (48 + 128) + 4 * 9 * 8)


def test_model_flops_by_hand():
    # one level, 1x1 factors collapse the U-Net to one pass and the head:
    # a 2D input of 9x9, 1 -> 2 channels, 2 last features, 2 outputs
    m = {"in_channels": 1, "num_fmaps": 2, "fmap_inc_factor": 2,
         "features_in_last_layer": 2, "downsampling_factors": []}
    want = (2 * 49 * 9 * 1 * 2 + 2 * 49 * 2 * 2 * 2 + 2 * 25 * 9 * 2 * 2
            + 2 * 25 * 2 * 2 + 2 * 25 * 2 * 2)
    assert flops.model_flops(m, (9, 9), 2) == want


@pytest.mark.parametrize("name, crop, out_channels, total", [
    ("cellulus-2d-f256", (252, 252), 2, 0.402e12),
    ("cellulus-3d-f24", (40, 76, 76), 3, 83.5e9),
])
def test_model_flops_of_the_configurations(name, crop, out_channels, total):
    got = flops.model_flops(model(name), crop, out_channels)
    assert abs(got - total) / total < 0.002


@pytest.mark.parametrize("name, crop", [("cellulus-2d-f256", (252, 252)),
                                        ("cellulus-3d-f24", (40, 76, 76))])
def test_conv_passes_match_the_port(name, crop):
    from cellulus_tpu_torch.models.geometry import compute_geometry, conv_pass_inputs

    m = model(name)
    assert flops.conv_passes(m, crop) == conv_pass_inputs(
        crop, m["downsampling_factors"], m["in_channels"], m["num_fmaps"],
        m["fmap_inc_factor"], m["features_in_last_layer"])
    g = compute_geometry(crop, m["downsampling_factors"])
    assert flops.output_size(crop, m["downsampling_factors"]) == g.output_size
    assert flops.context(crop, m["downsampling_factors"]) == g.context


def test_k2_shapes_are_six_a_step():
    shapes = flops.k2_shapes(model("cellulus-2d-f256"), 8, (252, 252))
    assert len(shapes) == 6
    assert shapes[0] == ((8, 252, 252, 1), (8, 250, 250, 256))
