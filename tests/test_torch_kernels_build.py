"""The kernel build cache (``cellulus_tpu_torch/utils/kernels.py``): a
library is named by a hash of its source, of every shared header and of
the flags, so an edited header rebuilds every kernel that may include it.
Needs no ``nvcc``: only the names are computed."""

import pytest

from cellulus_tpu_torch.utils import kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "alpha.cu").write_text('#include "shared.cuh"\nint alpha() { return 1; }\n')
    (src / "beta.cu").write_text("int beta() { return 2; }\n")
    (src / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(kernels, "CSRC", src)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    return src


def test_unchanged_sources_keep_their_library(csrc):
    assert kernels._library_path("alpha") == kernels._library_path("alpha")
    assert kernels._library_path("alpha") != kernels._library_path("beta")
    assert kernels._library_path("alpha").parent == kernels.BUILD_DIR


@pytest.mark.parametrize("edit", ["header", "new header", "source", "flags"])
def test_an_edit_names_a_new_library(csrc, monkeypatch, edit):
    before = {name: kernels._library_path(name) for name in ("alpha", "beta")}
    if edit == "header":
        (csrc / "shared.cuh").write_text("#pragma once\n// edited\n")
    elif edit == "new header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    elif edit == "source":
        (csrc / "alpha.cu").write_text("int alpha() { return 3; }\n")
    else:
        monkeypatch.setitem(kernels.EXTRA_FLAGS, "alpha", ("--fmad=false",))
    after = {name: kernels._library_path(name) for name in ("alpha", "beta")}
    assert after["alpha"] != before["alpha"]
    if edit in ("header", "new header"):  # every kernel may include a header
        assert after["beta"] != before["beta"]
    else:
        assert after["beta"] == before["beta"]


def test_the_shipped_kernels_share_the_tensor_core_header():
    """conv_dw.cu and conv_pass.cu both include mma_tile.cuh, which is why
    the hash covers the headers."""
    for name in ("conv_dw", "conv_pass"):
        assert '#include "mma_tile.cuh"' in (kernels.CSRC / f"{name}.cu").read_text()
    assert (kernels.CSRC / "mma_tile.cuh").exists()
