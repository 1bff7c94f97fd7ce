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
    """The tensor-core kernels include headers of csrc/ (conv_dw.cu and
    conv_pass.cu wgmma.cuh's wgmma, TMA and mbarrier helpers), which is why
    the hash covers the headers."""
    for name, header in (("conv_dw", "wgmma.cuh"), ("conv_pass", "wgmma.cuh")):
        assert f'#include "{header}"' in (kernels.CSRC / f"{name}.cu").read_text()
        assert (kernels.CSRC / header).exists()


def test_first_use_from_two_threads_builds_each_library_once(csrc, tmp_path, monkeypatch):
    """The pipelined path's first K1 launch (calling thread) and first fit
    launch (a worker) may load at once: the build lock compiles every source
    once, and both threads get their library."""
    import sys
    import threading

    log = tmp_path / "nvcc.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "args = sys.argv[1:]\n"
        f"open({str(log)!r}, 'a').write(args[-1] + '\\n')\n"
        "time.sleep(0.2)\n"
        "open(args[args.index('-o') + 1], 'w').write('lib')\n"
    )
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: ("loaded", path))
    got = {}
    start = threading.Barrier(2)

    def first_use(name):
        start.wait()
        got[name] = kernels.load(name, {})

    threads = [threading.Thread(target=first_use, args=(n,)) for n in ("alpha", "beta")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(log.read_text().split()) == sorted(str(csrc / f"{n}.cu") for n in
                                                     ("alpha", "beta"))
    assert got == {n: ("loaded", str(kernels._library_path(n))) for n in ("alpha", "beta")}


def test_launch_counts_are_exact_under_threads():
    import threading

    def wrapper():
        pass

    wrapper.launches = 0

    def count():
        for _ in range(20000):
            kernels.count_launch(wrapper)

    threads = [threading.Thread(target=count) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrapper.launches == 80000
