"""``cellulus_tpu_torch/utils/misc.py``, the port's copy of the notebooks'
helpers: ``extract_data`` unpacks a zip built here (a ``file://`` URL, no
network) once, and ``visualize_2d`` draws its four panels."""

import warnings
import zipfile

import numpy as np

from cellulus_tpu_torch.utils.misc import extract_data, visualize_2d


def test_extract_data_unpacks_once(tmp_path, capsys):
    archive = tmp_path / "demo.zip"
    with zipfile.ZipFile(archive, "w") as z:
        z.writestr("demo/train/a.txt", "cells")
        z.writestr("demo/test/b.txt", "more cells")
    data_dir = tmp_path / "data"
    extract_data(archive.as_uri(), str(data_dir), "demo")
    assert (data_dir / "demo" / "train" / "a.txt").read_text() == "cells"
    assert (data_dir / "demo" / "test" / "b.txt").read_text() == "more cells"
    (data_dir / "demo" / "train" / "a.txt").write_text("kept")
    extract_data(archive.as_uri(), str(data_dir), "demo")
    assert "already present - skipping download" in capsys.readouterr().out
    assert (data_dir / "demo" / "train" / "a.txt").read_text() == "kept"


def test_visualize_2d_draws_four_panels():
    import matplotlib

    matplotlib.use("Agg")
    rng = np.random.default_rng(0)
    image = rng.random((1, 16, 16))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # show() on a non-interactive backend
        fig = visualize_2d(image, rng.random((16, 16)), rng.random((16, 16)),
                           rng.integers(0, 3, (16, 16)), "offsets", "std", "labels")
    assert [ax.get_title() for ax in fig.axes] == ["raw", "offsets", "std", "labels"]
