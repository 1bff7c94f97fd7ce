"""Host utilities of the example notebooks, a copy of
``cellulus_tpu/utils/misc.py``: fetch and unpack a dataset archive, and a
2x2 figure of an image and three views derived from it."""

from __future__ import annotations

import os
from io import BytesIO
from urllib.request import urlopen
from zipfile import ZipFile


def extract_data(zip_url: str, data_dir: str, project_name: str) -> None:
    """Fetch ``zip_url`` (any ``urllib`` URL, ``file://`` included) and unpack
    it under ``data_dir``.

    Skipped when ``data_dir/project_name`` is already present, so notebook
    cells can re-run safely.
    """
    target = os.path.join(data_dir, project_name)
    if os.path.exists(target):
        print(f"[extract_data] {target} already present - skipping download")
        return
    os.makedirs(data_dir, exist_ok=True)
    print(f"[extract_data] fetching {zip_url} ...")
    with urlopen(zip_url) as response:
        payload = response.read()
    with ZipFile(BytesIO(payload)) as archive:
        archive.extractall(data_dir)
    print(f"[extract_data] unpacked {len(payload)} bytes into {data_dir}")


def visualize_2d(
    image,
    top_right,
    bottom_left,
    bottom_right,
    top_right_label,
    bottom_left_label,
    bottom_right_label,
    image_cmap="magma",
    top_right_cmap=None,
    bottom_left_cmap=None,
    bottom_right_cmap=None,
):
    """A 2x2 matplotlib grid: the raw image (its first channel) and three
    derived views, each titled with its label; shown with ``plt.show()``,
    and the figure returned."""
    import matplotlib.pyplot as plt

    panels = [
        (image if image.ndim == 2 else image[0], "raw", image_cmap),
        (top_right, top_right_label, top_right_cmap),
        (bottom_left, bottom_left_label, bottom_left_cmap),
        (bottom_right, bottom_right_label, bottom_right_cmap),
    ]
    fig, axes = plt.subplots(2, 2, figsize=(10, 10), constrained_layout=True)
    for ax, (panel, title, cmap) in zip(axes.ravel(), panels):
        ax.imshow(panel, interpolation="nearest", cmap=cmap)
        ax.set_title(title, fontsize=11, family="monospace")
        ax.set_axis_off()
    plt.show()
    return fig
