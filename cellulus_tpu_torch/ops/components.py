"""Connected components, size filter and consecutive relabel, on the host.

Semantics of ``cellulus_tpu/ops/components.py`` (``size_filter`` after
``label``): full connectivity (8 in 2D), components of different input ids
stay separate, components below ``min_size`` pixels are dropped, and the
survivors are numbered from 1 in (input id, raster order of the
component's first pixel) order. Labelling runs per id with
``scipy.ndimage.label`` inside the id's bounding box, as the JAX package's
oracle ``label_host`` does over the whole image.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi


def filter_relabel(values: np.ndarray, min_size: int) -> np.ndarray:
    """Label the components of every non-zero id, drop those smaller than
    ``min_size`` pixels and number the rest consecutively."""
    values = np.ascontiguousarray(values, dtype=np.int64)
    structure = np.ones((3,) * values.ndim, dtype=bool)
    out = np.zeros(values.shape, dtype=np.int32)
    next_label = 0
    for index, bbox in enumerate(ndi.find_objects(values)):
        if bbox is None:
            continue
        comp, n = ndi.label(values[bbox] == index + 1, structure=structure)
        sizes = np.bincount(comp.ravel(), minlength=n + 1)[1:]
        keep = sizes >= min_size
        remap = np.zeros(n + 1, dtype=np.int32)
        remap[1:][keep] = np.arange(next_label + 1, next_label + 1 + keep.sum())
        region = out[bbox]
        hit = comp > 0
        region[hit] = remap[comp[hit]]
        next_label += int(keep.sum())
    return out
