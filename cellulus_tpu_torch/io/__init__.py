"""Host-side I/O: zarr container store, chunk codecs, dataset metadata."""

from . import codecs, zarr
from .meta_data import DatasetMetaData

__all__ = ["codecs", "zarr", "DatasetMetaData"]
