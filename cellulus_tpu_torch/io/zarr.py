"""Minimal, dependency-free zarr v2 directory store.

The reference framework leans on the ``zarr`` package for all container I/O
(reference ``cellulus/predict.py:103-112``, ``detect.py:18-80``,
``train.py:205-224``). This module re-implements the subset of the zarr v2
spec that the pipeline needs, with no third-party dependencies:

- directory stores with nested groups (``.zgroup``) and arrays (``.zarray``),
- JSON attributes (``.zattrs``) with write-through persistence,
- C-order chunks stored as ``<i>.<j>.<k>`` files,
- ``null`` (raw), ``zlib``, ``gzip``, ``blosc`` (via the system libblosc —
  zarr-python's default codec), ``lz4`` and ``zstd`` compressors
  (see :mod:`.codecs`),
- basic indexing: integers, slices, ellipsis and full-array read/write.

Arrays written here open unchanged with zarr-python (v2 format), and
containers written by zarr-python — including ones produced with its
default ``Blosc(cname="lz4")`` compressor, as the reference's data-prep
scripts do (reference ``docs/examples/2d/01-data.py:47-56``) — open here.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np

from . import codecs as _codecs


class CorruptChunkError(RuntimeError):
    """A chunk file exists but cannot be decoded (truncated / corrupted).

    Distinct from layout RuntimeErrors so callers that degrade gracefully
    on MISSING data (e.g. train's optional validation set) can still fail
    loudly on data CORRUPTION."""


class _ChunkCache:
    """Process-wide LRU cache of decompressed chunks, keyed by
    (array path, chunk index). Training reads the same chunks thousands of
    times; decompression would otherwise dominate the host data pipeline."""

    def __init__(self, max_bytes: int = 1 << 29):  # 512 MiB
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._data: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._bytes = 0
        # write-generation per key: a reader that loaded file bytes BEFORE a
        # concurrent replace+invalidate must not cache them afterwards (the
        # stale entry would serve every later read). Ints only, bounded by
        # the number of distinct chunks ever written in this process.
        self._gen: dict = {}

    def get(self, key) -> Optional[np.ndarray]:
        with self._lock:
            arr = self._data.get(key)
            if arr is not None:
                self._data.move_to_end(key)
            return arr

    def generation(self, key) -> int:
        with self._lock:
            return self._gen.get(key, 0)

    def put(self, key, arr: np.ndarray, gen: Optional[int] = None) -> None:
        if arr.nbytes > self.max_bytes // 4:
            return
        with self._lock:
            if gen is not None and self._gen.get(key, 0) != gen:
                return  # the chunk was rewritten while we read the old file
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._data[key] = arr
            self._bytes += arr.nbytes
            while self._bytes > self.max_bytes and self._data:
                _, evicted = self._data.popitem(last=False)
                self._bytes -= evicted.nbytes

    def invalidate(self, key) -> None:
        with self._lock:
            self._gen[key] = self._gen.get(key, 0) + 1
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes


_chunk_cache = _ChunkCache()

_ARRAY_META = ".zarray"
_GROUP_META = ".zgroup"
_ATTRS_META = ".zattrs"


def _json_default(o: Any) -> Any:
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def _write_json(path: Path, obj: Any) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(obj, indent=2, default=_json_default))
    os.replace(tmp, path)


class Attributes:
    """Dict-like attribute set persisted to ``.zattrs`` on every write."""

    def __init__(self, path: Path):
        self._path = path / _ATTRS_META

    def _load(self) -> Dict[str, Any]:
        if self._path.exists():
            return json.loads(self._path.read_text())
        return {}

    def __getitem__(self, key: str) -> Any:
        return self._load()[key]

    def __setitem__(self, key: str, value: Any) -> None:
        data = self._load()
        data[key] = value
        _write_json(self._path, data)

    def __contains__(self, key: str) -> bool:
        return key in self._load()

    def get(self, key: str, default: Any = None) -> Any:
        return self._load().get(key, default)

    def update(self, other: Dict[str, Any]) -> None:
        data = self._load()
        data.update(other)
        _write_json(self._path, data)

    def asdict(self) -> Dict[str, Any]:
        return self._load()

    def keys(self):
        return self._load().keys()

    def items(self):
        return self._load().items()


_compress = _codecs.compress
_decompress = _codecs.decompress


def _default_chunks(shape: Tuple[int, ...], dtype: np.dtype) -> Tuple[int, ...]:
    """Pick chunks of roughly <= 16 MiB: leading (sample/channel) axes get
    chunk 1, spatial axes are split only if very large."""
    if len(shape) == 0:
        return ()
    chunks = list(shape)
    # chunk over the leading axes first (samples, channels are read one at
    # a time by the pipeline)
    itemsize = np.dtype(dtype).itemsize
    target = 16 * 1024 * 1024
    # halve the largest axis until under target (a for-loop bounded by ndim
    # left 64+ MiB chunks for large 2D samples — each partial write then
    # pays a full read-modify-write of that chunk)
    while itemsize * int(np.prod(chunks)) > target and max(chunks) > 1:
        j = int(np.argmax(chunks))
        chunks[j] = max(1, (chunks[j] + 1) // 2)
    # always chunk the sample axis at 1 when the array looks like (s, c, ...)
    if len(shape) >= 3:
        chunks[0] = 1
    return tuple(int(c) for c in chunks)


_TMP_COUNTER = __import__("itertools").count()


class Array:
    """A zarr v2 array in a directory store.

    Concurrency: chunk writes are protected by a per-array lock (tile
    writebacks from multiple threads may read-modify-write the same chunk
    when output tiles overlap at the image boundary)."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self._write_lock = threading.Lock()
        meta = json.loads((self.path / _ARRAY_META).read_text())
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{path}: unsupported zarr format {meta.get('zarr_format')}")
        self.shape: Tuple[int, ...] = tuple(meta["shape"])
        self.chunks: Tuple[int, ...] = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        if meta.get("order", "C") != "C":
            raise ValueError("only C-order arrays are supported")
        if meta.get("filters"):
            raise ValueError("filters are not supported")
        self.compressor: Optional[dict] = meta.get("compressor")
        fv = meta.get("fill_value", 0)
        if fv is None:
            fv = 0
        self.fill_value = fv
        self.attrs = Attributes(self.path)
        self._sep = meta.get("dimension_separator", ".")

    # -- creation ---------------------------------------------------------

    @staticmethod
    def create(
        path: Path,
        shape: Sequence[int],
        dtype: Any,
        chunks: Optional[Sequence[int]] = None,
        compressor: Union[str, dict, None] = "default",
        fill_value: Any = 0,
        overwrite: bool = False,
    ) -> "Array":
        path = Path(path)
        if (path / _ARRAY_META).exists() and not overwrite:
            raise FileExistsError(f"array already exists at {path}")
        path.mkdir(parents=True, exist_ok=True)
        dtype = np.dtype(dtype)
        shape = tuple(int(s) for s in shape)
        if chunks is None:
            chunks = _default_chunks(shape, dtype)
        if compressor == "default":
            # zarr-python's own default (blosc lz4) when libblosc is
            # loadable — ~10x faster than zlib on the 1-core host — else
            # stdlib zlib; both open unchanged in zarr-python
            compressor = _codecs.default_compressor()
        meta = {
            "zarr_format": 2,
            "shape": list(shape),
            "chunks": [int(c) for c in chunks],
            "dtype": dtype.str,
            "compressor": compressor,
            "fill_value": fill_value,
            "order": "C",
            "filters": None,
        }
        _write_json(path / _ARRAY_META, meta)
        return Array(path)

    # -- chunk I/O --------------------------------------------------------

    def _chunk_path(self, cidx: Tuple[int, ...]) -> Path:
        if len(cidx) == 0:
            return self.path / "0"
        return self.path / self._sep.join(str(i) for i in cidx)

    def _read_chunk(self, cidx: Tuple[int, ...]) -> np.ndarray:
        key = (str(self.path), cidx)
        cached = _chunk_cache.get(key)
        if cached is not None:
            return cached
        gen = _chunk_cache.generation(key)  # BEFORE touching the file
        p = self._chunk_path(cidx)
        if not p.exists():
            chunk = np.full(self.chunks, self.fill_value, dtype=self.dtype)
        else:
            try:
                raw = _decompress(
                    p.read_bytes(),
                    self.compressor,
                    expected_nbytes=int(np.prod(self.chunks)) * self.dtype.itemsize,
                )
                chunk = np.frombuffer(raw, dtype=self.dtype).reshape(self.chunks)
            except Exception as e:
                raise CorruptChunkError(
                    f"corrupt zarr chunk {p} (expected "
                    f"{int(np.prod(self.chunks))} x {self.dtype} after "
                    f"decompression): {type(e).__name__}: {e}"
                ) from e
        chunk.flags.writeable = False  # cached copies are shared, keep immutable
        _chunk_cache.put(key, chunk, gen=gen)
        return chunk

    def _write_chunk(self, cidx: Tuple[int, ...], data: np.ndarray) -> None:
        buf = _compress(
            np.ascontiguousarray(data, dtype=self.dtype).tobytes(),
            self.compressor,
            itemsize=self.dtype.itemsize,
        )
        p = self._chunk_path(cidx)
        tmp = p.with_name(
            p.name + f".tmp{os.getpid()}.{threading.get_ident()}.{next(_TMP_COUNTER)}"
        )
        tmp.write_bytes(buf)
        os.replace(tmp, p)
        # invalidate AFTER the atomic replace: a reader racing the write may
        # cache the old chunk mid-write, and invalidating first would let
        # that stale entry survive
        _chunk_cache.invalidate((str(self.path), cidx))

    # -- indexing ---------------------------------------------------------

    def _normalize_index(self, key: Any) -> Tuple[Tuple[slice, ...], Tuple[int, ...]]:
        """Return per-axis slices plus the axes to squeeze (integer indices)."""
        if not isinstance(key, tuple):
            key = (key,)
        # expand ellipsis
        if Ellipsis in key:
            i = key.index(Ellipsis)
            n_missing = len(self.shape) - (len(key) - 1)
            key = key[:i] + (slice(None),) * n_missing + key[i + 1 :]
        key = key + (slice(None),) * (len(self.shape) - len(key))
        if len(key) != len(self.shape):
            raise IndexError(f"too many indices for array of shape {self.shape}")
        slices = []
        squeeze = []
        for ax, (k, n) in enumerate(zip(key, self.shape)):
            if isinstance(k, (int, np.integer)):
                k = int(k)
                if k < 0:
                    k += n
                if not 0 <= k < n:
                    raise IndexError(f"index {k} out of bounds for axis {ax} (size {n})")
                slices.append(slice(k, k + 1))
                squeeze.append(ax)
            elif isinstance(k, slice):
                start, stop, step = k.indices(n)
                if step != 1:
                    raise IndexError("step slicing is not supported")
                slices.append(slice(start, stop))
            else:
                raise IndexError(f"unsupported index type: {type(k)}")
        return tuple(slices), tuple(squeeze)

    def _chunk_range(self, slices: Tuple[slice, ...]) -> Iterator[Tuple[int, ...]]:
        ranges = [
            range(s.start // c, max((s.stop - 1) // c + 1, s.start // c))
            if s.stop > s.start
            else range(0)
            for s, c in zip(slices, self.chunks)
        ]
        if any(len(r) == 0 for r in ranges):
            return
        idx = [r.start for r in ranges]
        while True:
            yield tuple(idx)
            for d in reversed(range(len(idx))):
                idx[d] += 1
                if idx[d] < ranges[d].stop:
                    break
                idx[d] = ranges[d].start
            else:
                return

    def __getitem__(self, key: Any) -> np.ndarray:
        slices, squeeze = self._normalize_index(key)
        out_shape = tuple(s.stop - s.start for s in slices)
        out = np.empty(out_shape, dtype=self.dtype)
        if 0 in out_shape:
            return out.squeeze(axis=squeeze) if squeeze else out
        for cidx in self._chunk_range(slices):
            chunk = self._read_chunk(cidx)
            src_sel, dst_sel = [], []
            for d, (ci, s, c, n) in enumerate(
                zip(cidx, slices, self.chunks, self.shape)
            ):
                c0 = ci * c
                lo = max(s.start, c0)
                hi = min(s.stop, c0 + c, n)
                src_sel.append(slice(lo - c0, hi - c0))
                dst_sel.append(slice(lo - s.start, hi - s.start))
            out[tuple(dst_sel)] = chunk[tuple(src_sel)]
        if squeeze:
            out = out.squeeze(axis=squeeze)
        return out

    def __setitem__(self, key: Any, value: Any) -> None:
        with self._write_lock:
            self._setitem_locked(key, value)

    def _setitem_locked(self, key: Any, value: Any) -> None:
        slices, squeeze = self._normalize_index(key)
        sel_shape = tuple(s.stop - s.start for s in slices)
        value = np.asarray(value, dtype=self.dtype)
        # broadcast the value to the selection shape (re-inserting squeezed axes)
        non_squeezed = [ax for ax in range(len(sel_shape)) if ax not in squeeze]
        vshape = [1] * len(sel_shape)
        for ax, s in zip(reversed(non_squeezed), reversed(value.shape)):
            vshape[ax] = s
        value = np.broadcast_to(value.reshape(vshape), sel_shape)
        for cidx in self._chunk_range(slices):
            src_sel, dst_sel = [], []
            full_chunk = True
            for d, (ci, s, c, n) in enumerate(
                zip(cidx, slices, self.chunks, self.shape)
            ):
                c0 = ci * c
                lo = max(s.start, c0)
                hi = min(s.stop, c0 + c, n)
                src_sel.append(slice(lo - s.start, hi - s.start))
                dst_sel.append(slice(lo - c0, hi - c0))
                if lo != c0 or hi != min(c0 + c, n) or (hi - lo) != c:
                    full_chunk = False
            if full_chunk:
                chunk = np.empty(self.chunks, dtype=self.dtype)
            else:
                chunk = self._read_chunk(cidx).copy()  # cached chunks are immutable
            chunk[tuple(dst_sel)] = value[tuple(src_sel)]
            self._write_chunk(cidx, chunk)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __len__(self) -> int:
        return self.shape[0]

    def __array__(self, dtype=None) -> np.ndarray:
        out = self[...]
        return out.astype(dtype) if dtype is not None else out


class Group:
    """A zarr v2 group in a directory store."""

    def __init__(self, path: Path, mode: str = "a"):
        self.path = Path(path)
        self.mode = mode
        if mode in ("a", "w"):
            self.path.mkdir(parents=True, exist_ok=True)
            if not (self.path / _GROUP_META).exists() and not (
                self.path / _ARRAY_META
            ).exists():
                _write_json(self.path / _GROUP_META, {"zarr_format": 2})
        elif not self.path.exists():
            raise FileNotFoundError(f"no zarr container at {path}")
        self.attrs = Attributes(self.path)

    def _child(self, name: str) -> Path:
        p = self.path
        for part in str(name).split("/"):
            p = p / part
        return p

    def __getitem__(self, name: str) -> Union[Array, "Group"]:
        p = self._child(name)
        if (p / _ARRAY_META).exists():
            return Array(p)
        if p.is_dir():
            return Group(p, mode=self.mode)
        raise KeyError(f"{name} not found in {self.path}")

    def __contains__(self, name: str) -> bool:
        p = self._child(name)
        return (p / _ARRAY_META).exists() or p.is_dir()

    def create_dataset(
        self,
        name: str,
        shape: Sequence[int],
        dtype: Any = np.float32,
        chunks: Optional[Sequence[int]] = None,
        compressor: Union[str, dict, None] = "default",
        overwrite: bool = True,
        fill_value: Any = 0,
    ) -> Array:
        if dtype is float:
            dtype = np.float32
        p = self._child(name)
        if overwrite and (p / _ARRAY_META).exists():
            import shutil

            shutil.rmtree(p)
        # make intermediate groups
        parent = p.parent
        rel = parent.relative_to(self.path)
        q = self.path
        for part in rel.parts:
            q = q / part
            q.mkdir(exist_ok=True)
            if not (q / _GROUP_META).exists():
                _write_json(q / _GROUP_META, {"zarr_format": 2})
        return Array.create(
            p, shape=shape, dtype=dtype, chunks=chunks, compressor=compressor,
            fill_value=fill_value,
        )

    def __setitem__(self, name: str, value: Any) -> None:
        value = np.asarray(value)
        arr = self.create_dataset(
            name, shape=value.shape, dtype=value.dtype, overwrite=True
        )
        arr[...] = value

    def keys(self):
        for p in sorted(self.path.iterdir()):
            if p.is_dir():
                yield p.name


def open(path: Union[str, Path], mode: str = "a") -> Union[Group, Array]:  # noqa: A001
    """Open a zarr container (group or array) at ``path``.

    Mirrors ``zarr.open``: returns an :class:`Array` if ``path`` holds array
    metadata, else a :class:`Group` (created on demand in "a"/"w" modes).
    """
    path = Path(path)
    if (path / _ARRAY_META).exists():
        return Array(path)
    return Group(path, mode=mode)
