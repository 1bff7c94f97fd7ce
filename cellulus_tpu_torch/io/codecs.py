"""Chunk compressors for the zarr v2 store, including C-Blosc via ctypes.

zarr-python's DEFAULT compressor is numcodecs ``Blosc(cname="lz4",
clevel=5, shuffle=SHUFFLE)`` — every container the reference's data-prep
scripts write (reference ``docs/examples/2d/01-data.py:47-56`` uses
``zarr.open`` + ``create_dataset`` with default compressors) stores
blosc-framed chunks. This module binds the system ``libblosc.so.1`` (the
canonical C implementation numcodecs itself wraps) through ctypes, so
those containers open here bit-exactly with no third-party Python
dependency, and chunks written here open unchanged in zarr-python.

Supported numcodecs-compatible compressor configs:

- ``{"id": "blosc", "cname": ..., "clevel": ..., "shuffle": ...}`` —
  byte/bit shuffle and every inner codec the system libblosc was built
  with (blosclz, lz4, lz4hc, snappy, zlib, zstd on Debian);
- ``{"id": "lz4", "acceleration": N}`` — numcodecs LZ4 framing
  (little-endian uint32 original size + LZ4 block), via ``liblz4.so.1``;
- ``{"id": "zstd", "level": N}`` — plain zstd frames, via the
  ``zstandard`` package when present, else ``libzstd.so.1``;
- ``{"id": "zlib"|"gzip", "level": N}`` — stdlib.

All bindings are optional: a missing shared library degrades to a clear
``ValueError`` naming the codec, never an import failure.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import gzip as _gzip
import struct
import threading
import zlib as _zlib
from typing import Optional

# numcodecs.blosc shuffle constants
NOSHUFFLE = 0
SHUFFLE = 1
BITSHUFFLE = 2
AUTOSHUFFLE = -1

_BLOSC_MAX_OVERHEAD = 16  # BLOSC_MAX_OVERHEAD in blosc.h (v1.x)

_load_lock = threading.Lock()


def _find_library(*names: str):
    for name in names:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        return lib
    return None


# -- libblosc ---------------------------------------------------------------

_blosc = None
_blosc_tried = False


def _get_blosc():
    """Load and type-annotate libblosc once; None if unavailable."""
    global _blosc, _blosc_tried
    with _load_lock:
        if _blosc_tried:
            return _blosc
        _blosc_tried = True
        lib = _find_library("libblosc.so.1", "libblosc.so", "libblosc.dylib")
        if lib is None:
            found = ctypes.util.find_library("blosc")
            if found:
                lib = _find_library(found)
        if lib is None:
            return None
        try:
            lib.blosc_compress_ctx.restype = ctypes.c_int
            lib.blosc_compress_ctx.argtypes = [
                ctypes.c_int,      # clevel
                ctypes.c_int,      # doshuffle
                ctypes.c_size_t,   # typesize
                ctypes.c_size_t,   # nbytes
                ctypes.c_void_p,   # src
                ctypes.c_void_p,   # dest
                ctypes.c_size_t,   # destsize
                ctypes.c_char_p,   # compressor name
                ctypes.c_size_t,   # blocksize (0 = automatic)
                ctypes.c_int,      # numinternalthreads
            ]
            lib.blosc_decompress_ctx.restype = ctypes.c_int
            lib.blosc_decompress_ctx.argtypes = [
                ctypes.c_void_p,   # src
                ctypes.c_void_p,   # dest
                ctypes.c_size_t,   # destsize
                ctypes.c_int,      # numinternalthreads
            ]
            lib.blosc_cbuffer_sizes.restype = None
            lib.blosc_cbuffer_sizes.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.blosc_list_compressors.restype = ctypes.c_char_p
            lib.blosc_list_compressors.argtypes = []
        except AttributeError:
            return None
        # blosc_cbuffer_validate is 1.16+; optional hardening
        try:
            lib.blosc_cbuffer_validate.restype = ctypes.c_int
            lib.blosc_cbuffer_validate.argtypes = [
                ctypes.c_void_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t),
            ]
        except AttributeError:
            pass
        _blosc = lib
        return _blosc


def blosc_available() -> bool:
    return _get_blosc() is not None


def blosc_list_compressors() -> list:
    lib = _get_blosc()
    if lib is None:
        return []
    return lib.blosc_list_compressors().decode().split(",")


def blosc_compress(
    buf: bytes,
    typesize: int = 1,
    cname: str = "lz4",
    clevel: int = 5,
    shuffle: int = SHUFFLE,
    blocksize: int = 0,
) -> bytes:
    lib = _get_blosc()
    if lib is None:
        raise ValueError(
            "blosc compression requested but libblosc is not available "
            "on this system"
        )
    if shuffle == AUTOSHUFFLE:
        # numcodecs semantics: bit-shuffle single-byte types, else byte
        shuffle = BITSHUFFLE if typesize == 1 else SHUFFLE
    typesize = max(1, int(typesize))
    nbytes = len(buf)
    dest = ctypes.create_string_buffer(nbytes + _BLOSC_MAX_OVERHEAD)
    n = lib.blosc_compress_ctx(
        int(clevel),
        int(shuffle),
        typesize,
        nbytes,
        buf,
        dest,
        len(dest),
        cname.encode(),
        int(blocksize),
        1,
    )
    if n <= 0:
        raise ValueError(
            f"blosc compression failed (cname={cname!r}, rc={n}); "
            f"available codecs: {blosc_list_compressors()}"
        )
    return dest.raw[:n]


def blosc_decompress(buf: bytes, expected_nbytes: Optional[int] = None) -> bytes:
    lib = _get_blosc()
    if lib is None:
        raise ValueError(
            "chunk is blosc-compressed but libblosc is not available "
            "on this system"
        )
    if len(buf) < _BLOSC_MAX_OVERHEAD:
        raise ValueError(f"truncated blosc frame ({len(buf)} bytes)")
    nbytes = ctypes.c_size_t(0)
    if hasattr(lib, "blosc_cbuffer_validate"):
        rc = lib.blosc_cbuffer_validate(buf, len(buf), ctypes.byref(nbytes))
        if rc < 0:
            raise ValueError("invalid blosc frame (validation failed)")
    else:
        cbytes = ctypes.c_size_t(0)
        blocksize = ctypes.c_size_t(0)
        lib.blosc_cbuffer_sizes(
            buf, ctypes.byref(nbytes), ctypes.byref(cbytes), ctypes.byref(blocksize)
        )
        if cbytes.value != len(buf):
            raise ValueError(
                f"invalid blosc frame (header says {cbytes.value} compressed "
                f"bytes, got {len(buf)})"
            )
    if expected_nbytes is not None and nbytes.value != expected_nbytes:
        raise ValueError(
            f"blosc frame decodes to {nbytes.value} bytes, expected "
            f"{expected_nbytes}"
        )
    if nbytes.value == 0:
        return b""
    dest = ctypes.create_string_buffer(nbytes.value)
    n = lib.blosc_decompress_ctx(buf, dest, nbytes.value, 1)
    if n < 0 or n != nbytes.value:
        raise ValueError(f"blosc decompression failed (rc={n})")
    return dest.raw


# -- standalone LZ4 (numcodecs framing) --------------------------------------

_lz4 = None
_lz4_tried = False


def _get_lz4():
    global _lz4, _lz4_tried
    with _load_lock:
        if _lz4_tried:
            return _lz4
        _lz4_tried = True
        lib = _find_library("liblz4.so.1", "liblz4.so", "liblz4.dylib")
        if lib is None:
            return None
        try:
            lib.LZ4_compressBound.restype = ctypes.c_int
            lib.LZ4_compressBound.argtypes = [ctypes.c_int]
            lib.LZ4_compress_fast.restype = ctypes.c_int
            lib.LZ4_compress_fast.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.LZ4_decompress_safe.restype = ctypes.c_int
            lib.LZ4_decompress_safe.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ]
        except AttributeError:
            return None
        _lz4 = lib
        return _lz4


def lz4_compress(buf: bytes, acceleration: int = 1) -> bytes:
    """numcodecs LZ4 format: LE uint32 original size + LZ4 block."""
    lib = _get_lz4()
    if lib is None:
        raise ValueError("lz4 compression requested but liblz4 is unavailable")
    bound = lib.LZ4_compressBound(len(buf))
    dest = ctypes.create_string_buffer(bound)
    n = lib.LZ4_compress_fast(buf, dest, len(buf), bound, int(acceleration))
    if n <= 0:
        raise ValueError(f"lz4 compression failed (rc={n})")
    return struct.pack("<I", len(buf)) + dest.raw[:n]


def lz4_decompress(buf: bytes, expected_nbytes: Optional[int] = None) -> bytes:
    lib = _get_lz4()
    if lib is None:
        raise ValueError("chunk is lz4-compressed but liblz4 is unavailable")
    if len(buf) < 4:
        raise ValueError("truncated lz4 chunk")
    (nbytes,) = struct.unpack("<I", buf[:4])
    # the size header is untrusted file content: validate BEFORE allocating
    # (a corrupt header claiming 4 GiB would otherwise OOM the host)
    if expected_nbytes is not None and nbytes != expected_nbytes:
        raise ValueError(
            f"lz4 chunk header says {nbytes} bytes, expected {expected_nbytes}"
        )
    if nbytes == 0:
        return b""
    dest = ctypes.create_string_buffer(nbytes)
    n = lib.LZ4_decompress_safe(buf[4:], dest, len(buf) - 4, nbytes)
    if n < 0 or n != nbytes:
        raise ValueError(f"lz4 decompression failed (rc={n})")
    return dest.raw


# -- zstd ---------------------------------------------------------------------

_zstd = None
_zstd_tried = False


def _get_zstd():
    """ctypes libzstd fallback for hosts without the zstandard package."""
    global _zstd, _zstd_tried
    with _load_lock:
        if _zstd_tried:
            return _zstd
        _zstd_tried = True
        lib = _find_library("libzstd.so.1", "libzstd.so", "libzstd.dylib")
        if lib is None:
            return None
        try:
            lib.ZSTD_compressBound.restype = ctypes.c_size_t
            lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
            lib.ZSTD_compress.restype = ctypes.c_size_t
            lib.ZSTD_compress.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
            ]
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t,
            ]
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_getFrameContentSize.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
            ]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        except AttributeError:
            return None
        _zstd = lib
        return _zstd


def zstd_compress(buf: bytes, level: int = 1) -> bytes:
    try:
        import zstandard
    except ImportError:
        pass
    else:
        return zstandard.ZstdCompressor(level=int(level)).compress(buf)
    lib = _get_zstd()
    if lib is None:
        raise ValueError(
            "zstd compression requested but neither the zstandard package "
            "nor libzstd is available"
        )
    bound = lib.ZSTD_compressBound(len(buf))
    dest = ctypes.create_string_buffer(bound)
    n = lib.ZSTD_compress(dest, bound, buf, len(buf), int(level))
    if lib.ZSTD_isError(n):
        raise ValueError(f"zstd compression failed (rc={n})")
    return dest.raw[:n]


# ZSTD_getFrameContentSize sentinels (zstd.h)
_ZSTD_CONTENTSIZE_UNKNOWN = 2**64 - 1
_ZSTD_CONTENTSIZE_ERROR = 2**64 - 2


def zstd_decompress(buf: bytes, expected_nbytes: Optional[int] = None) -> bytes:
    try:
        import zstandard
    except ImportError:
        pass
    else:
        return zstandard.ZstdDecompressor().decompress(
            buf, max_output_size=expected_nbytes or 0
        )
    lib = _get_zstd()
    if lib is None:
        raise ValueError(
            "chunk is zstd-compressed but neither the zstandard package "
            "nor libzstd is available"
        )
    size = lib.ZSTD_getFrameContentSize(buf, len(buf))
    if size == _ZSTD_CONTENTSIZE_ERROR:
        raise ValueError("invalid zstd frame")
    if size == _ZSTD_CONTENTSIZE_UNKNOWN:
        if expected_nbytes is None:
            raise ValueError(
                "zstd frame lacks a content-size header and no expected "
                "size is known"
            )
        size = expected_nbytes
    # the frame header is untrusted file content: validate before allocating
    if expected_nbytes is not None and size != expected_nbytes:
        raise ValueError(
            f"zstd frame decodes to {size} bytes, expected {expected_nbytes}"
        )
    if size == 0:
        return b""
    dest = ctypes.create_string_buffer(int(size))
    n = lib.ZSTD_decompress(dest, int(size), buf, len(buf))
    if lib.ZSTD_isError(n) or n != size:
        raise ValueError(f"zstd decompression failed (rc={n})")
    return dest.raw


# -- dispatch -----------------------------------------------------------------


def default_compressor() -> Optional[dict]:
    """zarr-python's own default (Blosc lz4/5/byte-shuffle) when libblosc is
    loadable; zlib-1 (stdlib, always available) otherwise."""
    if blosc_available():
        return {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": SHUFFLE}
    return {"id": "zlib", "level": 1}


def compress(buf: bytes, compressor: Optional[dict], itemsize: int = 1) -> bytes:
    if compressor is None:
        return buf
    cid = compressor.get("id")
    if cid == "zlib":
        return _zlib.compress(buf, int(compressor.get("level", 1)))
    if cid == "gzip":
        return _gzip.compress(buf, compresslevel=int(compressor.get("level", 1)))
    if cid == "blosc":
        return blosc_compress(
            buf,
            typesize=itemsize,
            cname=compressor.get("cname", "lz4"),
            clevel=int(compressor.get("clevel", 5)),
            shuffle=int(compressor.get("shuffle", SHUFFLE)),
            blocksize=int(compressor.get("blocksize", 0)),
        )
    if cid == "lz4":
        return lz4_compress(buf, acceleration=int(compressor.get("acceleration", 1)))
    if cid == "zstd":
        return zstd_compress(buf, level=int(compressor.get("level", 1)))
    raise ValueError(f"unsupported compressor: {cid}")


def decompress(
    buf: bytes, compressor: Optional[dict], expected_nbytes: Optional[int] = None
) -> bytes:
    if compressor is None:
        return buf
    cid = compressor.get("id")
    if cid == "zlib":
        return _zlib.decompress(buf)
    if cid == "gzip":
        return _gzip.decompress(buf)
    if cid == "blosc":
        return blosc_decompress(buf, expected_nbytes=expected_nbytes)
    if cid == "lz4":
        return lz4_decompress(buf, expected_nbytes=expected_nbytes)
    if cid == "zstd":
        return zstd_decompress(buf, expected_nbytes=expected_nbytes)
    raise ValueError(f"unsupported compressor: {cid}")
