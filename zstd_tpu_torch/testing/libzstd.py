"""ctypes bindings to the system libzstd — the differential-test oracle.

The reference has no automated bit-exactness oracle (its corpus files are
exercised manually via the CLI, see SURVEY.md §4); we close that gap by
binding the system ``libzstd.so`` and checking every decode bit-for-bit
against it, and by using it to *generate* compressed test corpora at
arbitrary levels (the repo may not ship a ``zstd`` CLI).

This module is used only by tests and benchmarks — the codec itself never
calls libzstd.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools


@functools.cache
def _lib() -> ctypes.CDLL:
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    lib = ctypes.CDLL(name)
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_int,
    ]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_void_p,
        ctypes.c_size_t,
    ]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_versionNumber.restype = ctypes.c_uint
    lib.ZSTD_createDCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_decompressDCtx.restype = ctypes.c_size_t
    lib.ZSTD_decompressDCtx.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_void_p,
        ctypes.c_size_t,
    ]
    # Advanced one-shot API for parameter control (block size, checksum, ...).
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_void_p,
        ctypes.c_size_t,
    ]
    return lib


def available() -> bool:
    try:
        _lib()
        return True
    except OSError:
        return False


def _check(lib: ctypes.CDLL, code: int) -> int:
    if lib.ZSTD_isError(ctypes.c_size_t(code)):
        raise RuntimeError(
            f"libzstd error: {lib.ZSTD_getErrorName(ctypes.c_size_t(code)).decode()}"
        )
    return code


# ZSTD_cParameter values (zstd.h, stable API)
_C_COMPRESSION_LEVEL = 100
_C_WINDOW_LOG = 101
_C_CHECKSUM_FLAG = 201
_C_CONTENT_SIZE_FLAG = 200
_C_TARGET_LENGTH = 130


def compress(
    data: bytes,
    level: int = 3,
    *,
    checksum: bool = False,
    window_log: int = 0,
    content_size: bool = True,
) -> bytes:
    """One-shot compress via libzstd's advanced API."""
    lib = _lib()
    bound = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(bound)
    cctx = lib.ZSTD_createCCtx()
    if not cctx:
        raise RuntimeError("ZSTD_createCCtx failed")
    try:
        _check(lib, lib.ZSTD_CCtx_setParameter(cctx, _C_COMPRESSION_LEVEL, level))
        _check(lib, lib.ZSTD_CCtx_setParameter(cctx, _C_CHECKSUM_FLAG, int(checksum)))
        _check(
            lib,
            lib.ZSTD_CCtx_setParameter(cctx, _C_CONTENT_SIZE_FLAG, int(content_size)),
        )
        if window_log:
            _check(lib, lib.ZSTD_CCtx_setParameter(cctx, _C_WINDOW_LOG, window_log))
        n = _check(
            lib,
            lib.ZSTD_compress2(cctx, dst, bound, data, len(data)),
        )
        return dst.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def decompress(data: bytes, max_output: int | None = None) -> bytes:
    """One-shot decompress via libzstd (the bit-exactness oracle)."""
    lib = _lib()
    if max_output is None:
        size = lib.ZSTD_getFrameContentSize(data, len(data))
        # ZSTD_CONTENTSIZE_UNKNOWN = -1, ZSTD_CONTENTSIZE_ERROR = -2 (as u64)
        if size >= 2**64 - 2:
            max_output = max(64 << 20, 100 * len(data))
        else:
            # Single-frame size only; multi-frame inputs need headroom.
            max_output = max(int(size) * 4 + (16 << 20), 64 << 20)
    dst = ctypes.create_string_buffer(max_output)
    n = _check(lib, lib.ZSTD_decompress(dst, max_output, data, len(data)))
    return dst.raw[:n]


class Decoder:
    """libzstd decode into one output buffer and one DCtx, both made once,
    so that a call allocates and copies nothing: the bar of libzstd's own
    speed on one thread, where :func:`decompress` also pays for a fresh
    zero-filled buffer and two copies of it a call."""

    def __init__(self, capacity: int):
        self._lib = _lib()
        self.buffer = ctypes.create_string_buffer(capacity)
        self._dctx = self._lib.ZSTD_createDCtx()
        if not self._dctx:
            raise RuntimeError("ZSTD_createDCtx failed")

    def decode(self, data: bytes) -> int:
        """Decode every frame of ``data`` into :attr:`buffer`; returns the
        bytes written."""
        return _check(self._lib, self._lib.ZSTD_decompressDCtx(
            self._dctx, self.buffer, len(self.buffer), data, len(data)))

    def close(self) -> None:
        if self._dctx:
            self._lib.ZSTD_freeDCtx(self._dctx)
            self._dctx = None


def version() -> int:
    return _lib().ZSTD_versionNumber()
