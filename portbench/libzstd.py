"""The benchmark's own ctypes binding of the system libzstd, which makes
its inputs (frames at a stated level, with or without a checksum) and
unpacks its content files.

A frozen copy of what the benchmark needs from the port's
``testing/libzstd.py``, so that a later change of the program cannot
change the inputs.  ctypes releases the interpreter lock around each
foreign call, so frames compress in parallel on a thread pool.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

# ZSTD_cParameter values (zstd.h, stable API).
_C_COMPRESSION_LEVEL = 100
_C_CONTENT_SIZE_FLAG = 200
_C_CHECKSUM_FLAG = 201


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    lib.ZSTD_versionNumber.restype = ctypes.c_uint
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
    return lib


def _check(lib: ctypes.CDLL, code: int) -> int:
    if lib.ZSTD_isError(ctypes.c_size_t(code)):
        raise RuntimeError(f"libzstd: {lib.ZSTD_getErrorName(ctypes.c_size_t(code)).decode()}")
    return code


def compress(data: bytes, level: int, *, checksum: bool) -> bytes:
    """One frame of ``data`` at ``level``, with its content size and, when
    asked, its XXH64 content checksum."""
    lib = _lib()
    bound = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(bound)
    cctx = lib.ZSTD_createCCtx()
    if not cctx:
        raise RuntimeError("ZSTD_createCCtx failed")
    try:
        _check(lib, lib.ZSTD_CCtx_setParameter(cctx, _C_COMPRESSION_LEVEL, level))
        _check(lib, lib.ZSTD_CCtx_setParameter(cctx, _C_CHECKSUM_FLAG, int(checksum)))
        _check(lib, lib.ZSTD_CCtx_setParameter(cctx, _C_CONTENT_SIZE_FLAG, 1))
        n = _check(lib, lib.ZSTD_compress2(cctx, dst, bound, data, len(data)))
        return dst.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def decompress(data: bytes, size: int) -> bytes:
    """Every frame of ``data``, decoded by libzstd into ``size`` bytes at
    most: the content files, and in the tests the frames the benchmark
    makes."""
    lib = _lib()
    dst = ctypes.create_string_buffer(size)
    n = _check(lib, lib.ZSTD_decompress(dst, size, data, len(data)))
    return dst.raw[:n]

