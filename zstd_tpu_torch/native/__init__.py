"""Native host-runtime bindings (ctypes over a gcc-built shared object).

Builds ``zstd_tpu_torch/csrc/host.c`` on first use (plain ``gcc -O2
-shared``) into the git-ignored ``build/zstd_tpu_torch/`` directory at
the repository root, and exposes the decode side:

* ``available()``
* ``fse_parse_build(data)`` / ``fse_weights(payload)`` (prepass tables)
* ``xxh64(data, seed)``
* ``execute_sequences(out, out_len, literals, ll, ofv, ml, rep)``
* ``resolve_offsets(ll, ofv, rep)`` (the device LZ77 route's offset scan)

Every caller has a pure-Python/NumPy fallback, and the native results
are covered by the same differential tests.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "host.c"
BUILD_DIR = _PKG.parent / "build" / "zstd_tpu_torch"
_SO = BUILD_DIR / "libzstd_tpu_torch_host.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to a private name, then rename: concurrent test workers may
    # build at once, and a reader must never load a half-written file.
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CC", "gcc"), "-O2", "-fPIC", "-shared", "-o", str(tmp), str(_SRC)]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, _SO)


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                _build()
            lib = ctypes.CDLL(str(_SO))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.zt_xxh64.restype = ctypes.c_uint64
        lib.zt_xxh64.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64]
        lib.zt_execute_sequences.restype = ctypes.c_int
        lib.zt_execute_sequences.argtypes = [
            ctypes.c_void_p,  # out
            ctypes.c_size_t,  # cap
            ctypes.POINTER(ctypes.c_size_t),  # out_len io
            ctypes.c_void_p,  # literals
            ctypes.c_size_t,  # lit_len
            ctypes.c_void_p,  # ll int32*
            ctypes.c_void_p,  # ofv uint32*
            ctypes.c_void_p,  # ml int32*
            ctypes.c_size_t,  # n
            ctypes.c_void_p,  # rep uint64[3]
        ]
        lib.zt_resolve_offsets.restype = ctypes.c_int
        lib.zt_resolve_offsets.argtypes = [
            ctypes.c_void_p,  # ll int32*
            ctypes.c_void_p,  # ofv uint32*
            ctypes.c_size_t,  # n
            ctypes.c_void_p,  # rep uint64[3]
            ctypes.c_void_p,  # off_out int64*
        ]
        lib.zt_fse_parse_build.restype = ctypes.c_int
        lib.zt_fse_parse_build.argtypes = [
            ctypes.c_char_p,  # data
            ctypes.c_size_t,  # len
            ctypes.c_int,  # max accuracy log
            ctypes.c_void_p,  # symbol uint16[512]
            ctypes.c_void_p,  # baseline uint16[512]
            ctypes.c_void_p,  # nbits uint8[512]
            ctypes.POINTER(ctypes.c_size_t),  # bits consumed
        ]
        lib.zt_fse_weights.restype = ctypes.c_int
        lib.zt_fse_weights.argtypes = [
            ctypes.c_char_p,  # payload
            ctypes.c_size_t,  # len
            ctypes.c_void_p,  # out weights uint8[256]
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def fse_parse_build(data) -> tuple | None:
    """Parse + build an FSE decode table from the buffer's bit 0.

    Returns ``(accuracy_log, symbol, baseline, nbits, bits_consumed)``
    with arrays sized to the table, or ``None`` when the native library
    is unavailable or the stream is corrupt — the caller then runs the
    Python path, which raises the precise typed error."""
    lib = _load()
    if lib is None:
        return None
    buf = bytes(data)
    symbol = np.empty(512, dtype=np.uint16)
    baseline = np.empty(512, dtype=np.uint16)
    nbits = np.empty(512, dtype=np.uint8)
    bits = ctypes.c_size_t(0)
    al = lib.zt_fse_parse_build(
        buf,
        len(buf),
        9,
        symbol.ctypes.data,
        baseline.ctypes.data,
        nbits.ctypes.data,
        ctypes.byref(bits),
    )
    if al < 0:
        return None
    size = 1 << al
    return al, symbol[:size], baseline[:size], nbits[:size], int(bits.value)


def fse_weights(payload) -> list[int] | None:
    """Decode FSE-compressed Huffman weights; None → run the Python path."""
    lib = _load()
    if lib is None:
        return None
    buf = bytes(payload)
    out = np.empty(256, dtype=np.uint8)
    n = lib.zt_fse_weights(buf, len(buf), out.ctypes.data)
    if n < 0:
        return None
    return out[:n].tolist()


def xxh64(data, seed: int = 0) -> int:
    lib = _load()
    if lib is None:
        raise NativeUnavailable("native library not built")
    arr = (
        data
        if isinstance(data, np.ndarray)
        else np.frombuffer(data, dtype=np.uint8)
    )
    if arr.size == 0:
        return lib.zt_xxh64(None, 0, seed)
    return lib.zt_xxh64(arr.ctypes.data, arr.size, seed)


_STATUS = {
    1: "null offset",
    2: "literal run exceeds remaining literals",
    3: "offset exceeds decoded length",
    4: "output overflow",
}


def execute_sequences(
    out: np.ndarray,
    out_len: int,
    literals,
    ll: np.ndarray,
    ofv: np.ndarray,
    ml: np.ndarray,
    rep: np.ndarray,
) -> int:
    """Run sequences into preallocated ``out`` (uint8, big enough).

    Returns the new output length; raises ValueError with the status
    message on corruption.  ``rep`` is a uint64[3] array, mutated.
    """
    lib = _load()
    if lib is None:
        raise NativeUnavailable("native library not built")
    lit = np.frombuffer(literals, dtype=np.uint8) if not isinstance(
        literals, np.ndarray
    ) else literals
    ll = np.ascontiguousarray(ll, dtype=np.int32)
    ofv = np.ascontiguousarray(ofv, dtype=np.uint32)
    ml = np.ascontiguousarray(ml, dtype=np.int32)
    n = len(ll)
    out_len_c = ctypes.c_size_t(out_len)
    status = lib.zt_execute_sequences(
        out.ctypes.data,
        out.size,
        ctypes.byref(out_len_c),
        lit.ctypes.data if lit.size else None,
        lit.size,
        ll.ctypes.data,
        ofv.ctypes.data,
        ml.ctypes.data,
        n,
        rep.ctypes.data,
    )
    if status != 0:
        raise ValueError(f"sequence execution failed: {_STATUS.get(status, status)}")
    return out_len_c.value


def resolve_offsets(ll, ofv, rep: np.ndarray) -> np.ndarray:
    """Resolve (ll, offset_value) pairs to actual offsets; mutates the
    uint64[3] ``rep`` history.  Raises ValueError on a null offset."""
    lib = _load()
    if lib is None:
        raise NativeUnavailable("native library not built")
    ll = np.ascontiguousarray(ll, dtype=np.int32)
    ofv = np.ascontiguousarray(ofv, dtype=np.uint32)
    out = np.empty(len(ll), dtype=np.int64)
    status = lib.zt_resolve_offsets(
        ll.ctypes.data, ofv.ctypes.data, len(ll), rep.ctypes.data,
        out.ctypes.data,
    )
    if status != 0:
        raise ValueError("null offset in sequence stream")
    return out
