"""Build the CUDA kernels from ``zstd_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, in the git-ignored
``build/zstd_tpu_torch/`` directory at the repository root, and loaded
with ``ctypes``.  A library is rebuilt when its source or the shared
header (``common.cuh``) is newer.  No PyTorch header is compiled, which keeps a build at
seconds rather than the minutes ``torch.utils.cpp_extension.load``
takes.  Each build keeps ``ptxas``'s resource report (``-Xptxas -v``:
registers, shared memory, stack frame and spills of every kernel) in
``<name>.ptxas.txt`` beside the library (:func:`ptxas_report`).

Builds run under a lock within a process; across processes (workers of
a multi-process job building at first use) each ``nvcc`` writes a name of
its own (the process id in it) that ``os.replace`` moves into place, so
a reader finds either no library or a whole one.

Every C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
import time

from ..native import BUILD_DIR

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("literals", "sequences", "compact", "lz77")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A CUDA kernel failed to build or to launch."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise KernelError("no CUDA toolkit found (set CUDA_HOME)")
    return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")


def _lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"libzt_{name}.so"


def _report_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"{name}.ptxas.txt"


def _stale(name: str) -> bool:
    so = _lib_path(name)
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in (CSRC / f"{name}.cu", CSRC / "common.cuh"))
    return so.stat().st_mtime < newest


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _lib_path(name).with_name(f"libzt_{name}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: pathlib.Path) -> None:
    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu:\n{out}")
    report = _report_path(name).with_name(f"{name}.{os.getpid()}.tmp.txt")
    report.write_text(out)
    os.replace(report, _report_path(name))
    os.replace(tmp, _lib_path(name))


def build_all() -> float:
    """Compile every stale kernel source, one ``nvcc`` per source, all
    started together; returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        jobs = [(n, *_start(n)) for n in SOURCES if _stale(n)]
        for n, proc, tmp in jobs:
            _finish(n, proc, tmp)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if _stale(name):
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        lib.zt_error_string.restype = ctypes.c_char_p
        lib.zt_error_string.argtypes = [ctypes.c_int]
        raise KernelError(f"{what}: {lib.zt_error_string(code).decode()} ({code})")


def ptxas_report(name: str) -> list[str]:
    """The resource lines of ``ptxas -v`` from the last build of ``name``:
    each kernel's stack frame, spills, registers and shared memory."""
    keep = ("Compiling entry", "stack frame", "Used")
    lines = _report_path(name).read_text().splitlines()
    return [ln.strip() for ln in lines if any(k in ln for k in keep)]


def launch_info(name: str, n_lanes: int, wide: bool = False, device=None) -> dict:
    """Launch geometry of a lane kernel (``literals``, ``sequences``; the
    narrow or ``wide`` instance) for ``n_lanes`` lanes on ``device`` (the
    current CUDA device by default), with its compiled resources from the
    CUDA runtime.  ``sms`` is the SMs the launch spreads over, min(blocks,
    that card's SM count): a block is one warp with a few KB of shared
    memory, so every block of a launch is resident at once."""
    import torch

    device = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    lib = load(name)
    out = (ctypes.c_int * 6)()
    lib.zt_launch_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(device):
        check(lib, lib.zt_launch_info(n_lanes, int(wide), out), f"{name} launch info")
    keys = ("blocks", "threads", "dynamic_smem_bytes", "static_smem_bytes", "registers", "local_bytes")
    info = dict(zip(keys, out))
    info["sms"] = min(info["blocks"], torch.cuda.get_device_properties(device).multi_processor_count)
    return info


def stream_ptr(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
