"""zstd_tpu_torch — the ZSTD codec's batched decoder on PyTorch and CUDA.

The PyTorch port of ``zstd_tpu``: the host prepass (frame/block parse,
table builds, the batch plan), the entropy decode as hand-written CUDA
kernels for Hopper (``csrc/``), host assembly with the C executor, and
the host encoder (``compress``: numpy and the C match finders).
``zstd_tpu`` stays the reference the port is held against; the port
imports nothing from it.

Layout:

* ``zstd_tpu_torch.utils``    — bit cursors, xxh64, error taxonomy
* ``zstd_tpu_torch.format``   — frame/block/section parsing, batch plan
* ``zstd_tpu_torch.ops``      — FSE/Huffman table builds, code tables, LZ77
* ``zstd_tpu_torch.runtime``  — host oracle decoder, decoding context, engine
* ``zstd_tpu_torch.kernels``  — CUDA kernel wrappers and their plain forms
* ``zstd_tpu_torch.parallel`` — lanes split over a device mesh
  (``ShardedEngine``, ``make_mesh``) and over the processes of a
  ``torch.distributed`` job (``multihost.MultihostEngine``)
* ``zstd_tpu_torch.native``   — ctypes bindings of the host C routines
* ``zstd_tpu_torch.testing``  — libzstd oracle, the bench corpus, the
  LZ77 spike's copy program, lane comparisons, a multi-process job,
  the fuzz harness, the multi-process scaling bench
* ``zstd_tpu_torch.encode``   — the host encoder (``compress``)
* ``zstd_tpu_torch.cli``      — command line (``python -m zstd_tpu_torch.cli``)
* ``zstd_tpu_torch.observability`` — run reports, ``torch.profiler`` hook
  and reads (device time by kernel, idle share)
* ``zstd_tpu_torch.bench``    — the benchmark (``python -m zstd_tpu_torch.bench``)
* ``csrc/``                   — CUDA (``*.cu``) and host C sources
"""

from .format.frame import MAX_WINDOW_SIZE
from .runtime.engine import DeviceEngine
from .runtime.oracle import decode_frame
from .utils import errors

__version__ = "0.1.0"


def decompress(
    data: bytes,
    *,
    device=None,
    max_window_size: int = MAX_WINDOW_SIZE,
    verify_checksum: bool = True,
    include_skippable: bool = False,
) -> bytes:
    """Decode every frame of ``data`` with the batched engine, on the CUDA
    card unless ``device`` names another (``"cpu"`` runs the kernels'
    plain PyTorch forms).  ``zstd_tpu.decompress`` runs the host oracle
    instead; the port's entry point runs the engine on purpose, as its
    CLI does, with the same bytes and typed errors."""
    return DeviceEngine(device=device, max_window_size=max_window_size).decompress(
        data, verify_checksum=verify_checksum, include_skippable=include_skippable
    )


def compress(data: bytes, level: int = 3, **kw) -> bytes:
    """Compress ``data`` into a ZSTD frame (see zstd_tpu_torch.encode)."""
    from . import encode

    return encode.compress(data, level, **kw)


__all__ = [
    "MAX_WINDOW_SIZE",
    "DeviceEngine",
    "compress",
    "decode_frame",
    "decompress",
    "errors",
    "__version__",
]
