"""zstd_tpu_torch — the ZSTD codec's batched decoder on PyTorch and CUDA.

The PyTorch port of ``zstd_tpu``: the host prepass (frame/block parse,
table builds, the batch plan), the entropy decode as hand-written CUDA
kernels for Hopper (``csrc/``), and host assembly with the C executor.
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
  LZ77 spike's copy program, lane comparisons, a multi-process job
* ``zstd_tpu_torch.cli``      — command line (``python -m zstd_tpu_torch.cli``)
* ``zstd_tpu_torch.observability`` — run reports, ``torch.profiler`` hook
* ``csrc/``                   — CUDA (``*.cu``) and host C sources
"""

from .runtime.engine import DeviceEngine

__version__ = "0.1.0"


def decompress(data: bytes, *, device=None, **kw) -> bytes:
    """Decode every frame of ``data`` with the batched engine, on the CUDA
    card unless ``device`` names another (``"cpu"`` runs the kernels'
    plain PyTorch forms)."""
    return DeviceEngine(device=device).decompress(data, **kw)


__all__ = ["DeviceEngine", "decompress", "__version__"]
