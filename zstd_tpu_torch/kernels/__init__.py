"""Device decode kernels of the PyTorch port.

* ``bitbuf.py``    — backward-bitstream reads for the plain forms
* ``entropy2.py``  — plain PyTorch forms of the entropy decode (the
  functions the CUDA kernels compute; the CPU path and the reference
  the kernels are held against)
* ``literals.py``  — Huffman literals kernel (``csrc/literals.cu``)
* ``sequences.py`` — tANS sequences kernel, narrow and wide
  (``csrc/sequences.cu``), and the elementwise word packing
* ``compact.py``   — ragged lane compaction kernel (``csrc/compact.cu``)
* ``lz77_device.py`` — device LZ77 route: copy programs of frames, and
  the pointer-doubling form (source map, ``resolve_and_materialize``)
* ``lz77.py``      — LZ77 copy-program kernel (``csrc/lz77.cu``)
* ``_build.py``    — nvcc build at first use, ctypes binding

Each wrapper counts its kernel launches in a plain integer attribute
(``decode_literals.launches``, ``exec_ops.launches`` and so on).
"""
