"""Scale-out decode: lanes split over the devices of a mesh (``mesh.py``,
``dist.py``) and over the processes of a ``torch.distributed`` job
(``multihost.py``).  The port of ``zstd_tpu/parallel/``."""
