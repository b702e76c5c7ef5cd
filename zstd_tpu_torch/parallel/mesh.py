"""The lane mesh of sharded decode.

The codec's parallel axis is *lanes*: independent entropy streams (4
literal streams x N blocks x M frames).  A 1-D mesh of devices
data-parallelizes them; the engine (``runtime/engine.py``) splits each
launch's lanes into one contiguous block per mesh device and replicates
the words buffer and the small entropy table banks on every distinct
device.  ``LaneMesh`` stands where JAX's ``jax.sharding.Mesh`` stands in
``zstd_tpu/parallel/mesh.py``; a mesh may name one device more than once
(the counterpart of JAX's virtual host-platform devices), so a mesh
larger than the machine's card count runs on the CPU or on one card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

@dataclass(frozen=True)
class LaneMesh:
    """A 1-D mesh over ``devices`` (repeats allowed), along the lane axis."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, *, device=None) -> LaneMesh:
    """A mesh over the first ``n_devices`` CUDA cards (all of them by
    default); raises without CUDA or when fewer cards are present.  With
    ``device`` ("cpu", "cuda:0", ...): ``n_devices`` (default 1) copies of
    that one device."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {dev} requested but CUDA is not available")
            dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
        elif dev.type != "cpu":
            raise ValueError(f"a lane mesh runs on cuda or cpu, not {dev}")
        return LaneMesh((dev,) * (1 if n_devices is None else n_devices))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh spans CUDA devices and none is available; pass device='cpu' "
            "for a mesh of CPU copies"
        )
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh({n_devices}) on a machine with {count} CUDA devices")
    return LaneMesh(tuple(torch.device("cuda", i) for i in range(n)))

