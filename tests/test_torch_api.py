"""The port's package API against ``zstd_tpu``'s: the same names, and
``decompress(max_window_size=...)`` with the same bytes below a frame's
window and the same typed error above it (the port's ``decompress`` runs
the engine, here on the CPU; JAX's runs the host oracle)."""

from __future__ import annotations

import numpy as np
import pytest

import zstd_tpu
import zstd_tpu_torch
from zstd_tpu.format.frame import iter_frames
from zstd_tpu.testing import libzstd


def test_all_is_the_reference_api_plus_the_engine():
    assert set(zstd_tpu_torch.__all__) == set(zstd_tpu.__all__) | {"DeviceEngine"}
    for name in zstd_tpu_torch.__all__:
        assert hasattr(zstd_tpu_torch, name), name
    assert zstd_tpu_torch.MAX_WINDOW_SIZE == zstd_tpu.MAX_WINDOW_SIZE
    def error_names(mod):
        return sorted(k for k, v in vars(mod).items()
                      if isinstance(v, type) and issubclass(v, mod.ZstdError))

    assert error_names(zstd_tpu_torch.errors) == error_names(zstd_tpu.errors)


@pytest.fixture(scope="module")
def frame():
    """Two small level-3 frames of seeded text and their largest window."""
    rng = np.random.default_rng(17)
    raw = (b"record %05d; " * 400) % tuple(int(k) for k in rng.integers(0, 99_999, 400))
    data = libzstd.compress(raw[:3_000], 3, checksum=True) + libzstd.compress(raw[3_000:], 3)
    window = max(f.header.window_size for f in iter_frames(data))
    return data, raw, window


@pytest.mark.parametrize("slack", [0, 1 << 20])
def test_decompress_below_the_window_limit(frame, slack):
    data, raw, window = frame
    want = zstd_tpu.decompress(data, max_window_size=window + slack)
    assert want == raw
    assert zstd_tpu_torch.decompress(data, device="cpu", max_window_size=window + slack) == want


def test_decompress_above_the_window_limit_raises_the_same_error(frame):
    data, _raw, window = frame
    with pytest.raises(zstd_tpu.errors.ZstdError) as want:
        zstd_tpu.decompress(data, max_window_size=window - 1)
    with pytest.raises(zstd_tpu_torch.errors.ZstdError) as got:
        zstd_tpu_torch.decompress(data, device="cpu", max_window_size=window - 1)
    assert type(got.value).__name__ == type(want.value).__name__ == "WindowTooLarge"
    assert str(got.value) == str(want.value)


def test_compress_and_decode_frame_match_the_reference():
    raw = b"the port's package API " * 300
    comp = zstd_tpu_torch.compress(raw, 3, checksum=True)
    assert comp == zstd_tpu.compress(raw, 3, checksum=True)
    from zstd_tpu_torch.format.frame import iter_frames as port_frames

    (fr,) = list(port_frames(comp))
    assert zstd_tpu_torch.decode_frame(fr) == raw
    assert zstd_tpu_torch.decompress(comp, device="cpu") == raw
