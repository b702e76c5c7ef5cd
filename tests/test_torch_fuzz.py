"""The port's fuzz harness (``zstd_tpu_torch.testing.fuzz``) on the CPU:
its loop, with the engine on the CPU (the kernels' plain forms) and
small payloads, finds no failure in any mode — libzstd and port-made
round trips, bit flips and truncations — with the engine held to the
JAX package's host oracle (and the port's oracle to it, input by input),
and it does catch an engine that returns other bytes or raises an
untyped error."""

from __future__ import annotations

import pytest

from zstd_tpu.runtime.oracle import decompress as jax_oracle_decompress
from zstd_tpu.utils.errors import ZstdError as JaxZstdError
from zstd_tpu_torch.runtime.engine import DeviceEngine
from zstd_tpu_torch.testing import fuzz

SMALL = (0, 1, 7, 100, 1000)


def _jax_oracle(port_oracle):
    """``fuzz.oracle`` backed by the JAX package's host oracle: (bytes,
    None) or (None, its ZstdError).  The port's oracle must give the same
    outcome on every input: the same bytes, or an error of the same class."""

    def held(data):
        try:
            want = jax_oracle_decompress(data), None
        except JaxZstdError as e:
            want = None, e
        got = port_oracle(data)
        assert got[0] == want[0] and type(got[1]).__name__ == type(want[1]).__name__, (
            f"port oracle {got[1]!r} / {None if got[0] is None else len(got[0])} bytes, "
            f"JAX oracle {want[1]!r} / {None if want[0] is None else len(want[0])} bytes")
        return want

    return held


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_agrees_with_the_oracle_in_every_mode(monkeypatch, seed):
    monkeypatch.setattr(fuzz, "oracle", _jax_oracle(fuzz.oracle))
    logged = []
    counts = fuzz.run(40, seed, engine=DeviceEngine(device="cpu"), sizes=SMALL, log=logged.append)
    assert counts.failures == 0, logged
    assert all(counts.modes.values()), counts.modes  # round trips, the encoder, flips, truncations
    assert counts.engine_equal + counts.engine_typed_errors == counts.iterations
    assert counts.engine_equal and counts.engine_typed_errors


class _Wrong:
    """An engine that breaks the contract in one of two ways."""

    device = DeviceEngine(device="cpu").device

    def __init__(self, how: str):
        self.how = how

    def decompress(self, data):
        if self.how == "bytes":
            return b"\x00wrong"
        raise IndexError("an untyped error")


@pytest.mark.parametrize("how", ["bytes", "untyped"])
def test_a_broken_engine_is_reported(how):
    logged = []
    counts = fuzz.run(8, 0, engine=_Wrong(how), sizes=SMALL, log=logged.append)
    assert counts.failures == 8 and len(logged) == 8
    kind = "AssertionError" if how == "bytes" else "IndexError"
    assert all(kind in line for line in logged), logged
