"""The PyTorch port's engine (``device="cpu"``) against the JAX package.

Equal final bytes alone prove little — the oracle fallback turns a wrong
kernel into right bytes — so the port's engine is first held to the JAX
engine's lax.scan path lane by lane (per-lane outputs and ok flags
before and after the wide retry) and its device LZ77 route to the JAX
engine's ``_assemble_frame_device`` frame by frame; those tests share one
run of the JAX engine and live in ``test_torch_entropy.py``.  Here: the
final bytes with ``fallback_frames == 0``, the multi-group pipeline with
skippable frames at group boundaries, corrupt input, and a kernel-wrapper
failure, which must propagate rather than fall back.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import zstd_tpu_torch
from torch_inputs import CORPORA, combined, skippable_groups
from zstd_tpu.runtime.oracle import decompress as jax_oracle_decompress
from zstd_tpu.testing import libzstd
from zstd_tpu.utils.errors import ZstdError as JaxZstdError
from zstd_tpu_torch.kernels import compact, literals, lz77, sequences
from zstd_tpu_torch.runtime import engine as t_engine
from zstd_tpu_torch.runtime.engine import DeviceEngine
from zstd_tpu_torch.utils.errors import ZstdError


@pytest.mark.parametrize("name", [*CORPORA, "combined"])
def test_final_bytes_exact_without_fallback(name):
    data, payload = combined() if name == "combined" else CORPORA[name]()
    eng = DeviceEngine(device="cpu")
    assert eng.decompress(data) == payload
    assert eng.stats.fallback_frames == 0, eng.stats.fallback_reasons
    assert eng.stats.seq_lanes > 0
    if name == "overflow_lane":
        assert eng.stats.retry_lanes == 1
    assert zstd_tpu_torch.decompress(data, device="cpu") == payload


def test_multi_group_with_skippables_at_boundaries(monkeypatch):
    data, plain, with_skip = skippable_groups()
    groups = []
    orig = DeviceEngine._iter_pipelined

    def spy(self, d, w):
        n = 0
        for g in orig(self, d, w):
            n += 1
            groups.append(g[0])
            yield g
        assert n == 9  # 6 frames + 3 skippables

    # One frame per group: every skippable frame sits on a group boundary.
    monkeypatch.setattr(t_engine, "GROUP_BYTES", 1)
    monkeypatch.setattr(DeviceEngine, "_iter_pipelined", spy)
    eng = DeviceEngine(device="cpu")
    assert eng.decompress(data) == plain == jax_oracle_decompress(data)
    assert eng.stats.fallback_frames == 0
    assert any(isinstance(g.frames[0].frame, t_engine.SkippableFrame) for g in groups)
    out = eng.decompress(data, include_skippable=True)
    assert out == with_skip == jax_oracle_decompress(data, include_skippable=True)


def _outcome(fn, data, err_base):
    try:
        return fn(data)
    except err_base as e:
        return type(e).__name__


def test_corrupt_input_raises_like_jax_oracle():
    payload = b"corrupt me " * 2000
    base = libzstd.compress(payload, 6, checksum=True)
    eng = DeviceEngine(device="cpu")
    errors = 0
    for pos in range(20, len(base), max(1, len(base) // 12)):
        comp = bytearray(base)
        comp[pos] ^= 0x55
        comp = bytes(comp)
        want = _outcome(jax_oracle_decompress, comp, JaxZstdError)
        got = _outcome(eng.decompress, comp, ZstdError)
        assert got == want, pos
        errors += isinstance(want, str)
    assert errors > 0


@pytest.mark.parametrize(
    "target",
    ["literals.decode_literals", "sequences.decode_sequences", "sequences.compact_lanes",
     "lz77.exec_ops"],
)
def test_kernel_failure_propagates(monkeypatch, target):
    module, name = target.split(".")
    mod = {"literals": literals, "sequences": sequences, "lz77": lz77}[module]

    def boom(*a, **kw):
        raise RuntimeError(f"injected {name} failure")

    monkeypatch.setattr(mod, name, boom)
    data, _payload = CORPORA["level3_text"]()
    with pytest.raises(RuntimeError, match="injected"):
        DeviceEngine(device="cpu", device_execute=module == "lz77").decompress(data)


@pytest.mark.parametrize("how", ["require_raises", "compiler_fails"])
def test_engine_refuses_to_start_without_the_host_library(monkeypatch, tmp_path, how):
    # The host steps have no form without csrc/host.c: like a failed CUDA
    # build, a failed host build stops the engine at construction, with
    # the compiler's message.
    from zstd_tpu_torch import native

    if how == "require_raises":
        message = "host.c:1: error: stand-in"

        def refuse():
            raise native.NativeUnavailable(message)

        monkeypatch.setattr(native, "require", refuse)
    else:
        # A fresh build (no library loaded yet) by a compiler that fails.
        message = "cc: stand-in compiler refuses host.c"
        cc = tmp_path / "cc"
        cc.write_text(f"#!/bin/sh\necho '{message}' >&2\nexit 1\n")
        cc.chmod(0o755)
        monkeypatch.setenv("CC", str(cc))
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(native, "_SO", tmp_path / "libhost.so")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        monkeypatch.setattr(native, "_error", "")
    with pytest.raises(native.NativeUnavailable, match=message):
        DeviceEngine(device="cpu")


def test_cpu_runs_plain_forms_and_counts_no_launch():
    before = (
        literals.decode_literals.launches,
        sequences.decode_sequences.launches,
        compact.compact_lanes.launches,
    )
    data, payload = CORPORA["level3_text"]()
    assert DeviceEngine(device="cpu").decompress(data) == payload
    after = (
        literals.decode_literals.launches,
        sequences.decode_sequences.launches,
        compact.compact_lanes.launches,
    )
    assert after == before


def test_wrappers_reject_other_devices():
    t = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        compact.compact_lanes(t.reshape(2, 2), t[:3], n_dense=0)
    with pytest.raises(ValueError):
        DeviceEngine(device="meta")
