"""The PyTorch port's engine (``device="cpu"``) against the JAX engine.

Equal final bytes alone prove little — the oracle fallback turns a wrong
kernel into right bytes — so the port is held to the JAX engine's
lax.scan path lane by lane first: per-lane outputs and ok flags before
and after the wide retry, on one plan of the ``tests/test_pallas.py``
corpora (``torch_inputs``).  Then the final bytes with
``fallback_frames == 0``, the multi-group pipeline with skippable frames
at group boundaries, corrupt input, and a kernel-wrapper failure, which
must propagate rather than fall back.  The device LZ77 route's assembly
is held to the JAX engine's ``_assemble_frame_device`` frame by frame on
the same plan and lane outputs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import zstd_tpu_torch
from torch_inputs import CORPORA, combined, jax_reference, skippable_groups
from zstd_tpu.runtime.oracle import decompress as jax_oracle_decompress
from zstd_tpu.testing import libzstd
from zstd_tpu.utils.errors import ZstdError as JaxZstdError
from zstd_tpu_torch.format.block_table import build_batch_plan
from zstd_tpu_torch.kernels import compact, literals, lz77, sequences
from zstd_tpu_torch.runtime import engine as t_engine
from zstd_tpu_torch.runtime.engine import DeviceEngine
from zstd_tpu_torch.utils.errors import ZstdError


@pytest.fixture(scope="module")
def ref():
    return jax_reference(combined()[0])


def _assert_lanes_equal(got_outs, got_ok, want_outs, want_ok, what):
    np.testing.assert_array_equal(got_ok, want_ok, err_msg=f"{what} ok flags")
    assert len(got_outs) == len(want_outs)
    for lane, (g, w) in enumerate(zip(got_outs, want_outs)):
        if g is None or w is None:
            assert g is None and w is None, f"{what} lane {lane}"
            continue
        if isinstance(w, tuple):
            for k in range(3):
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} lane {lane} field {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} lane {lane}")


def test_lanes_match_jax_engine_before_and_after_retry(ref):
    # The JAX plan goes to the port's engine as it is (plan_to_device is
    # duck-typed on the plan's numpy fields).
    plan = ref["plan"]
    eng = DeviceEngine(device="cpu")
    lit_outs, lit_ok, lp = eng._dispatch_literals(plan)
    seq_outs, seq_ok, sp = eng._dispatch_sequences(plan)
    eng._finish_literals(plan, lp, lit_outs, lit_ok)
    eng._finish_sequences(plan, sp, seq_outs, seq_ok)
    _assert_lanes_equal(lit_outs, lit_ok, ref["lit_outs"], ref["lit_ok"], "literals")
    _assert_lanes_equal(
        seq_outs, seq_ok, ref["pre"]["seq_outs"], ref["pre"]["seq_ok"], "pre-retry sequences"
    )
    assert not seq_ok.all()  # the overflow lane goes to the wide retry
    eng._retry_sequences(plan, seq_outs, seq_ok)
    assert eng.stats.retry_lanes == int((~ref["pre"]["seq_ok"]).sum())
    _assert_lanes_equal(seq_outs, seq_ok, ref["seq_outs"], ref["seq_ok"], "sequences")


def test_own_plan_drives_same_lanes(ref):
    # The port's own prepass gives the same lanes as the JAX plan.
    data = combined()[0]
    eng = DeviceEngine(device="cpu")
    (lit_outs, lit_ok), (seq_outs, seq_ok) = eng._run_both(build_batch_plan(data))
    _assert_lanes_equal(lit_outs, lit_ok, ref["lit_outs"], ref["lit_ok"], "literals")
    _assert_lanes_equal(seq_outs, seq_ok, ref["seq_outs"], ref["seq_ok"], "sequences")


def test_device_lz77_assembly_matches_jax_frame_by_frame(ref):
    # The JAX plan and the JAX engine's lane outputs go to both routes;
    # JAX's pointer doubling runs op by op (no XLA compilation).
    import jax

    from zstd_tpu.runtime.engine import DeviceEngine as JaxEngine

    plan = ref["plan"]
    lanes = (ref["lit_outs"], ref["lit_ok"], ref["seq_outs"], ref["seq_ok"])
    got = DeviceEngine(device="cpu", device_execute=True)._device_frames(plan, *lanes)
    assert sorted(got) == list(range(len(plan.frames)))
    jeng = JaxEngine(device_execute=True)
    try:
        with jax.disable_jit():
            for i, fp in enumerate(plan.frames):
                want = jeng._assemble_frame_device(fp, ref["lit_outs"], ref["seq_outs"])
                assert bytes(got[i]) == want, f"frame {i}"
    finally:
        jeng.close()


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


def test_pure_python_assembly_without_native(monkeypatch):
    # Without the host C library the engine assembles frames in Python.
    from zstd_tpu_torch import native

    monkeypatch.setattr(native, "available", lambda: False)
    data, payload = combined()
    eng = DeviceEngine(device="cpu")
    assert eng.decompress(data) == payload
    assert eng.stats.fallback_frames == 0


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
