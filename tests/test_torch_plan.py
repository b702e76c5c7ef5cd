"""The port's batch plan (``zstd_tpu_torch.format.block_table``) equals
the JAX package's, field by field, and uploads the same device arrays.

The plan is the codec's only state: what the port plans, the kernels
decode.  No JAX computation runs here; both prepasses are host code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from torch_inputs import CORPORA, skippable_groups
from zstd_tpu.format.block_table import build_batch_plan as jax_build
from zstd_tpu_torch.format.block_table import build_batch_plan as torch_build
from zstd_tpu_torch.runtime.engine import plan_to_device

INPUTS = {
    "level3_text": lambda: CORPORA["level3_text"]()[0],
    "level19_repeat": lambda: CORPORA["level19_repeat"]()[0],
    "skippables": lambda: skippable_groups()[0],
}


def _plain(v):
    """A comparable value: enums by value, buffers as bytes."""
    if hasattr(v, "value") and not isinstance(v, (int, bytes)):
        return v.value
    if isinstance(v, (memoryview, bytearray)):
        return bytes(v)
    return v


def _frame_key(frame):
    if hasattr(frame, "payload"):
        return ("skippable", frame.magic, bytes(frame.payload), frame.start, frame.end)
    header = dataclasses.astuple(frame.header)
    return ("zstd", header, frame.checksum, frame.start, frame.end, len(frame.blocks))


@pytest.mark.parametrize("name", list(INPUTS))
def test_plan_equals_jax_field_by_field(name):
    data = INPUTS[name]()
    want, got = jax_build(data), torch_build(data)
    for f in dataclasses.fields(want):
        if f.name == "frames":
            continue
        w, g = getattr(want, f.name), getattr(got, f.name)
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)
    assert len(got.frames) == len(want.frames)
    for fw, fg in zip(want.frames, got.frames):
        assert _frame_key(fg.frame) == _frame_key(fw.frame)
        assert (fg.fallback, fg.fallback_reason) == (fw.fallback, fw.fallback_reason)
        assert len(fg.blocks) == len(fw.blocks)
        for bw, bg in zip(fw.blocks, fg.blocks):
            for f in dataclasses.fields(bw):
                w, g = getattr(bw, f.name), getattr(bg, f.name)
                if f.name == "lit_streams":
                    assert [(r.lane, r.regen) for r in g] == [(r.lane, r.regen) for r in w]
                else:
                    assert _plain(g) == _plain(w), f.name
    if name == "skippables":
        assert any(hasattr(fp.frame, "payload") for fp in got.frames)


@pytest.mark.parametrize("name", list(INPUTS))
def test_plan_to_device_accepts_either_plan(name):
    data = INPUTS[name]()
    a = plan_to_device(jax_build(data), "cpu")
    b = plan_to_device(torch_build(data), "cpu")
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)
