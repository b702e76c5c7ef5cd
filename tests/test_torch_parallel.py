"""The port's lane-sharded decode (``zstd_tpu_torch.parallel``) on the CPU.

* ``shard_lanes_balanced`` equals the JAX package's.
* ``ShardedEngine`` on CPU meshes (``make_mesh(n, device="cpu")``, the
  counterpart of JAX's virtual host-platform devices): per-lane outputs
  and ok flags before and after the wide retry equal the single-device
  engine's (which ``test_torch_entropy.py`` holds to the JAX engine), the
  final bytes are exact with no oracle fallback, and each mesh position
  launches once for each lane list whose block it holds.
* Subset dispatch: the port's ``_run_literals_wide`` /
  ``_run_sequences_wide`` with a process's bin, one of whose lanes goes
  to the wide retry, agree lane by lane with the JAX engine's (op by op
  under ``jax.disable_jit``), and with the kernel
  wrappers stubbed a bin launches exactly its own lanes (the port's form
  of ``tests/test_work_division.py``).
* ``measure_phases``: the one-plan route, exact output, JAX's four phase
  keys.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_inputs import combined, level3_small, many_lanes, overflow_match
from zstd_tpu.parallel.dist import shard_lanes_balanced as jax_shard_lanes_balanced
from zstd_tpu_torch.format.block_table import build_batch_plan
from zstd_tpu_torch.kernels import literals, sequences
from zstd_tpu_torch.parallel.dist import ShardedEngine, shard_lanes_balanced, sharded_decompress
from zstd_tpu_torch.parallel.mesh import LaneMesh, make_mesh
from zstd_tpu_torch.parallel.multihost import MultihostEngine
from zstd_tpu_torch.runtime.engine import DeviceEngine
from zstd_tpu_torch.testing.lanes import assert_lanes_equal, engine_lanes

PHASE_KEYS = ("dispatch", "upload_wait", "device_compute", "fetch")


def _costs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    return {
        "seeded": rng.integers(0, 5_000, 61),
        "ties": np.repeat([7, 3, 3, 0, 12], 5),
        "fewer_lanes_than_shards": np.asarray([5, 1, 9]),
    }[kind]


@pytest.mark.parametrize("kind", ["seeded", "ties", "fewer_lanes_than_shards"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_shard_lanes_balanced_equals_jax(kind, n_shards):
    costs = _costs(kind)
    got = shard_lanes_balanced(costs, n_shards)
    want = jax_shard_lanes_balanced(costs, n_shards)
    assert len(got) == len(want) == n_shards
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    assert sorted(np.concatenate(got).tolist()) == list(range(len(costs)))


def test_make_mesh():
    mesh = make_mesh(4, device="cpu")
    assert isinstance(mesh, LaneMesh) and mesh.size == 4
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError):
        make_mesh(2, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2, device="cuda:0")


def _blocks_with_work(n_lanes: int, size: int) -> np.ndarray:
    """Per mesh position, 1 where its contiguous block of ceil(n / size)
    lanes holds a lane."""
    step = -(-n_lanes // size)
    return (np.arange(size) * step < n_lanes).astype(int)


@pytest.fixture(scope="module")
def combined_plan():
    data, payload = combined()
    plan = build_batch_plan(data)
    single = DeviceEngine(device="cpu")
    return data, payload, plan, engine_lanes(single, plan)


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_sharded_engine_equals_single_device_lane_by_lane(combined_plan, size):
    data, payload, plan, want = combined_plan
    eng = ShardedEngine(make_mesh(size, device="cpu"))
    got = engine_lanes(eng, plan)
    assert_lanes_equal(*got[0], *want[0], "literals")
    assert_lanes_equal(*got[1], *want[1], "pre-retry sequences")
    assert_lanes_equal(*got[2], *want[2], "sequences")
    assert not want[1][1].all()  # the overflow lane went to the wide retry
    failed = int((~want[1][1]).sum())
    expect = sum(
        _blocks_with_work(int(n), size)
        for n in ((plan.lit_regen > 0).sum(), (plan.seq_nseq > 0).sum(), failed)
    )
    assert eng.stats.mesh_calls == expect.tolist()
    assert eng.stats.kernel_calls == int(expect.sum())

    assert eng.decompress(data) == payload
    assert eng.stats.fallback_frames == 0, eng.stats.fallback_reasons
    assert eng.stats.retry_lanes == failed
    assert sum(eng.stats.mesh_calls) == eng.stats.kernel_calls


@pytest.mark.parametrize("size", [3, 256])
def test_sharded_engine_rejects_mesh_size(size):
    with pytest.raises(ValueError, match="power of two"):
        ShardedEngine(make_mesh(size, device="cpu"))


def test_sharded_decompress_and_device_route():
    data, payload = combined()
    assert sharded_decompress(data, make_mesh(2, device="cpu")) == payload
    eng = ShardedEngine(make_mesh(2, device="cpu"), device_execute=True)
    assert eng.decompress(data) == payload
    assert eng.stats.fallback_frames == 0
    with pytest.raises(ValueError):
        DeviceEngine(device="cpu", mesh=make_mesh(2, device="cpu"))


def test_route_choice(monkeypatch):
    # The frame-group pipeline only where _pipelines() holds: one device,
    # outside measure mode, not the multi-process engine (the JAX engine's
    # rule).
    calls = []
    orig = DeviceEngine._iter_pipelined

    def spy(self, *a):
        calls.append(type(self).__name__)
        yield from orig(self, *a)

    monkeypatch.setattr(DeviceEngine, "_iter_pipelined", spy)
    data, payload = combined()
    measured = DeviceEngine(device="cpu")
    measured.measure_phases = True
    engines = [
        DeviceEngine(device="cpu"),
        ShardedEngine(make_mesh(1, device="cpu")),
        MultihostEngine(device="cpu"),
        measured,
    ]
    for eng in engines:
        assert eng.decompress(data) == payload
        assert eng.stats.fallback_frames == 0
    assert calls == ["DeviceEngine"]


def test_measure_phases_exact_with_phase_keys():
    data, payload = combined()
    eng = DeviceEngine(device="cpu")
    eng.measure_phases = True
    assert eng.decompress(data) == payload
    assert eng.stats.fallback_frames == 0
    wall = eng.stats.wall_s
    for key in (*PHASE_KEYS, "prepass", "kernels", "assembly", "total"):
        assert key in wall and wall[key] >= 0, key
    assert eng.stats.retry_lanes == 1


def subset_corpus() -> tuple[bytes, bytes]:
    """level3_small and a small frame whose sequence lane overflows the
    narrow kernel: bin 0 of 2 holds that lane, so the subset's wide retry
    runs."""
    (a, pa), (b, pb) = level3_small(), overflow_match()
    return a + b, pa + pb


@pytest.fixture(scope="module")
def small_subset_jax():
    """The JAX engine's subset phases on ``subset_corpus``, bin 0 of 2 (op
    by op under jax.disable_jit: level3_text's bins take ~37 s so)."""
    import jax

    from zstd_tpu.format.block_table import build_batch_plan as jax_plan
    from zstd_tpu.runtime.engine import DeviceEngine as JaxEngine

    plan = jax_plan(subset_corpus()[0])
    lit_bin = jax_shard_lanes_balanced(plan.lit_regen, 2)[0]
    seq_bin = jax_shard_lanes_balanced(plan.seq_nseq, 2)[0]
    eng = JaxEngine(use_pallas=False)
    try:
        with jax.disable_jit():
            lit = eng._run_literals_wide(plan, subset=lit_bin)
            seq = eng._run_sequences_wide(plan, subset=seq_bin)
    finally:
        eng.close()
    return plan, lit_bin, seq_bin, lit, seq


def test_subset_phases_match_jax(small_subset_jax):
    plan, lit_bin, seq_bin, (jlo, jlok), (jso, jsok) = small_subset_jax
    assert 0 < len(lit_bin) < plan.n_lit_lanes and 0 < len(seq_bin) < plan.n_seq_lanes
    eng = DeviceEngine(device="cpu")
    lo, lok = eng._run_literals_wide(plan, subset=lit_bin)
    so, sok = eng._run_sequences_wide(plan, subset=seq_bin)
    assert eng.stats.retry_lanes == 1  # the overflow lane, in bin 0, retried wide
    assert_lanes_equal(lo, lok, jlo, jlok, "literals")
    assert_lanes_equal(so, sok, jso, jsok, "sequences")
    for outs, ok, b in ((lo, lok, lit_bin), (so, sok, seq_bin)):
        rest = np.setdiff1d(np.arange(len(outs)), b)
        assert all(outs[i] is None for i in rest) and ok[rest].all()
        assert all(outs[i] is not None for i in b) and ok[b].all()
    assert eng.stats.lit_lanes_run == len(lit_bin) and eng.stats.seq_lanes_run == len(seq_bin)


def _stub_wrappers(monkeypatch, launched: list):
    """Kernel wrappers that record the lanes they are given (their lane_mat
    rows) and return empty outputs of the right shapes."""

    def lit_stub(words, lane_mat, cum, *banks, n_dense):
        launched.append(("literals", lane_mat.numpy().copy()))
        L = lane_mat.shape[0]
        return torch.zeros(4 * n_dense, dtype=torch.uint8), torch.ones(L, dtype=torch.int32)

    def seq_stub(words, lane_mat, *banks, rows, wide=False):
        launched.append(("wide" if wide else "sequences", lane_mat.numpy().copy()))
        L = lane_mat.shape[0]
        plane = torch.zeros(rows, L, dtype=torch.int32)
        ok = torch.ones(L, dtype=torch.int32)
        return (plane, plane, plane, ok) if wide else (plane, plane, ok)

    monkeypatch.setattr(literals, "decode_literals", lit_stub)
    monkeypatch.setattr(sequences, "decode_sequences", seq_stub)


@pytest.mark.parametrize("size", [1, 2])
@pytest.mark.parametrize("nproc", [2, 4])
def test_subset_dispatch_launches_only_the_bin(monkeypatch, nproc, size):
    plan = build_batch_plan(many_lanes()[0])
    work = {"literals": plan.lit_regen, "sequences": plan.seq_nseq}
    base = {"literals": plan.lit_base, "sequences": plan.seq_base}
    p0 = {"literals": plan.lit_p0, "sequences": plan.seq_p0}
    for pid in range(nproc):
        launched: list = []
        _stub_wrappers(monkeypatch, launched)
        eng = DeviceEngine(mesh=make_mesh(size, device="cpu"))
        bins = {k: shard_lanes_balanced(v, nproc)[pid] for k, v in work.items()}
        eng._dispatch_literals(plan, subset=bins["literals"])
        eng._dispatch_sequences(plan, subset=bins["sequences"])
        for phase, counts in work.items():
            mats = [m for k, m in launched if k == phase]
            want = bins[phase][counts[bins[phase]] > 0]
            assert len(mats) == _blocks_with_work(len(want), size).sum()
            got = np.concatenate(mats) if mats else np.zeros((0, 2), np.int32)
            # Blocks in lane order; each row is its lane's (base, p0).
            np.testing.assert_array_equal(got[:, 0], base[phase][want])
            np.testing.assert_array_equal(got[:, 1], p0[phase][want])
            # Balanced: the bin's work is within 25% of the mean.
            loads = [int(counts[b].sum()) for b in shard_lanes_balanced(counts, nproc)]
            assert max(loads) <= 1.25 * np.mean(loads)
        assert eng.stats.lit_lanes_run == int((plan.lit_regen[bins["literals"]] > 0).sum())
        assert eng.stats.seq_lanes_run == int((plan.seq_nseq[bins["sequences"]] > 0).sum())
