"""The port's multi-process decode (``zstd_tpu_torch.parallel.multihost``)
on the CPU.

* The ordered exchange: the port's ``_exchange_literals`` /
  ``_exchange_sequences`` against the JAX package's, given the same
  gathered buffers (``_allgather`` replaced in both), for each process of
  a two-process job: the same buffers packed, the same lanes filled, the
  same ok flags; the port's lanes keep its engine's own dtypes.
* A real two-process gloo job in subprocesses
  (``testing/multihost_job.py``; the port's form of
  ``tests/test_multihost.py``): both outputs equal the payload and each
  other, each process launched kernels over its own bin only and fell
  back on no frame; once more with each process's bin split over a local
  mesh of two CPU copies.  Every worker has a timeout of its own.
* Two processes building a kernel library at once both end with a whole
  library (``kernels/_build.py``), with a stand-in compiler.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from torch_inputs import combined
from zstd_tpu.parallel import multihost as jax_multihost
from zstd_tpu_torch.format.block_table import build_batch_plan
from zstd_tpu_torch.parallel import multihost
from zstd_tpu_torch.parallel.dist import shard_lanes_balanced
from zstd_tpu_torch.runtime.engine import DeviceEngine
from zstd_tpu_torch.testing import multihost_job

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2


@pytest.fixture(scope="module")
def decoded():
    """One plan of the combined corpus and every lane's output from the
    single-device engine."""
    plan = build_batch_plan(combined()[0])
    (lo, lok), (so, sok) = DeviceEngine(device="cpu")._run_both(plan)
    return plan, (lo, lok), (so, sok)


def _own_bin(outs, ok, bin_):
    """What a process holds before the exchange: its bin's lanes only."""
    mine = [None] * len(outs)
    for lane in bin_:
        mine[lane] = outs[lane]
    return mine, np.where(np.isin(np.arange(len(ok)), bin_), ok, True)


def _exchange(module, cls_engine, phase, plan, bins, outs, ok, pid, monkeypatch, gathered=None):
    """Run one phase's exchange of ``module``'s engine as process ``pid``;
    ``_allgather`` records what it is given and returns ``gathered[k]``
    for its k-th call (zeros when None).  Returns (sent buffers, outs, ok)."""
    sent = []

    def allgather(arr):
        sent.append(np.array(arr))
        if gathered is None:
            return np.zeros((NPROC, *np.shape(arr)), dtype=np.asarray(arr).dtype)
        return gathered[len(sent) - 1]

    monkeypatch.setattr(module, "_allgather", allgather)
    eng = cls_engine.__new__(cls_engine)
    eng.nproc, eng.pid, eng.exchange_stats = NPROC, pid, {}
    outs, ok = list(outs), ok.copy()
    getattr(eng, f"_exchange_{phase}")(plan, bins, outs, ok)
    return sent, outs, ok


@pytest.mark.parametrize("pid", range(NPROC))
@pytest.mark.parametrize("phase", ["literals", "sequences"])
def test_exchange_matches_jax(decoded, monkeypatch, phase, pid):
    plan, lits, seqs = decoded
    counts, (outs, ok) = (plan.lit_regen, lits) if phase == "literals" else (plan.seq_nseq, seqs)
    bins = shard_lanes_balanced(counts, NPROC)
    # Every process's sent buffers, as the JAX package packs them.
    sends = [
        _exchange(jax_multihost, jax_multihost.MultihostEngine, phase, plan, bins,
                  *_own_bin(outs, ok, bins[p]), p, monkeypatch)[0]
        for p in range(NPROC)
    ]
    gathered = [np.stack([s[k] for s in sends]) for k in range(2)]
    mine = _own_bin(outs, ok, bins[pid])
    want_sent, want_outs, want_ok = _exchange(
        jax_multihost, jax_multihost.MultihostEngine, phase, plan, bins, *mine, pid, monkeypatch, gathered)
    got_sent, got_outs, got_ok = _exchange(
        multihost, multihost.MultihostEngine, phase, plan, bins, *mine, pid, monkeypatch, gathered)
    for g, w in zip(got_sent, want_sent):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got_ok, want_ok)
    np.testing.assert_array_equal(got_ok, ok)
    for lane, (g, w, full) in enumerate(zip(got_outs, want_outs, outs)):
        if w is None:
            assert g is None, lane
            continue
        parts = (g,) if phase == "literals" else g
        for k, (gp, wp, fp) in enumerate(zip(parts, (w,) if phase == "literals" else w,
                                             (full,) if phase == "literals" else full)):
            np.testing.assert_array_equal(gp, wp, err_msg=f"lane {lane} field {k}")
            np.testing.assert_array_equal(gp, fp, err_msg=f"lane {lane} field {k}")
            # The port's lanes keep the dtypes of its own _finish_* (JAX
            # widens exchanged sequence fields to int64 / uint64).
            assert gp.dtype == fp.dtype, (lane, k, gp.dtype, fp.dtype)


def test_engine_outside_a_job_is_one_process():
    data, payload = combined()
    eng = multihost.MultihostEngine(device="cpu")
    assert (eng.nproc, eng.pid) == (1, 0)
    assert eng.decompress(data) == payload
    assert eng.stats.fallback_frames == 0 and eng.stats.kernel_calls > 0
    assert set(eng.exchange_stats) == {"literals", "sequences"}
    assert multihost.multihost_decompress(data, device="cpu") == payload


def test_two_process_gloo_job(tmp_path):
    data, payload = combined()
    (tmp_path / "in.zst").write_bytes(data)
    (tmp_path / "expect.bin").write_bytes(payload)
    results = multihost_job.run_job(tmp_path / "in.zst", tmp_path / "expect.bin", nproc=NPROC,
                                    device="cpu", timeout=120, threads=1)
    assert [r["rank"] for r in results] == list(range(NPROC))
    assert len({r["sha256"] for r in results}) == 1
    plan = build_batch_plan(data)
    for r in results:
        assert r["exact"] and r["nproc"] == NPROC and r["bytes_out"] == len(payload)
        assert r["kernel_calls"] > 0 and r["fallback_frames"] == 0, r
        # Each process launched its own bins' lanes with work, and only them.
        assert r["lit_lanes_run"] == r["bins"]["literals"]["lanes_with_work"][r["rank"]]
        assert r["seq_lanes_run"] == r["bins"]["sequences"]["lanes_with_work"][r["rank"]]
        assert set(r["exchange"]) == {"literals", "sequences"}
    assert sum(r["seq_lanes_run"] for r in results) == int((plan.seq_nseq > 0).sum())
    assert sum(r["lit_lanes_run"] for r in results) == int((plan.lit_regen > 0).sum())



def test_two_process_gloo_job_over_local_meshes(tmp_path):
    # Each process splits its bin over a local mesh of two CPU copies
    # (MultihostEngine(local_mesh=...)): the same bytes, its bin's lanes
    # only, and every launch made by a mesh position holding a block.
    data, payload = combined()
    (tmp_path / "in.zst").write_bytes(data)
    (tmp_path / "expect.bin").write_bytes(payload)
    results = multihost_job.run_job(tmp_path / "in.zst", tmp_path / "expect.bin", nproc=NPROC,
                                    device="cpu", timeout=120, threads=1, local_mesh=2)
    assert len({r["sha256"] for r in results}) == 1
    for r in results:
        assert r["exact"] and r["fallback_frames"] == 0, r
        assert r["lit_lanes_run"] == r["bins"]["literals"]["lanes_with_work"][r["rank"]]
        assert r["seq_lanes_run"] == r["bins"]["sequences"]["lanes_with_work"][r["rank"]]
        assert len(r["mesh_calls"]) == 2 and min(r["mesh_calls"]) > 0, r["mesh_calls"]
        assert sum(r["mesh_calls"]) == r["kernel_calls"]

_BUILD = textwrap.dedent("""
    import pathlib, sys, time
    sys.path.insert(0, {repo!r})
    from zstd_tpu_torch.kernels import _build
    _build.BUILD_DIR = pathlib.Path({build!r})
    _build._nvcc = lambda: {nvcc!r}
    go = pathlib.Path({build!r}) / "go"
    while not go.exists():
        time.sleep(0.01)
    _build._finish("compact", *_build._start("compact"))
""")

_FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    # Stand-in compiler: writes its output in small pieces, slowly.
    import sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(out, "wb") as f:
        for i in range(64):
            f.write(bytes([i]) * 4096)
            f.flush()
            time.sleep(0.002)
    print("ptxas info    : Used 32 registers")
""")


def test_concurrent_builds_end_with_whole_libraries(tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    build.mkdir()
    script = _BUILD.format(repo=REPO, build=str(build), nvcc=str(nvcc))
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    (build / "go").touch()
    for p in procs:
        out, _ = p.communicate(timeout=60)
        assert p.returncode == 0, out
    want = b"".join(bytes([i]) * 4096 for i in range(64))
    assert (build / "libzt_compact.so").read_bytes() == want
    assert (build / "compact.ptxas.txt").read_text().startswith("ptxas info")
    assert sorted(p.name for p in build.iterdir()) == ["compact.ptxas.txt", "go", "libzt_compact.so"]


@pytest.mark.parametrize(
    "rank, local_rank, cards, want",
    [(0, None, 4, "cuda:0"), (3, None, 4, "cuda:3"), (5, None, 4, "cuda:1"), (1, None, 1, "cuda:0"),
     (6, "2", 4, "cuda:2")],
)
def test_each_rank_takes_its_own_card(monkeypatch, rank, local_rank, cards, want):
    # With neither a device nor a local mesh, process `rank` resolves to
    # its own card (LOCAL_RANK, else rank mod the card count).  The card
    # count is stubbed: nothing is launched, so no card is needed.
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(multihost, "_job", lambda: (8, rank))
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    eng = multihost.MultihostEngine()
    assert (eng.nproc, eng.pid) == (8, rank)
    assert str(eng.device) == want and eng._placement == (eng.device,)
    assert multihost.MultihostEngine(device="cpu").device.type == "cpu"  # a named device wins
    assert multihost.rank_device(rank) == want


class _Worker:
    """A stand-in for a worker process: records its command line and
    prints one JSON line."""

    def __init__(self, cmd, **kw):
        self.cmd, self.returncode = cmd, 0

    def communicate(self, timeout=None):
        return json.dumps({"rank": int(self.cmd[self.cmd.index("--rank") + 1])}) + "\n", None

    def poll(self):
        return 0


@pytest.mark.parametrize("device", [None, "cpu"])
def test_job_runner_names_a_device_only_when_asked(monkeypatch, device):
    # With no device named, no worker gets --device, so each worker's
    # MultihostEngine() resolves its own card through rank_device; a
    # named device (cpu included) goes to every worker.
    started = []
    monkeypatch.setattr(multihost_job.subprocess, "Popen",
                        lambda cmd, **kw: started.append(_Worker(cmd, **kw)) or started[-1])
    results = multihost_job.run_job("in.zst", nproc=3, device=device)
    assert [r["rank"] for r in results] == [0, 1, 2]
    for w in started:
        if device is None:
            assert "--device" not in w.cmd
        else:
            assert w.cmd[w.cmd.index("--device") + 1] == device


def test_no_card_and_no_device_raises(monkeypatch):
    # Nothing falls back to the CPU: without CUDA and with no device
    # named, the engine raises (in a job worker too, which is given no
    # device then).
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert multihost.rank_device(0) is None
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.MultihostEngine()
