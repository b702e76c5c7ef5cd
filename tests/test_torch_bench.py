"""The port's bench (``zstd_tpu_torch.bench``) against the JAX package's
``bench.py``, on the CPU at a few KB: the corpus byte for byte, the JSON
line's keys and its device-only fields null, bit-exact output with no
oracle fallback on every route (and the gate that fails the bench
otherwise), lane counts equal to the JAX host plan's, and the encoder
table equal to one computed with ``zstd_tpu.encode.compress`` (tolerance
0); the reused-buffer libzstd bar and the card's ``nvidia-smi`` row.  These test the bench's logic, not its speed: its numbers come from
the card (``python -m zstd_tpu_torch.bench``)."""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import subprocess
import types

import numpy as np
import pytest
import torch

import bench as jax_bench
import zstd_tpu.encode as jax_encode
import zstd_tpu.native as jax_native
from conftest import CORPUS_DIR
from zstd_tpu.format.block_table import build_batch_plan as jax_build_batch_plan
from zstd_tpu.testing import libzstd as jax_libzstd
from zstd_tpu_torch import bench, observability
from zstd_tpu_torch.runtime.engine import DeviceEngine
from zstd_tpu_torch.testing import libzstd as port_libzstd
from zstd_tpu_torch.testing.corpus import build_corpus, compress_chunks

ARGS = ["--device", "cpu", "--corpus-mb", "0.003", "--hl-bytes", "1536", "--iters", "1",
        "--enc-bytes", "3000"]
CORPUS_MB, ENC_BYTES = 0.003, 3000

DETAIL_KEYS = {
    "corpus_bytes", "compressed_bytes", "iters", "best_gbs", "worst_gbs",
    "oracle_baseline_gbs", "libzstd_serial_gbs", "vs_libzstd_serial",
    "libzstd_reused_gbs", "vs_libzstd_reused",
    "lit_lanes", "seq_lanes", "kernel_calls", "fallback_frames", "wall_s",
    "transfers", "highlevel_mix", "encode_vs_libzstd",
    "device", "build_s", "device_route", "idle_share", "device_busy_ms", "top_device_ms",
}


@pytest.fixture(scope="module")
def line():
    """The one stdout line of ``python -m zstd_tpu_torch.bench --device cpu``
    at a few KB (run in this process through ``main``)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench.main(ARGS) == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_corpus_equals_the_jax_bench_corpus():
    if (CORPUS_DIR / "moby-dick.txt.zst").exists():
        pytest.skip("bench.build_corpus decodes the bundled text file here; the port always "
                    "uses the generated word text")
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    assert sha(build_corpus()) == sha(jax_bench.build_corpus())


def test_line_has_every_key_and_cpu_nulls(line):
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert line["unit"] == "GB/s"
    assert "CPU (plain forms)" in line["metric"] and "1 GPU" not in line["metric"]
    d = line["detail"]
    assert set(d) == DETAIL_KEYS
    assert d["device"] == {"torch_device": "cpu", "name": None, "power_limit": None, "count": 0}
    for key in ("idle_share", "device_busy_ms", "top_device_ms"):
        assert d[key] is None, key
    t = d["transfers"]
    assert t["h2d_pinned_GBs"] is None and t["d2h_pinned_GBs"] is None and t["fetch_GBs"] is None
    assert set(t) == {"kernel_s", "rest_s", "prepass_s", "assembly_s", "total_s", "upload_MB",
                      "fetch_MB", "h2d_pinned_GBs", "d2h_pinned_GBs", "fetch_GBs",
                      "compute_only_GBs", "compute_incl_upload_GBs"}
    parts = sum(t["kernel_s"].values()) + t["rest_s"] + t["prepass_s"] + t["assembly_s"]
    assert parts == pytest.approx(t["total_s"], rel=1e-9)
    assert set(t["kernel_s"]) == {"dispatch", "upload_wait", "device_compute", "fetch"}
    assert set(d["wall_s"]) == {"prepass", "kernels", "assembly", "total", "words", "parse", "plan",
                                "launch", "wait", "unpack", "retry", "execute", "output"}
    assert set(d["device_route"]) == {"gbs", "best_gbs", "worst_gbs", "fallback_frames", "lz77_calls"}
    assert d["device_route"]["lz77_calls"] == 0  # the plain form runs on the CPU: no kernel launch
    assert d["libzstd_serial_gbs"] > 0 and d["vs_libzstd_serial"] > 0 and d["oracle_baseline_gbs"] > 0
    assert d["libzstd_reused_gbs"] > 0 and d["vs_libzstd_reused"] > 0
    assert d["best_gbs"] >= line["value"] >= d["worst_gbs"]


def test_bit_exact_and_no_fallback_on_every_route(line):
    d = line["detail"]
    raw = build_corpus(CORPUS_MB)
    assert d["corpus_bytes"] == len(raw)
    assert d["compressed_bytes"] == len(compress_chunks(raw, 3))
    assert d["fallback_frames"] == 0
    assert d["device_route"]["fallback_frames"] == 0
    assert d["highlevel_mix"]["fallback_frames"] == 0
    assert d["highlevel_mix"]["corpus_bytes"] == 1536


@pytest.mark.parametrize("fault", ["wrong_bytes", "fallback"])
def test_a_wrong_decode_or_a_fallback_fails_the_bench(monkeypatch, fault):
    class Faulty(DeviceEngine):
        def decompress(self, data, **kw):
            out = super().decompress(data, **kw)
            if fault == "fallback":
                self.stats.fallback_frames = 1
                return out
            return bytes([out[0] ^ 1]) + out[1:]

    monkeypatch.setattr(bench, "DeviceEngine", Faulty)
    with pytest.raises(bench.BenchFailed):
        bench.run(device="cpu", corpus_mb=CORPUS_MB, hl_bytes=1536, iters=1, enc_bytes=ENC_BYTES)


def test_lane_counts_equal_the_jax_host_plan(line):
    plan = jax_build_batch_plan(compress_chunks(build_corpus(CORPUS_MB), 3))
    assert line["detail"]["lit_lanes"] == plan.n_lit_lanes > 0
    assert line["detail"]["seq_lanes"] == plan.n_seq_lanes > 0


def test_encoder_table_equals_the_jax_encoders(line):
    assert jax_native.available()
    sets = bench.encoder_sets(build_corpus(CORPUS_MB), ENC_BYTES)
    expect = {
        name: {f"L{lv}": len(jax_encode.compress(p, level=lv)) / len(jax_libzstd.compress(p, lv))
               for lv in bench.ENC_LEVELS}
        for name, p in sets.items()
    }
    assert line["detail"]["encode_vs_libzstd"] == expect


def test_encoder_sets_at_the_default_size_are_the_jax_bench_sets():
    """``bench.py``'s inline construction of its four sets (root
    ``bench.py``, ``main``), copied here as the reference."""
    raw = build_corpus(0.3)
    rng2 = np.random.default_rng(7)
    expect = {
        "text": raw[:200_000],
        "records": b"".join(
            b"id=%08d|name=user%04d|score=%05d;" % (i, i % 7919, (i * 2654435761) % 99999)
            for i in range(6000)
        ),
        "lowent": rng2.choice(np.frombuffer(b"ACGT", dtype=np.uint8), 200_000).tobytes(),
        "repetitive": (lambda b: b"".join(b[: int(k)] for k in rng2.integers(512, 4096, 80)))(
            rng2.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        ),
    }
    assert bench.encoder_sets(raw) == expect


def test_without_cuda_the_bench_exits_naming_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the bench runs on the card")
    assert bench.main([]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "CUDA" in captured.err


def test_libzstd_decoder_reuses_one_buffer_and_gives_libzstds_bytes():
    """``libzstd.Decoder``, the bench's buffer-free libzstd bar, decodes
    multi-frame inputs into the one buffer it made, with libzstd's bytes."""
    raw = build_corpus(0.05)
    dec = port_libzstd.Decoder(len(raw))
    buffer = dec.buffer
    try:
        for data in (compress_chunks(raw, 3, chunk=16 << 10), jax_libzstd.compress(raw[:5000], 19)):
            n = dec.decode(data)
            assert dec.buffer is buffer
            assert dec.buffer.raw[:n] == jax_libzstd.decompress(data)
    finally:
        dec.close()


def test_card_line_takes_the_row_at_the_cards_pci_address(monkeypatch):
    """``nvidia-smi`` lists cards in PCI order and CUDA numbers them its
    own way: the row of CUDA card 0 is found by its PCI address, not by
    its index, and by its index only where every address is hidden (no
    card needed: both sides are stubbed)."""
    rows = ("00000000:19:00.0, NVIDIA H100 80GB HBM3, 700.00 W\n"
            "00000000:3B:00.0, NVIDIA H100 80GB HBM3, 500.00 W\n")
    monkeypatch.setattr(observability.subprocess, "run",
                        lambda *a, **k: subprocess.CompletedProcess(a, 0, stdout=rows))
    props = {0: (0, 0x3B, 0), 1: (0, 0x19, 0), 2: (0, 0x5D, 0)}
    monkeypatch.setattr(observability.torch.cuda, "get_device_properties", lambda i: types.SimpleNamespace(
        pci_domain_id=props[i][0], pci_bus_id=props[i][1], pci_device_id=props[i][2]))
    assert observability.card_line(0) == "NVIDIA H100 80GB HBM3, 500.00 W"
    assert observability.card_line(1) == "NVIDIA H100 80GB HBM3, 700.00 W"
    with pytest.raises(RuntimeError, match="no card"):
        observability.card_line(2)
    rows = rows.replace("00000000:19:00.0", "[N/A]").replace("00000000:3B:00.0", "[N/A]")
    assert observability.card_line(1) == "NVIDIA H100 80GB HBM3, 500.00 W"  # addresses hidden: the row index
