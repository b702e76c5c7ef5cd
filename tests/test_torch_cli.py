"""The port's CLI (``python -m zstd_tpu_torch.cli``) against the JAX
package's (``zstd_tpu.cli``), on the CPU, over frames generated with
libzstd: the same ``--info`` text, output bytes, errors and exit codes;
``--device --report``; and the port's ``profiled`` hook.  The port's CLI
decodes on the CUDA card; here the engine's device is set to the CPU
(the kernels' plain forms).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from zstd_tpu import cli as jax_cli
from zstd_tpu.observability import RunReport as JaxRunReport
from zstd_tpu.testing import libzstd
from zstd_tpu_torch import cli
from zstd_tpu_torch.observability import profiled
from zstd_tpu_torch.runtime import engine as t_engine

SKIP = b"\x50\x2a\x4d\x18" + (4).to_bytes(4, "little") + bytes([0x10, 0x20, 0x30, 0x42])


def _payloads() -> tuple[bytes, bytes]:
    rng = np.random.default_rng(5)
    words = [rng.integers(97, 123, int(n), dtype=np.uint8).tobytes() for n in rng.integers(2, 9, 200)]
    text = b" ".join(words[int(i)] for i in rng.integers(0, 200, 1500))
    return text, rng.integers(0, 256, 1000, dtype=np.uint8).tobytes() + text[:3000]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A level-19 frame (Huffman literals, FSE tables), a skippable frame
    and a level-3 frame, one file; its payload without and with the
    skippable content; and a copy with one byte flipped mid-frame."""
    a, b = _payloads()
    data = libzstd.compress(a, 19, checksum=True) + SKIP + libzstd.compress(b, 3, checksum=True)
    d = tmp_path_factory.mktemp("cli")
    good = d / "mix.zst"
    good.write_bytes(data)
    bad = bytearray(data)
    bad[len(data) // 4] ^= 0x55
    corrupt = d / "corrupt.zst"
    corrupt.write_bytes(bytes(bad))
    return {"good": good, "corrupt": corrupt, "plain": a + b, "skip": a + SKIP[8:] + b}


@pytest.fixture
def on_cpu(monkeypatch):
    """The port's engine on the CPU, where a run would use the card."""
    monkeypatch.setattr(t_engine, "resolve_device", lambda device=None: torch.device("cpu"))


def _both(capsys, argv_of):
    """(rc, stdout, stderr) of the JAX CLI, then of the port's."""
    res = []
    for main in (jax_cli.main, cli.main):
        rc = main(argv_of(main))
        cap = capsys.readouterr()
        res.append((rc, cap.out, cap.err))
    return res


def test_info_identical_to_jax_cli(files, capsys):
    want, got = _both(capsys, lambda _m: [str(files["good"]), "--info"])
    assert got == want
    assert got[0] == 0 and got[1].count("Skippable") == 1 and "huffman: max_bits=" in got[1]


@pytest.mark.parametrize("flags", [[], ["--print-skippable"]], ids=["plain", "print_skippable"])
def test_decode_to_file_equals_jax_cli(files, tmp_path, capsys, on_cpu, flags):
    outs = {jax_cli.main: tmp_path / "jax.bin", cli.main: tmp_path / "port.bin"}
    want, got = _both(capsys, lambda m: [str(files["good"]), "-o", str(outs[m]), *flags])
    assert got == want and got[0] == 0
    data = outs[cli.main].read_bytes()
    assert data == outs[jax_cli.main].read_bytes()
    assert data == (files["skip"] if flags else files["plain"])


def test_corrupt_input_exits_1_like_jax_cli(files, tmp_path, capsys, on_cpu):
    want, got = _both(capsys, lambda _m: [str(files["corrupt"]), "-o", str(tmp_path / "x.bin")])
    assert got == want
    assert got[0] == 1 and got[2].startswith("error: ") and "Traceback" not in got[2]


def test_device_report_on_cpu(files, tmp_path, capsys, on_cpu):
    out = tmp_path / "dev.bin"
    rc = cli.main([str(files["good"]), "--device", "--report", "-o", str(out)])
    assert rc == 0
    assert out.read_bytes() == files["plain"]
    report = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert set(report) == set(json.loads(JaxRunReport().to_json()))
    assert report["device"] == "cpu"
    assert report["bytes_out"] == len(files["plain"]) and report["fallback_frames"] == 0
    assert report["kernel_calls"] >= 2 and "total" in report["wall_s"]


def test_device_flag_needs_cuda(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for flags in (["--device"], []):  # the port's CLI decodes on the card either way
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([str(files["good"]), *flags])


def test_profiled_writes_trace_and_propagates_exceptions(tmp_path):
    with profiled(str(tmp_path / "ok")):
        torch.ones(4).sum()
    assert json.loads((tmp_path / "ok" / "trace.json").read_text())["traceEvents"]
    with pytest.raises(ZeroDivisionError):
        with profiled(str(tmp_path / "t")):
            1 / 0
    assert not (tmp_path / "t" / "trace.json").exists()
    with pytest.raises(ZeroDivisionError):
        with profiled(None):
            1 / 0
