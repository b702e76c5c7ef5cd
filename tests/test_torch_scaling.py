"""The port's multi-process scaling bench (``zstd_tpu_torch.testing.
scaling_bench``, the port of ``tools/scaling_bench.py``) on the CPU: gloo
over one and two CPU processes on a few KB, every rank bit-exact, the JAX
tool's keys, and its efficiency t(1) / (2 * t(2))."""

from __future__ import annotations

import pytest
import torch

from zstd_tpu_torch.testing import scaling_bench

JAX_TOOL_KEYS = {"metric", "corpus_MB", "kernels_s_1proc", "kernels_s_2proc", "speedup",
                 "efficiency", "per_proc_2"}


@pytest.fixture(scope="module")
def line():
    # Each job's workers must be bit-exact with no fallback, or run() raises.
    return scaling_bench.run(corpus_mb=0.003, device="cpu")


def test_keys_are_the_jax_tools_and_the_ports(line):
    assert set(line) == JAX_TOOL_KEYS | {"device", "cards"}
    assert line["corpus_MB"] == 0.003
    assert "CPU processes" in line["metric"]


def test_efficiency_is_t1_over_twice_t2(line):
    t1, t2 = line["kernels_s_1proc"], line["kernels_s_2proc"]
    assert t1 > 0 and t2 > 0
    assert len(line["per_proc_2"]) == 2 and t2 == max(line["per_proc_2"])
    assert line["efficiency"] == t1 / (2 * t2)
    assert line["speedup"] == t1 / t2


def test_cpu_processes_use_no_card(line):
    assert line["device"] == "cpu" and line["cards"] == 0


def test_without_cuda_the_scaling_bench_exits_naming_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the scaling bench runs on the cards")
    assert scaling_bench.main([]) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "CUDA" in captured.err
