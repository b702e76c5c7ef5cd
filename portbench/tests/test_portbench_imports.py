"""What the run loads: never JAX or the JAX package (top-level names
compared whole: ``zstd_tpu_torch`` is the port and allowed), and the
reference nothing of the program.  Without a card, or without the
program beside it, the run exits non-zero and prints no result."""

import shutil
import subprocess
import sys

from portbench import run, spec

REPO = str(spec.REPO)
WORKLOAD = spec.benchmark()["workloads"][0]["name"]


def _python(code: str, cwd: str = REPO) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["zstd_tpu_torch", "zstd_tpu_torch.runtime.engine", "jaxtyping"]) == []
    assert run.forbidden_modules(["zstd_tpu.runtime", "jax", "jaxlib.xla", "flax"]) == [
        "flax", "jax", "jaxlib", "zstd_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "from portbench import run\n"
        "from portbench.tests.conftest import tiny, tiny_corpus\n"
        f"cell = tiny({WORKLOAD!r})\n"
        "res = run.execute(cell, 5, 0.001, False, device='cpu', t_start=0.0,"
        " corpus=tiny_corpus(cell, 5), log=lambda m: None)\n"
        "assert res['correct'], res\n"
        "assert 'zstd_tpu_torch' in sys.modules\n"
        "print('FORBIDDEN', run.forbidden_modules())\n"
    )
    p = _python(code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stdout


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys\n"
        "import portbench.reference.compare\n"
        "top = {m.split('.', 1)[0] for m in sys.modules}\n"
        "print('LOADED', sorted(top & {'zstd_tpu_torch', 'zstd_tpu', 'jax', 'torch'}))\n"
    )
    p = _python(code)
    assert p.returncode == 0, p.stderr
    assert "LOADED []" in p.stdout


def test_run_exits_nonzero_without_a_card():
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", WORKLOAD,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env={**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 1 CUDA card" in p.stderr


def test_run_fails_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files."""
    shutil.copy(f"{REPO}/BENCHMARK.json", tmp_path)
    shutil.copytree(f"{REPO}/portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _python(
        "from portbench import run, spec\n"
        "from portbench.tests.conftest import tiny, tiny_corpus\n"
        f"cell = tiny({WORKLOAD!r})\n"
        "run.execute(cell, 5, 0.001, False, device='cpu', t_start=0.0, corpus=tiny_corpus(cell, 5))\n",
        cwd=str(tmp_path))
    assert p.returncode != 0 and "zstd_tpu_torch" in p.stderr
