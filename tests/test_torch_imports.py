"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its engine runs on the card unless asked for the CPU."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "zstd_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "zstd_tpu")


def _imported_roots(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    assert not (_imported_roots(path) & set(FORBIDDEN)), path


def test_import_leaves_jax_and_reference_out():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )
    code = f"""
import importlib, importlib.util, sys
for m in {modules!r}:
    importlib.import_module(m)
spec = importlib.util.spec_from_file_location("chip_smoke", {str(REPO / "chip_smoke.py")!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)  # defines main() without running it
assert callable(mod.main)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print("FORBIDDEN", bad)
assert not bad, bad
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "FORBIDDEN []" in res.stdout


def test_default_device_is_cuda_and_raises_without_it():
    from zstd_tpu_torch.runtime.engine import DeviceEngine, resolve_device

    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceEngine(device="cuda")
    assert DeviceEngine(device="cpu").device == torch.device("cpu")
