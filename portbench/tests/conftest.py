"""Helpers for the benchmark's tests: a cell cut to a size the CPU runs
in seconds (the kernels' plain PyTorch forms)."""

import functools

import pytest

from portbench import inputs, spec

TINY_FRAME = 16384
TINY_CHUNKS = 6


def tiny(name: str) -> spec.Cell:
    """Cell ``name`` with 16 KiB chunks."""
    cell = spec.load(name)
    cell.config["frame_bytes"] = TINY_FRAME
    return cell


@functools.cache
def content_of(name: str) -> bytes:
    return inputs.content(name)


def tiny_corpus(cell: spec.Cell, seed: int, offset: int = 0) -> inputs.Corpus:
    """``cell``'s corpus over six of its content's chunks, from ``offset``:
    requests of three 16 KiB chunks."""
    raw = content_of(cell.traffic["content"])[offset : offset + TINY_CHUNKS * TINY_FRAME]
    return inputs.make_corpus(cell, seed, raw)


@pytest.fixture
def cuda_device():
    """cuda:0, or a skip where this machine has no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
