"""The inputs: the content file as described, a corpus deterministic per
seed and different across seeds, every pass dealing every chunk once,
frames that libzstd decodes, and the entropy-work count of the
roofline."""

import json

import numpy as np
import pytest

from portbench import inputs, libzstd, sections, spec

from .conftest import TINY_CHUNKS, TINY_FRAME, content_of, tiny, tiny_corpus

WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]


def test_content_matches_its_description():
    for name in {spec.load(w).traffic["content"] for w in WORKLOADS}:
        desc = json.loads((inputs.CONTENT / f"{name}.json").read_text())
        raw = content_of(name)
        assert len(raw) == desc["bytes"] and raw[257:262] == b"ustar"  # a tar, as described
        assert len(desc["source"]) <= 200


def test_corpus_is_deterministic_and_seeded():
    cell = tiny(WORKLOADS[0])
    a, b = tiny_corpus(cell, 2**31 + 7), tiny_corpus(cell, 2**31 + 7)
    assert a.frames == b.frames and [a.request(i) for i in range(4)] == [b.request(i) for i in range(4)]
    c = tiny_corpus(cell, 2**40 + 8)
    assert c.raw != a.raw and c.request(0) != a.request(0)
    assert b"".join(c.raw) != b"".join(a.raw)  # rotated by another offset
    assert sorted(b"".join(c.raw)) == sorted(b"".join(a.raw))  # of the same bytes


def test_every_pass_deals_every_chunk_once():
    corpus = tiny_corpus(tiny(WORKLOADS[0]), -3)
    b = corpus.batches_per_file
    assert b == 2
    for p in range(3):
        orders = [corpus.order(p * b + k) for k in range(b)]
        assert sorted(np.concatenate(orders)) == list(range(TINY_CHUNKS))
        assert [len(o) for o in orders] == [TINY_CHUNKS // b] * b
    full = inputs.Corpus(raw=[], frames=[k.to_bytes(2, "little") for k in range(311)], work=[],
                         batches_per_file=2, seed=-3)  # the chunk count of a cell
    assert len({full.request(i) for i in range(1000)}) == 1000  # no request repeats


@pytest.mark.parametrize("workload", WORKLOADS)
def test_requests_decode_to_their_expected_bytes(workload):
    cell = tiny(workload)
    corpus = tiny_corpus(cell, 2**31 + 3, offset=5 << 20)
    for raw, frame in zip(corpus.raw, corpus.frames):
        assert libzstd.decompress(frame, TINY_FRAME) == raw
    for i in range(4):
        expected = corpus.expected(i)
        assert len(expected) == TINY_CHUNKS // 2 * TINY_FRAME
        assert libzstd.decompress(corpus.request(i), len(expected)) == expected
        assert corpus.entropy_bytes(i) == sum(sections.frame_work(corpus.frames[j]).bytes
                                              for j in corpus.order(i))


@pytest.mark.parametrize("level,frame", [(3, 1 << 20), (19, 1 << 20), (3, 65536), (1, 65536)])
def test_entropy_work_matches_the_ports_parser(level, frame):
    """The count from the headers against a second witness, the port's own
    frame parser (the count itself reads nothing of the program)."""
    from zstd_tpu_torch.format.block import BlockType
    from zstd_tpu_torch.format.frame import iter_frames
    from zstd_tpu_torch.format.literals import LiteralsType

    raw = content_of(spec.load(WORKLOADS[0]).traffic["content"])[3 << 20 : 5 << 20]
    data = b"".join(libzstd.compress(raw[i : i + frame], level, checksum=True)
                    for i in range(0, len(raw), frame))
    work = sections.frame_work(data)
    regen = nseq = lit_in = 0
    for f in iter_frames(data):
        for blk in f.blocks:
            if blk.btype != BlockType.COMPRESSED:
                continue
            lit = blk.literals
            if lit.ltype in (LiteralsType.COMPRESSED, LiteralsType.TREELESS):
                regen += lit.regenerated_size
                jump_table = 6 if len(lit.streams) == 4 else 0
                lit_in += len(lit.huffman_payload or b"") + jump_table + sum(len(s) for s in lit.streams)
            nseq += blk.sequences.num_sequences
    assert (work.literal_in, work.literal_out, work.sequences) == (lit_in, regen, nseq)
    assert work.bytes == work.literal_in + work.literal_out + work.sequence_in + 12 * nseq
