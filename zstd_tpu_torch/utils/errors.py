"""Structured error taxonomy for the TPU-native ZSTD codec.

Mirrors the reference's seven per-layer ``thiserror`` enums
(zstd-decompressor/src: parsing.rs:11-25, frame.rs:13-39,
block.rs:11-25, literals.rs:7-17, sequences.rs:13-23, decoders/mod.rs:9-23,
decoding_context.rs:7-15) as a Python exception hierarchy.  Host-side
validation raises these; device kernels instead report per-block status
codes that the runtime converts back into these exceptions.
"""

from __future__ import annotations


class ZstdError(Exception):
    """Base class for all codec errors."""


# --- bitstream / byte parsing (parsing.rs:11-25) ---------------------------


class ParsingError(ZstdError):
    pass


class NotEnoughBytes(ParsingError):
    def __init__(self, requested: int, available: int):
        super().__init__(
            f"not enough bytes: {requested} requested, {available} available"
        )
        self.requested = requested
        self.available = available


class NotEnoughBits(ParsingError):
    def __init__(self, requested: int, available: int):
        super().__init__(
            f"not enough bits: {requested} requested, {available} available"
        )
        self.requested = requested
        self.available = available


class EmptyInput(ParsingError):
    """Backward bitstream constructed over an empty buffer (parsing.rs:201-203)."""


class MissingSentinel(ParsingError):
    """Backward bitstream whose final byte is zero (no sentinel bit, parsing.rs:204-206)."""


# --- frame layer (frame.rs:13-39) ------------------------------------------


class FrameError(ZstdError):
    pass


class UnrecognizedMagic(FrameError):
    def __init__(self, magic: int):
        super().__init__(f"unrecognized frame magic: {magic:#010x}")
        self.magic = magic


class ReservedBitSet(FrameError):
    pass


class WindowTooLarge(FrameError):
    def __init__(self, got: int, maximum: int):
        super().__init__(f"window size too large: {got} > max {maximum}")
        self.got = got
        self.maximum = maximum


class ChecksumMismatch(FrameError):
    """Content checksum mismatch.

    The reference only warns on stderr (frame.rs:251-254); we raise by
    default and allow opting out (``verify_checksum=False``).
    """

    def __init__(self, computed: int, stored: int):
        super().__init__(
            f"content checksum mismatch: computed {computed:#010x}, stored {stored:#010x}"
        )
        self.computed = computed
        self.stored = stored


# --- block layer (block.rs:11-25) ------------------------------------------


class BlockError(ZstdError):
    pass


class ReservedBlockType(BlockError):
    pass


class BlockSizeTooLarge(BlockError):
    pass


# --- literals section (literals.rs:7-17) ------------------------------------


class LiteralsError(ZstdError):
    pass


class MissingHuffmanTable(LiteralsError):
    """Treeless literals block with no previously-installed table (literals.rs:63-66)."""


class StreamSizesTooBig(LiteralsError):
    """4-stream jump table sizes exceed the section (literals.rs:115-117)."""


# --- sequences section (sequences.rs:13-23) ---------------------------------


class SequencesError(ZstdError):
    pass


class ReservedModeBits(SequencesError):
    """Low 2 bits of the compression-modes byte set (sequences.rs:96-99)."""


class NoPreviousTable(SequencesError):
    """Repeat mode with no previous table in the context (sequences.rs:165-171)."""


# --- entropy decoders (decoders/mod.rs:9-23) --------------------------------


class DecoderError(ZstdError):
    pass


class CorruptedTable(DecoderError):
    """FSE distribution does not sum to the table size (fse.rs:64-66)."""


class AccuracyLogTooLarge(DecoderError):
    def __init__(self, al: int, maximum: int):
        super().__init__(f"FSE accuracy log {al} exceeds max {maximum}")
        self.al = al
        self.maximum = maximum


class SymbolCodeTooLarge(DecoderError):
    """Sequence code above the LL/ML/OF maxima (sequence.rs:46-48, 95-97)."""


class CorruptedHuffman(DecoderError):
    """Huffman weights do not complete to a power of two (huffman.rs:177-203)."""


# --- decoding context / sequence execution (decoding_context.rs:7-15) --------


class ContextError(ZstdError):
    pass


class NullOffset(ContextError):
    """Offset value of zero (decoding_context.rs:52)."""


class ImpossibleValue(ContextError):
    """Sequence references data outside what has been decoded (decoding_context.rs:86-90)."""
