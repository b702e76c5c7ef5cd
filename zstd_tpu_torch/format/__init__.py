from .frame import (
    MAX_WINDOW_SIZE,
    Frame,
    FrameHeader,
    SkippableFrame,
    ZstdFrame,
    iter_frames,
    parse_frame,
    parse_frame_header,
)
from .block import BlockDesc, BlockType, parse_block
from .literals import LiteralsDesc, LiteralsType, parse_literals_section
from .sequences import (
    SeqMode,
    SeqModeDesc,
    SequencesDesc,
    parse_num_sequences,
    parse_sequences_section,
)

__all__ = [
    "MAX_WINDOW_SIZE",
    "Frame",
    "FrameHeader",
    "SkippableFrame",
    "ZstdFrame",
    "iter_frames",
    "parse_frame",
    "parse_frame_header",
    "BlockDesc",
    "BlockType",
    "parse_block",
    "LiteralsDesc",
    "LiteralsType",
    "parse_literals_section",
    "SeqMode",
    "SeqModeDesc",
    "SequencesDesc",
    "parse_num_sequences",
    "parse_sequences_section",
]
