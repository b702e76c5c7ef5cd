from .bits import (
    BackwardBitCursor,
    ForwardBitCursor,
    ForwardByteCursor,
    backward_start_bitpos,
)
from .xxh64 import xxh64
from . import errors

__all__ = [
    "BackwardBitCursor",
    "ForwardBitCursor",
    "ForwardByteCursor",
    "backward_start_bitpos",
    "xxh64",
    "errors",
]
