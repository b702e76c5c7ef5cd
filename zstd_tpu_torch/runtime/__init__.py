from .context import DecodingContext, TableSpec
from .oracle import decode_frame, decompress

__all__ = ["DecodingContext", "TableSpec", "decode_frame", "decompress"]
