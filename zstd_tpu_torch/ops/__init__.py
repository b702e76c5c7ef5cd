from . import fse, huffman, lz77, sequence_codes

__all__ = ["fse", "huffman", "lz77", "sequence_codes"]
