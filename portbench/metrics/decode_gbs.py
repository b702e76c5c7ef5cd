"""Decompressed bytes of every request completed in the window over the
window's seconds, in GB/s (10^9 bytes)."""


def read(run):
    return run.bytes_out / run.window_s / 1e9 if run.requests else None
