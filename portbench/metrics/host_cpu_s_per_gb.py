"""The process's CPU seconds (user and system, all threads) over the
window, per GB (10^9 bytes) decoded."""


def read(run):
    gb = run.bytes_out / 1e9
    return run.cpu_s / gb if gb else None
