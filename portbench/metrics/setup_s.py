"""Seconds from the process's start to the window's first call: imports,
CUDA start-up, kernel builds, input generation and compression, and the
warm-up decodes."""


def read(run):
    return run.setup_s
