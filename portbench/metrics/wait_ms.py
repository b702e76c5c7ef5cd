"""The engine's wait span (``wall_s["wait"]``: the host blocked on a
frame group's CUDA events) per request, in ms."""


def read(run):
    return run.span_ms("wait")
