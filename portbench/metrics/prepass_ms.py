"""The engine's prepass span (``wall_s["prepass"]``: parsing frame
groups into batch plans) per request, in ms."""


def read(run):
    return run.span_ms("prepass")
