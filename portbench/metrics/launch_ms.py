"""The engine's launch span (``wall_s["launch"]``: host time that builds
the lane columns and queues the uploads, the kernel launches, the copies
back to pinned buffers and their events) per request, in ms."""


def read(run):
    return run.span_ms("launch")
