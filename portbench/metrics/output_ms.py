"""The engine's output span (``wall_s["output"]``: the decoded
bytearray copied to ``bytes``, after the engine's ``total`` and inside the
request's latency) per request, in ms."""


def read(run):
    return run.span_ms("output")
