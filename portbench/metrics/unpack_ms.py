"""The engine's unpack span (``wall_s["unpack"]``: ``_finish_literals``
and ``_finish_sequences``, the host's numpy unpacking of every lane) per
request, in ms."""


def read(run):
    return run.span_ms("unpack")
