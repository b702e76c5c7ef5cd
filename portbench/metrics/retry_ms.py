"""The engine's retry span (``wall_s["retry"]``: the wide re-decode of
the sequence lanes that overflowed the packed fields, its copies back
included) per request, in ms."""


def read(run):
    return run.span_ms("retry")
