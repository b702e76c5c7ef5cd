"""The engine's execute span (``wall_s["execute"]``: each frame's
rebuilding from its lanes' literals and sequences, where matches copy
from earlier blocks of the frame; a part of ``assembly_ms``) per
request, in ms."""


def read(run):
    return run.span_ms("execute")
