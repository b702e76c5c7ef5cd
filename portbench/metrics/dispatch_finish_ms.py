"""The engine's ``wall_s["kernels"]`` per request, in ms.  The engine
takes it as the rest of the call after prepass and assembly, so it holds
the uploads, launches, waits on the card, fetches, the host's unpacking
of the lanes and the wide retry: little of it is kernel time."""


def read(run):
    return run.span_ms("kernels")
