"""The engine's assembly span (``wall_s["assembly"]``: the C executor,
XXH64 checks and any oracle fallback) per request, in ms."""


def read(run):
    return run.span_ms("assembly")
