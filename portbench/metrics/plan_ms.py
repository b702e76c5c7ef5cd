"""The engine's batch-plan span (``wall_s["plan"]``: ``build_batch_plan``
of each frame group) per request, in ms; with ``parse_ms`` it makes
``prepass_ms``."""


def read(run):
    return run.span_ms("plan")
