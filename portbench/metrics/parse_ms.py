"""The engine's frame-parse span (``wall_s["parse"]``: ``parse_frame`` of
each frame group's frames) per request, in ms; with ``plan_ms`` it makes
``prepass_ms``."""


def read(run):
    return run.span_ms("parse")
