"""The engine's input-words span (``wall_s["words"]``: the input as u32
words and their upload to the card) per request, in ms."""


def read(run):
    return run.span_ms("words")
