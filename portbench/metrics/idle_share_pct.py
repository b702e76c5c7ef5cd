"""100 x (1 - device busy / traced window): the share of the traced
window in which no device event ran (busy time is the union of the
device events' intervals)."""


def read(run):
    t = run.trace
    if t is None or not t.window_s or not t.busy_s:
        return None
    return 100 * (1 - t.busy_s / t.window_s)
