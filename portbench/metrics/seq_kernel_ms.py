"""Device milliseconds per request of every profiler device event whose
name holds ``sequences_kernel``, over the traced window."""


def read(run):
    t = run.trace
    if t is None or not t.requests:
        return None
    s = t.device_s_named("sequences_kernel")
    return 1e3 * s / t.requests if s else None
