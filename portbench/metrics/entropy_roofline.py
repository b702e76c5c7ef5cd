"""The entropy stage's share of its roofline, in %: the least time the
card's memory could move the bytes the traced requests' entropy stage
needs (``sections.EntropyWork``, counted from the inputs' headers), over
the device time of every kernel (copies and fills left out) in the
traced window.  The byte count does not depend on the kernels that do
the work, so a fused or split kernel leaves the metric comparable."""


def read(run):
    t = run.trace
    if t is None or not t.kernel_s or run.peaks is None or t.requests != len(run.requests):
        return None
    need = sum(r.entropy_bytes for r in run.requests)
    return 100 * need / run.peaks["hbm_bytes_per_s"] / t.kernel_s if need else None
