"""Per-lane results of an engine, for holding one engine to another lane
by lane (the tests and ``chip_smoke.py``)."""

from __future__ import annotations

import numpy as np


def engine_lanes(eng, plan):
    """One plan through an engine's own launch and land (``_launch``, the
    wait and unpack of ``_land``, then ``_retry_sequences``): ((literal
    outs, ok), pre-retry (sequence outs, ok), post-retry (sequence outs,
    ok))."""
    staged = eng._launch(plan)
    own = vars(eng).get("_retry_sequences")
    eng._retry_sequences = lambda *a: None  # the lanes as the unpack leaves them
    try:
        lit, (seq_outs, seq_ok) = eng._land(staged)
    finally:
        if own is None:
            del eng._retry_sequences
        else:
            eng._retry_sequences = own
    pre = (list(seq_outs), seq_ok.copy())
    eng._retry_sequences(plan, seq_outs, seq_ok)
    return lit, pre, (seq_outs, seq_ok)


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(b, tuple):
        return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def differing_lanes(got, want) -> list[int]:
    """Lanes whose output (None, a byte array or an (ll, ofv, ml) tuple)
    or ok flag differ, with tolerance 0, between two (outs, ok) pairs of
    one plan; every lane when the lane counts differ."""
    (go, gk), (wo, wk) = got, want
    if not len(go) == len(wo) == len(gk) == len(wk):
        return list(range(max(len(go), len(wo), len(gk), len(wk))))
    return [i for i, (g, w, a, b) in enumerate(zip(go, wo, gk, wk))
            if not (_same(g, w) and bool(a) == bool(b))]


def lane_diffs(got, want) -> int:
    """How many lanes differ (``differing_lanes``)."""
    return len(differing_lanes(got, want))


def assert_lanes_equal(got_outs, got_ok, want_outs, want_ok, what: str) -> None:
    """Raise AssertionError naming the first lanes that differ."""
    bad = differing_lanes((got_outs, got_ok), (want_outs, want_ok))
    assert not bad, f"{what}: {len(bad)} lanes differ, first {bad[:8]}"
