"""The system's own host spans in a checked trace (``trace.Trace.spans``,
which holds every ``train.`` and ``serve.`` span, the benchmark's and the
system's): each stage's host self time and the device's idle gaps that
began while the stage was the innermost open span, a traced step or call.

The system opens its spans inside the benchmark's ``train.dispatch`` and
``serve.predict``, so the traced window, and with it every other metric,
reads the same with or without them. A system without a span of the name
gives None: the metric is left out of the result."""

from __future__ import annotations

from typing import Optional


def host_ms(trace, name: str) -> Optional[float]:
    """Self time of the spans called ``name``: each one's duration less the
    part of it that other spans nested inside it cover, summed and divided
    by the traced calls, in milliseconds. None where no span has the
    name."""
    own = [(s, e) for s, e, n in trace.spans if n == name]
    if not own:
        return None
    total = 0.0
    for s, e in own:
        covered, reach = 0.0, s
        for a, b, n in trace.spans:  # in order of their starts
            if s <= a and b <= e and (a, b, n) != (s, e, name) and b > reach:
                covered += b - max(a, reach)
                reach = b
        total += (e - s) - covered
    return total / trace.calls / 1e3


def idle_ms(trace, name: str) -> Optional[float]:
    """The device's idle time in the gaps that ``trace.idle_gaps`` names
    by ``name`` (the innermost span open when the gap began), divided by
    the traced calls, in milliseconds; 0.0 where the span holds no gap.
    None where no span has the name or the trace holds no device event."""
    if not trace.device or all(n != name for _, _, n in trace.spans):
        return None
    return sum(us for n, us in trace.idle_gaps() if n == name) \
        / trace.calls / 1e3
