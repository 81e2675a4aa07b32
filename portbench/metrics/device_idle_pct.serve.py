"""Share of the traced window in which the busiest device lane ran
nothing: from the first traced call's host span to the end of the last
span or device event."""


def read(ctx):
    t = ctx.trace
    if ctx.window["train"] or not t.device:
        return None
    lo, hi = t.window_us
    return (1.0 - t.busy_us() / (hi - lo)) * 100.0
