"""Mean host milliseconds of the serve call, from its start to its return
(no wait for the device), over the window of the traced run: the host's
share of each call."""


def read(ctx):
    w = ctx.window
    if w["train"] or not w["dispatch_s"]:
        return None
    return sum(w["dispatch_s"]) / len(w["dispatch_s"]) * 1e3
