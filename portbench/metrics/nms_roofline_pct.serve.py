"""K1's least time a call (``yardstick.nms_ms`` over the served batch and
its candidates after the cut) over its traced device time, in percent.
Left out where the trace does not hold one K1 launch a call."""

from portbench import yardstick


def candidates(cfg: dict) -> int:
    """Rows decoding gives an image, cut to ``eval.max_candidates``."""
    g, m = cfg["grid"], cfg["model"]
    if m["head"] == "fpn":
        per = len(g["anchors"]) // m["fpn_scales"]
        n = sum((g["grid"] * 2 ** s) ** 2 * per
                for s in range(m["fpn_scales"]))
    else:
        n = g["grid"] ** 2
    cut = cfg["eval"]["max_candidates"]
    return min(n, cut) if cut else n


def read(ctx):
    t = ctx.trace
    if ctx.window["train"] or not t.complete or t.traced["nms"] != t.calls:
        return None
    least_ms = yardstick.nms_ms(ctx.batch, candidates(ctx.config))
    return least_ms * t.calls / (t.port_kernel_us(("nms",)) / 1e3) * 100.0
