"""K2 + K3's least time a step (``yardstick.bn_step_ms``: each BatchNorm's
input read once and its sums written once, at the traced batch in bf16)
over their traced device time, in percent. Left out where the trace's K2
and K3 launches are not the step's."""

from portbench import yardstick

KINDS = ("bn_stats", "bn_grad_stats")


def read(ctx):
    t = ctx.trace
    if not ctx.window["train"] or not t.complete:
        return None
    least_ms, launches = yardstick.bn_step_ms(ctx.config, ctx.batch, 2)
    if sum(t.traced[k] for k in KINDS) != launches * t.calls:
        return None
    return least_ms * t.calls / (t.port_kernel_us(KINDS) / 1e3) * 100.0
