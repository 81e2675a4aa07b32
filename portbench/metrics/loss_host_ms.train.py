"""Host milliseconds a traced step in the loss terms from the target and
predicted grids: the self time of the system's ``train.step.loss`` spans
(``spans.host_ms``)."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "train.step.loss")
