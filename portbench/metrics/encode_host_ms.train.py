"""Host milliseconds a traced step in the encoding of the augmented boxes
into the head's target grids: the self time of the system's
``train.step.encode`` spans (``spans.host_ms``)."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "train.step.encode")
