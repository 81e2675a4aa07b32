"""Host milliseconds a traced step in the ``backward()`` call of the loss:
the self time of the system's ``train.step.backward`` spans
(``spans.host_ms``)."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "train.step.backward")
