"""Host milliseconds a traced step in the model's forward in training mode:
the self time of the system's ``train.step.forward`` spans
(``spans.host_ms``)."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "train.step.forward")
