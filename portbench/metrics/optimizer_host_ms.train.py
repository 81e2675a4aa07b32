"""Host milliseconds a traced step in the optimizer's update of every
parameter and the EMA where it is on: the self time of the system's
``train.step.optimizer`` spans (``spans.host_ms``)."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "train.step.optimizer")
