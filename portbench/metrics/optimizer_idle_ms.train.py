"""Device idle milliseconds a traced step in the gaps that began while the
system's ``train.step.optimizer`` span was the innermost one open
(``spans.idle_ms``): the optimizer's update of every parameter and the EMA
where it is on."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, "train.step.optimizer")
