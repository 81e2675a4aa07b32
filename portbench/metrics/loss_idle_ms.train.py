"""Device idle milliseconds a traced step in the gaps that began while the
system's ``train.step.loss`` span was the innermost one open
(``spans.idle_ms``): the loss terms from the target and predicted grids."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, "train.step.loss")
