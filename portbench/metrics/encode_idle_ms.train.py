"""Device idle milliseconds a traced step in the gaps that began while the
system's ``train.step.encode`` span was the innermost one open
(``spans.idle_ms``): the encoding of the augmented boxes into the head's
target grids."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, "train.step.encode")
