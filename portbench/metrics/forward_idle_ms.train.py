"""Device idle milliseconds a traced step in the gaps that began while the
system's ``train.step.forward`` span was the innermost one open
(``spans.idle_ms``): the model's forward in training mode."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, "train.step.forward")
