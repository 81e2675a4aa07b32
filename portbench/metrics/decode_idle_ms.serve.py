"""Device idle milliseconds a traced call in the gaps that began while the
system's ``serve.predict.decode`` span was the innermost one open
(``spans.idle_ms``): ``predict``'s decode of the grids into candidate rows
(with TTA's un-flip and concatenation)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, "serve.predict.decode")
