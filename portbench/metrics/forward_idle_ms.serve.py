"""Device idle milliseconds a traced call in the gaps that began while the
system's ``serve.predict.forward`` span was the innermost one open
(``spans.idle_ms``): ``predict``'s forward (the copy to the device,
preprocessing and the model; both passes with TTA)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, "serve.predict.forward")
