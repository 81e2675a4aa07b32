"""Device idle milliseconds a traced call in the gaps that began while the
system's ``serve.predict.nms`` span was the innermost one open
(``spans.idle_ms``): ``predict``'s top-k cut and NMS."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, "serve.predict.nms")
