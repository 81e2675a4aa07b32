"""Host milliseconds a traced call in ``predict``'s top-k cut and NMS: the
self time of the system's ``serve.predict.nms`` spans
(``spans.host_ms``)."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "serve.predict.nms")
