"""Host milliseconds a traced call in ``predict``'s forward (the copy to the
device, preprocessing and the model; both passes with TTA): the self time of
the system's ``serve.predict.forward`` spans (``spans.host_ms``)."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "serve.predict.forward")
