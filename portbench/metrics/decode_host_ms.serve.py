"""Host milliseconds a traced call in ``predict``'s decode of the grids into
candidate rows (with TTA's un-flip and concatenation): the self time of the
system's ``serve.predict.decode`` spans (``spans.host_ms``)."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "serve.predict.decode")
