"""Host milliseconds a traced step in the step's augmentation (mosaic, mixup
where the config has them, then ``augment_batch``'s flip, colour and crop):
the self time of the system's ``train.step.augment`` spans
(``spans.host_ms``)."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "train.step.augment")
