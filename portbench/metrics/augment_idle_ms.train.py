"""Device idle milliseconds a traced step in the gaps that began while the
system's ``train.step.augment`` span was the innermost one open
(``spans.idle_ms``): the step's augmentation (mosaic, mixup where the config
has them, then ``augment_batch``'s flip, colour and crop)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, "train.step.augment")
