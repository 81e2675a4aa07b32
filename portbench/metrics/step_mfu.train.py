"""Model FLOPs of the window's images over the window's time, as a share
of the H100's 989 TFLOP/s dense bf16 peak (at the power limit the result's
``device.power_limit_w`` states). FLOPs from the layers' shapes
(``yardstick.model_flops``: forward, weight and input gradients)."""

from portbench import yardstick


def read(ctx):
    w = ctx.window
    if not w["train"] or not w["images"]:
        return None
    flops = yardstick.model_flops(ctx.config, True) * w["images"]
    return flops / w["seconds"] / yardstick.BF16_FLOPS * 100.0
