"""Device milliseconds a traced step of PyTorch's elementwise kernels (the
kernel function names that end in ``elementwise_kernel``), from the
trace: the work between the convolutions, whichever layer launched it."""


def read(ctx):
    t = ctx.trace
    if not ctx.window["train"] or not t.complete:
        return None
    us = sum(v for k, v in t.by_category().items()
             if k.endswith("elementwise_kernel"))
    return us / t.calls / 1e3
