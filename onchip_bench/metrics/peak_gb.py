"""``peak_gb``: ``torch.cuda.max_memory_allocated`` over the window (reset at
its start), in units of 1e9 bytes."""


def read(ctx):
    return ctx.window["peak_bytes"] / 1e9
