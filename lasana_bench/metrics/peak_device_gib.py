"""``torch.cuda.max_memory_allocated`` over the window (reset after
set-up), in GiB."""


def read(ctx):
    return ctx.window_peak_bytes / 2 ** 30
