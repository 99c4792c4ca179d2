"""Device kernels in the traced window over its photos, launches an image."""


def read(ctx):
    if ctx.trace is None or ctx.traced.images == 0:
        return None
    return ctx.trace["kernels"] / ctx.traced.images
