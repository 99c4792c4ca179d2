"""1 - the union of the device's kernel and copy intervals over the traced window, %."""

from bench_port.readers import idle_share


def read(ctx):
    return idle_share(ctx)
