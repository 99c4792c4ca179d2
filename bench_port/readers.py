"""Arithmetic shared by the per-layer metrics' readers
(``bench_port/metrics/<name>.py``).  Each returns None where the run
holds nothing to read."""

from __future__ import annotations

import statistics

from bench_port import peaks


def median(values):
    return statistics.median(values) if values else None


def mfu(ctx):
    """The model's FLOPs over the traced window, as a share (%) of the
    card's dense peak in the configuration's compute precision."""
    t = ctx.trace
    if t is None or t["window_s"] <= 0 or ctx.traced.images == 0:
        return None
    done = ctx.session.model_flops_per_image() * ctx.traced.images
    return 100.0 * done / t["window_s"] / peaks.compute_peak(ctx.card,
                                                             ctx.cfg)


def conv_ms_per_img(ctx):
    t = ctx.trace
    if t is None or t["conv_s"] <= 0 or ctx.traced.images == 0:
        return None
    return 1e3 * t["conv_s"] / ctx.traced.images


def idle_share(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline(ctx, wrapper: str):
    """The kernel's least time over its device time, summed over its
    launches in the traced window (%)."""
    t = ctx.trace
    if t is None or wrapper not in t["port"]:
        return None
    count, seconds = t["port"][wrapper]
    bounds = ctx.session.kernel_bounds(ctx.card, ctx.traced.calls_run)
    if wrapper not in bounds or seconds <= 0:
        return None
    expected, bound_s = bounds[wrapper]
    if expected != count:
        return None
    return 100.0 * bound_s / seconds
