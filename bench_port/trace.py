"""Reduction of a ``torch.profiler`` trace of the traced window to the
numbers the per-layer metrics read.

From the raw kineto events (no ``key_averages``, which is slow on traces
of a few hundred thousand launches):

* ``busy_s``: the union of the device's kernel, copy and set intervals
  (not the ranges of host annotations on the device's timeline);
* kernel launches, and the device time and count of each of the
  program's own kernels (``PORT_KERNELS``, by the kernel's name);
* ``conv_s``: the device time of kernels launched under a CPU op whose
  name, or an enclosing op's name, holds "convolution" (cuDNN's
  forward and backward, their bias adds and format changes);
* the device operations that took most time, and the idle gaps between
  device work, named by the innermost host op running at the gap's
  middle.
"""

from __future__ import annotations

import heapq
import re
from collections import defaultdict

import torch

# the program's kernels: trace name pattern -> launch wrapper.  The serving
# and training walks are one template, told apart by its argument
# (``enum class Walk { kServe, kTrain, kEnvmap }``), which the demangler
# prints as the enumerator or as ``(Walk)<n>``.
PORT_KERNELS = (
    (re.compile(r"bilateral_blur_kernel"), "bilateral_blur"),
    (re.compile(r"render_sg_bwd_kernel"), "render_sg_bwd"),
    (re.compile(r"sg_envmap_bwd_kernel"), "sg_envmap_bwd"),
    (re.compile(r"sg_render_walk_kernel<.*?(kServe|Walk\)\s*0)"),
     "render_sg_env"),
    (re.compile(r"sg_render_walk_kernel<.*?(kTrain|Walk\)\s*1)"),
     "render_sg_fwd"),
    (re.compile(r"sg_render_walk_kernel<.*?(kEnvmap|Walk\)\s*2)"),
     "sg_envmap_fwd"),
)
# names that look like the program's kernels, kept for a failed guard
_PORT_HINT = re.compile(r"walk|blur|render_sg|sg_envmap")
_PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")


def port_kernel(name: str):
    for pattern, wrapper in PORT_KERNELS:
        if pattern.search(name):
            return wrapper
    return None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def union_s(spans) -> tuple:
    """(busy seconds, merged [(start_ns, end_ns)]) of intervals in ns."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) / 1e9, merged


def _conv_ops(cpu):
    """Correlation ids of CPU ops that are, or run inside, an op named
    ``*convolution*`` (nesting by time, per thread)."""
    marked = set()
    by_thread = defaultdict(list)
    for start, end, name, corr, tid in cpu:
        by_thread[tid].append((start, -end, name, corr))
    for ops in by_thread.values():
        ops.sort()
        stack = []  # (end, under_conv)
        for start, neg_end, name, corr in ops:
            end = -neg_end
            while stack and stack[-1][0] <= start:
                stack.pop()
            under = "convolution" in name or (stack and stack[-1][1])
            if under:
                marked.add(corr)
            stack.append((end, bool(under)))
    return marked


def _gap_hosts(merged, cpu, t0, t1):
    """{host op name: idle seconds} over the gaps of ``merged`` inside
    [t0, t1]."""
    gaps = []
    edge = t0
    for a, b in merged:
        if a > edge:
            gaps.append((edge, min(a, t1)))
        edge = max(edge, b)
    if edge < t1:
        gaps.append((edge, t1))
    ops = sorted((s, e, n) for s, e, n, _, _ in cpu)
    out, heap, i = defaultdict(float), [], 0
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) // 2
        while i < len(ops) and ops[i][0] <= mid:
            heapq.heappush(heap, (-ops[i][0], ops[i][1], ops[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        host = heap[0][2] if heap else "(no host op)"
        out[host] += (b - a) / 1e9
    return out


WINDOW = "bench_port.window"


def reduce(prof) -> dict:
    """The summary of a profile whose traced window is the host op
    :data:`WINDOW` (a ``record_function`` that ends at a synchronize):
    ``busy_s`` inside it, ``window_s``, ``kernels`` (launch count),
    ``copies``,
    ``port`` {wrapper: [count, device s]}, ``conv_s``, ``device_ops``
    [[name, s]] and ``idle_gaps`` [[host op, s]], ten each."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    t0_ns = t1_ns = None
    events = list(prof.profiler.kineto_results.events())
    # the range a host annotation (``record_function``) spans on the
    # device's timeline carries the annotation's name; it is no operation
    host_names = {e.name() for e in events
                  if e.device_type() != DeviceType.CUDA}
    for e in events:
        name = e.name()
        on_device = e.device_type() == DeviceType.CUDA
        if name == WINDOW:
            if not on_device:
                t0_ns, t1_ns = e.start_ns(), e.end_ns()
            continue
        if on_device:
            if name in _PROFILER_OWN or name in host_names:
                continue
            dev.append((e.start_ns(), e.end_ns(), name,
                        e.linked_correlation_id()))
        elif e.device_type() == DeviceType.CPU and not e.is_async():
            cpu.append((e.start_ns(), e.end_ns(), name, e.correlation_id(),
                        e.start_thread_id()))
    if t0_ns is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    dev = [(max(a, t0_ns), min(b, t1_ns), n, c) for a, b, n, c in dev
           if b > t0_ns and a < t1_ns]
    busy, merged = union_s((a, b) for a, b, _, _ in dev)
    conv_ops = _conv_ops(cpu)
    port = defaultdict(lambda: [0, 0.0])
    by_name = defaultdict(float)
    kernels = copies = 0
    conv_s = 0.0
    unmatched = set()
    for a, b, name, link in dev:
        dur = (b - a) / 1e9
        by_name[name] += dur
        if is_copy(name):
            copies += 1
            continue
        kernels += 1
        wrapper = port_kernel(name)
        if wrapper is not None:
            port[wrapper][0] += 1
            port[wrapper][1] += dur
        elif _PORT_HINT.search(name):
            unmatched.add(name[:200])
        if link in conv_ops:
            conv_s += dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = _gap_hosts(merged, cpu, t0_ns, t1_ns)
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": (t1_ns - t0_ns) / 1e9,
            "kernels": kernels, "copies": copies,
            "port": {k: list(v) for k, v in port.items()}, "conv_s": conv_s,
            "unmatched": sorted(unmatched),
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n[:160], s] for n, s in top_gaps]}


def profile():
    """A profiler of the host and the device, recording nothing but
    events (no shapes, stacks or memory)."""
    from torch.profiler import ProfilerActivity

    return torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
