"""Named spans of the port's work, recorded while a ``torch.profiler`` runs.

``span(name, device=None)`` marks a stretch of host work:

* with no profiler recording (``torch.autograd.profiler._is_profiler_enabled``
  False) it is one shared no-op context: nothing is made or kept;
* under ``torch.profiler.profile`` it opens
  ``torch.profiler.record_function("irois." + name)``, so the span is a
  range of the profiler's trace beside the operators and kernels it
  launches, and keeps a :class:`Record` in memory: its host interval in
  ``time.time_ns()`` (the clock the trace's host events are stamped on),
  the enclosing span on the same thread, the number of the enclosing
  ``train.step`` (shared by the spans of one step on every thread,
  autograd's backward thread too) and, where ``device`` is a CUDA device,
  a pair of timing events on the current stream.

The spans: ``train.step`` around a train step's call, and inside it
``train.forward`` (the loss), ``train.backward`` (the gradients, summed
over the ranks) and ``train.optimizer`` (Adam and the rate schedule), in
``train/steps.py``; ``kernel.<wrapper>`` around each hand-written
kernel's launch in ``ops/sg_render.py`` and ``ops/bilateral.py``, host
only.

To read them, run the work under ``torch.profiler.profile`` and then call
:func:`records` (and :func:`device_ms` of a record), or view the
``irois.*`` ranges in the trace that ``export_chrome_trace`` writes.
The records stay in a bounded buffer (the newest :data:`CAPACITY`);
nothing is written to disk.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "irois."
STEP = "train.step"  # the span that numbers a step
CAPACITY = 1 << 16

_OFF = contextlib.nullcontext()
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_numbers = itertools.count()
_open_step: Optional[int] = None  # the open train.step's number
_local = threading.local()  # each thread's stack of open records


@dataclasses.dataclass(eq=False)
class Record:
    """One closed span: ``end_ns`` is set when it closes; ``parent`` is
    the enclosing :class:`Record` on the same thread or None; ``step``
    the enclosing ``train.step``'s number or None; ``events`` the
    (start, end) CUDA events or None."""

    name: str
    start_ns: int
    parent: Optional["Record"]
    step: Optional[int]
    thread: int
    events: Optional[tuple] = None
    end_ns: Optional[int] = None


class _Span:
    __slots__ = ("name", "device", "record", "range", "outer_step")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        global _open_step
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.outer_step = _open_step
        if self.name == STEP:
            _open_step = next(_numbers)
        rec = self.record = Record(
            self.name, time.time_ns(), stack[-1] if stack else None,
            _open_step, threading.get_ident())
        stack.append(rec)
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        dev = self.device
        if dev is not None and torch.device(dev).type == "cuda":
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        return rec

    def __exit__(self, *exc):
        global _open_step
        rec = self.record
        if rec.events is not None:
            rec.events[1].record()
        self.range.__exit__(*exc)
        rec.end_ns = time.time_ns()
        _local.stack.pop()
        _buffer.append(rec)
        if self.name == STEP:
            _open_step = self.outer_step
        return False


def span(name: str, device=None):
    """A context over the work named ``name`` (module docstring); a no-op
    unless a profiler is recording."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def records() -> list:
    """The kept records, in the order their spans closed."""
    return list(_buffer)


def clear() -> None:
    _buffer.clear()


def device_ms(record: Record) -> Optional[float]:
    """The device time between the record's events, in ms, once the
    stream has passed its end event (waits for it); None for a span with
    no events (host only, or on the CPU)."""
    if record.events is None:
        return None
    start, end = record.events
    end.synchronize()
    return start.elapsed_time(end)
