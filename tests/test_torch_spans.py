"""The port's spans (``utils/spans.py``): off, they make and keep nothing;
under ``torch.profiler`` each is a ``record_function`` range of the trace
and a record on the trace's clock; the train steps' stage spans nest in
each step and leave the step's numbers bit-equal."""

import copy
import threading
import time
from collections import deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from inverserenderingofindoorscene_torch.data.synthetic import synthetic_batch
from inverserenderingofindoorscene_torch.pipeline.brdf import BRDFNets
from inverserenderingofindoorscene_torch.pipeline.light import LightNets
from inverserenderingofindoorscene_torch.train.steps import (
    BRDFTrainStep,
    LightTrainStep,
)
from inverserenderingofindoorscene_torch.utils import spans

# How far a kineto event's edge may lie inside its record's interval.  The
# record's stamps are taken just outside the range's enter and exit
# (measured on an 8-core CPU, torch 2.13, 5,400 spans with six processes
# at once: start edges 2.5 us to 0.32 ms, median ~6 us; end edges 0.5 us
# to 26 us); kineto's stamps are converted from the CPU's counter to the
# epoch by a linear fit, so an edge may also fall a few us outside.
EDGE_MAX_NS = 2_000_000
EDGE_SLACK_NS = 10_000
STAGES = ["train.forward", "train.backward", "train.optimizer"]


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.clear()
    yield
    spans.clear()


def test_off_makes_and_keeps_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("constructed while no profiler records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    ctx = spans.span(spans.STEP, device="cuda")
    assert ctx is spans.span("kernel.render_sg_fwd")
    with ctx:
        with spans.span("train.forward", device="cuda"):
            pass
    assert spans.records() == []


def test_nested_spans_parent_step_and_trace_clock():
    with cpu_profile() as prof:
        with spans.span("outer"):
            with spans.span(spans.STEP):
                with spans.span("train.forward"):
                    time.sleep(0.002)
                with spans.span("train.backward"):
                    with spans.span("kernel.inner"):
                        pass
            with spans.span(spans.STEP):
                with spans.span("train.forward"):
                    pass
    recs = sorted(spans.records(), key=lambda r: r.start_ns)
    names = [r.name for r in recs]
    assert names == ["outer", "train.step", "train.forward", "train.backward",
                     "kernel.inner", "train.step", "train.forward"]
    outer, s1, f1, b1, k1, s2, f2 = recs
    assert outer.parent is None and outer.step is None
    assert s1.parent is outer and s2.parent is outer
    assert (f1.parent, b1.parent, k1.parent, f2.parent) == (s1, s1, b1, s2)
    assert s1.step is not None and s2.step not in (None, s1.step)
    assert f1.step == b1.step == k1.step == s1.step and f2.step == s2.step
    assert {r.thread for r in recs} == {threading.get_ident()}
    assert all(spans.device_ms(r) is None for r in recs)

    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(spans.PREFIX)),
                    key=lambda e: e.start_ns())
    assert [e.name() for e in events] == [spans.PREFIX + n for n in names]
    for e, r in zip(events, recs):
        lead, trail = e.start_ns() - r.start_ns, r.end_ns - e.end_ns()
        assert -EDGE_SLACK_NS <= lead <= EDGE_MAX_NS, (r.name, lead)
        assert -EDGE_SLACK_NS <= trail <= EDGE_MAX_NS, (r.name, trail)


def test_other_thread_takes_the_open_step():
    """A span on another thread (autograd's backward thread on the card)
    has no parent and the step open on the caller's."""
    with cpu_profile():
        with spans.span(spans.STEP):
            t = threading.Thread(target=_open_close,
                                 args=("kernel.render_sg_bwd",))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    by_name = {r.name: r for r in spans.records()}
    kernel, step = by_name["kernel.render_sg_bwd"], by_name[spans.STEP]
    assert kernel.parent is None and kernel.step == step.step
    assert kernel.thread != step.thread


def _open_close(name):
    with spans.span(name):
        pass


def test_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(spans, "_buffer", deque(maxlen=3))
    with cpu_profile():
        for i in range(5):
            with spans.span(f"s{i}"):
                pass
    assert [r.name for r in spans.records()] == ["s2", "s3", "s4"]


# -- the train steps --------------------------------------------------

IM_HW, ENV_RC = (64, 64), (32, 32)


def _make(kind):
    gen = torch.Generator().manual_seed(11)
    brdf = BRDFNets(0, generator=gen)
    if kind == "brdf":
        return BRDFTrainStep(brdf, device="cpu"), brdf
    light = LightNets(env_rows=ENV_RC[0], env_cols=ENV_RC[1], generator=gen)
    return LightTrainStep(brdf, light, device="cpu"), light


def _two_steps(step, trained, profiled):
    losses = []
    batches = [synthetic_batch(batch=2, im_hw=IM_HW, env_rc=ENV_RC, seed=s,
                               device="cpu") for s in (3, 4)]
    for batch in batches:
        if profiled:
            with cpu_profile():
                out = step(batch)
        else:
            out = step(batch)
        losses.append({k: v.clone() for k, v in out.items()})
    params = {n: p.detach().clone() for n, p in trained.named_parameters()}
    return losses, params


@pytest.fixture(scope="module", params=["brdf", "light"])
def stepped(request):
    """(records of 2 profiled steps, (losses, params) profiled, the same
    unprofiled) of one step kind, from one start, on one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        step, trained = _make(request.param)
        twin = copy.deepcopy((step, trained))
        spans.clear()
        on = _two_steps(step, trained, profiled=True)
        recs = spans.records()
        spans.clear()
        off = _two_steps(*twin, profiled=False)
        assert spans.records() == []
    finally:
        torch.set_num_threads(threads)
    return recs, on, off


def test_steps_record_their_stages_in_order(stepped):
    recs = stepped[0]
    steps = sorted((r for r in recs if r.name == spans.STEP),
                   key=lambda r: r.start_ns)
    assert len(steps) == 2 and steps[0].step != steps[1].step
    for s in steps:
        assert s.parent is None
        kids = sorted((r for r in recs if r.parent is s),
                      key=lambda r: r.start_ns)
        assert [r.name for r in kids] == STAGES
        assert all(r.step == s.step for r in kids)
        edges = [s.start_ns] + [t for r in kids
                                for t in (r.start_ns, r.end_ns)] + [s.end_ns]
        assert edges == sorted(edges)


def test_steps_bit_equal_with_the_profiler_on_and_off(stepped):
    _, (losses_on, params_on), (losses_off, params_off) = stepped
    for a, b in zip(losses_on, losses_off):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert params_on.keys() == params_off.keys()
    assert all(torch.equal(params_on[n], params_off[n]) for n in params_on)
