"""One run of one cell: set-up, the window (untraced, or with its last
part traced), the device's readings, the comparison and the result.

:func:`execute` is what ``run.py`` calls on the card; the benchmark's
tests call it on the CPU at small sizes (``overrides``) and with the
timed path broken underneath (``patch``).
"""

from __future__ import annotations

import sys
import time

import torch

from bench_port import harness, program
from bench_port import trace as T

GIB = 2 ** 30


class Context:
    """What a per-layer metric's reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    out.update(extra or {})
    return out


def _per_layer(spec, session, ctx) -> dict:
    out = {}
    for m in spec["per_layer"]:
        value = harness.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(name: str, seed: int, seconds: float, trace: bool,
            t_start: float, device: str = "cuda", overrides=None,
            patch=None, root=harness.ROOT, readings=None) -> dict:
    """The result of one run (the dict printed as its last line).
    ``readings``, a dict, receives every number the comparison read,
    the compared ones and those beside them."""
    spec = harness.load_cell(name, root)
    if overrides:
        spec["config"] = _merge(spec["config"], overrides.get("config"))
        spec["traffic"] = _merge(spec["traffic"], overrides.get("traffic"))
    on_card = torch.device(device).type == "cuda"
    card = torch.cuda.get_device_name(0) if on_card else "cpu"
    session = harness.driver(spec["traffic"]).Session(spec, seed, device)
    if patch is not None:
        patch(session)
    t_setup = time.perf_counter()
    session.setup()
    setup_s = time.perf_counter() - t_start
    print(f"setup {setup_s:.3f} s: {t_setup - t_start:.3f} s to the "
          f"session, then {session.setup_log}", file=sys.stderr, flush=True)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    traced_s = min(seconds, spec["traffic"]["trace_seconds"]) if trace else 0
    window = harness.Window(session, seconds - traced_s, sync)
    index, summary, traced = session.first_index, None, None
    if seconds - traced_s > 0:
        index = window.run(index)
    if trace:
        before = program.counters() if on_card else {}
        traced = harness.Window(session, traced_s, sync)
        with T.profile() as prof:
            with torch.profiler.record_function(T.WINDOW):
                end = traced.run(index)
        traced.calls_run = list(range(index, end))
        after = program.counters() if on_card else {}
        summary = T.reduce(prof)
        del prof
        for wrapper, n in after.items():
            launched = n - before[wrapper]
            found = summary["port"].get(wrapper, [0, 0.0])[0]
            if found < launched:
                raise SystemExit(
                    f"the trace holds {found} {wrapper} kernels of the "
                    f"{launched} the program launched in the traced window "
                    f"(kernels of like names: {summary['unmatched']})")
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    main = window if seconds - traced_s > 0 else traced
    e2e = session.end_to_end(main)
    e2e["setup_s"] = setup_s
    e2e["peak_mem_gib"] = memory_peak / GIB
    step_ms = session.step_ms() if hasattr(session, "step_ms") and on_card \
        else []
    call_ms = list(getattr(session, "call_ms", []))
    if hasattr(session, "after_window"):
        session.after_window()
    session.free_program()
    numbers = session.check(all_photos=True) if (
        trace and hasattr(session, "nvert")) else session.check()
    if readings is not None:
        readings.update(numbers)
        readings.update(getattr(session, "worst", {}))
    correct, checks = harness.compare(numbers, spec["limits"]["limits"])
    result = {"correct": correct, "attempted": window.calls + (
        traced.calls if traced else 0), "failed": session.failed}
    if trace:
        ctx = Context(card=card, cfg=spec["config"], session=session,
                      window=main, traced=traced, trace=summary,
                      step_ms=step_ms[:window.calls] or step_ms,
                      call_ms=call_ms[:window.calls] or call_ms)
        result["metrics"] = _per_layer(spec, session, ctx)
    else:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in spec["end_to_end"]}
    result["device"] = {"platform": "gpu" if on_card else "cpu",
                        "kind": card, "count": 1,
                        "memory_peak_bytes": memory_peak}
    if trace:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result

