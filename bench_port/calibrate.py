"""Readings for the limits of a cell's comparison, many seeds in one
process: the program's runs, the control (the reference computed one
precision below the configuration's), and planted faults.

    python bench_port/calibrate.py --workload <cell> --seconds 3 \
        --seeds 11,12,13 [--control-seeds 21,22,23 [--control-after-run]] \
        [--fault half_batch --fault-seeds 31,32,33] [--size 64x64]

One JSON line a reading on standard output: {"kind", "seed",
"readings"} (and the run's end-to-end metrics for the program's runs).
The benchmark's own runs do not run this.  ``--size`` runs the cell at a
smaller image (its lighting grid half the image), on the CPU when there
is no card (the benchmark's tests do).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench_port import harness  # noqa: E402

for _key, _value in harness.cache_env(ROOT).items():
    os.environ[_key] = _value


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def overrides_of(size):
    if not size:
        return None
    h, w = (int(x) for x in size.split("x"))
    return {"config": {"im_height": h, "im_width": w, "env_rows": h // 2,
                       "env_cols": w // 2}}


def control(cell, seed, device, overrides=None, seconds=None):
    """The control's numbers: the reference with the configuration's
    control convolution, against the reference, on a run's inputs; with
    ``seconds``, after a run of the program of that length, so that a
    training cell's control also takes the replay from the state the
    program's window left (returns (program's readings, control's))."""
    from bench_port.reference.precision import CONTROLS
    from bench_port.runner import _merge, execute

    spec = harness.load_cell(cell)
    conv = CONTROLS[spec["config"]["control"]]
    if seconds is not None:
        kept, readings = [], {}
        execute(cell, seed, seconds, False, time.perf_counter(),
                device=device, overrides=overrides, patch=kept.append,
                readings=readings)
        out = kept[0].check(conv=conv)
        out.update(getattr(kept[0], "worst", {}))
        return readings, out
    if overrides:
        spec["config"] = _merge(spec["config"], overrides.get("config"))
        spec["traffic"] = _merge(spec["traffic"], overrides.get("traffic"))
    session = harness.driver(spec["traffic"]).Session(spec, seed, device)
    session.make_inputs()
    out = session.check(conv=conv)
    out.update(getattr(session, "worst", {}))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--control-after-run", action="store_true",
                   help="run the program first, so that a training "
                   "cell's control also takes the replay")
    p.add_argument("--fault", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--size", default="")
    args = p.parse_args(argv)

    import torch

    from bench_port.faults import FAULTS
    from bench_port.runner import execute

    device = "cuda" if torch.cuda.is_available() else "cpu"
    ov = overrides_of(args.size)
    runs = [("program", s, None) for s in _ints(args.seeds)]
    runs += [(f"fault:{args.fault}", s, FAULTS[args.fault])
             for s in _ints(args.fault_seeds)]
    for kind, seed, patch in runs:
        readings = {}
        r = execute(args.workload, seed, args.seconds, False,
                    time.perf_counter(), device=device, overrides=ov,
                    patch=patch, readings=readings)
        print(json.dumps({"kind": kind, "seed": seed, "readings": readings,
                          "correct": r["correct"], "metrics": r["metrics"]}),
              flush=True)
    for seed in _ints(args.control_seeds):
        if args.control_after_run:
            prog, ctrl = control(args.workload, seed, device, ov,
                                 args.seconds)
            print(json.dumps({"kind": "program", "seed": seed,
                              "readings": prog}), flush=True)
        else:
            ctrl = control(args.workload, seed, device, ov)
        print(json.dumps({"kind": "control", "seed": seed,
                          "readings": ctrl}), flush=True)
    if harness.forbidden_loaded():
        raise SystemExit("loaded " + ", ".join(harness.forbidden_loaded()))


if __name__ == "__main__":
    main()
