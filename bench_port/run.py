"""Run one cell of the port's benchmark once, on the card.

    python bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up (the port's kernels built or loaded
from ``build/``, seeded weights and inputs made on the card, the cell's
shapes warmed) is timed from the start of this script to the first timed
call; then the window runs for ``--seconds``; then the reference checks
what the window produced.  The last line of standard output is the
result (JSON); the compared numbers, each beside its limit, are the last
lines of standard error and the result's last key.  ``--trace 1`` traces
the window's last part and reports the cell's per-layer metrics instead
of its end-to-end ones.  Exits non-zero, with no result, without a CUDA
card, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench_port import harness  # noqa: E402

for _key, _value in harness.cache_env(ROOT).items():
    os.environ[_key] = _value


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    spec = harness.load_cell(args.workload, ROOT)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    # one process, one host thread of torch's own: the card's work is
    # issued by the main thread, and idle pool threads only contend for
    # the host's cores
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    from bench_port.runner import execute

    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), T_START, device="cuda", root=ROOT)
    loaded = harness.forbidden_loaded()
    if loaded:
        print("the run loaded " + ", ".join(loaded) + ": no result",
              file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
