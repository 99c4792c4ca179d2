"""The part of a training cell that its drivers (``traffic/train_*.py``)
share.

Set-up builds the program's one training step (its nets and its Adam),
drives it from the seed through its first three steps on three distinct
batches of the pool through the step's own call, and reads from it: each
step's loss, each leaf's first gradient (the optimizer's first moment
after one step over 1 - beta1) and each leaf's change over the three
steps.  A fourth step warms the last batch; the window then goes on with
the same object.  The window dispatches steps back to back and reads the
losses back every 16 steps, as the training CLIs' logger does.

Once the window has closed (and the memory peak is read), the same object
takes three more steps on the pool's next batches, through the same
call, from the state the window left: the replay.  Its start (the
parameters and Adam's moments and step count) is kept, and the same
readings are taken of it, the first gradient from the moments before and
after its first step.

The comparison (after the window, the program freed): the reference
takes the same three first steps from the same weights in float32, and
the replay's three steps from the replay's start, and the two sides'
readings give

* ``loss``: the worst step's |loss - reference loss| / |reference loss|,
  and ``loss1``, the first step's;
* ``grad``: the worst leaf's |norm of its first gradient - the
  reference's| / the larger of the reference leaf's norm and the median
  leaf's, and ``grad_median``, the median leaf's;
* ``change``: the same for each leaf's change over the three steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (the others move under Adam by round-off alone), and
  ``change_median``.

and the same of the replay, named ``replay_<number>``; and
``window_steps``: how many of the steps driven before the replay
(set-up's and the window's) Adam did not count.  The reference can
follow the window only from the program's own state after it: the
replay judges that state's next steps, ``window_steps`` that each of the
window's steps reached the optimizer.

The cell's file says which are held to a limit (PERF.md gives the
readings each limit was set from).
"""

from __future__ import annotations

import gc
import statistics

import torch

from bench_port import harness, program
from bench_port.reference import train as T
from bench_port.traffic.photos import make_train_batch

FIRST_STEPS = 3
REPLAY_STEPS = 3


def numbers(prog: dict, ref: dict, leaves=None) -> dict:
    """The numbers of two sides' readings ({"loss": [per step], "grad":
    {leaf: norm}, "change": {leaf: norm}}): ``loss``, ``grad`` and
    ``change`` (the module docstring), and beside them ``loss1`` (the
    first step's loss gap) and ``grad_median`` / ``change_median`` (the
    median leaf's gap).  ``leaves``, a dict, receives the worst leaves'
    names and the worst step."""
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(prog["loss"], ref["loss"])]
    names = list(ref["grad"])
    g_med = statistics.median(ref["grad"][n] for n in names)
    grads = [abs(prog["grad"][n] - ref["grad"][n])
             / max(ref["grad"][n], g_med) for n in names]
    moving = [n for n in names if ref["grad"][n] >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][n] for n in moving)
    changes = [abs(prog["change"][n] - ref["change"][n])
               / max(ref["change"][n], c_med) for n in moving]
    out = {"loss": max(losses), "grad": max(grads), "change": max(changes),
           "loss1": losses[0], "grad_median": statistics.median(grads),
           "change_median": statistics.median(changes)}
    if leaves is not None:
        leaves["grad_leaf"] = names[grads.index(out["grad"])]
        leaves["change_leaf"] = moving[changes.index(out["change"])]
        leaves["loss_step"] = losses.index(out["loss"]) + 1
    return out


def _norms(named):
    return {n: float(torch.linalg.vector_norm(t.double()))
            for n, t in named}


def adam_state(opt, params) -> dict:
    """A copy of the program's Adam state of ``params`` ([(name, leaf)]):
    {"m": {name: first moment}, "v": {name: second moment}, "t": the
    step count}; a leaf it holds no state of has zero moments."""
    m, v, t = {}, {}, 0
    for n, p in params:
        st = opt.state.get(p, {})
        m[n] = st["exp_avg"].detach().clone() if "exp_avg" in st \
            else torch.zeros_like(p)
        v[n] = st["exp_avg_sq"].detach().clone() if "exp_avg_sq" in st \
            else torch.zeros_like(p)
        if "step" in st:
            t = int(st["step"])
    return {"m": m, "v": v, "t": t}


class TrainSession:
    """A training cell's run; a driver gives the hooks ``program_step``,
    ``reference_loss`` and ``model_flops_per_image``, and where it drives
    the program's kernels ``kernel_bounds``; ``with_env`` where its
    batches carry lighting."""

    with_env = False

    def __init__(self, spec: dict, seed: int, device):
        self.spec, self.seed = spec, seed
        self.device = torch.device(device)
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        self.batch = self.traffic["batch"]
        self.failed = 0
        self.events, self.pending = [], []
        self.replay = None

    # -- hooks ---------------------------------------------------------
    def program_step(self):
        """(step, trained module) of the program."""
        raise NotImplementedError

    def reference_loss(self, conv):
        """(trained reference module, loss_fn(batch))."""
        raise NotImplementedError

    # -- set-up --------------------------------------------------------
    def make_inputs(self) -> None:
        cfg = self.cfg
        self.batches = [
            make_train_batch(self.seed, i, self.batch,
                             (cfg["im_height"], cfg["im_width"]),
                             (cfg["env_rows"], cfg["env_cols"]),
                             (cfg["env_height"], cfg["env_width"]),
                             self.device, self.with_env)
            for i in range(self.traffic["pool"])]

    def setup(self) -> None:
        log = harness.PhaseLog(self._sync)
        program.set_backends(self.cfg)
        self.make_inputs()
        log("inputs")
        self.step, self.trained = self.program_step()
        log("program")
        params = list(self.trained.named_parameters())
        start = {n: p.detach().clone() for n, p in params}
        losses, grads = [], None
        for i in range(FIRST_STEPS):
            losses.append(float(self.step(self.batches[i])["total"]))
            log(f"step {i + 1}")
            if grads is None:
                opt = self.step.optimizer
                b1 = opt.param_groups[0]["betas"][0]
                grads = _norms(
                    (n, opt.state[p].get("exp_avg", torch.zeros_like(p))
                     / (1.0 - b1)) for n, p in params)
        self.readings = {"loss": losses, "grad": grads,
                         "change": _norms((n, p.detach() - start[n])
                                          for n, p in params)}
        del start
        for i in range(FIRST_STEPS, self.traffic["warm_steps"]):
            self.step(self.batches[i % len(self.batches)])
        self.first_index = self.next_index = self.traffic["warm_steps"]
        log("warm")
        self.setup_log = log.text()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # -- the window ----------------------------------------------------
    def call(self, i: int) -> int:
        self.next_index = i + 1
        if self.device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            metrics = self.step(self.batches[i % len(self.batches)])
            ev[1].record()
            self.events.append(ev)
        else:
            metrics = self.step(self.batches[i % len(self.batches)])
        self.pending.append(metrics["total"])
        if len(self.pending) >= harness.FLUSH_STEPS:
            self._flush()
        return self.batch

    def _flush(self):
        for loss in self.pending:
            if not torch.isfinite(loss).item():
                self.failed += 1
        self.pending = []

    def end_window(self) -> None:
        self._flush()

    def step_ms(self) -> list:
        self._sync()
        out = [a.elapsed_time(b) for a, b in self.events]
        self.events = []
        return out

    def end_to_end(self, window) -> dict:
        """The images trained a second over the window, under the
        traffic's ``rate_metric``."""
        return {self.traffic["rate_metric"]: window.images / window.elapsed}

    # -- after the window ----------------------------------------------
    def after_window(self) -> None:
        """The replay: its start kept, its three steps taken and read."""
        params = list(self.trained.named_parameters())
        opt = self.step.optimizer
        start = adam_state(opt, params)
        start["params"] = {n: p.detach().clone() for n, p in params}
        self.steps_missed = abs(self.next_index - start["t"])
        b1 = opt.param_groups[0]["betas"][0]
        batches = [i % len(self.batches) for i in
                   range(self.next_index, self.next_index + REPLAY_STEPS)]
        losses, grads = [], None
        for i in batches:
            losses.append(float(self.step(self.batches[i])["total"]))
            if grads is None:
                m1 = adam_state(opt, params)["m"]
                grads = _norms((n, (m1[n] - b1 * start["m"][n]) / (1.0 - b1))
                               for n, _ in params)
        self.replay = {"batches": batches, "start": start, "readings": {
            "loss": losses, "grad": grads,
            "change": _norms((n, p.detach() - start["params"][n])
                             for n, p in params)}}

    def free_program(self) -> None:
        del self.step, self.trained
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, conv, replay=False) -> dict:
        """The reference's readings of set-up's first steps, or with
        ``replay`` of the replay's steps from its start."""
        program.reference_backends()
        trained, loss_fn = self.reference_loss(conv)
        names = [n for n, _ in trained.named_parameters()]
        if replay:
            start = self.replay["start"]
            with torch.no_grad():
                for n, p in trained.named_parameters():
                    p.copy_(start["params"][n])
            out = T.run_steps(trained, loss_fn,
                              [self.batches[i] for i in self.replay["batches"]],
                              self.traffic["lr"],
                              {"m": [start["m"][n] for n in names],
                               "v": [start["v"][n] for n in names],
                               "t": start["t"]})
        else:
            out = T.run_steps(trained, loss_fn, self.batches[:FIRST_STEPS],
                              self.traffic["lr"])
        return {"loss": out["loss"], "grad": dict(zip(names, out["grad"])),
                "change": dict(zip(names, out["change"]))}

    def check(self, conv=None) -> dict:
        """The compared numbers: the program's readings against the
        reference's, or, with ``conv``, the reference computed with that
        convolution (a control) against the reference; the replay's too
        where the program ran (the control's from the replay's start)."""
        ref = self.reference_readings(None)
        side = self.readings if conv is None else self.reference_readings(conv)
        self.worst = {}
        out = numbers(side, ref, self.worst)
        if self.replay is not None:
            side = self.replay["readings"] if conv is None else \
                self.reference_readings(conv, replay=True)
            replay = numbers(side, self.reference_readings(None, replay=True))
            out.update({f"replay_{k}": v for k, v in replay.items()})
            if conv is None:
                out["window_steps"] = self.steps_missed
        return out
