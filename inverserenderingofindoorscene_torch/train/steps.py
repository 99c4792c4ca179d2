"""Training steps for the staged pipeline.

The counterpart of the JAX package's ``train/steps.py``.  The reference
trains each stage with Adam(lr=1e-4, betas=(0.5, 0.999)) and halves the
rate every 10 epochs; :func:`reference_adam` is that optimizer with the
halving as a per-step schedule.  A step here owns its modules and its
optimizer and updates them in place (the JAX step is a pure function of
a ``TrainState``).  Ported: the BRDF, lighting and bilateral stages, at
either cascade level (the modules carry their level), and the IIW and
NYU fine-tunes.  The fine-tune CLIs alternate a synthetic BRDF step
and a real-data step on ONE Adam and one schedule (the JAX CLIs' one
``TrainState``, whose count advances twice a cycle): hand the first
step's ``optimizer`` and ``scheduler`` to the second.  The nets carry
their compute dtype (``BRDFNets`` / ``LightNets`` ``compute_dtype``):
in bfloat16 the conv stacks run in bf16 while Adam and the LR schedule
act on the float32 params, and the losses read the float32 heads.

Data parallel: every step takes ``group``, a ``torch.distributed`` process
group whose ranks each hold their rows of the global batch
(``parallel/``), the counterpart of the JAX steps' ``axis_name``.  At
construction the step makes every rank's nets, trained and frozen, rank
0's (``replicate_``); its losses are the global ones; after ``backward``
the gradients are summed over the ranks in one flat all_reduce
(``sum_grads_``), not averaged, as the JAX steps ``psum`` theirs; so the
ranks take the step one process takes on the whole batch, and return its
metrics.  ``group`` None is one process.
"""

from __future__ import annotations

from typing import Optional

import torch

from inverserenderingofindoorscene_torch.device import resolve_device
from inverserenderingofindoorscene_torch.parallel.collectives import (
    pmax,
    pmean,
    sum_grads_,
)
from inverserenderingofindoorscene_torch.parallel.mesh import replicate_
from inverserenderingofindoorscene_torch.pipeline.bilateral import (
    bilateral_step,
    bilateral_total_error,
)
from inverserenderingofindoorscene_torch.pipeline.brdf import (
    brdf_step,
    brdf_total_error,
)
from inverserenderingofindoorscene_torch.pipeline.finetune import (
    iiw_step,
    nyu_step,
)
from inverserenderingofindoorscene_torch.pipeline.light import light_step
from inverserenderingofindoorscene_torch.utils.spans import STEP, span
from inverserenderingofindoorscene_torch.utils.weights import (
    brdf_adam_state_dict,
    light_adam_state_dict,
)


def reference_adam(params, lr: float = 1e-4,
                   epoch_decay_steps: Optional[int] = None):
    """Adam(lr, betas=(0.5, 0.999), eps=1e-8) over ``params``.

    Returns (optimizer, scheduler): with ``epoch_decay_steps`` (steps per
    10 epochs) the scheduler halves the rate every that many steps (call
    ``scheduler.step()`` after each optimizer step); without it the
    scheduler is None."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.5, 0.999), eps=1e-8)
    if epoch_decay_steps is None:
        return opt, None
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: 0.5 ** (step // epoch_decay_steps))
    return opt, sched


def position_schedule(scheduler, count: int) -> None:
    """Put a :func:`reference_adam` scheduler at optax's step count
    ``count``: the next ``optimizer.step()`` then uses lr * 0.5^(count //
    epoch_decay_steps), the rate optax's schedule gives the update at that
    count, and each ``scheduler.step()`` after it goes on from there.
    ``None`` (no decay) has no position."""
    if scheduler is None:
        return
    scheduler.last_epoch = count
    for group, base, rate in zip(scheduler.optimizer.param_groups,
                                 scheduler.base_lrs, scheduler.lr_lambdas):
        group["lr"] = base * rate(count)
    scheduler._last_lr = [g["lr"] for g in scheduler.optimizer.param_groups]


def _update(step, nets, batch: dict, fill_grads: bool = False):
    """One update of ``step``'s trained module ``nets``: the loss
    (``step.loss(batch)``, whose first two items are the total and the
    dict of its parts), the gradients (with ``fill_grads`` a zero one for
    each parameter the loss does not reach) summed over the step's group,
    then Adam and the schedule.  Returns (metrics, the loss's items): the
    parts and ``total``, detached.  Each stage is a span
    (``utils/spans.py``) timed on ``step.device``: ``train.forward``,
    ``train.backward``, ``train.optimizer``."""
    step.optimizer.zero_grad(set_to_none=True)
    with span("train.forward", step.device):
        out = step.loss(batch)
    total = out[0]
    with span("train.backward", step.device):
        total.backward()
        if fill_grads:
            for p in nets.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        sum_grads_(nets.parameters(), step.group)
    with span("train.optimizer", step.device):
        step.optimizer.step()
        if step.scheduler is not None:
            step.scheduler.step()
    metrics = {k: v.detach() for k, v in out[1].items()}
    metrics["total"] = total.detach()
    return metrics, out


class BRDFTrainStep:
    """The BRDF-training step of trainBRDF: Adam on the encoder and the
    four decoders, loss = 4 albedo_w albedo + normal_w normal + rough_w
    rough + depth_w depth.  The module moves to ``device`` (``None`` means
    CUDA) in place.

    Calling it with a batch (NHWC tensors, moved to the step's device;
    the ``*_pre`` maps too at cascade >= 1) takes one step and returns the
    metrics: the four errors and ``total``, as detached scalars.
    :meth:`loss` computes (total, errors) without the update.

    ``optimizer`` / ``scheduler``: an Adam over these nets' parameters and
    its schedule, shared with another step (the fine-tune cycle); by
    default the step makes its own :func:`reference_adam` from ``lr`` and
    ``epoch_decay_steps``.  ``group``: the ranks of a data-parallel step
    (module docstring)."""

    def __init__(self, brdf_nets, albedo_w: float = 1.5,
                 normal_w: float = 1.0, rough_w: float = 0.5,
                 depth_w: float = 0.5, device=None, lr: float = 1e-4,
                 epoch_decay_steps: Optional[int] = None, optimizer=None,
                 scheduler=None, group=None):
        self.weights = (albedo_w, normal_w, rough_w, depth_w)
        self._setup(brdf_nets, device, lr, epoch_decay_steps, optimizer,
                    scheduler, group)

    def _setup(self, brdf_nets, device, lr, epoch_decay_steps, optimizer,
               scheduler, group):
        self.device = resolve_device(device)
        self.group = group
        self.brdf_nets = replicate_(brdf_nets.to(self.device), group)
        if optimizer is None:
            optimizer, scheduler = reference_adam(
                self.brdf_nets.parameters(), lr, epoch_decay_steps)
        self.optimizer, self.scheduler = optimizer, scheduler

    def loss(self, batch: dict):
        batch = {k: v.to(self.device) for k, v in batch.items()}
        _, errors = brdf_step(self.brdf_nets, batch, self.group)
        return brdf_total_error(errors, *self.weights), errors

    def load_optax_state(self, mu: dict, nu: dict, count: int) -> None:
        """Continue from an optax Adam state of JAX ``BRDFNets`` params
        (:func:`brdf_adam_state_dict`), the LR schedule put at ``count``."""
        self.optimizer.load_state_dict(brdf_adam_state_dict(
            self.optimizer, self.brdf_nets, mu, nu, count))
        position_schedule(self.scheduler, count)

    def __call__(self, batch: dict) -> dict:
        with span(STEP, self.device):
            # a net the loss does not reach (the IIW loss reads albedo
            # only) takes a zero gradient: optax's Adam decays its moments
            # and moves it, torch's would skip a parameter without one
            return _update(self, self.brdf_nets, batch, fill_grads=True)[0]


class IIWTrainStep(BRDFTrainStep):
    """The IIW half of the fine-tune cycle (trainFineTuneIIW): Adam on the
    BRDF nets, loss = rank_w (eq + darker), the ranking losses of
    :func:`iiw_step`, which runs the albedo decoder alone (the others
    take a zero gradient).  Metrics: ``eq``, ``darker``, ``total``.  At
    cascade 1 the batch carries the ``*_pre`` maps
    (``pipeline.finetune.synthesize_pre``).  ``device``, ``lr``,
    ``epoch_decay_steps``, ``optimizer``, ``scheduler`` and ``group`` as
    in :class:`BRDFTrainStep`; over a group the two losses, each a mean
    over the rank's images, are averaged over the ranks (JAX's
    ``pmean``)."""

    def __init__(self, brdf_nets, rank_w: float = 2.0, device=None,
                 lr: float = 1e-4, epoch_decay_steps: Optional[int] = None,
                 optimizer=None, scheduler=None, group=None):
        self.rank_w = rank_w
        self._setup(brdf_nets, device, lr, epoch_decay_steps, optimizer,
                    scheduler, group)

    def loss(self, batch: dict):
        batch = {k: v.to(self.device) for k, v in batch.items()}
        _, eq_l, dk_l = iiw_step(self.brdf_nets, batch, heads=("albedo",))
        eq_l, dk_l = pmean(eq_l, self.group), pmean(dk_l, self.group)
        return self.rank_w * (eq_l + dk_l), {"eq": eq_l, "darker": dk_l}


class NYUTrainStep(BRDFTrainStep):
    """The NYU half of the fine-tune cycle (trainFineTuneNYU): Adam on the
    BRDF nets, loss = normal_w normal + depth_w depth, the losses of
    :func:`nyu_step`, which runs the normal and depth decoders alone.
    Metrics: ``normal``, ``depth``, ``angle_deg``
    (reported only), ``total``.  Arguments as in :class:`IIWTrainStep`."""

    def __init__(self, brdf_nets, normal_w: float = 4.5,
                 depth_w: float = 4.5, device=None, lr: float = 1e-4,
                 epoch_decay_steps: Optional[int] = None, optimizer=None,
                 scheduler=None, group=None):
        self.normal_w, self.depth_w = normal_w, depth_w
        self._setup(brdf_nets, device, lr, epoch_decay_steps, optimizer,
                    scheduler, group)

    def loss(self, batch: dict):
        batch = {k: v.to(self.device) for k, v in batch.items()}
        _, losses = nyu_step(self.brdf_nets, batch,
                             heads=("normal", "depth"), group=self.group)
        total = self.normal_w * losses["normal"] + self.depth_w * losses[
            "depth"]
        return total, losses


class LightTrainStep:
    """The lighting-training step of trainLight: frozen BRDF nets, Adam on
    the light nets, loss = reconst_w reconst + render_w render.  Both
    modules move to ``device`` (``None`` means CUDA) in place.

    Calling it with a batch (NHWC tensors, moved to the step's device)
    takes one step and returns the metrics: the four BRDF errors,
    ``reconst``, ``render`` and ``total``, as detached scalars.
    :meth:`loss` computes (total, losses) without the update, for taking
    gradients on their own.  ``group``: the ranks of a data-parallel step
    (module docstring)."""

    def __init__(self, brdf_nets, light_nets, reconst_w: float = 10.0,
                 render_w: float = 1.0, offset: float = 1.0,
                 use_kernels: bool = True, device=None, lr: float = 1e-4,
                 epoch_decay_steps: Optional[int] = None, group=None):
        self.device = resolve_device(device)
        self.group = group
        self.brdf_nets = replicate_(
            brdf_nets.to(self.device).requires_grad_(False), group)
        self.light_nets = replicate_(light_nets.to(self.device), group)
        self.reconst_w, self.render_w = reconst_w, render_w
        self.offset = offset
        self.use_kernels = use_kernels
        self.optimizer, self.scheduler = reference_adam(
            self.light_nets.parameters(), lr, epoch_decay_steps)

    def loss(self, batch: dict):
        batch = {k: v.to(self.device) for k, v in batch.items()}
        losses, _ = light_step(self.brdf_nets, self.light_nets, batch,
                               offset=self.offset,
                               use_kernels=self.use_kernels, group=self.group)
        total = (self.reconst_w * losses["reconst"]
                 + self.render_w * losses["render"])
        return total, losses

    def load_optax_state(self, mu: dict, nu: dict, count: int) -> None:
        """Continue from an optax Adam state of JAX ``LightNets`` params:
        the moments and the step count into the optimizer
        (:func:`light_adam_state_dict`), the LR schedule to ``count``."""
        self.optimizer.load_state_dict(light_adam_state_dict(
            self.optimizer, self.light_nets, mu, nu, count))
        position_schedule(self.scheduler, count)

    def __call__(self, batch: dict) -> dict:
        with span(STEP, self.device):
            return _update(self, self.light_nets, batch)[0]


class BilateralTrainStep:
    """The bilateral-training step of trainBRDFBilateral: frozen BRDF
    nets, Adam on the three confidence nets through the solver's gradient
    CG solve, loss = 4 albedo_w albedo_bs + rough_w rough_bs + depth_w
    depth_bs.  Both modules move to ``device`` (``None`` means CUDA) in
    place; ``use_kernels`` blurs with the CUDA kernel or its plain
    version.

    Calling it with a batch takes one step and returns the metrics: the
    ``_raw``/``_bs`` losses, ``normal_raw``, ``total``, and the true
    vertex counts, ``nvert_<mode>`` (the largest of the batch) and their
    maximum ``nvert_max``.  :meth:`loss` computes (total, losses, stats)
    without the update.  ``group``: the ranks of a data-parallel step
    (module docstring); the confidences' batch maximum and the vertex
    counts are then taken over all of them."""

    def __init__(self, brdf_nets, bs_nets, albedo_w: float = 1.5,
                 rough_w: float = 0.5, depth_w: float = 0.5,
                 use_kernels: bool = True, device=None, lr: float = 1e-4,
                 epoch_decay_steps: Optional[int] = None, group=None):
        self.device = resolve_device(device)
        self.group = group
        self.brdf_nets = replicate_(
            brdf_nets.to(self.device).requires_grad_(False), group)
        self.bs_nets = replicate_(bs_nets.to(self.device), group)
        self.weights = (albedo_w, rough_w, depth_w)
        self.use_kernels = use_kernels
        self.optimizer, self.scheduler = reference_adam(
            self.bs_nets.parameters(), lr, epoch_decay_steps)

    def loss(self, batch: dict):
        batch = {k: v.to(self.device) for k, v in batch.items()}
        losses, aux = bilateral_step(self.brdf_nets, self.bs_nets, batch,
                                     use_kernels=self.use_kernels,
                                     group=self.group)
        total = bilateral_total_error(losses, *self.weights)
        return total, losses, aux["grid_stats"]

    def __call__(self, batch: dict) -> dict:
        with span(STEP, self.device):
            metrics, (_, _, stats) = _update(self, self.bs_nets, batch)
            for mode, st in stats.items():
                nvert = st["nvert"].max()
                if self.group is not None:
                    # on the step's device: NCCL takes no CPU tensor
                    nvert = pmax(nvert.to(self.device), self.group)
                metrics[f"nvert_{mode}"] = nvert
            metrics["nvert_max"] = max(metrics[f"nvert_{m}"] for m in stats)
            return metrics


# the JAX package's names: a call builds the step
make_brdf_train_step = BRDFTrainStep
make_iiw_train_step = IIWTrainStep
make_nyu_train_step = NYUTrainStep
make_light_train_step = LightTrainStep
make_bilateral_train_step = BilateralTrainStep
