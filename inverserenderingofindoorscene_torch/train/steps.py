"""Training steps for the staged pipeline.

The counterpart of the JAX package's ``train/steps.py``.  The reference
trains each stage with Adam(lr=1e-4, betas=(0.5, 0.999)) and halves the
rate every 10 epochs; :func:`reference_adam` is that optimizer with the
halving as a per-step schedule.  A step here owns its modules and its
optimizer and updates them in place (the JAX step is a pure function of
a ``TrainState``).  Only the lighting stage at cascade 0 is ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from inverserenderingofindoorscene_torch.device import resolve_device
from inverserenderingofindoorscene_torch.pipeline.light import light_step


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


class LightTrainStep:
    """The lighting-training step of trainLight: frozen BRDF nets, Adam on
    the light nets, loss = reconst_w reconst + render_w render.  Both
    modules move to ``device`` (``None`` means CUDA) in place.

    Calling it with a batch (NHWC tensors, moved to the step's device)
    takes one step and returns the metrics: the four BRDF errors,
    ``reconst``, ``render`` and ``total``, as detached scalars.
    :meth:`loss` computes (total, losses) without the update, for taking
    gradients on their own."""

    def __init__(self, brdf_nets, light_nets, reconst_w: float = 10.0,
                 render_w: float = 1.0, offset: float = 1.0,
                 use_kernels: bool = True, device=None, lr: float = 1e-4,
                 epoch_decay_steps: Optional[int] = None):
        self.device = resolve_device(device)
        self.brdf_nets = brdf_nets.to(self.device).requires_grad_(False)
        self.light_nets = light_nets.to(self.device)
        self.reconst_w, self.render_w = reconst_w, render_w
        self.offset = offset
        self.use_kernels = use_kernels
        self.optimizer, self.scheduler = reference_adam(
            self.light_nets.parameters(), lr, epoch_decay_steps)

    def loss(self, batch: dict):
        batch = {k: v.to(self.device) for k, v in batch.items()}
        losses, _ = light_step(self.brdf_nets, self.light_nets, batch,
                               offset=self.offset,
                               use_kernels=self.use_kernels)
        total = (self.reconst_w * losses["reconst"]
                 + self.render_w * losses["render"])
        return total, losses

    def __call__(self, batch: dict) -> dict:
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = self.loss(batch)
        total.backward()
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total"] = total.detach()
        return metrics


# the JAX package's name: a call builds the step
make_light_train_step = LightTrainStep
