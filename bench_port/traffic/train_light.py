"""Driver of light training traffic: the program's ``LightTrainStep``
(Adam on the light nets of one cascade, the BRDF nets frozen, the SG
decode and shading through the program's kernels, in the configuration's
compute dtype) on a pool of distinct batches with their lighting,
cycled.

The reference computes its convolutions in bfloat16, as the
configuration states them (``reference.nets.conv_bf16``): the rendering
loss fits the shading onto the image with a 2x2 least-squares system
that amplifies each difference upstream into the gradients, so that a
float32 reference reads the configuration's own bfloat16 rounding nearly
as large as the fp8 control's."""

from __future__ import annotations

from bench_port import flops, peaks, program
from bench_port.reference import nets as R
from bench_port.reference import train as T
from bench_port.training import TrainSession

# the program's training kernels, one launch each a step
KERNELS = ("render_sg_fwd", "render_sg_bwd", "sg_envmap_fwd",
           "sg_envmap_bwd")


class Session(TrainSession):

    with_env = True

    def program_step(self):
        from inverserenderingofindoorscene_torch.train.steps import (
            LightTrainStep,
        )

        cfg = self.cfg
        nets = [program.port(kind, 0, cfg, self.device, self.seed,
                             cfg["compute_dtype"]) for kind in ("brdf",
                                                                 "light")]
        step = LightTrainStep(*nets, use_kernels=True, device=self.device,
                              lr=self.traffic["lr"])
        return step, step.light_nets

    def reference_loss(self, conv):
        brdf, light = (program.reference(kind, 0, self.cfg, self.device,
                                         self.seed, conv or R.CONV_BF16)
                       for kind in ("brdf", "light"))
        brdf.requires_grad_(False)
        return light, lambda batch: T.light_loss(brdf, light, batch)

    def model_flops_per_image(self) -> float:
        return flops.light_step_flops(self.cfg, self.batch) / self.batch

    def kernel_bounds(self, card: str, calls: list) -> dict:
        """{wrapper: (launches, bound s)} of the steps ``calls``."""
        cfg = self.cfg
        shape = (self.batch, cfg["env_rows"], cfg["env_cols"],
                 cfg["sg_num"], cfg["env_height"] * cfg["env_width"])
        return {k: (len(calls), len(calls) * peaks.kernel_bound_s(
            card, *getattr(flops, k)(*shape))) for k in KERNELS}
