"""Driver of BRDF training traffic: the program's ``BRDFTrainStep``
(Adam, the encoder and four decoders of one cascade, in the
configuration's compute dtype) on a pool of distinct batches, cycled."""

from __future__ import annotations

from bench_port import flops, program
from bench_port.reference import nets as R
from bench_port.reference import train as T
from bench_port.training import TrainSession


class Session(TrainSession):

    def program_step(self):
        from inverserenderingofindoorscene_torch.train.steps import (
            BRDFTrainStep,
        )

        nets = program.port("brdf", 0, self.cfg, self.device, self.seed,
                            self.cfg["compute_dtype"])
        step = BRDFTrainStep(nets, device=self.device,
                             lr=self.traffic["lr"])
        return step, step.brdf_nets

    def reference_loss(self, conv):
        nets = program.reference("brdf", 0, self.cfg, self.device, self.seed,
                                 conv or R.CONV_F32)
        return nets, lambda batch: T.brdf_loss(nets, batch)

    def model_flops_per_image(self) -> float:
        return flops.brdf_step_flops(self.cfg, self.batch) / self.batch
