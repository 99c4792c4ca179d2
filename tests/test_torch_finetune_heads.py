"""The fine-tune steps run only the decoders their loss reads (ROADMAP C14).

``IIWTrainStep`` runs the albedo decoder, ``NYUTrainStep`` the normal and
depth decoders: a forward hook on each unread decoder counts no call.
The steps' updates are those of the same step running all four decoders
(the unread decoders take a zero gradient either way): every parameter
bit-equal after two steps, the metrics too.  The BRDF nets run
at 32x32 on the CPU on one thread, each convolution shape warmed first:
with more threads, torch's CPU convolutions round the encoder's gradient
differently from call to call on the same inputs
(tests/test_torch_checkpoint.py).
"""

import pytest
import torch

from inverserenderingofindoorscene_torch.data.synthetic import (
    synthetic_iiw_batch,
    synthetic_nyu_batch,
)
from inverserenderingofindoorscene_torch.pipeline.brdf import HEADS, BRDFNets
from inverserenderingofindoorscene_torch.pipeline.finetune import (
    iiw_step,
    nyu_step,
)
from inverserenderingofindoorscene_torch.train.steps import (
    IIWTrainStep,
    NYUTrainStep,
)

IM_HW = (32, 32)


class IIWAllHeads(IIWTrainStep):
    """The IIW step as it was before: all four decoders run."""

    def loss(self, batch):
        batch = {k: v.to(self.device) for k, v in batch.items()}
        _, eq_l, dk_l = iiw_step(self.brdf_nets, batch)
        return self.rank_w * (eq_l + dk_l), {"eq": eq_l, "darker": dk_l}


class NYUAllHeads(NYUTrainStep):
    def loss(self, batch):
        batch = {k: v.to(self.device) for k, v in batch.items()}
        _, losses = nyu_step(self.brdf_nets, batch)
        total = self.normal_w * losses["normal"] + self.depth_w * losses[
            "depth"]
        return total, losses


CASES = {
    "iiw": (IIWTrainStep, IIWAllHeads, ("albedo",)),
    "nyu": (NYUTrainStep, NYUAllHeads, ("normal", "depth")),
}


def batches(kind):
    if kind == "iiw":
        return [synthetic_iiw_batch(batch=2, im_hw=IM_HW, max_num=40,
                                    seed=s, device="cpu")[0]
                for s in range(2)]
    return [synthetic_nyu_batch(batch=2, im_hw=IM_HW, seed=s, device="cpu")
            for s in range(2)]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["iiw", "nyu"])
def test_finetune_step_runs_only_read_decoders(kind, one_thread):
    cls, all_heads_cls, read = CASES[kind]
    data = batches(kind)

    def nets():
        return BRDFNets(0, generator=torch.Generator().manual_seed(3))

    all_heads_cls(nets(), device="cpu")(data[0])  # warms every shape (C12)
    step = cls(nets(), device="cpu")
    ref = all_heads_cls(nets(), device="cpu")
    calls = dict.fromkeys(HEADS, 0)
    for name in HEADS:
        getattr(step.brdf_nets, name).register_forward_hook(
            lambda *_, name=name: calls.__setitem__(name, calls[name] + 1))
    for b in data:
        got, want = step(b), ref(b)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert calls == {name: 2 if name in read else 0 for name in HEADS}
    sd, sd_ref = step.brdf_nets.state_dict(), ref.brdf_nets.state_dict()
    init = nets().state_dict()
    for k in sd_ref:
        assert torch.equal(sd[k], sd_ref[k]), k
    assert not torch.equal(sd["encoder.conv1.weight"],
                           init["encoder.conv1.weight"])
