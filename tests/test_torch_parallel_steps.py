"""The eight train-step families through two gloo ranks on the CPU.

One two-rank cluster (``parallel/dryrun.py``, started once for the
module, the ranks meeting through a ``file://`` rendezvous in pytest's
tmp dir, one torch thread each) takes one step of each family of
``__graft_entry__.dryrun_multichip``: the light step at cascades 0 and 1
(64x80, grid 32x40), the BRDF, bilateral (seeded confidence nets, whose
maximum is taken over both ranks), IIW and NYU steps and the IIW and NYU
steps at cascade 1 (32x32), global batch 4, two rows a rank, each step
warmed first (ROADMAP C12).  Each rank also takes its share of the
families in one process on the whole batch from the same weights.

Held, at the tolerances of JAX tests/test_parallel.py and
tests/test_shard_map.py:
  * the two ranks' metrics and updated parameters bit-equal (a sha256 of
    their bytes);
  * the metrics within rtol 2e-4 of the single-process step's (5e-4 for
    the bilateral step), f32 sums in another order;
  * the updated parameters within 3e-4 of it (Adam's first update is
    lr g / (|g| + eps), so a gradient near zero may flip sign under
    another reduction order: the drift is bounded by ~2 lr);
  * and, since that update hardly depends on the gradient's scale, the
    summed gradient within relative L2 1e-4 of the single-process one,
    all trained parameters together (measured <= 7.6e-7 over the eight;
    in a copy with the gradients averaged instead of summed it is 0.5,
    and with the bilateral confidence divided by each rank's own maximum
    1.3e-2, while that copy's metrics and parameters pass the two checks
    above);
  * no kernel launch: CPU tensors take the kernels' plain versions.
"""

import json
import sys

import pytest

from inverserenderingofindoorscene_torch.parallel.dryrun import FAMILIES
from torch_parallel_worker import run_ranks

WORLD = 2
METRIC_RTOL = {"bilateral": 5e-4}
PARAM_ATOL = 3e-4
GRAD_REL_L2 = 1e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """[rank 0's {family: record}, rank 1's]."""
    tmp = tmp_path_factory.mktemp("steps")
    outs = run_ranks(lambda r: [
        sys.executable, "-m", "inverserenderingofindoorscene_torch.parallel."
        "dryrun", "--initMethod", f"file://{tmp}/store", "--world",
        str(WORLD), "--rank", str(r), "--device", "cpu", "--warm",
        "--threads", "1"], WORLD, timeout=400)
    records = []
    for out in outs:
        line = [x for x in out.splitlines() if x.startswith("DRYRUN ")][-1]
        records.append(json.loads(line[len("DRYRUN "):])["families"])
    return records


@pytest.mark.parametrize("name", FAMILIES)
def test_ranks_are_bit_equal(ranks, name):
    a, b = (r[name] for r in ranks)
    assert a["digest"] == b["digest"]
    assert a["metrics"] == b["metrics"]
    assert a["local_b"] == b["local_b"] == 2


def single_process(ranks, name):
    """The rank that took ``name``'s single-process step: its record."""
    return ranks[FAMILIES.index(name) % WORLD][name]


@pytest.mark.parametrize("name", FAMILIES)
def test_metrics_match_the_single_process_step(ranks, name):
    rec = single_process(ranks, name)
    want = rec["ref"]["metrics"]
    assert sorted(rec["metrics"]) == sorted(want)
    rtol = METRIC_RTOL.get(name, 2e-4)
    for k, v in want.items():
        assert rec["metrics"][k] == pytest.approx(v, rel=rtol, abs=0), k


@pytest.mark.parametrize("name", FAMILIES)
def test_params_match_the_single_process_step(ranks, name):
    assert single_process(ranks, name)["ref"]["max_param_diff"] < PARAM_ATOL


@pytest.mark.parametrize("name", FAMILIES)
def test_summed_gradient_is_the_single_process_one(ranks, name):
    assert single_process(ranks, name)["ref"]["grad_rel_l2"] < GRAD_REL_L2


def test_cpu_tensors_launch_no_kernel(ranks):
    for records in ranks:
        for name, rec in records.items():
            assert set(rec["launches"].values()) == {0}, name
