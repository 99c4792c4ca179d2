"""The reference against the program's plain route on the CPU at 64x64,
and sound runs of the harness there."""

import time

import pytest
import torch

from bench_port import program
from bench_port.calibrate import control
from bench_port.reference import bilateral as RB
from bench_port.reference import sg as RSG
from bench_port.runner import execute
from conftest import BATCH, ROOT, SERVE, SMALL

CFG = {"im_height": 64, "im_width": 64, "env_rows": 32, "env_cols": 32,
       "env_height": 8, "env_width": 16, "sg_num": 12}


def close(a, b, rtol=1e-4, atol=1e-5):
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("level", [0, 1])
def test_brdf_and_light_nets(level, one_thread):
    g = torch.Generator().manual_seed(level)
    im = torch.rand(2, 3, 64, 64, generator=g)
    inp = im if level == 0 else torch.rand(2, 17, 64, 64, generator=g)
    ours = program.reference("brdf", level, CFG, "cpu", 7)
    theirs = program.port("brdf", level, CFG, "cpu", 7)
    theirs(im, inp)  # a shape's first call on the CPU (ROADMAP C12)
    got, want = theirs(im, inp), ours(im, inp)
    for k in want:
        close(got[k], want[k])
    linp = torch.rand(2, 11, 128, 128, generator=g)
    pre = None if level == 0 else torch.rand(2, 84, 32, 32, generator=g)
    ours = program.reference("light", level, CFG, "cpu", 7)
    theirs = program.port("light", level, CFG, "cpu", 7)
    theirs(linp, (32, 32), pre)
    got, want = theirs(linp, (32, 32), pre), ours(linp, (32, 32), pre)
    for k in want:
        close(got[k], want[k])


def test_confidence_nets(one_thread):
    g = torch.Generator().manual_seed(3)
    im = torch.rand(2, 64, 64, 3, generator=g)
    target = torch.rand(2, 64, 64, 3, generator=g)
    ours = program.reference("bs", 0, CFG, "cpu", 7)
    theirs = program.port("bs", 0, CFG, "cpu", 7)
    theirs.confidence("albedo", im, target)
    got = theirs.confidence("albedo", im, target)
    want = ours.confidence("albedo", im.permute(0, 3, 1, 2),
                           target.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, want)


def test_sg_decode_and_shading():
    from inverserenderingofindoorscene_torch.ops.sg_render import (
        render_sg_env_plain,
    )

    g = torch.Generator().manual_seed(4)
    b, h, w, k = 1, 6, 7, 12
    albedo = torch.rand(b, h, w, 3, generator=g)
    normal = torch.nn.functional.normalize(
        torch.randn(b, h, w, 3, generator=g), dim=-1)
    rough = torch.rand(b, h, w, 1, generator=g) * 2 - 1
    axis = torch.nn.functional.normalize(
        torch.randn(b, h, w, k, 3, generator=g), dim=-1)
    lamb = torch.rand(b, h, w, k, generator=g) * 20
    weight = torch.rand(b, h, w, k, 3, generator=g)
    d, s, env = render_sg_env_plain(albedo, normal, rough, axis, lamb, weight)
    env_r = RSG.sg_to_envmap(axis, lamb, weight, 8, 16)
    d_r, s_r = RSG.render_envmap(albedo, normal, rough, env_r, 57.0, 8, 16)
    close(env, env_r, 1e-6, 1e-7)
    close(d, d_r, 1e-5, 1e-7)
    close(s, s_r, 1e-4, 1e-6)


def test_bilateral_solve_is_the_programs():
    from inverserenderingofindoorscene_torch.ops.bilateral import (
        MODE_PARAMS,
        bilateral_solve_stats,
    )

    g = torch.Generator().manual_seed(5)
    guide = torch.rand(1, 24, 32, 3, generator=g).round() * 0.5 + 0.2
    target = torch.rand(1, 24, 32, 3, generator=g)
    conf = torch.rand(1, 24, 32, 1, generator=g)
    got, stats = bilateral_solve_stats(guide, target, conf, MODE_PARAMS[0],
                                       use_kernels=False)
    want, nvert = RB.solve(guide[0], target[0], conf[0], RB.MODES["albedo"])
    assert int(stats["nvert"][0]) == nvert
    close(got[0], want, 1e-6, 1e-7)


def test_sound_serving_run_is_correct(serve_root, one_thread):
    r = execute(SERVE, 2100000011, 0.5, False, time.perf_counter(),
                device="cpu", overrides=SMALL, root=serve_root)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


def test_sound_training_run_in_float32_reads_round_off(one_thread):
    readings = {}
    ov = {"config": dict(SMALL["config"], compute_dtype="float32"),
          "traffic": {"batch": 2}}
    execute("c0-brdf-train-b16", 3000000001, 0.5, False,
            time.perf_counter(), device="cpu", overrides=ov, root=ROOT,
            readings=readings)
    assert readings["loss1"] < 1e-5
    assert readings["grad_median"] < 1e-4
    assert readings["change_median"] < 1e-3
    assert readings["replay_change_median"] < 1e-3
    assert readings["window_steps"] == 0


@pytest.mark.parametrize("cell", sorted(BATCH))
def test_sound_training_run_is_correct(cell, one_thread):
    r = execute(cell, 3000000002, 0.5, False, time.perf_counter(),
                device="cpu", overrides={"config": SMALL["config"],
                                         "traffic": {"batch": BATCH[cell]}},
                root=ROOT)
    assert r["correct"], r["checks"]


def test_training_control_takes_the_replay(one_thread):
    """After a run of the program, the control (fp8 here) also takes the
    replay from the state the window left, and reads it far above the
    program."""
    prog, ctrl = control("c0-light-train-b5", 3000000003, "cpu",
                         {"config": SMALL["config"],
                          "traffic": {"batch": BATCH["c0-light-train-b5"]}},
                         seconds=0.3)
    assert "window_steps" in prog and "window_steps" not in ctrl
    assert ctrl["replay_grad_median"] > 3 * prog["replay_grad_median"]
