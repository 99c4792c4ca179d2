"""The benchmark's arithmetic on synthetic numbers: the trace's
intervals, the quantiles, the comparison's verdict, the readers, the
peaks and the kernels' bounds."""

import math
import statistics
from types import SimpleNamespace

import pytest

from bench_port import flops, harness, peaks, readers
from bench_port import trace as T
from bench_port.traffic.serve import shape_gap
from bench_port.training import adam_state, numbers

CARD = "NVIDIA H100 80GB HBM3"


def test_union_merges_overlaps_and_keeps_gaps():
    busy, merged = T.union_s([(0, 10), (5, 20), (30, 40), (40, 45),
                              (50, 51)])
    assert merged == [[0, 20], [30, 45], [50, 51]]
    assert busy == pytest.approx(36e-9)


def test_gaps_are_named_by_the_innermost_host_op():
    merged = [[10, 20], [40, 50]]
    cpu = [(0, 100, "outer", 1, 7), (25, 35, "inner", 2, 7)]
    gaps = T._gap_hosts(merged, cpu, 0, 60)
    # [0,10) and [50,60) under "outer", [20,40) under "inner" (mid 30)
    assert gaps == {"outer": pytest.approx(20e-9),
                    "inner": pytest.approx(20e-9)}


def test_conv_ops_include_ops_nested_in_a_convolution():
    cpu = [(0, 100, "aten::conv2d", 1, 1), (10, 50, "aten::convolution", 2,
                                            1),
           (20, 30, "aten::add_", 3, 1), (60, 70, "aten::relu", 4, 1),
           (0, 50, "aten::convolution_backward", 5, 2),
           (55, 60, "aten::mul", 6, 2)]
    # conv2d's name holds no "convolution"; its relu is outside the
    # convolution it wraps
    assert T._conv_ops(cpu) == {2, 3, 5}


def test_port_kernels_by_name():
    assert T.port_kernel("void bilateral_blur_kernel(float const*)") == \
        "bilateral_blur"
    for arg, wrapper in ((0, "render_sg_env"), (1, "render_sg_fwd"),
                         (2, "sg_envmap_fwd")):
        assert T.port_kernel("void (anonymous namespace)::sg_render_walk_"
                             f"kernel<((anonymous namespace)::Walk){arg}>"
                             "(float const*)") == wrapper
    assert T.port_kernel("sm90_xmma_fprop_implicit_gemm") is None


def test_quantile_is_numpy_linear():
    assert harness.quantile([1, 2, 3, 4, 5], 0.95) == pytest.approx(4.8)
    assert harness.quantile([7], 0.95) == 7


def test_compare_holds_each_reading_to_its_limit():
    ok, checks = harness.compare({"a": 1e-4, "b": 0.0}, {"a": 1e-3,
                                                         "b": 1e-5})
    assert ok and checks["a"] == {"value": 1e-4, "limit": 1e-3}
    assert not harness.compare({"a": 2e-3}, {"a": 1e-3})[0]
    assert not harness.compare({"a": math.nan}, {"a": 1e-3})[0]
    assert not harness.compare({}, {"a": 1e-3})[0]
    assert not harness.compare({"a": 0.0}, {"a": None})[0]


def test_training_numbers():
    ref = {"loss": [2.0, 1.0, 1.0], "grad": {"a": 1.0, "b": 2.0, "c": 0.0},
           "change": {"a": 1.0, "b": 1.0, "c": 5.0}}
    prog = {"loss": [2.02, 1.0, 1.1], "grad": {"a": 1.1, "b": 2.0,
                                                "c": 0.5},
            "change": {"a": 1.0, "b": 1.5, "c": 0.0}}
    leaves = {}
    got = numbers(prog, ref, leaves)
    assert got["loss"] == pytest.approx(0.1)
    assert got["loss1"] == pytest.approx(0.01)
    # grad: gaps over max(norm, median 1.0): 0.1, 0.0, 0.5
    assert got["grad"] == pytest.approx(0.5)
    assert got["grad_median"] == pytest.approx(0.1)
    # leaf c has no gradient: left out of the change
    assert got["change"] == pytest.approx(0.5)
    assert leaves == {"grad_leaf": "c", "change_leaf": "b", "loss_step": 3}


def test_shape_gap_is_blind_to_a_scale_alone():
    import torch

    raw = torch.tensor([1.0, 2.0, 3.0, 4.0])
    assert shape_gap(2.5 * raw, raw) == pytest.approx(0.0, abs=1e-12)
    bent = 2.5 * raw * torch.tensor([1.01, 1.01, 1.0, 1.0])
    assert 1e-3 < shape_gap(bent, raw) < 1e-2
    assert shape_gap(torch.zeros(4), raw) is None
    assert shape_gap(raw, torch.zeros(4)) == pytest.approx(1.0)


def test_adam_state_reads_the_moments_and_the_step_count():
    import torch

    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(
        torch.ones(2))
    opt = torch.optim.Adam([a, b], lr=0.1, betas=(0.5, 0.999))
    assert adam_state(opt, [("a", a)])["t"] == 0
    for _ in range(2):
        opt.zero_grad()
        (2.0 * a.sum()).backward()
        opt.step()
    st = adam_state(opt, [("a", a), ("b", b)])
    assert st["t"] == 2
    # m after two steps of a constant gradient 2: 2 (1 - 0.5^2)
    assert torch.allclose(st["m"]["a"], torch.full((3,), 1.5))
    # b took no gradient: no state, zero moments
    assert not st["m"]["b"].any() and not st["v"]["b"].any()


def ctx(**trace):
    base = {"busy_s": 0.5, "window_s": 2.0, "conv_s": 0.25, "kernels": 100,
            "port": {"k": [4, 0.002]}}
    base.update(trace)
    session = SimpleNamespace(
        model_flops_per_image=lambda: 67e12 * 0.01,
        kernel_bounds=lambda card, calls: {"k": (4, 0.001)})
    return SimpleNamespace(trace=base, traced=SimpleNamespace(
        images=10, calls_run=[0, 1]), session=session, card=CARD,
        cfg={"compute_dtype": "float32", "cudnn_allow_tf32": False})


def test_readers():
    assert readers.idle_share(ctx()) == pytest.approx(75.0)
    assert readers.conv_ms_per_img(ctx()) == pytest.approx(25.0)
    # 10 images x 0.01 s at the f32 peak over 2 s
    assert readers.mfu(ctx()) == pytest.approx(5.0)
    assert readers.roofline(ctx(), "k") == pytest.approx(50.0)
    # a launch count the bounds do not expect reads nothing, as does a
    # kernel the trace did not hold
    assert readers.roofline(ctx(port={"k": [3, 0.002]}), "k") is None
    assert readers.roofline(ctx(port={}), "k") is None
    assert readers.conv_ms_per_img(ctx(conv_s=0.0)) is None
    assert readers.median([]) is None
    assert readers.median([3, 1, 2]) == statistics.median([3, 1, 2])


def test_peaks_refuse_an_unknown_card():
    assert peaks.compute_peak(CARD, {"compute_dtype": "bfloat16",
                                     "cudnn_allow_tf32": True}) == 989e12
    assert peaks.compute_peak(CARD, {"compute_dtype": "float32",
                                     "cudnn_allow_tf32": True}) == 495e12
    with pytest.raises(SystemExit):
        peaks.peaks("NVIDIA H200")


def test_kernel_bounds_from_shapes():
    # render_sg_env at B=1, 120x160, K=12, D=128: bound by its bytes,
    # 0.0111 ms (chip_smoke.py's record of the kernel)
    n_bytes, ops = flops.render_sg_env(1, 120, 160, 12, 128)
    assert peaks.kernel_bound_s(CARD, n_bytes, ops) == pytest.approx(
        0.0111e-3, rel=1e-2)
    # render_sg_bwd at B=5: bound by its operations, 0.0776 ms
    assert peaks.kernel_bound_s(CARD, *flops.render_sg_bwd(
        5, 120, 160, 12, 128)) == pytest.approx(0.0776e-3, rel=1e-2)
    v, c = 76778, 1
    assert flops.bilateral_blur(v, c) == (4 * 2 * v + 40 * v, 11 * v)


def test_model_flops_count_the_reference_nets():
    cfg = {"im_height": 64, "im_width": 64, "env_rows": 32, "env_cols": 32,
           "env_height": 8, "env_width": 16, "sg_num": 12}
    fwd = flops.serve_flops(cfg, 1)
    assert fwd > 0 and flops.serve_flops(cfg, 2) == 2 * fwd
    assert flops.brdf_step_flops(cfg, 2) > 0
    assert flops.light_step_flops(cfg, 2) == 2 * flops.light_step_flops(
        cfg, 1)
