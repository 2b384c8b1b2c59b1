"""The yardstick's counts: bytes, operations and FLOPs on hand-checked
shapes, and the trace's busy and idle time on a made-up timeline."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import bounds, trace
from portbench.metrics import common
from portbench.reference.train import full_float32, stated_precision


def test_bound_takes_the_larger_of_bytes_and_operations():
    t, by = bounds.bound(3.35e12, 1.0)
    assert (t, by) == (pytest.approx(1e3), "bytes")
    t, by = bounds.bound(1.0, 67e12)
    assert (t, by) == (pytest.approx(1e3), "operations")


def test_sampler_ops_per_point():
    # 2 levels x 4 taps x a multiply-add, plus the tent, per channel; 20
    # a point for the coordinates
    assert bounds.sampler_ops("mipmap_sample", 10, 3) == 10 * (3 * 19 + 20)
    assert bounds.sampler_ops("mipmap_sample_dcoords", 1, 1) == 32 + 40


def test_pyramid_texel_bytes_single_point():
    # a point at the centre of texel (1, 1) of a 4x4 image at level 0: its
    # four taps are that texel alone (the others weigh 0 but are counted
    # as floor and ceil of an integer coordinate, the same texel)
    W = 4
    x = (2 * 1 + 1) / W - 1  # align_corners=False centre of column 1
    grid = torch.tensor([[[[x, x]]]])
    levels = torch.zeros(1, 1, 1)
    assert bounds.pyramid_texel_bytes((1, 3, 4, 4), grid, levels) == 3 * 4


def test_pyramid_texel_bytes_whole_image():
    # every texel centre of an 8x8 image, level 0: each texel once
    n = 8
    c = (2 * torch.arange(n) + 1) / n - 1
    gy, gx = torch.meshgrid(c, c, indexing="ij")
    grid = torch.stack([gx, gy], -1)[None]
    levels = torch.zeros(1, n, n)
    assert bounds.pyramid_texel_bytes((1, 2, n, n), grid, levels) == \
        n * n * 2 * 4


def test_flop_counter_counts_a_conv_and_its_input_backward():
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    w = torch.randn(5, 3, 3, 3)  # no gradient: as G's frozen weights
    with FlopCounterMode(display=False) as flops:
        torch.nn.functional.conv2d(x, w, padding=1).sum().backward()
    forward = 2 * 2 * 5 * 8 * 8 * 3 * 9
    assert flops.get_total_flops() == 2 * forward


def test_full_float32_restores_the_flags():
    b = torch.backends
    for flags in ((True, True), (False, True), (True, False)):
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = flags
        with full_float32():
            assert not b.cuda.matmul.allow_tf32
            assert not b.cudnn.allow_tf32
        assert (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32) == flags
    with pytest.raises(RuntimeError):
        with full_float32():
            raise RuntimeError
    assert (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32) == flags


def test_stated_precision_restores_the_flags():
    b = torch.backends
    for flags in ((True, True), (False, False), (True, False)):
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = flags
        with stated_precision():
            assert not b.cuda.matmul.allow_tf32
            assert b.cudnn.allow_tf32
        assert (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32) == flags


class _Event:
    def __init__(self, name, start, end, device, corr=0):
        self._v = (name, start, end, device, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._v[4]


def test_trace_busy_idle_and_kernels():
    events = [_Event(trace.RUN_RANGE, 0, 1000, False),
              _Event(trace.SENTINEL, -50, 100, True),
              _Event("mipmap_pyramid_fwd_kernel", 100, 300, True),
              _Event("gemm", 250, 400, True),  # overlaps the one before
              _Event("Memcpy DtoH", 600, 700, True),
              _Event("aten::mm", 450, 580, False)]
    t = trace.Trace(events, (0, 1000), 2, {"k1_least_s": 50e-9,
                                          "model_flops_per_unit": 1e3})
    assert t.window_s == pytest.approx(900e-9)  # opens after the sentinel
    assert t.busy_s == pytest.approx(400e-9)
    assert len(t.kernels) == 2
    assert common.per_unit_kernels(t) == 1
    assert common.idle_share(t) == pytest.approx(100 * 5 / 9)
    assert common.roofline(t, {common.K1: "k1_least_s"}) == \
        pytest.approx(25.0)
    assert common.roofline(t, {common.K3: "k3_least_s"}) is None
    assert common.mfu(t) == pytest.approx(
        100 * 2e3 / 900e-9 / bounds.TF32_FLOPS_PER_S)
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(200e-9)
    assert math.isclose(sum(gaps.values()), 500e-9)
