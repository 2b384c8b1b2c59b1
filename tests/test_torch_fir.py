"""The FIR resampler's card path, checked on the CPU.

``ops/resample.py::upfirdn2d`` runs the FIR kernel (csrc/upfirdn2d.cu) on a
CUDA tensor of any floating dtype, through ``Upfirdn2d``, whose backward is the same
function with the taps flipped, up and down swapped and the complementary
pads (``grad_pads``). Here that formula runs in plain PyTorch and is held to
autograd of the plain forward at each call class the model makes: the STN
encoders' Blur (pad (2, 2) before a 3x3 stride-2 conv, (1, 1) before the
skip's 1x1), G's blur after each transposed conv (pad (1, 1), taps times 4,
odd sides), ToRGB's ``upsample2x`` (up 2, 3 channels) and the gradient of
that gradient (down 2). ``Upfirdn2d`` itself runs on the CPU with its
launcher swapped for the plain version. The kernel against the plain
version on the card: tests/test_torch_kernels.py (marker ``cuda``).
"""

import types

import pytest
import torch

from gangealing_torch import LAUNCHES
from gangealing_torch.models import layers
from gangealing_torch.ops import resample as rs

BLUR = (1, 3, 3, 1)
# (taps, gain, up, down, pad, channels, side): the model's call classes
CALLS = {
    "stn_blur_pad2": (BLUR, 1, 1, 1, (2, 2), 4, 16),
    "stn_blur_pad2_8": (BLUR, 1, 1, 1, (2, 2), 6, 8),
    "stn_skip_pad1": (BLUR, 1, 1, 1, (1, 1), 4, 16),
    "stn_skip_pad1_odd": (BLUR, 1, 1, 1, (1, 1), 4, 13),
    **{f"g_blur_{s}": (BLUR, 4, 1, 1, (1, 1), 2, s)
       for s in (9, 17, 33, 65, 129, 257)},
    "upsample2x_8": (BLUR, 4, 2, 1, (2, 1), 3, 8),
    "upsample2x_32": (BLUR, 4, 2, 1, (2, 1), 3, 32),
    "upsample2x_grad": (BLUR[::-1], 4, 1, 2, (1, 1), 3, 16),
    "asymmetric_taps": ((1, 2, 5, 3), 1, 1, 1, (2, 1), 2, 11),
    "crop": (BLUR, 1, 1, 1, (-1, 2), 2, 12),
}


def _x(channels, side, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(2, channels, side, side, generator=g, dtype=dtype)


@pytest.mark.parametrize("call", sorted(CALLS))
def test_gradient_formula_equals_autograd(call):
    """``upfirdn2d_grad`` (plain on the CPU) equals autograd of the plain
    forward: the formula the kernel's backward runs."""
    taps, gain, up, down, pad, C, side = CALLS[call]
    f = rs.fir(taps, gain)
    x = _x(C, side, 0, torch.float64).requires_grad_()
    y = rs.upfirdn2d(x, f, up=up, down=down, pad=pad)
    dy = torch.randn(y.shape, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(2))
    (ref,) = torch.autograd.grad(y, x, dy)
    pads = (pad[0], pad[1], pad[0], pad[1])
    ours = rs.upfirdn2d_grad(dy, f, up, down, pads, (side, side))
    assert ours.shape == x.shape
    torch.testing.assert_close(ours, ref, atol=1e-12, rtol=0)


def _plain_launcher(calls):
    """``upfirdn2d_cuda`` run by the plain version, each call recorded."""
    def launch(x, f, up, down, pads, name="upfirdn2d"):
        assert x.is_contiguous()
        calls.append((name, up, down, pads))
        return rs.upfirdn2d_plain(x, rs.fir_matrix(f), up, down, pads)
    return launch


@pytest.fixture
def function_on_cpu(monkeypatch):
    """``upfirdn2d`` through ``Upfirdn2d`` on CPU tensors of any floating
    dtype, the launcher the plain version; yields the launches made."""
    calls = []
    monkeypatch.setattr(rs, "takes_kernel", lambda x: x.is_floating_point())
    monkeypatch.setattr(rs, "upfirdn2d_cuda", _plain_launcher(calls))
    yield calls


@pytest.mark.parametrize("call", ["stn_blur_pad2", "g_blur_33",
                                  "upsample2x_8", "upsample2x_grad", "crop"])
def test_function_backward_and_double_backward(function_on_cpu, call):
    """``Upfirdn2d``'s gradient and gradient of gradient pass torch's
    numerical checks, one launch a forward and one a backward."""
    taps, gain, up, down, pad, C, side = CALLS[call]
    f = rs.fir(taps, gain)
    x = _x(1, min(side, 9), 3, torch.float64).requires_grad_()

    def fn(t):
        return rs.upfirdn2d(t, f, up=up, down=down, pad=pad)
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))
    function_on_cpu.clear()
    y = fn(x)
    y.backward(torch.ones_like(y))
    assert [c[0] for c in function_on_cpu] == ["upfirdn2d", "upfirdn2d_dx"]
    assert function_on_cpu[1][1:3] == (down, up)


def test_function_saves_no_tensor(function_on_cpu):
    x = _x(2, 12, 4).requires_grad_()
    y = rs.blur(x, BLUR, (1, 1), upsample_factor=2)
    assert y.grad_fn.saved_tensors == ()


def test_strided_input_is_made_contiguous(function_on_cpu):
    x = _x(3, 10, 5).transpose(2, 3)
    ref = rs.upfirdn2d_plain(x, rs.make_kernel(BLUR), 1, 1, (2, 2, 2, 2))
    torch.testing.assert_close(rs.blur(x, BLUR, (2, 2)), ref, atol=0, rtol=0)


def test_cpu_tensors_launch_nothing():
    before = dict(LAUNCHES)
    x = _x(3, 16, 6).requires_grad_()
    blur = layers.Blur(BLUR, pad=(2, 2))
    y = (blur(x).sum() + rs.blur(x, BLUR, (1, 1), 2).sum()
         + rs.upsample2x(x, BLUR).sum())
    y.backward()
    assert LAUNCHES == before


@pytest.mark.parametrize("taps,gain", [(BLUR, 1), (BLUR, 4), ((1, 2, 1), 1),
                                       ((1, 2, 5, 3), 2)])
def test_tap_cache_holds_make_kernel(taps, gain):
    """The cached taps are what ``make_kernel`` builds, to the bit: the
    plain version's 2-D taps, and the kernel's launch taps (the plain
    version's conv weight, zero-padded to 4 x 4), each built once."""
    f = rs.fir(list(taps), gain)
    ref = rs.make_kernel(list(taps)) * gain
    torch.testing.assert_close(rs.fir_matrix(f), ref, atol=0, rtol=0)
    K = len(taps)
    launch = torch.tensor(list(rs.kernel_taps(f))).reshape(4, 4)
    torch.testing.assert_close(launch[:K, :K], torch.flip(ref, (0, 1)),
                               atol=0, rtol=0)
    assert not launch[K:].any() and not launch[:, K:].any()
    assert rs.fir_matrix(rs.fir(taps, gain)) is rs.fir_matrix(f)
    assert rs.kernel_taps(rs.fir(taps, gain)) is rs.kernel_taps(f)


@pytest.mark.parametrize("device,dtype,kernel", [
    ("cuda", torch.float32, True), ("cuda", torch.bfloat16, True),
    ("cuda", torch.float16, True), ("cuda", torch.float64, True),
    ("cpu", torch.float32, False), ("cpu", torch.bfloat16, False)])
def test_dtype_choice(device, dtype, kernel):
    """The FIR kernel takes every CUDA tensor: bfloat16 (``--compute_dtype
    bfloat16``), float16 and float64 too, each under its own code in the
    kernel's entry point; a CPU tensor takes the plain version."""
    x = types.SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert rs.takes_kernel(x) is kernel
    if kernel:
        assert rs.KERNEL_DTYPES[dtype] == ("float32", "float64", "bfloat16",
                                           "float16").index(str(dtype)[6:])


def test_function_keeps_the_dtype(function_on_cpu):
    """A bfloat16 tensor goes to the launcher as it is, and its output and
    gradient come back in bfloat16."""
    x = _x(3, 12, 8, torch.bfloat16).requires_grad_()
    y = rs.blur(x, BLUR, (1, 1), upsample_factor=2)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert y.dtype == dx.dtype == torch.bfloat16
    assert [c[0] for c in function_on_cpu] == ["upfirdn2d", "upfirdn2d_dx"]


def test_plain_path_is_unchanged():
    """A CPU tensor through ``blur`` and ``upsample2x`` gives the bits of
    the depthwise conv over ``make_kernel``'s taps."""
    x = _x(3, 16, 7)
    k = rs.make_kernel(BLUR)
    torch.testing.assert_close(
        rs.blur(x, BLUR, (1, 1), upsample_factor=2),
        rs.upfirdn2d_plain(x, k * 4, 1, 1, (1, 1, 1, 1)), atol=0, rtol=0)
    torch.testing.assert_close(
        rs.upsample2x(x, BLUR),
        rs.upfirdn2d_plain(x, k * 4, 2, 1, (2, 1, 2, 1)), atol=0, rtol=0)
