"""FIR resampling, bias-activation and bilinear resizing.

Port of the off-TPU branches of gangealing_tpu/ops/resample.py. The JAX
package wrote these in XLA, not Pallas. ``upfirdn2d`` takes its plain
version, one depthwise ``F.conv2d`` over a padded copy, for a CPU tensor;
a CUDA tensor goes through ``Upfirdn2d``, whose forward and backward
launch the FIR kernel of csrc/upfirdn2d.cu (implicit padding, polyphase
upsampling, the taps as launch arguments), which in float32 gives the
plain version's bits. The rest are PyTorch ops on every device.
"""

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gangealing_torch import _build

# the most taps a side the FIR kernel takes; shorter filters are padded
KERNEL_TAPS = 4
# (up, down) of the forwards and of their gradients
KERNEL_FACTORS = ((1, 1), (2, 1), (1, 2))
# the element types the FIR kernel takes, by their code in its entry point
KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
                 torch.float16: 3}


def make_kernel(k, device=None):
    """1-D or 2-D FIR kernel, normalized to sum 1 (reference networks.py:17)."""
    k = torch.as_tensor(k, dtype=torch.float32, device=device)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


class Fir(NamedTuple):
    """The separable FIR ``make_kernel(k) * gain``, by its 1-D taps ``k``.
    It is hashable, so its tap forms are cached on the host and no tap
    tensor is built on the card a call."""
    k: tuple
    gain: float = 1.0

    def flipped(self):
        return Fir(self.k[::-1], self.gain)


def fir(k, gain=1.0):
    """The ``Fir`` of the 1-D taps ``k`` (any sequence) times ``gain``."""
    return Fir(tuple(float(v) for v in k), float(gain))


@functools.lru_cache(maxsize=None)
def fir_matrix(f):
    """The 2-D float32 CPU taps of ``f``, as ``make_kernel`` builds them."""
    return make_kernel(f.k) * f.gain


@functools.lru_cache(maxsize=None)
def kernel_taps(f):
    """The FIR kernel's launch taps of ``f``: the correlation taps (the
    plain version's conv weight, ``fir_matrix`` flipped), zero-padded to
    ``KERNEL_TAPS`` a side, row-major, as a host float32 array."""
    w = torch.zeros(KERNEL_TAPS, KERNEL_TAPS)
    K = len(f.k)
    w[:K, :K] = torch.flip(fir_matrix(f), (0, 1))
    return (ctypes.c_float * w.numel())(*w.flatten().tolist())


def takes_kernel(x):
    """Whether ``upfirdn2d`` runs the FIR kernel on ``x``: a CUDA tensor,
    of any floating dtype in ``KERNEL_DTYPES`` (bfloat16 under
    ``--compute_dtype bfloat16`` too). A CPU tensor takes the plain
    version."""
    return x.device.type == "cuda"


def upfirdn2d(x, f, up=1, down=1, pad=(0, 0)):
    """Upsample (zero-insert), FIR filter by the ``Fir`` ``f``, downsample.

    x: (N, C, H, W). ``pad`` is (pad0, pad1) applied to both spatial dims.
    Output H' = (H*up + pad0 + pad1 - kh)//down + 1. As in the reference,
    each sample is followed by ``up - 1`` zeros.
    """
    pads = (pad[0], pad[1], pad[0], pad[1])
    if takes_kernel(x):
        return upfirdn2d_card(x, f, up, down, pads)
    return upfirdn2d_plain(x, fir_matrix(f), up, down, pads)


def upfirdn2d_plain(x, kernel, up, down, pads):
    """The plain version: zero-insert, pad by ``pads`` (x0, x1, y0, y1;
    negative crops), and filter as one depthwise conv."""
    N, C, H, W = x.shape
    if up > 1:
        x = F.pad(x.reshape(N, C, H, 1, W, 1), (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(N, C, H * up, W * up)
    x = F.pad(x, pads)
    # correlating with the flipped kernel is a true convolution
    k = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    return F.conv2d(x, k[None, None].expand(C, 1, *kernel.shape),
                    stride=down, groups=C)


def upfirdn2d_card(x, f, up, down, pads):
    """The card's path: the FIR kernel through ``Upfirdn2d``, on a
    contiguous copy of an input that is not NCHW-contiguous."""
    return Upfirdn2d.apply(x.contiguous(), f, up, down, pads, "upfirdn2d")


def grad_pads(taps, in_hw, out_hw, up, down, pads):
    """The pads (x0, x1, y0, y1) of the gradient of an upfirdn2d from
    ``in_hw`` to ``out_hw``: the same FIR flipped, ``up`` and ``down``
    swapped, over its output's gradient (StyleGAN2's upfirdn2d gradient)."""
    (H, W), (OH, OW) = in_hw, out_hw
    px0, _, py0, _ = pads
    return (taps - px0 - 1, W * up - OW * down + px0 - up + 1,
            taps - py0 - 1, H * up - OH * down + py0 - up + 1)


def upfirdn2d_grad(dy, f, up, down, pads, in_hw):
    """The gradient of ``upfirdn2d(x, f, up, down)`` padded by ``pads``
    with respect to ``x`` of spatial size ``in_hw``, given ``dy``: the
    kernel on the card (a launch counted as ``upfirdn2d_dx``), the plain
    version elsewhere."""
    gp = grad_pads(len(f.k), in_hw, dy.shape[-2:], up, down, pads)
    if takes_kernel(dy):
        return Upfirdn2d.apply(dy.contiguous(), f.flipped(), down, up, gp,
                               "upfirdn2d_dx")
    return upfirdn2d_plain(dy, fir_matrix(f.flipped()), down, up, gp)


class Upfirdn2d(torch.autograd.Function):
    """upfirdn2d on the card: the FIR kernel forward; the backward is this
    Function again on the gradient (``upfirdn2d_grad``), so it is
    differentiable again. Nothing is saved for the backward but shapes."""

    @staticmethod
    def forward(ctx, x, f, up, down, pads, name):
        ctx.geometry = (f, up, down, pads, tuple(x.shape[-2:]))
        return upfirdn2d_cuda(x, f, up, down, pads, name)

    @staticmethod
    def backward(ctx, dy):
        f, up, down, pads, in_hw = ctx.geometry
        return upfirdn2d_grad(dy, f, up, down, pads, in_hw), *[None] * 5


def upfirdn2d_cuda(x, f, up, down, pads, name="upfirdn2d"):
    """The FIR kernel: ``upfirdn2d`` of a contiguous (N, C, H, W) CUDA
    tensor of a dtype in ``KERNEL_DTYPES`` by ``f`` of at most
    ``KERNEL_TAPS`` taps a side, up and down in ``KERNEL_FACTORS``, padded
    by ``pads`` (x0, x1, y0, y1), in ``x``'s dtype, summed in float (double
    for float64); in float32 to the bits of the plain version (a
    forward's, or with ``name`` ``"upfirdn2d_dx"`` its autograd's). One
    launch, counted under ``name``."""
    device = x.device
    _build.check_operand("x", x, 4, device, dtypes=tuple(KERNEL_DTYPES))
    K = len(f.k)
    if K > KERNEL_TAPS or (up, down) not in KERNEL_FACTORS:
        raise ValueError(f"the FIR kernel takes up to {KERNEL_TAPS} taps and "
                         f"(up, down) in {KERNEL_FACTORS}; got {K} taps, "
                         f"({up}, {down})")
    N, C, H, W = x.shape
    px0, px1, py0, py1 = pads
    OH = (H * up + py0 + py1 - K) // down + 1
    OW = (W * up + px0 + px1 - K) // down + 1
    if OH <= 0 or OW <= 0:
        raise ValueError(f"upfirdn2d of {tuple(x.shape)} by {K} taps, up "
                         f"{up}, down {down}, pads {pads} is empty")
    y = torch.empty((N, C, OH, OW), device=device, dtype=x.dtype)
    lib = _build.load_kernels()
    # a gradient sums its taps in the order ATen's conv backward does
    _build.launch(name, lib.gg_upfirdn2d, x.data_ptr(), y.data_ptr(),
                  KERNEL_DTYPES[x.dtype], N * C, H, W, OH, OW, up, down, px0,
                  py0, kernel_taps(f),
                  int(name == "upfirdn2d_dx"), device.index,
                  _build.stream_of(device))
    return y


def upsample2x(x, kernel, factor=2):
    """Blur-based 2x upsample (reference networks.py:28-46)."""
    p = len(kernel) - factor
    return upfirdn2d(x, fir(kernel, factor ** 2), up=factor,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def blur(x, kernel, pad, upsample_factor=1):
    """FIR blur (reference networks.py:70-86); after an upsampling by
    ``upsample_factor`` the taps are scaled by its square."""
    return upfirdn2d(x, fir(kernel, upsample_factor ** 2), pad=pad)


def rounded_like(value, x):
    """The Python scalar ``value`` rounded to the dtype of ``x``. JAX
    rounds a scalar to an array's dtype before an op between them; torch
    takes it at float32 (or wider), which differs only below float32."""
    if x.dtype in (torch.float32, torch.float64):
        return value
    return _rounded(value, x.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(value, dtype):
    return torch.tensor(value, dtype=dtype).item()


def fused_leaky_relu(x, bias=None, negative_slope=0.2, scale=2 ** 0.5):
    """bias-add (broadcast at channel dim 1) + leaky ReLU + scale."""
    if bias is not None:
        shape = [1] * x.ndim
        shape[1] = bias.shape[0]
        x = x + bias.reshape(shape).to(x.dtype)
    return (torch.where(x >= 0, x, x * rounded_like(negative_slope, x))
            * rounded_like(scale, x))


def _tent_kernel(stride, device=None):
    k = torch.arange(1, 2 * stride + 1, 2, dtype=torch.float32, device=device)
    k = torch.cat([k, k.flip(0)])
    return k / k.sum()


def bilinear_downsample(x, stride):
    """Anti-aliased integer-stride downsample with a separable tent kernel.

    Matches reference BilinearDownsample (antialiased_sampling.py:241-256):
    reflection-pad stride//2, then horizontal and vertical depthwise convs.
    """
    if stride == 1:
        return x
    C = x.shape[1]
    k = _tent_kernel(stride, x.device).to(x.dtype)
    pad = stride // 2
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    x = F.conv2d(x, k[None, None, None, :].expand(C, 1, 1, 2 * stride),
                 stride=(1, stride), groups=C)
    return F.conv2d(x, k[None, None, :, None].expand(C, 1, 2 * stride, 1),
                    stride=(stride, 1), groups=C)


def _resize_axis_weights(in_size, out_size, dtype=torch.float32, device=None):
    """Per-output-pixel source indices and lerp weights (half-pixel centers),
    with the source clamped to [0, in_size - 1]."""
    scale = in_size / out_size
    src = (torch.arange(out_size, dtype=dtype, device=device) + 0.5) * scale - 0.5
    src = src.clamp(0.0, in_size - 1)
    i0 = torch.floor(src).long()
    i1 = (i0 + 1).clamp(max=in_size - 1)
    w1 = src - i0.to(dtype)
    return i0, i1, 1.0 - w1, w1


def interpolate_bilinear(x, out_h, out_w):
    """Bilinear resize of (..., H, W) arrays, torch interpolate semantics
    (align_corners=False, antialias=False), as two separable weighted takes.
    """
    H, W = x.shape[-2:]
    xf = x.float()
    if H != out_h:
        i0, i1, w0, w1 = _resize_axis_weights(H, out_h, device=x.device)
        xf = (xf.index_select(-2, i0) * w0[:, None]
              + xf.index_select(-2, i1) * w1[:, None])
    if W != out_w:
        i0, i1, w0, w1 = _resize_axis_weights(W, out_w, device=x.device)
        xf = xf.index_select(-1, i0) * w0 + xf.index_select(-1, i1) * w1
    return xf.to(x.dtype)
