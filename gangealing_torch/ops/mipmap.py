"""Mipmap-anti-aliased warping (the quality core of the STN sampler).

Port of gangealing_tpu/ops/mipmap.py. ``_mipmap_warp_fold`` is the plain
PyTorch version. On CUDA, ``mipmap_warp`` builds the levels and a
native-resolution Gaussian pyramid (``_build_pyramid``: the blur chain,
no upsampling) with plain torch ops and samples the pyramid through
``MipmapSample``, an autograd Function over the kernels of
csrc/mipmap_sample.cu, which rebuild each full-resolution tap from the
native levels: the forward (K1) replaces
gangealing_tpu/ops/pallas_mipmap.py::_fwd_kernel, its backward the
``_dcoords_kernel`` (K3, d/dgrid and d/dlevels) and ``_dimg_kernel`` (K5a,
d/dpyramid, a deterministic binned gather). ``_sample_pyramid`` is their
plain version. Autograd chains d/dlevels through ``mipmap_levels`` and
d/dpyramid through the blur chain, as the JAX package chains its kernels
through ``_band_tent_coords``.

The plain version differentiates as ``jax.grad`` of the JAX fold path does,
ties included (clamps and the level tent at integer levels).
"""

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gangealing_torch import _build
from gangealing_torch.ops.grid_sample import (
    _check_dout, _check_grid, grid_sample, jabs, jclip, jmax)
from gangealing_torch.ops.resample import interpolate_bilinear
from gangealing_torch.utils.profiling import span


def _gaussian_blur_2x(x):
    """[1,3,3,1] outer-product blur, reflection pad 1, stride 2, as two
    separable 1-D passes."""
    C = x.shape[1]
    k1 = torch.tensor([1.0, 3.0, 3.0, 1.0], dtype=x.dtype, device=x.device)
    k1 = k1 / 8.0  # so kv * kh == k / 64, the normalized 2-D kernel
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
    out = F.conv2d(xp, k1[None, None, :, None].expand(C, 1, 4, 1),
                   stride=(2, 1), groups=C)
    return F.conv2d(out, k1[None, None, None, :].expand(C, 1, 1, 4),
                    stride=(1, 2), groups=C)


def _max_coord_distance(coords):
    """Max distance to 4-neighbor sampling coords. coords: (N, H, W, 2)."""
    padded = F.pad(coords.permute(0, 3, 1, 2), (1, 1, 1, 1),
                   mode="replicate").permute(0, 2, 3, 1)

    def dist(other):
        sq = ((other - coords) ** 2).sum(dim=3)
        return torch.sqrt(jmax(sq, 1.0))

    d_l = dist(padded[:, 1:-1, :-2, :])
    d_r = dist(padded[:, 1:-1, 2:, :])
    d_u = dist(padded[:, :-2, 1:-1, :])
    d_d = dist(padded[:, 2:, 1:-1, :])
    return torch.maximum(torch.maximum(d_l, d_r), torch.maximum(d_u, d_d))


def mipmap_levels(grid, height, width, max_num_levels):
    """Per-pixel mipmap level from the sampling grid (N, H, W, 2)."""
    # (size - 1) * (g + 1) / 2 as the JAX package forms it, to the bit: the
    # halving is exact whichever side of the product it falls on
    scale = grid.new_tensor([(width - 1.0) / 2.0, (height - 1.0) / 2.0])
    coords = (grid + 1.0) * scale
    levels = torch.log2(_max_coord_distance(coords))
    return jclip(levels, 0.0, max_num_levels - 1.0)


def _pad_to_power_of_2(x):
    """Reflect-pad (N, C, H, W) on both axes by the amounts that bring the
    width to the next power of 2, as the Gaussian levels are built. Returns
    the padded tensor and the left and right pads."""
    size = x.shape[-1]
    log_size = math.log2(size)
    if float(log_size).is_integer():
        return x, 0, 0
    total = int(2 ** math.ceil(log_size)) - size
    lp = total // 2
    rp = total - lp
    return F.pad(x, (lp, rp, lp, rp), mode="reflect"), lp, rp


def _build_stack(x, num_levels):
    """Gaussian stack: level i is blurred (cumulatively downsampled 2x then
    bilinearly upsampled back). Non-power-of-2 inputs reflect-padded first.
    Returns list of (N, C, H, W) tensors, length num_levels."""
    x, lp, rp = _pad_to_power_of_2(x)
    levels = [x]
    cur = x
    full = x.shape[-1]
    for _ in range(1, num_levels):
        cur = _gaussian_blur_2x(cur)
        levels.append(interpolate_bilinear(cur, full, full))
    if lp or rp:
        levels = [lv[:, :, lp:-rp, lp:-rp] for lv in levels]
    return levels


class PyramidShape(NamedTuple):
    """The geometry of a ``Pyramid``: ``num_levels`` levels of ``channels``
    channels, level d of side ``size >> d``; the warp samples the
    (height, width) crop at offset ``lp`` of every level's full-resolution
    rebuild."""
    num_levels: int
    channels: int
    height: int
    width: int
    size: int
    lp: int

    def sides(self):
        return [self.size >> d for d in range(self.num_levels)]

    def texel(self):
        """Floats per texel of the coarse levels: the channels, zero-padded
        to whole float4 groups."""
        return 4 * -(-self.channels // 4)


class Pyramid(NamedTuple):
    """A Gaussian pyramid at native resolution. ``level0`` (N, C, S, S) is
    the input reflect-padded to S = ``shape.size`` (the input itself when
    its side is a power of 2); ``coarse`` (N, L) holds levels 1.. of each
    image, packed as [level][row][column][channel] with the channels padded
    to ``shape.texel()``."""
    level0: torch.Tensor
    coarse: torch.Tensor
    shape: PyramidShape


def _build_pyramid(x, num_levels):
    """Native-resolution Gaussian pyramid of a square (N, C, H, H) image:
    level 0 is the input (padded as ``_build_stack`` pads it), level d is
    ``_gaussian_blur_2x`` applied d times, at its own (size / 2^d)^2. No
    level is upsampled."""
    N, C, H, W = x.shape
    if H != W:
        raise ValueError(f"the Gaussian levels need a square image, got "
                         f"{H}x{W}")
    level0, lp, _ = _pad_to_power_of_2(x)
    shape = PyramidShape(num_levels, C, H, W, level0.shape[-1], lp)
    if shape.sides()[-1] < 1:
        raise ValueError(f"{num_levels} levels need a side of at least "
                         f"{2 ** (num_levels - 1)}, got {W}")
    coarse, cur = [], level0
    for _ in range(1, num_levels):
        cur = _gaussian_blur_2x(cur)
        texels = F.pad(cur.permute(0, 2, 3, 1), (0, shape.texel() - C))
        coarse.append(texels.reshape(N, -1))
    return Pyramid(level0.contiguous(), torch.cat(coarse, dim=1), shape)


def _pyramid_levels(pyramid):
    """The levels of a pyramid, each as (N, C, side, side)."""
    level0, coarse, shape = pyramid
    N, C, t = coarse.shape[0], shape.channels, shape.texel()
    sides = shape.sides()[1:]
    parts = coarse.split([s * s * t for s in sides], dim=1)
    return [level0] + [p.reshape(N, s, s, t)[..., :C].permute(0, 3, 1, 2)
                       for p, s in zip(parts, sides)]


def _rebuild_stack(pyramid):
    """The full-resolution Gaussian stack (N, D, C, H, W) of a pyramid,
    equal to ``_build_stack``'s: every level d >= 1 upsampled by
    ``interpolate_bilinear``, then the crop."""
    shape = pyramid.shape
    full, lp = shape.size, shape.lp
    levels = [lv if d == 0 else interpolate_bilinear(lv, full, full)
              for d, lv in enumerate(_pyramid_levels(pyramid))]
    stack = torch.stack(levels, dim=1)
    return stack[..., lp:lp + shape.height, lp:lp + shape.width]


def _sample_stack(stack, grid, levels, padding_mode):
    """The plain version of the mipmap kernel: warp all D levels of the
    (N, D, C, H, W) stack as folded channels, then tent-lerp over the level
    axis. Exact; pays D x the sampling work."""
    N, D, C, H, W = stack.shape
    Ho, Wo = grid.shape[1], grid.shape[2]
    warped = grid_sample(stack.reshape(N, D * C, H, W), grid,
                         padding_mode=padding_mode).reshape(N, D, C, Ho, Wo)
    # Linear interp between floor/ceil levels == tent-weighted sum over the
    # level axis (weights are zero outside [floor, ceil]).
    lv = levels[:, None, None, :, :]
    d = torch.arange(D, dtype=levels.dtype,
                     device=levels.device)[None, :, None, None, None]
    w = jmax(1.0 - jabs(lv - d), 0.0)
    return (warped * w.to(warped.dtype)).sum(dim=1)  # (N, C, Ho, Wo)


def _mipmap_warp_fold(inputs, grid, num_levels, levels, padding_mode):
    """The plain mipmap warp: build the Gaussian stack and sample it with
    ``_sample_stack``."""
    stack = torch.stack(_build_stack(inputs, num_levels), dim=1)
    return _sample_stack(stack, grid, levels, padding_mode)


def _sample_pyramid(pyramid, grid, levels, padding_mode):
    """The plain version of K1 and K3: rebuild the full-resolution stack of
    a pyramid and sample it with ``_sample_stack``."""
    return _sample_stack(_rebuild_stack(pyramid), grid, levels, padding_mode)


class MipmapSample(torch.autograd.Function):
    """Sample a pyramid at per-point levels on the card: K1 forward; the
    backward launches K3 for d/dgrid and d/dlevels and K5a for d/dlevel0
    and d/dcoarse, each only when its inputs need a gradient."""

    @staticmethod
    def forward(ctx, level0, coarse, shape, grid, levels, padding_mode):
        ctx.save_for_backward(level0, coarse, grid, levels)
        ctx.shape = shape
        ctx.padding_mode = padding_mode
        return mipmap_sample(Pyramid(level0, coarse, shape), grid, levels,
                             padding_mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        level0, coarse, grid, levels = ctx.saved_tensors
        pyramid = Pyramid(level0, coarse, ctx.shape)
        dout = dout.contiguous()
        dlevel0 = dcoarse = dgrid = dlevels = None
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
            dgrid, dlevels = mipmap_sample_dcoords(pyramid, grid, levels,
                                                   dout, ctx.padding_mode)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dlevel0, dcoarse = mipmap_sample_dpyramid(
                ctx.shape, grid, levels, dout, ctx.padding_mode)
        return dlevel0, dcoarse, None, dgrid, dlevels, None


def _coarse_floats(shape):
    """Floats of one image's coarse levels in the ``Pyramid`` packing."""
    return sum(shape.texel() * s * s for s in shape.sides()[1:])


def _check_points(shape, grid, levels, N, device):
    """Raise unless grid (N, Ho, Wo, 2) and levels (N, Ho, Wo) are what the
    kernels take for a pyramid of ``shape``; return (Ho, Wo)."""
    _build.check_operand("grid", grid, 4, device)
    _build.check_operand("levels", levels, 3, device)
    Ho, Wo = _check_grid(grid, N)
    if tuple(levels.shape) != (N, Ho, Wo):
        raise ValueError(f"levels must be {(N, Ho, Wo)}, got {tuple(levels.shape)}")
    if shape.num_levels < 2:
        raise ValueError(f"the pyramid needs at least 2 levels, got "
                         f"{shape.num_levels}")
    return Ho, Wo


def _check_pyramid_operands(pyramid, grid, levels):
    level0, coarse, shape = pyramid
    device = level0.device
    _build.check_operand("level0", level0, 4, device)
    _build.check_operand("coarse", coarse, 2, device)
    N = level0.shape[0]
    Ho, Wo = _check_points(shape, grid, levels, N, device)
    S, C = shape.size, shape.channels
    per_image = _coarse_floats(shape)
    if tuple(level0.shape) != (N, C, S, S) or \
            tuple(coarse.shape) != (N, per_image):
        raise ValueError(f"a pyramid of {shape} for {N} images has level 0 "
                         f"{(N, C, S, S)} and coarse levels {(N, per_image)}"
                         f", got {tuple(level0.shape)} and "
                         f"{tuple(coarse.shape)}")
    if coarse.data_ptr() % 16:
        raise ValueError("the coarse levels must be 16-byte aligned")
    return Ho, Wo


def _pyramid_args(pyramid):
    shape = pyramid.shape
    return (pyramid.level0.shape[0], shape.num_levels, shape.channels,
            shape.size, shape.height, shape.width, shape.lp)


def mipmap_sample(pyramid, grid, levels, padding_mode="border"):
    """K1: sample a ``Pyramid`` (``_build_pyramid``) at per-point levels, on
    the card.

    The pyramid's tensors, grid (N, Ho, Wo, 2) and levels (N, Ho, Wo):
    contiguous float32 CUDA tensors on one device, at least 2 levels.
    Returns (N, C, Ho, Wo) float32, equal to ``_sample_pyramid`` to a few
    units in the last place.
    """
    Ho, Wo = _check_pyramid_operands(pyramid, grid, levels)
    device = grid.device
    out = torch.empty((grid.shape[0], pyramid.shape.channels, Ho, Wo),
                      device=device, dtype=torch.float32)
    lib = _build.load_kernels()
    _build.launch("mipmap_sample", lib.gg_mipmap_pyramid_fwd,
                  pyramid.level0.data_ptr(), pyramid.coarse.data_ptr(),
                  grid.data_ptr(), levels.data_ptr(), out.data_ptr(),
                  *_pyramid_args(pyramid), Ho, Wo,
                  _build.padding_code(padding_mode), device.index,
                  _build.stream_of(device))
    return out


def mipmap_sample_dcoords(pyramid, grid, levels, dout, padding_mode="border"):
    """K3: the gradients of ``mipmap_sample`` with respect to the grid
    (N, Ho, Wo, 2) and the levels (N, Ho, Wo), given ``dout`` (N, C, Ho, Wo)
    on the card."""
    Ho, Wo = _check_pyramid_operands(pyramid, grid, levels)
    device = grid.device
    _check_dout(dout, grid.shape[0], pyramid.shape.channels, Ho, Wo, device)
    dgrid = torch.empty_like(grid)
    dlevels = torch.empty_like(levels)
    lib = _build.load_kernels()
    _build.launch("mipmap_sample_dcoords", lib.gg_mipmap_pyramid_dcoords,
                  pyramid.level0.data_ptr(), pyramid.coarse.data_ptr(),
                  grid.data_ptr(), levels.data_ptr(), dout.data_ptr(),
                  dgrid.data_ptr(), dlevels.data_ptr(),
                  *_pyramid_args(pyramid), Ho, Wo,
                  _build.padding_code(padding_mode), device.index,
                  _build.stream_of(device))
    return dgrid, dlevels


def mipmap_sample_dpyramid(shape, grid, levels, dout, padding_mode="border"):
    """K5a: the gradient of ``mipmap_sample`` with respect to a pyramid of
    ``shape`` (``PyramidShape``), given ``dout`` (N, C, Ho, Wo) on the card:
    d/dlevel0 (N, C, S, S), in the padded frame, and d/dcoarse (N, L) in the
    ``Pyramid`` packing, its padding channels 0. A binned gather with no
    atomics: the same bits from run to run. Three kernels, one count in
    ``LAUNCHES``; the gradients and the scratch come from ``torch.empty``."""
    device = grid.device
    N = grid.shape[0]
    Ho, Wo = _check_points(shape, grid, levels, N, device)
    D, C, S = shape.num_levels, shape.channels, shape.size
    _check_dout(dout, N, C, Ho, Wo, device)
    code = _build.padding_code(padding_mode)
    if Ho * Wo == 0:
        return (torch.zeros((N, C, S, S), device=device),
                torch.zeros((N, _coarse_floats(shape)), device=device))
    if grid.data_ptr() % 8:  # K5a reads a point as one float2
        grid = grid.clone()
    lib = _build.load_kernels()
    nbytes = lib.gg_mipmap_dpyramid_scratch(N, D, C, S, Ho * Wo)
    if nbytes < 0:
        raise ValueError(f"K5a does not take a pyramid of {shape} sampled "
                         f"at {N} x {Ho} x {Wo} points")
    dlevel0 = torch.empty((N, C, S, S), device=device, dtype=torch.float32)
    dcoarse = torch.empty((N, _coarse_floats(shape)), device=device,
                          dtype=torch.float32)
    scratch = torch.empty(max(nbytes, 1), device=device, dtype=torch.uint8)
    _build.launch("mipmap_sample_dpyramid", lib.gg_mipmap_dpyramid,
                  grid.data_ptr(), levels.data_ptr(), dout.data_ptr(),
                  dlevel0.data_ptr(), dcoarse.data_ptr(), scratch.data_ptr(),
                  N, D, C, S, shape.height, shape.width, shape.lp, Ho * Wo,
                  code, device.index, _build.stream_of(device))
    return dlevel0, dcoarse


def mipmap_warp(inputs, grid, max_num_levels=3.5, padding_mode="border"):
    """Anti-aliased grid_sample: per-pixel mipmap level selection.

    inputs: (N, C, H, W); grid: (N, Ho, Wo, 2) normalized to [-1, 1].
    A CPU tensor takes the plain ``_mipmap_warp_fold``; a CUDA tensor
    takes ``_pyramid_warp``.
    """
    N, C, H, W = inputs.shape
    num_levels = int(math.ceil(max_num_levels - 1.0)) + 1
    # the JAX warp's floor at its min_level of 0: no change to the values,
    # but half the gradient of a level that sits on it
    levels = jmax(mipmap_levels(grid, H, W, max_num_levels), 0.0)
    if inputs.device.type == "cpu":
        return _mipmap_warp_fold(inputs, grid, num_levels, levels,
                                 padding_mode)
    return _pyramid_warp(inputs, grid, num_levels, levels, padding_mode)


def _pyramid_warp(inputs, grid, num_levels, levels, padding_mode):
    """The card's warp: build the native-resolution pyramid (under the
    span ``stn.pyramid``) and sample it through ``MipmapSample``, which
    launches the kernels or raises."""
    with span("stn.pyramid"):
        level0, coarse, shape = _build_pyramid(inputs, num_levels)
    return MipmapSample.apply(level0, coarse, shape, grid.contiguous(),
                              levels.contiguous(), padding_mode
                              ).to(inputs.dtype)
