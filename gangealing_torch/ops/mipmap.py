"""Mipmap-anti-aliased warping (the quality core of the STN sampler).

Port of gangealing_tpu/ops/mipmap.py. ``_mipmap_warp_fold`` is the plain
PyTorch version. On CUDA, ``mipmap_warp`` builds the Gaussian stack and the
levels with plain torch ops and samples the stack through ``MipmapSample``,
an autograd Function over the kernels of csrc/mipmap_sample.cu: the forward
(K1) replaces gangealing_tpu/ops/pallas_mipmap.py::_fwd_kernel, its
backward the ``_dcoords_kernel`` (K3, d/dgrid and d/dlevels) and
``_dimg_kernel`` (K5a, d/dstack). Autograd chains d/dlevels through
``mipmap_levels`` and d/dstack through ``_build_stack``, as the JAX package
chains its kernels through ``_band_tent_coords``.

The plain version differentiates as ``jax.grad`` of the JAX fold path does,
ties included (clamps and the level tent at integer levels).
"""

import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gangealing_torch import _build
from gangealing_torch.ops.grid_sample import (
    _check_dout, _check_grid, grid_sample, jabs, jclip, jmax)
from gangealing_torch.ops.resample import interpolate_bilinear


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
    x = (width - 1.0) * (grid[..., 0] + 1.0) / 2.0
    y = (height - 1.0) * (grid[..., 1] + 1.0) / 2.0
    coords = torch.stack([x, y], dim=3)
    levels = torch.log2(_max_coord_distance(coords))
    return jclip(levels, 0.0, max_num_levels - 1.0)


def _build_stack(x, num_levels):
    """Gaussian stack: level i is blurred (cumulatively downsampled 2x then
    bilinearly upsampled back). Non-power-of-2 inputs reflect-padded first.
    Returns list of (N, C, H, W) tensors, length num_levels."""
    log_size = math.log2(x.shape[-1])
    pad_needed = not float(log_size).is_integer()
    if pad_needed:
        target = int(2 ** math.ceil(log_size))
        total = target - x.shape[-1]
        lp = total // 2
        rp = total - lp
        x = F.pad(x, (lp, rp, lp, rp), mode="reflect")
    levels = [x]
    cur = x
    full = x.shape[-1]
    for _ in range(1, num_levels):
        cur = _gaussian_blur_2x(cur)
        levels.append(interpolate_bilinear(cur, full, full))
    if pad_needed:
        levels = [lv[:, :, lp:-rp, lp:-rp] for lv in levels]
    return levels


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


class MipmapSample(torch.autograd.Function):
    """Sample a Gaussian stack at per-point levels on the card: K1 forward;
    the backward launches K3 for d/dgrid and d/dlevels and K5a for
    d/dstack, each only when its inputs need a gradient."""

    @staticmethod
    def forward(ctx, stack, grid, levels, padding_mode):
        ctx.save_for_backward(stack, grid, levels)
        ctx.padding_mode = padding_mode
        return mipmap_sample(stack, grid, levels, padding_mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        stack, grid, levels = ctx.saved_tensors
        dout = dout.contiguous()
        dstack = dgrid = dlevels = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dgrid, dlevels = mipmap_sample_dcoords(stack, grid, levels, dout,
                                                   ctx.padding_mode)
        if ctx.needs_input_grad[0]:
            dstack = mipmap_sample_dstack(grid, levels, dout, stack.shape,
                                          ctx.padding_mode)
        return dstack, dgrid, dlevels, None


def _check_stack_operands(stack, grid, levels):
    device = stack.device
    _build.check_operand("stack", stack, 5, device)
    _build.check_operand("grid", grid, 4, device)
    _build.check_operand("levels", levels, 3, device)
    N, D = stack.shape[:2]
    Ho, Wo = _check_grid(grid, N)
    if tuple(levels.shape) != (N, Ho, Wo):
        raise ValueError(f"levels must be {(N, Ho, Wo)}, got {tuple(levels.shape)}")
    if D < 2:
        raise ValueError(f"the stack needs at least 2 levels, got {D}")
    return Ho, Wo


def mipmap_sample(stack, grid, levels, padding_mode="border"):
    """K1: sample a Gaussian stack at per-point levels, on the card.

    stack (N, D, C, H, W) with D >= 2, grid (N, Ho, Wo, 2), levels
    (N, Ho, Wo): contiguous float32 CUDA tensors on one device. Returns
    (N, C, Ho, Wo) float32, equal to ``_sample_stack``.
    """
    Ho, Wo = _check_stack_operands(stack, grid, levels)
    device = stack.device
    N, D, C, H, W = stack.shape
    code = _build.padding_code(padding_mode)
    out = torch.empty((N, C, Ho, Wo), device=device, dtype=torch.float32)
    lib = _build.load_kernels()
    _build.launch("mipmap_sample", lib.gg_mipmap_sample_fwd, stack.data_ptr(),
                  grid.data_ptr(), levels.data_ptr(), out.data_ptr(), N, D, C,
                  H, W, Ho * Wo, code, device.index, _build.stream_of(device))
    return out


def mipmap_sample_dcoords(stack, grid, levels, dout, padding_mode="border"):
    """K3: the gradients of ``mipmap_sample`` with respect to the grid
    (N, Ho, Wo, 2) and the levels (N, Ho, Wo), given ``dout`` (N, C, Ho, Wo)
    on the card."""
    Ho, Wo = _check_stack_operands(stack, grid, levels)
    device = stack.device
    N, D, C, H, W = stack.shape
    _check_dout(dout, N, C, Ho, Wo, device)
    code = _build.padding_code(padding_mode)
    dgrid = torch.empty_like(grid)
    dlevels = torch.empty_like(levels)
    lib = _build.load_kernels()
    _build.launch("mipmap_sample_dcoords", lib.gg_mipmap_sample_dcoords,
                  stack.data_ptr(), grid.data_ptr(), levels.data_ptr(),
                  dout.data_ptr(), dgrid.data_ptr(), dlevels.data_ptr(), N, D,
                  C, H, W, Ho * Wo, code, device.index,
                  _build.stream_of(device))
    return dgrid, dlevels


def mipmap_sample_dstack(grid, levels, dout, stack_shape,
                         padding_mode="border"):
    """K5a: the gradient of ``mipmap_sample`` with respect to the stack, of
    ``stack_shape`` (N, D, C, H, W), given ``dout`` on the card. A scatter
    with atomicAdd: the order of the sums, and so the last bits, change from
    run to run."""
    device = grid.device
    N, D, C, H, W = stack_shape
    dstack = torch.zeros((N, D, C, H, W), device=device, dtype=torch.float32)
    Ho, Wo = _check_stack_operands(dstack, grid, levels)
    _check_dout(dout, N, C, Ho, Wo, device)
    code = _build.padding_code(padding_mode)
    lib = _build.load_kernels()
    _build.launch("mipmap_sample_dstack", lib.gg_mipmap_sample_dstack,
                  grid.data_ptr(), levels.data_ptr(), dout.data_ptr(),
                  dstack.data_ptr(), N, D, C, H, W, Ho * Wo, code,
                  device.index, _build.stream_of(device))
    return dstack


def mipmap_warp(inputs, grid, max_num_levels=3.5, padding_mode="border"):
    """Anti-aliased grid_sample: per-pixel mipmap level selection.

    inputs: (N, C, H, W); grid: (N, Ho, Wo, 2) normalized to [-1, 1].
    A CPU tensor takes the plain ``_mipmap_warp_fold``; a CUDA tensor
    samples through ``MipmapSample``, which launches the kernels or raises.
    """
    N, C, H, W = inputs.shape
    num_levels = int(math.ceil(max_num_levels - 1.0)) + 1
    # the JAX warp's floor at its min_level of 0: no change to the values,
    # but half the gradient of a level that sits on it
    levels = jmax(mipmap_levels(grid, H, W, max_num_levels), 0.0)
    if inputs.device.type == "cpu":
        return _mipmap_warp_fold(inputs, grid, num_levels, levels,
                                 padding_mode)
    stack = torch.stack(_build_stack(inputs, num_levels), dim=1)
    return MipmapSample.apply(stack, grid.contiguous(), levels.contiguous(),
                              padding_mode).to(inputs.dtype)
