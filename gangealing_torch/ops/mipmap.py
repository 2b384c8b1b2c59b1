"""Mipmap-anti-aliased warping (the quality core of the STN sampler).

Port of gangealing_tpu/ops/mipmap.py. ``_mipmap_warp_fold`` is the plain
PyTorch version; ``mipmap_warp`` is the wrapper of the CUDA mipmap kernel
(csrc/mipmap_sample.cu), which replaces the TPU kernel
gangealing_tpu/ops/pallas_mipmap.py::_fwd_kernel.
"""

import math

import torch
import torch.nn.functional as F

from gangealing_torch import _build
from gangealing_torch.ops.grid_sample import grid_sample
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
        return torch.sqrt(sq.clamp_min(1.0))

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
    return levels.clamp(0.0, max_num_levels - 1.0)


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
    w = (1.0 - (lv - d).abs()).clamp_min(0.0)
    return (warped * w.to(warped.dtype)).sum(dim=1)  # (N, C, Ho, Wo)


def _mipmap_warp_fold(inputs, grid, num_levels, levels, padding_mode):
    """The plain mipmap warp: build the Gaussian stack and sample it with
    ``_sample_stack``."""
    stack = torch.stack(_build_stack(inputs, num_levels), dim=1)
    return _sample_stack(stack, grid, levels, padding_mode)


def mipmap_sample(stack, grid, levels, padding_mode="border"):
    """K1: sample a Gaussian stack at per-point levels, on the card.

    stack (N, D, C, H, W) with D >= 2, grid (N, Ho, Wo, 2), levels
    (N, Ho, Wo): contiguous float32 CUDA tensors on one device. Returns
    (N, C, Ho, Wo) float32, equal to ``_sample_stack``.
    """
    device = stack.device
    _build.check_operand("stack", stack, 5, device)
    _build.check_operand("grid", grid, 4, device)
    _build.check_operand("levels", levels, 3, device)
    N, D, C, H, W = stack.shape
    _, Ho, Wo, two = grid.shape
    if grid.shape[0] != N or two != 2:
        raise ValueError(f"grid must be ({N}, Ho, Wo, 2), got {tuple(grid.shape)}")
    if tuple(levels.shape) != (N, Ho, Wo):
        raise ValueError(f"levels must be {(N, Ho, Wo)}, got {tuple(levels.shape)}")
    if D < 2:
        raise ValueError(f"the stack needs at least 2 levels, got {D}")
    code = _build.padding_code(padding_mode)
    out = torch.empty((N, C, Ho, Wo), device=device, dtype=torch.float32)
    lib = _build.load_kernels()
    _build.launch("mipmap_sample", lib.gg_mipmap_sample_fwd, stack.data_ptr(),
                  grid.data_ptr(), levels.data_ptr(), out.data_ptr(), N, D, C,
                  H, W, Ho * Wo, code, device.index, _build.stream_of(device))
    return out


def mipmap_warp(inputs, grid, max_num_levels=3.5, padding_mode="border"):
    """Anti-aliased grid_sample: per-pixel mipmap level selection.

    inputs: (N, C, H, W); grid: (N, Ho, Wo, 2) normalized to [-1, 1].
    A CPU tensor takes the plain ``_mipmap_warp_fold``; a CUDA tensor
    launches the mipmap kernel, or raises if the kernel does not take it.
    """
    N, C, H, W = inputs.shape
    num_levels = int(math.ceil(max_num_levels - 1.0)) + 1
    levels = mipmap_levels(grid, H, W, max_num_levels)
    if inputs.device.type == "cpu":
        return _mipmap_warp_fold(inputs, grid, num_levels, levels,
                                 padding_mode)
    stack = torch.stack(_build_stack(inputs, num_levels), dim=1)
    return mipmap_sample(stack, grid.contiguous(), levels.contiguous(),
                         padding_mode).to(inputs.dtype)
