"""Mipmap-anti-aliased warping, plain: a frozen copy of the fold path of
gangealing_torch/ops/mipmap.py (``_build_stack`` + ``_sample_stack``),
which the port takes on the CPU. No kernel.

``RECORDER``, when a list, receives each warp's (image shape, grid,
levels, padding) so that the benchmark can count the bytes the port's
sampler kernels must read on the same points (``portbench/bounds.py``).
"""

import math

import torch
import torch.nn.functional as F

from portbench.reference.grid_sample import (
    grid_sample, jabs, jclip, jmax)
from portbench.reference.resample import interpolate_bilinear


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


RECORDER = None


def mipmap_warp(inputs, grid, max_num_levels=3.5, padding_mode="border"):
    """Anti-aliased grid_sample: per-pixel mipmap level selection.

    inputs: (N, C, H, W); grid: (N, Ho, Wo, 2) normalized to [-1, 1].
    """
    N, C, H, W = inputs.shape
    num_levels = int(math.ceil(max_num_levels - 1.0)) + 1
    # the JAX warp's floor at its min_level of 0: no change to the values,
    # but half the gradient of a level that sits on it
    levels = jmax(mipmap_levels(grid, H, W, max_num_levels), 0.0)
    if RECORDER is not None:
        RECORDER.append((tuple(inputs.shape), grid.detach(),
                         levels.detach(), padding_mode))
    stack = torch.stack(_build_stack(inputs, num_levels), dim=1)
    return _sample_stack(stack, grid, levels, padding_mode)
