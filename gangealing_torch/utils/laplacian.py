"""Laplacian stack blending for seamless AR compositing.

Port of gangealing_tpu/utils/laplacian.py (reference
utils/laplacian_blending.py:13-134, LaplacianBlender and
extend_object_border). The blur is a depthwise ``F.conv2d`` with a 2-D
Gaussian kernel after replicate padding, as the JAX package's is a grouped
conv after ``jnp.pad(mode="edge")``.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics: sampled Gaussian, normalized."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(xs ** 2) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _gauss2d(ksize, sigma):
    k1 = gaussian_kernel_1d(ksize, sigma)
    return torch.from_numpy(np.outer(k1, k1))


def _blur(img, kernel, padding):
    C = img.shape[1]
    k = kernel.to(device=img.device, dtype=img.dtype)
    k = k[None, None].expand(C, 1, *kernel.shape)
    img_pad = F.pad(img, (padding,) * 4, mode="replicate")
    return F.conv2d(img_pad, k, groups=C)


def laplacian_stacks(img, levels, kernels, paddings):
    """Returns (lap_stack, gauss_stack): lists of (N, C, H, W)."""
    lap, gauss = [], []
    for level in range(levels):
        gauss.append(img)
        if level < levels - 1:
            blurred = _blur(img, kernels[level], paddings[level])
            lap.append(img - blurred)
            img = blurred
        else:
            lap.append(img)
    return lap, gauss


def laplacian_blend(img0, img1, mask, levels=5, gaussian_kernel_size=45,
                    gaussian_sigma=1, level_size_adder=0,
                    level_sigma_multiplier=2):
    """Blend img0 (mask == 0) with img1 (mask == 1) through Laplacian
    stacks."""
    if gaussian_kernel_size % 2 != 1 or level_size_adder % 2 != 0:
        raise ValueError("the kernel size must be odd and the size adder "
                         "even")
    kernels, paddings = [], []
    for level in range(levels):
        width = gaussian_kernel_size + level_size_adder
        sigma = gaussian_sigma * level_sigma_multiplier ** level
        kernels.append(_gauss2d(width, sigma))
        paddings.append(width // 2)
    lp0, _ = laplacian_stacks(img0, levels, kernels, paddings)
    lp1, _ = laplacian_stacks(img1, levels, kernels, paddings)
    _, gpm = laplacian_stacks(mask, levels, kernels, paddings)
    out = 0.0
    for a, b, m in zip(lp0, lp1, gpm):
        out = out + a + m * (b - a)
    return out


# Blender configurations of the vis pipeline
# (utils/vis_tools/helpers.py:188-193).
BLEND_CONFIGS = {
    "laplacian": dict(levels=5, gaussian_kernel_size=45, gaussian_sigma=1,
                      level_size_adder=0, level_sigma_multiplier=2),
    "laplacian_light": dict(levels=3, gaussian_kernel_size=11,
                            gaussian_sigma=0.5, level_size_adder=0,
                            level_sigma_multiplier=2),
}


def extend_object_border(img, mask, max_pixel_radius=45):
    """Object-centric border padding (laplacian_blending.py:110-134)."""
    out = img
    cur_mask = mask
    for radius in range(1, max_pixel_radius + 1):
        sqrt_rad = round(radius / math.sqrt(2))
        points = [(radius, 0), (-radius, 0), (0, radius), (0, -radius),
                  (sqrt_rad, sqrt_rad), (-sqrt_rad, sqrt_rad),
                  (sqrt_rad, -sqrt_rad), (-sqrt_rad, -sqrt_rad)]
        for pv, ph in points:
            img_shifted = torch.roll(img, (pv, ph), dims=(2, 3))
            mask_shifted = torch.roll(mask, (pv, ph), dims=(2, 3))
            out = out + img_shifted * (1 - cur_mask)
            cur_mask = (cur_mask + mask_shifted).clamp(0.0, 1.0)
    return out
