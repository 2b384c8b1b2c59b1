"""Visualization helpers: point splatting onto images, dense-label loading,
image grids, image and video writing.

Port of gangealing_tpu/utils/vis.py (reference utils/vis_tools/helpers.py:
splat_points:135-194, load_dense_label:79-122, images2grid:39-43,
save_video:55-75, colorscale sampling:125-131). Images are torch tensors in
[-1, 1] on any device; grids, file writing and label loading go through
numpy on the host. Plotly colorscales are matplotlib colormaps of the same
names; video goes through cv2. matplotlib, PIL and cv2 are imported inside
the functions that need them.
"""

import math
import os

import numpy as np
import torch

from gangealing_torch.ops.resample import interpolate_bilinear
from gangealing_torch.ops.splat import splat2d_pair_auto
from gangealing_torch.utils.laplacian import BLEND_CONFIGS, laplacian_blend

CLUSTER_COLORSCALES = ["plasma", "plotly3", "viridis", "cividis"]
_MPL_FALLBACKS = {"plotly3": "magma", "turbo": "turbo"}


def _numpy(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def get_colorscale(cluster=None):
    if cluster is None or cluster >= len(CLUSTER_COLORSCALES):
        return "turbo"
    return CLUSTER_COLORSCALES[cluster]


def get_colors(num_points, colorscale="turbo"):
    """(1, P, 3) colors in [-1, 1] sampled along a colormap."""
    import matplotlib
    name = _MPL_FALLBACKS.get(colorscale, colorscale)
    cmap = matplotlib.colormaps[name]
    steps = np.linspace(0, 1, num_points)
    rgb = np.asarray(cmap(steps))[:, :3].astype(np.float32)  # [0, 1]
    return torch.from_numpy(rgb * 2.0 - 1.0)[None]


def normalize_images(images, amin=None, amax=None):
    images = torch.as_tensor(images)
    if amin is None or amax is None:
        amin = images.amin(dim=(1, 2, 3), keepdim=True)
        amax = images.amax(dim=(1, 2, 3), keepdim=True)
    else:
        images = images.clamp(amin, amax)
    span = torch.as_tensor(amax - amin, dtype=images.dtype)
    return (images - amin) / span.clamp(min=1e-5)


def images2grid(images, nrow=8, padding=2, normalize=False, range=None,
                pad_value=0.0):
    """(N, C, H, W) -> (H', W', C) uint8 grid (torchvision make_grid
    semantics)."""
    images = torch.as_tensor(_numpy(images))
    if normalize:
        if range is not None:
            images = normalize_images(images, range[0], range[1])
        else:
            images = normalize_images(images)
    images = images.numpy()
    N, C, H, W = images.shape
    ncol = min(nrow, N)
    nrows = int(math.ceil(N / ncol))
    grid = np.full((C, padding + nrows * (H + padding),
                    padding + ncol * (W + padding)), pad_value, np.float32)
    for i in np.arange(N):  # `range` is taken by the keyword (API parity)
        r, c = divmod(i, ncol)
        y = padding + r * (H + padding)
        x = padding + c * (W + padding)
        grid[:, y:y + H, x:x + W] = images[i]
    return (grid * 255 + 0.5).clip(0, 255).transpose(1, 2, 0).astype(
        np.uint8)


def save_image(images, path, nrow=8, normalize=False, range=None):
    from PIL import Image
    grid = images2grid(images, nrow=nrow, normalize=normalize, range=range)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(grid).save(path)


def load_pil(path, resolution=None):
    """Image file -> (1, C, H, W) float32 tensor in [-1, 1]."""
    from PIL import Image
    img = Image.open(path)
    if resolution is not None:
        img = img.resize((resolution, resolution), Image.LANCZOS)
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return torch.from_numpy((arr * 2 - 1).transpose(2, 0, 1).copy())[None]


def save_video(frames, fps, out_path, input_is_tensor=False,
               apply_normalize=True):
    """frames: list of (H, W, C) uint8 arrays, or (T, C, H, W) in [-1, 1]
    when ``input_is_tensor``; written as mp4v through cv2."""
    import cv2
    if input_is_tensor:
        f = torch.as_tensor(_numpy(frames))
        if apply_normalize:
            f = normalize_images(f, -1, 1) * 255
        frames = list(f.numpy().transpose(0, 2, 3, 1).clip(0, 255).astype(
            np.uint8))
    h, w = frames[0].shape[:2]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    try:
        for fr in frames:
            writer.write(np.ascontiguousarray(fr[..., ::-1]))  # RGB -> BGR
    finally:
        writer.release()


def load_dense_label(path, resolution=None, load_colors=False):
    """RGBA image -> the (x, y) pixel coords of its nonzero-alpha pixels,
    their colors and alphas (helpers.py:79-113). Returns float32 CPU
    tensors ((1, P, 2), (1, P, 3) or None, (1, P, 1))."""
    from PIL import Image
    label = np.asarray(Image.open(path)).astype(np.float32)  # (H, W, 4)
    if label.ndim != 3 or label.shape[-1] != 4:
        raise ValueError(f"{path}: a dense label is an RGBA image, got "
                         f"shape {label.shape}")
    label = label.transpose(2, 0, 1)[None]  # (1, 4, H, W)
    if resolution is not None and resolution != label.shape[2]:
        scale = resolution / label.shape[2]
        label = interpolate_bilinear(
            torch.from_numpy(np.ascontiguousarray(label)),
            int(label.shape[2] * scale), int(label.shape[3] * scale)).numpy()
    ii, jj = np.where(label[0, 3] > 0)
    points = np.stack([jj, ii], -1)[None].astype(np.float32)  # (1, P, 2) xy
    if load_colors:
        image = label / 255.0
        alphas = image[0, 3, ii, jj].reshape(1, -1, 1).astype(np.float32)
        # numpy moves the advanced-index axis to the front: (P, 3)
        colors = ((image[0, :3, ii, jj] - 0.5) * 2.0)[None].astype(
            np.float32)
    else:
        alphas = np.ones((1, points.shape[1], 1), np.float32)
        colors = None
    return (torch.from_numpy(points),
            torch.from_numpy(colors) if colors is not None else None,
            torch.from_numpy(alphas))


def splat_points(images, points, sigma, opacity, colorscale="turbo",
                 colors=None, alpha_channel=None, blend_alg="alpha",
                 max_sigma=None):
    """Overlay (N, P, 2) pixel points onto (N, C, H, W) images by Gaussian
    splatting (helpers.py:135-194). Everything moves to the images'
    device; on the card the object and the mask are one K6 launch.
    ``max_sigma`` (default: the largest sigma) bounds the plain splat's
    window."""
    images = torch.as_tensor(images)
    dev = images.device
    points = torch.as_tensor(points, device=dev)
    N = images.shape[0]
    if points.ndim == 4:  # (N, K, P, 2): one colorscale per K
        num_points = points.shape[2]
        K = points.shape[1]
        points = points.reshape(N, K * num_points, 2)
        if colors is None:
            cs = [colorscale] * K if isinstance(colorscale, str) \
                else colorscale
            colors = torch.cat([get_colors(num_points, c) for c in cs], 1)
            colors = colors.repeat(N, 1, 1)
    elif colors is None:
        if isinstance(colorscale, str):
            colors = get_colors(points.shape[1], colorscale).repeat(N, 1, 1)
        else:
            colors = torch.cat([get_colors(points.shape[1], c)
                                for c in colorscale], 0)
    colors = torch.as_tensor(colors, device=dev)
    if alpha_channel is None:
        alpha_channel = torch.ones((N, points.shape[1], 1), device=dev)
    alpha_channel = torch.as_tensor(alpha_channel, device=dev)
    if isinstance(sigma, (float, int)):
        sigma_arr = torch.full((N,), float(sigma), device=dev)
        if max_sigma is None:
            max_sigma = float(sigma)
    else:
        sigma_arr = torch.as_tensor(sigma, device=dev)
        if max_sigma is None:
            max_sigma = float(sigma_arr.max())
    obj, mask = splat2d_pair_auto(points, colors.to(images.dtype),
                                  alpha_channel.to(images.dtype), sigma_arr,
                                  *images.shape[2:], max_sigma=max_sigma)
    mask = mask * opacity
    if blend_alg == "alpha":
        return mask * obj + (1 - mask) * images
    if blend_alg in BLEND_CONFIGS:
        return laplacian_blend(images, obj, mask, **BLEND_CONFIGS[blend_alg])
    raise NotImplementedError(blend_alg)
