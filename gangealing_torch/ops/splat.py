"""Gaussian point splatting, forward only.

Port of gangealing_tpu/ops/splat.py. Semantics (reference
utils/splat2d_cuda, splat_gpu_impl.cu:36-96 and splat_gpu.c:36-41): scatter
P sub-pixel points with C-channel values into an (N, C, H, W) canvas; each
point deposits exp(-d^2 / (2 sigma^2)) over the pixel window
[floor(p - 2s), ceil(p + 2s)] clamped to the image; points out of bounds
are skipped; the canvas plus the input is divided by (alpha + 1e-8), with
``soft_normalize`` clamping alpha to at least 1.

``splat2d`` is the plain PyTorch version: it follows the JAX package's
f32 ``splat2d`` op for op, a scatter-add over a static window of
R = 2 * ceil(2 * max_sigma) + 3 pixels a side, masked to each point's own
window, in chunks of points. ``splat2d_cuda`` launches K6
(csrc/splat.cu), which replaces the TPU kernel
gangealing_tpu/ops/splat.py::_splat_kernel; it walks each point's exact
window, so it takes no ``max_sigma`` and agrees with ``splat2d`` whenever
every sigma is at most ``max_sigma``. ``splat2d_auto`` takes ``splat2d``
for a CPU tensor and K6 for a CUDA tensor, whatever the point count.
"""

import math

import torch

from gangealing_torch import _build

# Elements of one chunk's footprint (points x R x R), as in the JAX package.
_CHUNK_ELEMS = 4 * 2 ** 20


def _splat_scatter_chunk(alpha, out, x, y, values, s, H, W, R):
    """Scatter-add one chunk of points into the (N, H*W) alpha and the
    (N, H*W, C) value canvases, in place."""
    in_bounds = (x >= 0) & (x < W) & (y >= 0) & (y < H)  # (N, Pc)

    length = 2.0 * s
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    t = torch.maximum(zero, torch.floor(y - length))       # (N, Pc)
    b = torch.minimum(zero + (H - 1.0), torch.ceil(y + length))
    l = torch.maximum(zero, torch.floor(x - length))
    r = torch.minimum(zero + (W - 1.0), torch.ceil(x + length))

    offs = torch.arange(R, dtype=x.dtype, device=x.device)  # (R,)
    py = t[..., None] + offs                                # (N, Pc, R)
    px = l[..., None] + offs
    my = (py <= b[..., None]) & (py < H)
    mx = (px <= r[..., None]) & (px < W)

    normalizer = -1.0 / (2.0 * s * s)                       # (N, 1)
    gy = torch.exp(normalizer[..., None] * (py - y[..., None]) ** 2)
    gx = torch.exp(normalizer[..., None] * (px - x[..., None]) ** 2)
    gy = gy * my.to(x.dtype)
    gx = gx * mx.to(x.dtype)
    alpha_w = gy[:, :, :, None] * gx[:, :, None, :]         # (N, Pc, R, R)
    alpha_w = alpha_w * in_bounds[:, :, None, None].to(x.dtype)

    pyi = py.clamp(0, H - 1).long()
    pxi = px.clamp(0, W - 1).long()
    N, Pc = x.shape
    flat_idx = (pyi[:, :, :, None] * W + pxi[:, :, None, :]).reshape(
        N, Pc * R * R)

    aw = alpha_w.reshape(N, Pc * R * R)
    alpha.scatter_add_(1, flat_idx, aw)
    vw = aw[:, :, None] * values.repeat_interleave(R * R, dim=1)
    C = values.shape[-1]
    out.scatter_add_(1, flat_idx[:, :, None].expand(N, Pc * R * R, C), vw)


def splat2d(input, coordinates, values, sigma, soft_normalize=False,
            max_sigma=8.0):
    """The plain version. input: (N, C, H, W) canvas; coordinates:
    (N, P, 2) x then y in pixels; values: (N, P, C); sigma: (N,). Returns
    (N, C, H, W). Points go through in chunks so that a dense label at a
    large ``max_sigma`` stays within a few hundred MB."""
    N, C, H, W = input.shape
    P = coordinates.shape[1]
    R = 2 * int(math.ceil(2 * float(max_sigma))) + 3
    dtype = input.dtype

    x = coordinates[..., 0].to(dtype)  # (N, P)
    y = coordinates[..., 1].to(dtype)
    s = sigma.to(dtype)[:, None]  # (N, 1)
    values = values.to(dtype)

    chunk = max(1, _CHUNK_ELEMS // (R * R))
    alpha = torch.zeros((N, H * W), dtype=dtype, device=input.device)
    out = torch.zeros((N, H * W, C), dtype=dtype, device=input.device)
    for start in range(0, P, chunk):
        end = min(P, start + chunk)
        _splat_scatter_chunk(alpha, out, x[:, start:end], y[:, start:end],
                             values[:, start:end], s, H, W, R)
    out = out.permute(0, 2, 1).reshape(N, C, H, W) + input
    return _normalize(out, alpha.reshape(N, 1, H, W), soft_normalize)


def _normalize(out, alpha, soft_normalize):
    if soft_normalize:
        alpha = torch.maximum(alpha, torch.ones((), dtype=alpha.dtype,
                                                device=alpha.device))
    return out / (alpha + 1e-8)


def splat2d_cuda(input, coordinates, values, sigma, soft_normalize=False):
    """K6 on the card, then the normalisation as torch ops (the split of
    gangealing_tpu/ops/splat.py::splat2d_mxu). input (N, C, H, W),
    coordinates (N, P, 2), values (N, P, C) and sigma (N,): contiguous
    float32 CUDA tensors on one device. The kernel adds into its
    accumulator with atomicAdd, so the order of the sums, and so the last
    bits, change from run to run."""
    device = input.device
    _build.check_operand("input", input, 4, device)
    _build.check_operand("coordinates", coordinates, 3, device)
    _build.check_operand("values", values, 3, device)
    _build.check_operand("sigma", sigma, 1, device)
    N, C, H, W = input.shape
    P = coordinates.shape[1]
    if tuple(coordinates.shape) != (N, P, 2):
        raise ValueError(f"coordinates must be ({N}, P, 2), got "
                         f"{tuple(coordinates.shape)}")
    if tuple(values.shape) != (N, P, C):
        raise ValueError(f"values must be {(N, P, C)}, got "
                         f"{tuple(values.shape)}")
    if tuple(sigma.shape) != (N,):
        raise ValueError(f"sigma must be ({N},), got {tuple(sigma.shape)}")
    acc = torch.zeros((N, C + 1, H, W), device=device, dtype=torch.float32)
    lib = _build.load_kernels()
    _build.launch("splat", lib.gg_splat_fwd, coordinates.data_ptr(),
                  values.data_ptr(), sigma.data_ptr(), acc.data_ptr(), N, P,
                  C, H, W, device.index, _build.stream_of(device))
    return _normalize(acc[:, :C] + input, acc[:, C:], soft_normalize)


def splat2d_auto(input, coordinates, values, sigma, soft_normalize=False,
                 max_sigma=8.0):
    """``splat2d`` for a CPU tensor; K6 for a CUDA tensor, which launches
    or raises. ``max_sigma`` bounds the plain version's window only; the
    kernel walks each point's exact window."""
    if input.device.type == "cpu":
        return splat2d(input, coordinates, values, sigma,
                       soft_normalize=soft_normalize, max_sigma=max_sigma)
    f32 = dict(dtype=torch.float32)
    return splat2d_cuda(input.to(**f32).contiguous(),
                        coordinates.to(**f32).contiguous(),
                        values.to(**f32).contiguous(),
                        sigma.to(**f32).contiguous(), soft_normalize)
