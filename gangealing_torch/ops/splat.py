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
gangealing_tpu/ops/splat.py::_splat_kernel: one launch writes the
normalised output, with no accumulator in device memory and the same bits
from run to run. K6 walks each point's exact window, so it takes no
``max_sigma`` and agrees with ``splat2d`` whenever every sigma is at most
``max_sigma``. ``splat2d_auto`` takes ``splat2d`` for a CPU tensor and K6
for a CUDA tensor, whatever the point count.

``splat2d_pair`` (plain), ``splat2d_pair_cuda`` (K6) and
``splat2d_pair_auto`` splat one set of points twice, as the AR apps do: an
object, normalised by alpha, and a mask, soft-normalised, on blank
canvases. On the card the two share one K6 launch and one alpha sum.
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
    alpha = alpha.reshape(N, 1, H, W)
    if soft_normalize:
        alpha = torch.maximum(alpha, torch.ones((), dtype=dtype,
                                                device=alpha.device))
    return out / (alpha + 1e-8)


def splat2d_pair(coordinates, obj_values, mask_values, sigma, H, W,
                 max_sigma=8.0):
    """The plain version of the pair: ``splat2d`` of the object values
    (N, P, Co) and, soft-normalised, of the mask values (N, P, Cm), both on
    zero canvases of H x W in the object values' dtype. Returns (object
    (N, Co, H, W), mask (N, Cm, H, W))."""
    N = coordinates.shape[0]
    dtype, device = obj_values.dtype, coordinates.device
    obj = splat2d(torch.zeros((N, obj_values.shape[-1], H, W), dtype=dtype,
                              device=device),
                  coordinates, obj_values, sigma, False, max_sigma)
    mask = splat2d(torch.zeros((N, mask_values.shape[-1], H, W), dtype=dtype,
                               device=device),
                   coordinates, mask_values, sigma, True, max_sigma)
    return obj, mask


def _check_points(coordinates, sigma, device):
    _build.check_operand("coordinates", coordinates, 3, device)
    _build.check_operand("sigma", sigma, 1, device)
    N, P = coordinates.shape[:2]
    if coordinates.data_ptr() % 8:
        raise ValueError("coordinates must start on an 8-byte boundary: K6 "
                         "reads a point's x and y as one float2")
    if coordinates.shape[2] != 2:
        raise ValueError(f"coordinates must be (N, P, 2), got "
                         f"{tuple(coordinates.shape)}")
    if tuple(sigma.shape) != (N,):
        raise ValueError(f"sigma must be ({N},), got {tuple(sigma.shape)}")
    return N, P


def _check_values(name, values, N, P, device):
    _build.check_operand(name, values, 3, device)
    if tuple(values.shape[:2]) != (N, P):
        raise ValueError(f"{name} must be ({N}, {P}, C), got "
                         f"{tuple(values.shape)}")


def _launch(coordinates, sigma, H, W, hard=(None, None, None),
            soft=(None, None, None)):
    """One K6 launch. ``hard`` and ``soft`` are (values, canvas or None,
    out) of the channels divided by alpha + 1e-8 and by
    max(alpha, 1) + 1e-8; a set of None has no channels."""
    N, P = coordinates.shape[:2]
    device = coordinates.device

    def ptr(t):
        return None if t is None else t.data_ptr()

    def channels(t):
        return 0 if t is None else t.shape[1]

    lib = _build.load_kernels()
    _build.launch("splat", lib.gg_splat_fwd, coordinates.data_ptr(),
                  sigma.data_ptr(), *map(ptr, hard), *map(ptr, soft), N, P,
                  channels(hard[2]), channels(soft[2]), H, W, device.index,
                  _build.stream_of(device))


def splat2d_cuda(input, coordinates, values, sigma, soft_normalize=False):
    """``splat2d`` as one K6 launch. input (N, C, H, W), coordinates
    (N, P, 2), values (N, P, C) and sigma (N,): contiguous float32 CUDA
    tensors on one device."""
    device = input.device
    _build.check_operand("input", input, 4, device)
    N, P = _check_points(coordinates, sigma, device)
    if input.shape[0] != N:
        raise ValueError(f"input must have {N} images, got {input.shape[0]}")
    _check_values("values", values, N, P, device)
    C, H, W = input.shape[1:]
    if values.shape[2] != C:
        raise ValueError(f"values must be {(N, P, C)}, got "
                         f"{tuple(values.shape)}")
    out = torch.empty_like(input)
    channels = (values, input, out)
    if soft_normalize:
        _launch(coordinates, sigma, H, W, soft=channels)
    else:
        _launch(coordinates, sigma, H, W, hard=channels)
    return out


def splat2d_pair_cuda(coordinates, obj_values, mask_values, sigma, H, W):
    """``splat2d_pair`` as one K6 launch, which forms alpha once and writes
    both outputs. coordinates (N, P, 2), obj_values (N, P, Co),
    mask_values (N, P, Cm) and sigma (N,): contiguous float32 CUDA tensors
    on one device."""
    device = coordinates.device
    N, P = _check_points(coordinates, sigma, device)
    _check_values("obj_values", obj_values, N, P, device)
    _check_values("mask_values", mask_values, N, P, device)
    f32 = dict(dtype=torch.float32, device=device)
    obj = torch.empty((N, obj_values.shape[2], H, W), **f32)
    mask = torch.empty((N, mask_values.shape[2], H, W), **f32)
    _launch(coordinates, sigma, H, W, hard=(obj_values, None, obj),
            soft=(mask_values, None, mask))
    return obj, mask


def _f32(*tensors):
    return [t.to(dtype=torch.float32).contiguous() for t in tensors]


def splat2d_auto(input, coordinates, values, sigma, soft_normalize=False,
                 max_sigma=8.0):
    """``splat2d`` for a CPU tensor; K6 for a CUDA tensor, which launches
    or raises. ``max_sigma`` bounds the plain version's window only; the
    kernel walks each point's exact window."""
    if input.device.type == "cpu":
        return splat2d(input, coordinates, values, sigma,
                       soft_normalize=soft_normalize, max_sigma=max_sigma)
    return splat2d_cuda(*_f32(input, coordinates, values, sigma),
                        soft_normalize)


def splat2d_pair_auto(coordinates, obj_values, mask_values, sigma, H, W,
                      max_sigma=8.0):
    """``splat2d_pair`` for a CPU tensor; one K6 launch for a CUDA tensor,
    which launches or raises. ``max_sigma`` bounds the plain version's
    window only: the kernel walks each point's exact window, so the two
    agree only while every sigma is at most ``max_sigma``."""
    if coordinates.device.type == "cpu":
        return splat2d_pair(coordinates, obj_values, mask_values, sigma, H, W,
                            max_sigma=max_sigma)
    return splat2d_pair_cuda(*_f32(coordinates, obj_values, mask_values,
                                   sigma), H, W)
