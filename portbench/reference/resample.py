"""FIR resampling, bias-activation and bilinear resizing in plain PyTorch.

Port of the off-TPU branches of gangealing_tpu/ops/resample.py. The JAX
package wrote these in XLA, not Pallas, so here they are PyTorch and cuDNN
ops: ``upfirdn2d`` is one depthwise ``F.conv2d``.
"""

import functools

import torch
import torch.nn.functional as F


def make_kernel(k, device=None):
    """1-D or 2-D FIR kernel, normalized to sum 1 (reference networks.py:17)."""
    k = torch.as_tensor(k, dtype=torch.float32, device=device)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """Upsample (zero-insert), FIR filter, downsample, the filter as one
    depthwise conv.

    x: (N, C, H, W); kernel: (kh, kw). ``pad`` is (pad0, pad1) applied to both
    spatial dims. Output H' = (H*up + pad0 + pad1 - kh)//down + 1. As in the
    reference, each sample is followed by ``up - 1`` zeros.
    """
    N, C, H, W = x.shape
    if up > 1:
        x = F.pad(x.reshape(N, C, H, 1, W, 1), (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(N, C, H * up, W * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    # correlating with the flipped kernel is a true convolution
    k = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    return F.conv2d(x, k[None, None].expand(C, 1, *kernel.shape),
                    stride=down, groups=C)


def upsample2x(x, kernel, factor=2):
    """Blur-based 2x upsample (reference networks.py:28-46)."""
    kernel = make_kernel(kernel, x.device) * (factor ** 2)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=factor,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def blur(x, kernel, pad, upsample_factor=1):
    """FIR blur (reference networks.py:70-86); after an upsampling by
    ``upsample_factor`` the taps are scaled by its square."""
    kernel = make_kernel(kernel, x.device)
    if upsample_factor > 1:
        kernel = kernel * (upsample_factor ** 2)
    return upfirdn2d(x, kernel, pad=pad)


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
