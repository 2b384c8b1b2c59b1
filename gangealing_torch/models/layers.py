"""StyleGAN2-family building blocks, as nn.Modules.

Port of gangealing_tpu/models/layers.py: the STN encoder's EqualLinear,
EqualConv2d, Blur, FusedLeakyReLU, ConvLayer and ResBlock, and the
generator's pixel_norm, ModulatedConv2d, StyledConv (with noise injection),
ToRGB and ConstantInput. Module and parameter names follow the reference's
torch modules, so a state_dict holds the same flat keys as the JAX
package's parameter dicts. The blur FIR taps are host constants
(``ops/resample.py::Fir``), not buffers.

Every constructor takes the ``device`` to build on and the
``torch.Generator`` its random weights are drawn from. Parameters are
float32; the convolutions run in the dtype of their input, with each
weight, style, demodulation, noise and bias cast to it where it is used,
at the JAX package's rounding points (its ``compute_dtype``).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from gangealing_torch.ops.resample import (
    blur, fir, fused_leaky_relu, rounded_like, upfirdn2d, upsample2x)

BLUR_KERNEL = (1, 3, 3, 1)


def dtype_of(name):
    """The dtype a ``--compute_dtype`` name runs the convolutions in, as
    the JAX package reads the name: bfloat16 for 'bfloat16'; None for
    'float32' (or None), which leaves them in their input's dtype."""
    return torch.bfloat16 if name == "bfloat16" else None


def cast_to(x, dtype):
    """``x`` in ``dtype``; as it is for None."""
    return x if dtype is None else x.to(dtype)


def float32_or_wider(x):
    """``x`` in float32, or in its own dtype where that is wider."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def randn(shape, generator=None, device=None):
    """Standard normal weights drawn from ``generator`` (on its own device),
    placed on ``device``."""
    gen_device = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=gen_device).to(device)


def pixel_norm(x, eps=1e-8):
    return x * torch.rsqrt((x ** 2).mean(dim=1, keepdim=True) + eps)


class EqualLinear(nn.Module):
    """Linear layer with equalized learning rate (networks.py:127). The
    weight is stored divided by ``lr_mul``."""

    def __init__(self, in_dim, out_dim, activation=None, *, bias_init=0.0,
                 lr_mul=1.0, device=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            randn((out_dim, in_dim), generator, device) / lr_mul)
        self.bias = nn.Parameter(
            torch.full((out_dim,), float(bias_init), device=device))
        self.scale = 1.0 / math.sqrt(in_dim) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x):
        out = F.linear(x, self.weight * self.scale)
        if self.activation:
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        return out + self.bias * self.lr_mul


class EqualConv2d(nn.Module):
    """Conv2d with equalized learning rate (networks.py:89)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 bias=True, *, device=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            randn((out_ch, in_ch, kernel_size, kernel_size), generator, device))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_ch, device=device))
        else:
            self.register_parameter("bias", None)
        self.scale = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return F.conv2d(x, (self.weight * self.scale).to(x.dtype),
                        bias=self.bias, stride=self.stride,
                        padding=self.padding)


class Blur(nn.Module):
    """FIR blur (networks.py:70)."""

    def __init__(self, kernel, pad):
        super().__init__()
        self.fir = fir(kernel)
        self.pad = pad

    def forward(self, x):
        return upfirdn2d(x, self.fir, pad=self.pad)


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels, bias=True, *, device=None):
        super().__init__()
        if bias:
            self.bias = nn.Parameter(torch.zeros(channels, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


class ConvLayer(nn.Sequential):
    """Optional Blur + EqualConv2d + FusedLeakyReLU (networks.py:589-635).
    Slot 0 holds the Blur when the layer downsamples, as in the reference."""

    def __init__(self, in_ch, out_ch, kernel_size, downsample=False,
                 bias=True, activate=True, *, device=None, generator=None):
        layers = []
        if downsample:
            p = (len(BLUR_KERNEL) - 2) + (kernel_size - 1)
            layers.append(Blur(BLUR_KERNEL, pad=((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_ch, out_ch, kernel_size, stride=stride,
                                  padding=padding, bias=bias and not activate,
                                  device=device, generator=generator))
        if activate:
            layers.append(FusedLeakyReLU(out_ch, bias=bias, device=device))
        super().__init__(*layers)


class ResBlock(nn.Module):
    """Residual block of the encoder (networks.py:375-393)."""

    def __init__(self, in_ch, out_ch, downsample=True, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = ConvLayer(in_ch, in_ch, 3, **kw)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, downsample=downsample, **kw)
        self.skip = ConvLayer(in_ch, out_ch, 1, downsample=downsample,
                              activate=False, bias=False, **kw)

    def forward(self, x):
        return ((self.conv2(self.conv1(x)) + self.skip(x))
                / rounded_like(math.sqrt(2), x))


class ModulatedConv2d(nn.Module):
    """StyleGAN2's modulated conv (networks.py:176-282) in the JAX package's
    shared-weight form: the style scales the input channels, one conv with
    the shared weight runs over the whole batch, and the demodulation scales
    the output channels, which equals the reference's per-sample grouped
    conv. ``upsample`` is a stride-2 transposed conv then a blur;
    ``normalize`` is the form of the layers under ``num_fp16_res``."""

    def __init__(self, in_ch, out_ch, kernel_size, style_dim, demodulate=True,
                 upsample=False, normalize=False, *, device=None,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(randn(
            (1, out_ch, in_ch, kernel_size, kernel_size), generator, device))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0,
                                      device=device, generator=generator)
        self.fan_in = in_ch * kernel_size * kernel_size
        self.demodulate = demodulate
        self.upsample = upsample
        self.normalize = normalize

    def forward(self, x, style):
        w = self.weight[0]
        kh = w.shape[2]
        s = self.modulation(style)  # (N, I)
        if self.normalize:
            s = s / s.abs().max()
        weight = w / math.sqrt(self.fan_in)
        if self.normalize:
            weight = weight * math.sqrt(1.0 / self.fan_in) / weight.abs().amax(
                dim=(1, 2, 3), keepdim=True)
        xs = x * s[:, :, None, None].to(x.dtype)
        w_x = weight.to(x.dtype)
        if self.upsample:
            out = F.conv_transpose2d(xs, w_x.transpose(0, 1), stride=2)
        else:
            out = F.conv2d(xs, w_x, padding=kh // 2)
        if self.demodulate:
            wsq = (weight ** 2).sum(dim=(2, 3))  # (O, I)
            demod = torch.rsqrt((s ** 2) @ wsq.T + 1e-8)  # (N, O)
            out = out * demod[:, :, None, None].to(out.dtype)
        if self.upsample:
            p = (len(BLUR_KERNEL) - 2) - (kh - 1)
            out = blur(out, BLUR_KERNEL, pad=((p + 1) // 2 + 1, p // 2 + 1),
                       upsample_factor=2)
        return out


class NoiseInjection(nn.Module):
    def __init__(self, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x, noise):
        return x + self.weight.to(x.dtype) * noise.to(x.dtype)


class StyledConv(nn.Module):
    """ModulatedConv2d + NoiseInjection + FusedLeakyReLU (networks.py:314-350).
    ``noise`` is (N or 1, 1, H, W), or None for none."""

    def __init__(self, in_ch, out_ch, kernel_size, style_dim, upsample=False,
                 normalize=False, *, device=None, generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, kernel_size, style_dim,
                                    upsample=upsample, normalize=normalize,
                                    device=device, generator=generator)
        self.noise = NoiseInjection(device=device)
        self.activate = FusedLeakyReLU(out_ch, device=device)

    def forward(self, x, style, noise=None):
        out = self.conv(x, style)
        if noise is not None:
            out = self.noise(out, noise)
        return self.activate(out)


class ToRGB(nn.Module):
    """1x1 modulated conv without demodulation, plus a bias and the
    blur-upsampled skip (networks.py:353-372). The bias is added in the
    input's dtype and the skip summed in float32 (layers.py:337-340 of
    the JAX package)."""

    def __init__(self, in_ch, style_dim, *, device=None, generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, demodulate=False,
                                    device=device, generator=generator)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1, device=device))

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias.to(x.dtype)
        if skip is not None:
            out = float32_or_wider(out) + upsample2x(skip, BLUR_KERNEL)
        return out


class ConstantInput(nn.Module):
    def __init__(self, channels, size=4, *, device=None, generator=None):
        super().__init__()
        self.input = nn.Parameter(randn((1, channels, size, size), generator,
                                        device))

    def forward(self, batch):
        return self.input.expand(batch, -1, -1, -1)
