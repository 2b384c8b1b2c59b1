"""StyleGAN2-family building blocks of the STN encoder, as nn.Modules.

Port of the STN part of gangealing_tpu/models/layers.py (EqualLinear,
EqualConv2d, Blur, FusedLeakyReLU, ConvLayer, ResBlock). Module and
parameter names follow the reference's torch modules, so a state_dict holds
the same flat keys as the JAX package's parameter dicts. Derived buffers
(the blur FIR taps) are not persistent.

Every constructor takes the ``device`` to build on and the
``torch.Generator`` its random weights are drawn from.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from gangealing_torch.ops.resample import fused_leaky_relu, make_kernel, upfirdn2d

BLUR_KERNEL = (1, 3, 3, 1)


def randn(shape, generator=None, device=None):
    """Standard normal weights drawn from ``generator`` (on its own device),
    placed on ``device``."""
    gen_device = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=gen_device).to(device)


class EqualLinear(nn.Module):
    """Linear layer with equalized learning rate (networks.py:127)."""

    def __init__(self, in_dim, out_dim, activation=None, *, device=None,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(randn((out_dim, in_dim), generator, device))
        self.bias = nn.Parameter(torch.zeros(out_dim, device=device))
        self.scale = 1.0 / math.sqrt(in_dim)
        self.activation = activation

    def forward(self, x):
        out = F.linear(x, self.weight * self.scale)
        if self.activation:
            return fused_leaky_relu(out, self.bias)
        return out + self.bias


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
        return F.conv2d(x, self.weight * self.scale, bias=self.bias,
                        stride=self.stride, padding=self.padding)


class Blur(nn.Module):
    """FIR blur (networks.py:70); its taps are a derived buffer."""

    def __init__(self, kernel, pad, *, device=None):
        super().__init__()
        self.register_buffer("kernel", make_kernel(kernel, device),
                             persistent=False)
        self.pad = pad

    def forward(self, x):
        return upfirdn2d(x, self.kernel, pad=self.pad)


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
            layers.append(Blur(BLUR_KERNEL, pad=((p + 1) // 2, p // 2),
                               device=device))
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
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)
