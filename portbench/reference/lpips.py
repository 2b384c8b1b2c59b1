"""Perceptual losses: LPIPS (VGG16 + learned linear calibration) and the
SimCLR-VGG variant, as nn.Modules.

Port of gangealing_tpu/models/lpips.py. The state_dict keys are the
reference LPIPS names (``net.slice{i}.{idx}.weight``,
``lin{k}.model.1.weight``), which are the JAX package's parameter keys, so
the richzhang calibration and SimCLR VGG weights load directly. Each loss
returns per-sample (N, 1, 1, 1) distances. With ``compute_dtype``
bfloat16 the whole trunk runs in bfloat16, each of its 13 biases cast to
it, and the features come back to float32 for the normalisation, the lins
and the reduction.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import (
    cast_to, float32_or_wider, randn)

# torchvision VGG16 `features` conv layer indices and channel widths
_VGG_SLICES = [
    # (slice_name, [(layer_idx, in_ch, out_ch), ...], maxpool index or None)
    ("slice1", [(0, 3, 64), (2, 64, 64)], None),
    ("slice2", [(5, 64, 128), (7, 128, 128)], 4),
    ("slice3", [(10, 128, 256), (12, 256, 256), (14, 256, 256)], 9),
    ("slice4", [(17, 256, 512), (19, 512, 512), (21, 512, 512)], 16),
    ("slice5", [(24, 512, 512), (26, 512, 512), (28, 512, 512)], 23),
]
VGG_CHANNELS = [64, 128, 256, 512, 512]

SCALING_SHIFT = (-0.030, -0.088, -0.188)
SCALING_SCALE = (0.458, 0.448, 0.450)


class VGG16(nn.Module):
    """The five slices of torchvision's VGG16 ``features``, each an
    nn.Sequential keyed by the torchvision layer index; random weights are
    He-initialised from ``generator`` (the pnet_rand path)."""

    def __init__(self, *, device=None, generator=None):
        super().__init__()
        for sname, convs, pool in _VGG_SLICES:
            seq = nn.Sequential()
            if pool is not None:
                seq.add_module(str(pool), nn.MaxPool2d(2, 2))
            for idx, cin, cout in convs:
                conv = nn.Conv2d(cin, cout, 3, padding=1, device=device)
                with torch.no_grad():
                    conv.weight.copy_(randn((cout, cin, 3, 3), generator,
                                            device) * np.sqrt(2.0 / (cin * 9)))
                    conv.bias.zero_()
                seq.add_module(str(idx), conv)
                seq.add_module(str(idx + 1), nn.ReLU())
            self.add_module(sname, seq)

    def forward(self, x):
        outs = []
        for sname, _, _ in _VGG_SLICES:
            for layer in getattr(self, sname):
                x = _conv(layer, x) if isinstance(layer, nn.Conv2d) \
                    else layer(x)
            outs.append(x)
        return outs


def _conv(conv, x):
    """``conv`` in the dtype of ``x``. Off float32 the bias is added after
    the conv, cast to that dtype, where the JAX package adds it."""
    if x.dtype == conv.weight.dtype:
        return conv(x)
    return (F.conv2d(x, conv.weight.to(x.dtype), padding=conv.padding)
            + conv.bias.to(x.dtype)[:, None, None])


class LinLayer(nn.Module):
    """The reference's NetLinLayer: dropout (off in eval) then a 1x1 conv
    without bias; only the conv has weights, under ``model.1``."""

    def __init__(self, channels, *, device=None, generator=None):
        super().__init__()
        conv = nn.Conv2d(channels, 1, 1, bias=False, device=device)
        with torch.no_grad():
            conv.weight.copy_(randn((1, channels, 1, 1), generator,
                                    device).abs() * 0.1)
        self.model = nn.Sequential(nn.Identity(), conv)


class LPIPS(nn.Module):
    """VGG16 trunk ``net`` and, for ``use_lins``, the calibration layers
    ``lin0``..``lin4``."""

    def __init__(self, use_lins=False, *, device=None, generator=None):
        super().__init__()
        self.net = VGG16(device=device, generator=generator)
        self.use_lins = use_lins
        if use_lins:
            for i, c in enumerate(VGG_CHANNELS):
                self.add_module(f"lin{i}", LinLayer(c, device=device,
                                                    generator=generator))


def _normalize_tensor(feat, eps=1e-10):
    return feat / (torch.sqrt((feat ** 2).sum(dim=1, keepdim=True)) + eps)


def lpips_distance(model: LPIPS, x, y, compute_dtype=None):
    """Per-sample perceptual distance, (N, 1, 1, 1), of images in [-1, 1]:
    calibrated by the lins if the model has them, else the raw sum over
    channels (the vgg_ssl mode). The trunk runs in ``compute_dtype``
    (None: the images')."""
    shift = torch.tensor(SCALING_SHIFT, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(SCALING_SCALE, device=x.device).reshape(1, 3, 1, 1)
    fx = model.net(cast_to((x - shift) / scale, compute_dtype))
    fy = model.net(cast_to((y - shift) / scale, compute_dtype))
    val = 0.0
    for i, (a, b) in enumerate(zip(fx, fy)):
        a, b = float32_or_wider(a), float32_or_wider(b)
        d = (_normalize_tensor(a) - _normalize_tensor(b)) ** 2
        if model.use_lins:
            d = F.conv2d(d, getattr(model, f"lin{i}").model[1].weight)
        else:
            d = d.sum(dim=1, keepdim=True)
        val = val + d.mean(dim=(2, 3), keepdim=True)
    return val


def make_perceptual_loss(kind, compute_dtype=None):
    """loss(model, x, y) -> (N, 1, 1, 1), as get_perceptual_loss
    (lpips.py:13-23): 'vgg_ssl' is the raw distance over 18, 'lpips' the
    calibrated one; the trunk runs in ``compute_dtype`` (None: the
    images')."""
    if kind == "vgg_ssl":
        return lambda m, x, y: lpips_distance(m, x, y, compute_dtype) / 18.0
    if kind == "lpips":
        return lambda m, x, y: lpips_distance(m, x, y, compute_dtype)
    raise NotImplementedError(kind)


def import_torchvision_vgg(state_dict):
    """torchvision ``features.N.weight`` names (or a bare ``N.weight``
    nn.Sequential state_dict, as the SimCLR VGG checkpoint is saved) ->
    ``net.sliceX.N.weight`` float32 tensors. LPIPS ``net.*`` and ``lin*``
    names pass through; ``scaling_layer`` buffers are dropped (the shift and
    scale are constants here)."""
    idx_to_slice = {idx: sname for sname, convs, _ in _VGG_SLICES
                    for idx, _, _ in convs}
    out = {}
    for k, v in state_dict.items():
        v = torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach")
                                       else v, np.float32))
        parts = k.split(".")
        if parts[0] == "features":
            parts = parts[1:]
        elif parts[0] == "net" or parts[0].startswith("lin"):
            out[k] = v
            continue
        try:
            idx = int(parts[0])
        except ValueError:
            continue
        if idx in idx_to_slice:
            out[f"net.{idx_to_slice[idx]}.{idx}.{parts[1]}"] = v
    return out
