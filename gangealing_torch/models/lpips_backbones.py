"""Additional LPIPS backbones: AlexNet, SqueezeNet 1.1 and ResNet feature
stacks, as functions of a flat parameter dict of tensors.

Port of gangealing_tpu/models/lpips_backbones.py (reference
models/losses/lpips_backbones.py). The keys are the JAX package's
(``net.slice_all.N.*``, ``net.layerL.B.*``), so ``io/from_jax.
params_from_jax`` carries its parameters across unrenamed, and the
torchvision importers map a torchvision state_dict onto them. VGG16 lives
in models/lpips.py (the default and the only backbone the training
recipes use); nothing in the port calls these.
"""

import math

import torch
import torch.nn.functional as F

ALEX_CHANNELS = [64, 192, 384, 256, 256]
SQUEEZE_CHANNELS = [64, 128, 256, 384, 384, 512, 512]

# torchvision alexnet.features layout:
# 0 conv(3,64,k11,s4,p2) 1 relu 2 maxpool3s2 3 conv(64,192,k5,p2) 4 relu
# 5 maxpool3s2 6 conv(192,384,k3,p1) 7 relu 8 conv(384,256,k3,p1) 9 relu
# 10 conv(256,256,k3,p1) 11 relu 12 maxpool3s2
# slices end after relus 1, 4, 7, 9, 11 (lpips_backbones.py:64-77)


def _maxpool(x, k=3, s=2):
    return F.max_pool2d(x, k, s)


def _conv(params, name, x, stride=1, padding=0):
    """Conv ``name`` with its bias added after it, as the JAX package adds
    it."""
    y = F.conv2d(x, params[f"{name}.weight"], stride=stride, padding=padding)
    return y + params[f"{name}.bias"].reshape(1, -1, 1, 1)


def alexnet_features(params, x, prefix="net"):
    """The 5 relu slices of torchvision AlexNet features."""
    def c(idx, x, stride=1, padding=0):
        return _conv(params, f"{prefix}.slice_all.{idx}", x, stride, padding)

    outs = []
    h = F.relu(c(0, x, stride=4, padding=2))
    outs.append(h)
    h = _maxpool(h)
    h = F.relu(c(3, h, padding=2))
    outs.append(h)
    h = _maxpool(h)
    h = F.relu(c(6, h, padding=1))
    outs.append(h)
    h = F.relu(c(8, h, padding=1))
    outs.append(h)
    h = F.relu(c(10, h, padding=1))
    outs.append(h)
    return outs


def alexnet_init(generator, device=None):
    """He-normal AlexNet feature weights drawn from ``generator`` (a
    ``torch.Generator``, on its own device), zero biases."""
    shapes = [(0, 3, 64, 11), (3, 64, 192, 5), (6, 192, 384, 3),
              (8, 384, 256, 3), (10, 256, 256, 3)]
    p = {}
    for idx, cin, cout, k in shapes:
        std = math.sqrt(2.0 / (cin * k * k))
        w = torch.randn((cout, cin, k, k), generator=generator,
                        device=generator.device) * std
        p[f"net.slice_all.{idx}.weight"] = w.to(device)
        p[f"net.slice_all.{idx}.bias"] = torch.zeros(cout, device=device)
    return p


def _as_tensor(v):
    if torch.is_tensor(v):
        return v.detach().cpu().float().clone()
    return torch.tensor(v, dtype=torch.float32)


def import_torchvision_alexnet(state_dict):
    out = {}
    for k, v in state_dict.items():
        parts = k.split(".")
        if parts[0] == "features":
            out[f"net.slice_all.{parts[1]}.{parts[2]}"] = _as_tensor(v)
    return out


# --- SqueezeNet 1.1 (lpips_backbones.py:6-54) -------------------------------
# torchvision squeezenet1_1.features layout:
#   0 conv(3,64,k3,s2) 1 relu 2 maxpool3s2 3 Fire 4 Fire 5 maxpool3s2
#   6 Fire 7 Fire 8 maxpool3s2 9 Fire 10 Fire 11 Fire 12 Fire
# LPIPS slices end after indices 1, 4, 7, 9, 10, 11, 12.

_FIRE_CFG = {  # idx -> (in, squeeze, expand)
    3: (64, 16, 64), 4: (128, 16, 64), 6: (128, 32, 128), 7: (256, 32, 128),
    9: (256, 48, 192), 10: (384, 48, 192), 11: (384, 64, 256),
    12: (512, 64, 256),
}


def _fire(params, prefix, x):
    s = F.relu(_conv(params, f"{prefix}.squeeze", x))
    e1 = F.relu(_conv(params, f"{prefix}.expand1x1", s))
    e3 = F.relu(_conv(params, f"{prefix}.expand3x3", s, padding=1))
    return torch.cat([e1, e3], dim=1)


def squeezenet_features(params, x, prefix="net"):
    """The 7 LPIPS slices of torchvision SqueezeNet 1.1 features."""
    def fire(idx, h):
        return _fire(params, f"{prefix}.slice_all.{idx}", h)

    outs = []
    h = F.relu(_conv(params, f"{prefix}.slice_all.0", x, stride=2))
    outs.append(h)                                   # relu1 (idx 1)
    h = fire(4, fire(3, _maxpool(h)))
    outs.append(h)                                   # relu2 (idx 4)
    h = fire(7, fire(6, _maxpool(h)))
    outs.append(h)                                   # relu3 (idx 7)
    h = fire(9, _maxpool(h))
    outs.append(h)                                   # relu4 (idx 9)
    for idx in (10, 11, 12):
        h = fire(idx, h)
        outs.append(h)                               # relu5-7 (idx 10-12)
    return outs


def import_torchvision_squeezenet(state_dict):
    out = {}
    for k, v in state_dict.items():
        parts = k.split(".")
        if parts[0] == "features":
            out["net.slice_all." + ".".join(parts[1:])] = _as_tensor(v)
    return out


# --- ResNet (lpips_backbones.py:143-185) -------------------------------------
# torchvision resnet18/34 (BasicBlock) and resnet50 (Bottleneck), eval-mode
# batchnorm. The reference's `resnet` wrapper exposes 5 slices:
# relu1 (post conv1+bn1+relu), conv2..conv5 (post layer1..layer4).
# The reference defines this backbone but never wires it into the LPIPS
# chns dispatch (lpips.py:142-150): it is a standalone feature extractor.

RESNET18_CHANNELS = [64, 64, 128, 256, 512]
_RESNET_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}


def _bn(params, prefix, x, eps=1e-5):
    def p(name):
        return params[f"{prefix}.{name}"].reshape(1, -1, 1, 1)
    return (x - p("running_mean")) * torch.rsqrt(p("running_var") + eps) \
        * p("weight") + p("bias")


def _convbn(params, prefix, bn_prefix, x, stride=1, padding=0):
    y = F.conv2d(x, params[f"{prefix}.weight"], stride=stride,
                 padding=padding)
    return _bn(params, bn_prefix, y)


def _downsample(params, prefix, x, stride):
    if f"{prefix}.downsample.0.weight" in params:
        return _convbn(params, f"{prefix}.downsample.0",
                       f"{prefix}.downsample.1", x, stride=stride)
    return x


def _basic_block(params, prefix, x, stride):
    out = F.relu(_convbn(params, f"{prefix}.conv1", f"{prefix}.bn1", x,
                         stride=stride, padding=1))
    out = _convbn(params, f"{prefix}.conv2", f"{prefix}.bn2", out, padding=1)
    return F.relu(out + _downsample(params, prefix, x, stride))


def _bottleneck(params, prefix, x, stride):
    out = F.relu(_convbn(params, f"{prefix}.conv1", f"{prefix}.bn1", x))
    out = F.relu(_convbn(params, f"{prefix}.conv2", f"{prefix}.bn2", out,
                         stride=stride, padding=1))
    out = _convbn(params, f"{prefix}.conv3", f"{prefix}.bn3", out)
    return F.relu(out + _downsample(params, prefix, x, stride))


def resnet_features(params, x, num=18, prefix="net"):
    """The 5 reference slices of a torchvision ResNet (relu1,
    conv2..conv5)."""
    block = _basic_block if num in (18, 34) else _bottleneck
    h = F.conv2d(x, params[f"{prefix}.conv1.weight"], stride=2, padding=3)
    h = F.relu(_bn(params, f"{prefix}.bn1", h))
    outs = [h]
    # torch's maxpool(3, 2, padding=1) pads with -inf, as the JAX package
    h = F.max_pool2d(h, 3, 2, padding=1)
    for li, nblocks in enumerate(_RESNET_LAYERS[num], start=1):
        for bi in range(nblocks):
            stride = 2 if (li > 1 and bi == 0) else 1
            h = block(params, f"{prefix}.layer{li}.{bi}", h, stride)
        outs.append(h)
    return outs


def import_torchvision_resnet(state_dict, prefix="net"):
    """A torchvision ResNet state_dict (optionally nested under 'net.' or
    'net.net.') -> the flat parameter dict, without ``fc`` and the batch
    norms' ``num_batches_tracked``."""
    out = {}
    for k, v in state_dict.items():
        kk = k
        while kk.startswith("net."):
            kk = kk[4:]
        if kk.startswith("fc.") or kk.endswith("num_batches_tracked"):
            continue
        out[f"{prefix}.{kk}"] = _as_tensor(v)
    return out
