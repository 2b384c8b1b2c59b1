"""The port's LPIPS backbones (gangealing_torch/models/lpips_backbones.py)
against the JAX package's, on the CPU.

Parameters are made with numpy from a seed (AlexNet's from JAX's own
``alexnet_init``), carried across with ``params_from_jax`` unrenamed, and
both sides run the same input. Each slice is held at atol 1e-5 scaled by
max(1, max|ref|), rtol 0: float32 convolutions on both sides, summed in
another order (ResNet-50's deepest slice read 1.3e-6 scaled). The
importers are held on torchvision-shaped state_dicts built here, as
tests/test_lpips_backbones.py builds them: the port's dict
equals JAX's to the bit, and AlexNet's and SqueezeNet's slices equal the
torch modules' own at the same tolerance.
"""

from importlib import import_module

import numpy as np
import pytest
import torch
import torch.nn as nn
import jax
import jax.numpy as jnp

from gangealing_torch.io import params_from_jax
from gangealing_torch.models import lpips_backbones as tlb

jlb = import_module("gangealing_tpu.models.lpips_backbones")

ATOL = 1e-5


def _close(ours, ref):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.detach().numpy(), ref, atol=ATOL * scale,
                               rtol=0)


def _conv_params(rng, p, name, cin, cout, k, bias=True):
    p[f"{name}.weight"] = (rng.randn(cout, cin, k, k)
                           * np.sqrt(2.0 / (cin * k * k))).astype(np.float32)
    if bias:
        p[f"{name}.bias"] = (0.1 * rng.randn(cout)).astype(np.float32)


def _bn_params(rng, p, name, c):
    p[f"{name}.weight"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    p[f"{name}.bias"] = (0.1 * rng.randn(c)).astype(np.float32)
    p[f"{name}.running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
    p[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)


def squeezenet_params(seed):
    rng = np.random.RandomState(seed)
    p = {}
    _conv_params(rng, p, "net.slice_all.0", 3, 64, 3)
    for idx, (cin, s, e) in tlb._FIRE_CFG.items():
        pre = f"net.slice_all.{idx}"
        _conv_params(rng, p, f"{pre}.squeeze", cin, s, 1)
        _conv_params(rng, p, f"{pre}.expand1x1", s, e, 1)
        _conv_params(rng, p, f"{pre}.expand3x3", s, e, 3)
    return p


def resnet_state_dict(num, seed):
    """A torchvision-shaped ResNet state_dict in numpy: the conv and
    eval-mode batch norm parameters of every block, with ``fc`` and
    ``num_batches_tracked``, which the importer drops."""
    rng = np.random.RandomState(seed)
    p = {}
    _conv_params(rng, p, "conv1", 3, 64, 7, bias=False)
    _bn_params(rng, p, "bn1", 64)
    p["bn1.num_batches_tracked"] = np.array(0)
    bottleneck = num == 50
    cin = 64
    for li, nblocks in enumerate(tlb._RESNET_LAYERS[num], start=1):
        width = 64 * 2 ** (li - 1)
        cout = width * 4 if bottleneck else width
        for bi in range(nblocks):
            pre = f"layer{li}.{bi}"
            if bottleneck:
                convs = [(cin, width, 1), (width, width, 3),
                         (width, cout, 1)]
            else:
                convs = [(cin, width, 3), (width, cout, 3)]
            for j, (a, b, k) in enumerate(convs, start=1):
                _conv_params(rng, p, f"{pre}.conv{j}", a, b, k, bias=False)
                _bn_params(rng, p, f"{pre}.bn{j}", b)
            if bi == 0 and (li > 1 or cin != cout):
                _conv_params(rng, p, f"{pre}.downsample.0", cin, cout, 1,
                             bias=False)
                _bn_params(rng, p, f"{pre}.downsample.1", cout)
            cin = cout
    p["fc.weight"] = rng.randn(10, cin).astype(np.float32)
    p["fc.bias"] = rng.randn(10).astype(np.float32)
    return p


def _features(name, seed):
    """(the port's slices, JAX's) of backbone ``name`` on one input."""
    x = np.random.RandomState(seed).randn(2, 3, 64, 64).astype(np.float32)
    if name == "alexnet":
        params = jlb.alexnet_init(jax.random.PRNGKey(seed))
        ours_fn, ref_fn = tlb.alexnet_features, jlb.alexnet_features
    elif name == "squeezenet":
        params = squeezenet_params(seed)
        ours_fn, ref_fn = tlb.squeezenet_features, jlb.squeezenet_features
    else:
        num = int(name[len("resnet"):])
        params = jlb.import_torchvision_resnet(resnet_state_dict(num, seed))
        ours_fn = lambda p, h: tlb.resnet_features(p, h, num=num)  # noqa: E731
        ref_fn = lambda p, h: jlb.resnet_features(p, h, num=num)  # noqa: E731
    with torch.no_grad():
        ours = ours_fn(params_from_jax(params), torch.from_numpy(x))
    ref = ref_fn({k: jnp.asarray(v) for k, v in params.items()},
                 jnp.asarray(x))
    return ours, ref


@pytest.mark.parametrize("name", ["alexnet", "squeezenet", "resnet18",
                                  "resnet50"])
def test_features_match_jax(name):
    ours, ref = _features(name, 0)
    assert len(ours) == len(ref)
    channels = {"alexnet": tlb.ALEX_CHANNELS,
                "squeezenet": tlb.SQUEEZE_CHANNELS,
                "resnet18": tlb.RESNET18_CHANNELS,
                "resnet50": [64, 256, 512, 1024, 2048]}[name]
    assert [o.shape[1] for o in ours] == channels
    for o, r in zip(ours, ref):
        assert tuple(o.shape) == r.shape
        _close(o, r)


class _Fire(nn.Module):
    def __init__(self, cin, s, e):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, s, 1)
        self.expand1x1 = nn.Conv2d(s, e, 1)
        self.expand3x3 = nn.Conv2d(s, e, 3, padding=1)

    def forward(self, x):
        x = torch.relu(self.squeeze(x))
        return torch.cat([torch.relu(self.expand1x1(x)),
                          torch.relu(self.expand3x3(x))], 1)


def _torchvision_features(name):
    """torchvision's AlexNet or SqueezeNet 1.1 ``features`` and the indices
    after which the LPIPS slices end."""
    torch.manual_seed(0)
    if name == "alexnet":
        return nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2d(3, 2)).eval(), {1, 4, 7, 9, 11}
    fire = {i: _Fire(*tlb._FIRE_CFG[i]) for i in tlb._FIRE_CFG}
    return nn.Sequential(
        nn.Conv2d(3, 64, 3, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
        fire[3], fire[4], nn.MaxPool2d(3, 2), fire[6], fire[7],
        nn.MaxPool2d(3, 2), fire[9], fire[10], fire[11],
        fire[12]).eval(), {1, 4, 7, 9, 10, 11, 12}


@pytest.mark.parametrize("name", ["alexnet", "squeezenet"])
def test_torchvision_importer(name):
    feats, ends = _torchvision_features(name)
    sd = {f"features.{k}": v for k, v in feats.state_dict().items()}
    ours = getattr(tlb, f"import_torchvision_{name}")(sd)
    ref = getattr(jlb, f"import_torchvision_{name}")(sd)
    assert set(ours) == set(ref)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))
    x = np.random.RandomState(1).randn(1, 3, 128, 128).astype(np.float32)
    with torch.no_grad():
        got = getattr(tlb, f"{name}_features")(ours, torch.from_numpy(x))
        h, want = torch.from_numpy(x), []
        for i, layer in enumerate(feats):
            h = layer(h)
            if i in ends:
                want.append(h.numpy())
    assert len(got) == len(want)
    for o, r in zip(got, want):
        _close(o, r)


@pytest.mark.parametrize("num", [18, 50])
def test_torchvision_resnet_importer(num):
    """The importer on a torchvision state_dict nested under 'net.net.',
    with torch tensors: JAX's dict to the bit, without ``fc`` and
    ``num_batches_tracked``."""
    sd = {f"net.net.{k}": torch.from_numpy(np.asarray(v))
          for k, v in resnet_state_dict(num, 2).items()}
    ours = tlb.import_torchvision_resnet(sd)
    ref = jlb.import_torchvision_resnet(sd)
    assert set(ours) == set(ref)
    assert not any(k.startswith("net.fc.") or "num_batches" in k
                   for k in ours)
    for k, v in ours.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))


def test_alexnet_init_from_a_generator():
    """alexnet_init draws from the explicit generator: the same seed gives
    the same weights, another seed others, and the slices have
    ALEX_CHANNELS."""
    a = tlb.alexnet_init(torch.Generator().manual_seed(0))
    b = tlb.alexnet_init(torch.Generator().manual_seed(0))
    c = tlb.alexnet_init(torch.Generator().manual_seed(1))
    assert set(a) == set(jlb.alexnet_init(jax.random.PRNGKey(0)))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["net.slice_all.0.weight"],
                           c["net.slice_all.0.weight"])
    with torch.no_grad():
        outs = tlb.alexnet_features(a, torch.zeros(1, 3, 64, 64))
    assert [o.shape[1] for o in outs] == tlb.ALEX_CHANNELS
