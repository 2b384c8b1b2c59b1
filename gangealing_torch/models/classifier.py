"""The cluster classifier: a ResNet encoder giving 2K logits (K clusters,
each as seen and mirrored).

Port of gangealing_tpu/models/classifier.py (reference
models/cluster_classifier.py:8-101, ResnetClassifier). Its blocks are the
similarity STN's (``ConvLayer``, ``ResBlock``), under the same names, so
``warm_start_from_stn`` can copy the STN's encoder into it, and its
state_dict keys are the JAX package's flat names, so
``io/from_jax.params_from_jax`` carries its weights across unrenamed.
"""

import math
from dataclasses import dataclass

import torch
from torch import nn

from gangealing_torch.models.layers import ConvLayer, EqualLinear, ResBlock
from gangealing_torch.ops.resample import bilinear_downsample


@dataclass(frozen=True)
class ClassifierConfig:
    size: int = 128               # stn_in_size / flow_size
    supersize: int = 256
    channel_multiplier: float = 0.5
    num_heads: int = 2            # 2 * K (clusters x flips)
    max_channels: int = 512

    @property
    def channels(self):
        cm = self.channel_multiplier
        full = {4: 512, 8: 512, 16: 512, 32: 512, 64: int(256 * cm),
                128: int(128 * cm), 256: int(64 * cm), 512: int(32 * cm),
                1024: int(16 * cm)}
        return {k: min(v, self.max_channels) for k, v in full.items()}

    def encoder_plan(self):
        """(stem channels, (in, out) of each ResBlock, encoder output
        channels, channels at 4 px)."""
        ch = self.channels
        blocks = []
        in_ch = ch[self.size]
        for i in range(int(math.log2(self.size)), 2, -1):
            out_ch = ch[2 ** (i - 1)]
            blocks.append((int(in_ch), int(out_ch)))
            in_ch = out_ch
        return int(ch[self.size]), blocks, int(in_ch), int(ch[4])


def classifier_config(t_cfg, supersize):
    """The classifier of a ComposedSTN configuration, as the JAX package's
    load_stn and classifier CLI build it: the STN's input size and widths,
    two logits a head."""
    return ClassifierConfig(size=t_cfg.flow_size, supersize=supersize,
                            channel_multiplier=t_cfg.channel_multiplier,
                            num_heads=2 * t_cfg.num_heads,
                            max_channels=t_cfg.max_channels)


class Classifier(nn.Module):
    def __init__(self, cfg: ClassifierConfig, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        stem_ch, blocks, enc_out, ch4 = cfg.encoder_plan()
        self.convs = nn.Sequential(
            ConvLayer(3, stem_ch, 1, **kw),
            *[ResBlock(ic, oc, **kw) for ic, oc in blocks])
        self.final_conv = ConvLayer(enc_out, ch4, 3, **kw)
        self.to_logits = EqualLinear(ch4 * 16, cfg.num_heads,
                                     activation="fused_lrelu", **kw)

    def forward(self, x):
        """(N, 3, S, S) images -> (N, 2K) logits; an input wider than
        ``cfg.size`` is bilinearly downsampled to it first."""
        if x.shape[-1] > self.cfg.size:
            x = bilinear_downsample(x, x.shape[-1] // self.cfg.size)
        out = self.final_conv(self.convs(x))
        return self.to_logits(out.reshape(out.shape[0], -1))


def classifier_assign(classifier, x, ignore_flips=False):
    classes = classifier(x).argmax(dim=1)
    if ignore_flips:
        classes = classes % (classifier.cfg.num_heads // 2)
    return classes


def classifier_run_flip(classifier, x):
    """Mirror the inputs predicted to need it (cluster_classifier.py:70-76).
    Returns (flipped input, logits, classes, flip (N,) bool)."""
    k = classifier.cfg.num_heads // 2
    preds = classifier(x)
    classes = preds.argmax(dim=1)
    flip = classes >= k
    x = torch.where(flip.reshape(-1, 1, 1, 1), x.flip(3), x)
    return x, preds, classes, flip


def classifier_run_flip_target(classifier, x, target_cluster):
    """The flip decision restricted to one cluster's pair of logits, as
    seen and mirrored (cluster_classifier.py:78-84). Returns (flipped
    input, flip (N,) bool)."""
    k = classifier.cfg.num_heads // 2
    preds = classifier(x)
    pair = preds[:, [target_cluster, target_cluster + k]]
    flip = pair.argmax(dim=1) == 1
    x = torch.where(flip.reshape(-1, 1, 1, 1), x.flip(3), x)
    return x, flip


def classifier_run_flip_cartesian(classifier, x):
    """Every input once for each cluster, mirrored where that cluster's
    pair of logits says so (cluster_classifier.py:86-96). Returns the
    (N*K, C, H, W) inputs, k fastest, and the one-hot warp policy
    (N*K, K)."""
    k = classifier.cfg.num_heads // 2
    N = x.shape[0]
    preds = classifier(x)
    flip = preds.reshape(N, 2, k).argmax(dim=1) == 1  # (N, k)
    xr = x[:, None].expand(N, k, *x.shape[1:])
    xr = torch.where(flip[:, :, None, None, None], xr.flip(4), xr)
    xr = xr.reshape(N * k, *x.shape[1:])
    warp_policy = torch.eye(k, dtype=x.dtype, device=x.device).repeat(N, 1)
    return xr, warp_policy


def reverse_topk_accuracy(distances, logits, k=2):
    """"Reverse top-K": a prediction counts as right when it is one of the
    k clusters of lowest loss (models/__init__.py:36-43). Ties in the
    distances go to the lower index, as a stable sort gives them."""
    idx = torch.sort(distances, dim=1, stable=True).indices[:, :k]
    pred = logits.argmax(dim=1)
    return (idx == pred[:, None]).any(dim=1).float().mean()
