"""StyleGAN2 generator (config-f, rosinality checkpoint layout) as an
nn.Module.

Port of gangealing_tpu/models/stylegan2.py. The state_dict keys equal the
JAX package's parameter keys, the per-layer noise buffers
``noises.noise_{i}`` included, so a reference ``g_ema`` or a JAX parameter
dict loads with ``strict=True``. Random draws (z, the per-layer noise) come
from an explicit ``torch.Generator``. Style mixing takes a static
``inject_index``, as in the JAX package: the reference's random choice is
the caller's.
"""

import math
from dataclasses import dataclass

import torch
from torch import nn

from gangealing_torch.models.layers import (
    ConstantInput, EqualLinear, StyledConv, ToRGB, cast_to, pixel_norm,
    randn)
from gangealing_torch.utils.profiling import span


@dataclass(frozen=True)
class GeneratorConfig:
    size: int = 256
    style_dim: int = 512
    n_mlp: int = 8
    channel_multiplier: int = 2
    num_fp16_res: int = 0  # >0 marks trailing convs with the normalize path
    max_channels: int = 512  # cap (tests use small values; checkpoints 512)

    @property
    def log_size(self) -> int:
        return int(math.log2(self.size))

    @property
    def n_latent(self) -> int:
        return self.log_size * 2 - 2

    @property
    def num_layers(self) -> int:
        return (self.log_size - 2) * 2 + 1

    @property
    def channels(self):
        cm = self.channel_multiplier
        full = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm,
                256: 64 * cm, 512: 32 * cm, 1024: 16 * cm}
        return {k: min(v, self.max_channels) for k, v in full.items()}

    def noise_shapes(self, batch):
        return [(batch, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2))
                for i in range(self.num_layers)]


class PixelNorm(nn.Module):
    def forward(self, x):
        return pixel_norm(x)


class Generator(nn.Module):
    """The StyleGAN2 synthesis network and its mapping MLP
    (networks.py:396-586)."""

    def __init__(self, cfg: GeneratorConfig, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        sd = cfg.style_dim
        self.style = nn.Sequential(PixelNorm(), *[
            EqualLinear(sd, sd, activation="fused_lrelu", lr_mul=0.01, **kw)
            for _ in range(cfg.n_mlp)])
        ch = cfg.channels
        self.input = ConstantInput(ch[4], **kw)
        self.conv1 = StyledConv(ch[4], ch[4], 3, sd, **kw)
        self.to_rgb1 = ToRGB(ch[4], sd, **kw)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = ch[4]
        for i in range(3, cfg.log_size + 1):
            out_ch = ch[2 ** i]
            normalize = i > cfg.log_size - cfg.num_fp16_res
            self.convs.append(StyledConv(in_ch, out_ch, 3, sd, upsample=True,
                                         normalize=normalize, **kw))
            self.convs.append(StyledConv(out_ch, out_ch, 3, sd,
                                         normalize=normalize, **kw))
            self.to_rgbs.append(ToRGB(out_ch, sd, **kw))
            in_ch = out_ch
        # the fixed per-layer noise of the randomize_noise=False path
        self.noises = nn.Module()
        for i, shape in enumerate(cfg.noise_shapes(1)):
            self.noises.register_buffer(f"noise_{i}", randn(shape, **kw))

    def mapping(self, z):
        """The style MLP with its PixelNorm input (networks.py:414-423)."""
        return self.style(z)

    def make_noise(self, batch, rng=None):
        """Fresh per-layer noise images drawn from ``rng``."""
        dev = self.input.input.device
        return [randn(s, rng, dev) for s in self.cfg.noise_shapes(batch)]

    def batch_latent(self, n, rng=None):
        dev = self.input.input.device
        return self.mapping(randn((n, self.cfg.style_dim), rng, dev))

    def mean_latent(self, n, rng=None):
        return self.batch_latent(n, rng).mean(dim=0, keepdim=True)

    def _expand_latent(self, styles, inject_index):
        n_latent = self.cfg.n_latent
        if len(styles) < 2 or inject_index == n_latent:
            s = styles[0]
            return s[:, None, :].expand(-1, n_latent, -1) if s.ndim < 3 else s
        if inject_index is None:
            raise ValueError("style mixing requires an explicit inject_index")
        return torch.cat([
            styles[0][:, None, :].expand(-1, inject_index, -1),
            styles[1][:, None, :].expand(-1, n_latent - inject_index, -1)],
            dim=1)

    def forward(self, styles, noise=None, rng=None, randomize_noise=True,
                input_is_latent=False, inject_index=None, truncation=1.0,
                truncation_latent=None, return_latents=False,
                compute_dtype=None):
        """``styles``: a list of (N, style_dim) z or w tensors, or of one
        (N, n_latent, style_dim) W+ tensor. ``noise``: a list of per-layer
        noise images; if None, drawn from ``rng`` (randomize_noise) or the
        fixed buffers. ``compute_dtype``: the dtype of the synthesis from
        the constant input on, None for the parameters' (the mapping and
        the latents keep it); the image comes back at float32 or wider
        from the last ToRGB's skip sum.
        Returns (image, W+ latent or None)."""
        if not isinstance(styles, (list, tuple)):
            styles = [styles]
        if not input_is_latent:
            styles = [self.mapping(s) for s in styles]
        if truncation < 1.0:
            truncated = truncation_latent + truncation * (
                styles[0] - truncation_latent)
            styles = [truncated, styles[0]]
            if inject_index is None:
                inject_index = self.cfg.n_latent
        latent = self._expand_latent(styles, inject_index)
        N = latent.shape[0]
        if noise is None:
            if randomize_noise:
                noise = self.make_noise(N, rng)
            else:
                noise = [getattr(self.noises, f"noise_{i}")
                         for i in range(self.cfg.num_layers)]

        out = self.conv1(cast_to(self.input(N), compute_dtype), latent[:, 0],
                         noise=noise[0])
        skip = self.to_rgb1(out, latent[:, 1])
        # the last two blocks, the widest planes, under a span of their own
        top = max(0, len(self.to_rgbs) - 2)
        for b in range(top):
            out, skip = self._block(b, out, skip, latent, noise)
        with span("generator.top"):
            for b in range(top, len(self.to_rgbs)):
                out, skip = self._block(b, out, skip, latent, noise)
        return skip, (latent if return_latents else None)

    def _block(self, b, out, skip, latent, noise):
        """Synthesis block ``b``: its upsampling and its plain StyledConv,
        then its ToRGB added to the upsampled skip."""
        i = 1 + 2 * b
        out = self.convs[2 * b](out, latent[:, i], noise=noise[1 + 2 * b])
        out = self.convs[2 * b + 1](out, latent[:, i + 1],
                                    noise=noise[2 + 2 * b])
        return out, self.to_rgbs[b](out, latent[:, i + 2], skip)
