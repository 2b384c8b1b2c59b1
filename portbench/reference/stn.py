"""Spatial Transformer Networks: similarity and flow warping heads, the single
STN and the composed STN, as nn.Modules.

A frozen copy of gangealing_torch/models/stn.py up to ``ComposedSTN``,
over the plain samplers (no kernel). Parameter names are the
reference's torch names, which are also the JAX package's flat keys, so
``ComposedSTN.load_state_dict`` takes a JAX parameter dict (through
io/from_jax.py) or a reference checkpoint's ``t_ema`` strictly.
"""

import math
from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from portbench.reference.layers import (
    ConvLayer, EqualConv2d, EqualLinear, ResBlock, cast_to, dtype_of,
    float32_or_wider)
from portbench.reference.grid_sample import (
    affine_grid, grid_sample, identity_grid)
from portbench.reference.mipmap import mipmap_warp
from portbench.reference.resample import (
    bilinear_downsample, interpolate_bilinear)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class STNConfig:
    transform: str = "similarity"  # 'similarity' | 'flow'
    flow_size: int = 128
    supersize: int = 256
    channel_multiplier: float = 0.5
    num_heads: int = 1
    flow_downsample: int = 8
    antialias: bool = True
    max_channels: int = 512  # cap (tests use small values; checkpoints 512)
    compute_dtype: str = "float32"  # 'bfloat16' runs the encoder's convs
    # in bfloat16; the warp heads' inputs and outputs stay float32

    @property
    def is_flow(self):
        return self.transform == "flow"

    @property
    def channels(self):
        cm = self.channel_multiplier
        full = {4: 512, 8: 512, 16: 512, 32: 512, 64: int(256 * cm),
                128: int(128 * cm), 256: int(64 * cm), 512: int(32 * cm),
                1024: int(16 * cm)}
        return {k: min(v, self.max_channels) for k, v in full.items()}

    def encoder_plan(self):
        """(in_ch, out_ch, downsample) per ResBlock, plus stem/final dims."""
        ch = self.channels
        log_size = int(math.log2(self.flow_size))
        log_downsample = int(math.log2(self.flow_downsample))
        end_log = log_size - 4 if self.is_flow else 2
        if end_log < 2:
            raise ValueError(
                f"flow_size={self.flow_size} too small for transform="
                f"{self.transform} (min 64 for flow, 16 for similarity)")
        blocks = []
        in_ch = ch[self.flow_size]
        num_down = 0
        for i in range(log_size, end_log, -1):
            down = (not self.is_flow) or (num_down < log_downsample)
            num_down += down
            out_ch = ch[2 ** (i - 1)]
            blocks.append((int(in_ch), int(out_ch), down))
            in_ch = out_ch
        return int(ch[self.flow_size]), blocks, int(in_ch), int(ch[4])


@dataclass(frozen=True)
class ComposedSTNConfig:
    transforms: Tuple[str, ...] = ("similarity", "flow")
    flow_size: int = 128
    supersize: int = 256
    channel_multiplier: float = 0.5
    num_heads: int = 1
    flow_downsample: int = 8
    antialias: bool = True
    max_channels: int = 512
    compute_dtype: str = "float32"

    def stn_cfg(self, transform: str) -> STNConfig:
        return STNConfig(transform=transform, flow_size=self.flow_size,
                         supersize=self.supersize,
                         channel_multiplier=self.channel_multiplier,
                         num_heads=self.num_heads,
                         flow_downsample=self.flow_downsample,
                         antialias=self.antialias,
                         max_channels=self.max_channels,
                         compute_dtype=self.compute_dtype)

    @property
    def stn_cfgs(self):
        return [self.stn_cfg(t) for t in self.transforms]

    @property
    def is_flow(self):
        return "flow" in self.transforms


# ---------------------------------------------------------------------------
# warps
# ---------------------------------------------------------------------------

def make_affine_matrix(rot, scale, shift_x, shift_y):
    """(N, K) raw params -> (N, K, 2, 3) similarity matrices
    (warping_heads.py:36-50)."""
    N, K = rot.shape
    rot = torch.tanh(rot) * math.pi
    scale = torch.exp(scale)
    cos_r = torch.cos(rot)
    sin_r = torch.sin(rot)
    m = torch.stack([scale * cos_r, -scale * sin_r, shift_x,
                     scale * sin_r, scale * cos_r, shift_y], dim=2)
    return m.reshape(N, K, 2, 3)


def make_3x3(m):
    """(..., 2, 3) -> (..., 3, 3) homogeneous."""
    row = torch.zeros(m.shape[:-2] + (1, 3), dtype=m.dtype, device=m.device)
    row[..., 0, 2] = 1.0
    return torch.cat([m, row], dim=-2)


def apply_affine(matrix, grid):
    """Apply (N, 2, 3) affine to an arbitrary sampling grid (N, H, W, 2)
    (warping_heads.py:268-277)."""
    g = grid.reshape(grid.shape[0], -1, 2)
    g = torch.cat([g, torch.ones_like(g[..., :1])], dim=2)
    return torch.einsum("npk,nok->npo", g, matrix).reshape(grid.shape)


def check_oob(grid, image_bounds, out_hw, split_size, threshold=0.025):
    """Fraction of sampled pixels beyond image bounds > threshold
    (warping_heads.py:280-309). Returns (N*split,) bool."""
    Ho, Wo = out_hw
    if image_bounds is None:
        boundary_y = torch.tensor(float(Ho), device=grid.device)
        boundary_x = torch.tensor(float(Wo), device=grid.device)
    else:
        ib = image_bounds.repeat_interleave(split_size, 0).float()
        landscape = ib[:, 0] < ib[:, 1]
        full_y = torch.full_like(ib[:, 0], float(Ho))
        full_x = torch.full_like(ib[:, 0], float(Wo))
        boundary_y = torch.where(landscape, torch.round(Ho * ib[:, 0] / ib[:, 1]),
                                 full_y)
        boundary_x = torch.where(landscape, full_x,
                                 torch.round(Wo * ib[:, 1] / ib[:, 0]))
    gx = grid[..., 0].reshape(grid.shape[0], -1).abs()
    gy = grid[..., 1].reshape(grid.shape[0], -1).abs()
    bx = ((boundary_x - 1) / Wo).reshape(-1, 1)
    by = ((boundary_y - 1) / Ho).reshape(-1, 1)
    oob_x = (gx > bx).float().mean(dim=1) > threshold
    oob_y = (gy > by).float().mean(dim=1) > threshold
    return oob_x | oob_y


def _warp(img, grid, antialias, padding_mode):
    img, grid = img.contiguous(), grid.contiguous()
    if antialias:
        return mipmap_warp(img, grid, max_num_levels=3.5,
                           padding_mode=padding_mode)
    return grid_sample(img, grid, padding_mode=padding_mode)


def _as_alpha(alpha, like):
    return torch.as_tensor(alpha, dtype=like.dtype,
                           device=like.device).reshape(-1, 1, 1, 1)


# ---------------------------------------------------------------------------
# warping heads
# ---------------------------------------------------------------------------

class SimilarityHead(nn.Module):
    """Regress + apply a similarity warp (warping_heads.py:14-148).

    The linear layer is zero at init, so the head starts as the identity.
    """

    def __init__(self, in_dim, num_heads=1, antialias=True, *, device=None):
        super().__init__()
        self.linear = nn.Linear(in_dim, 4 * num_heads, device=device)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)
        self.num_heads = num_heads
        self.antialias = antialias

    def forward(self, img, features, output_resolution=None, alpha=None,
                base_warp=None, padding_mode="border",
                return_out_of_bounds=False, image_bounds=None,
                warp_policy="cartesian"):
        """warp_policy: 'cartesian' or an (N, K) logits tensor
        ('assign_only'). Returns (out, grid, matrix, oob)."""
        K = self.num_heads
        N = features.shape[0]
        raw = self.linear(features)  # (N, 4K)
        if isinstance(warp_policy, torch.Tensor):
            assignments = warp_policy.argmax(dim=1) % K
            raw = raw.reshape(N, 4, K).permute(0, 2, 1)  # (N, K, 4)
            raw = raw.gather(1, assignments[:, None, None].expand(N, 1, 4))[:, 0]
            split = 1
            params_nk = [raw[:, i:i + 1] for i in range(4)]
        elif warp_policy == "cartesian":
            split = K
            params_nk = [raw[:, i * K:(i + 1) * K] for i in range(4)]
        else:
            raise NotImplementedError(warp_policy)

        matrix = make_affine_matrix(*params_nk)  # (N, split, 2, 3)
        if base_warp is not None:
            if base_warp.ndim == 3:
                base_warp = base_warp[:, None]
            matrix = base_warp @ make_3x3(matrix)
        if alpha is not None:
            eye = torch.eye(2, 3, dtype=matrix.dtype, device=matrix.device)
            matrix = eye + _as_alpha(alpha, matrix) * (matrix - eye)
        out_res = output_resolution if output_resolution is not None \
            else img.shape[-1]
        matrix = matrix.reshape(N * split, 2, 3)
        img_rep = img.repeat_interleave(split, dim=0)
        grid = affine_grid(matrix, (N * split, img.shape[1], out_res, out_res))
        out = _warp(img_rep, grid, self.antialias, padding_mode)
        oob = check_oob(grid, image_bounds, (out_res, out_res), split) \
            if return_out_of_bounds else None
        return out, grid, matrix, oob


def convex_upsample_flow(flow, mask, ds):
    """RAFT convex upsampling (warping_heads.py:180-193).

    flow: (N, H, W, 2) low-res; mask: (N, 9*ds*ds, H, W). Returns
    (N, ds*H, ds*W, 2)."""
    N, H, W, _ = flow.shape
    f = flow.permute(0, 3, 1, 2)  # (N, 2, H, W)
    m = mask.reshape(N, 1, 9, ds, ds, H, W).softmax(dim=2)
    # F.unfold's channel order is c * 9 + (ki * 3 + kj)
    up = nn.functional.unfold(ds * f, (3, 3), padding=1)
    up = up.reshape(N, 2, 9, 1, 1, H, W)
    up = (m * up).sum(dim=2)  # (N, 2, ds, ds, H, W)
    up = up.permute(0, 4, 2, 5, 3, 1)  # (N, H, ds, W, ds, 2)
    return up.reshape(N, ds * H, ds * W, 2)


class FlowHead(nn.Module):
    """Regress + apply an unconstrained flow (warping_heads.py:151-265).

    The last flow conv is zero at init, so the head starts as the identity.
    """

    def __init__(self, in_ch, num_heads=1, flow_downsample=8, antialias=True,
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(padding=1, device=device, generator=generator)
        ds = flow_downsample
        self.flow_out = nn.Sequential(
            EqualConv2d(in_ch, in_ch, 3, **kw), nn.ReLU(),
            EqualConv2d(in_ch, num_heads * 2, 3, **kw))
        nn.init.zeros_(self.flow_out[2].weight)
        self.mask_out = nn.Sequential(
            EqualConv2d(in_ch, in_ch, 3, **kw), nn.ReLU(),
            EqualConv2d(in_ch, num_heads * 9 * ds * ds, 3, **kw))
        self.num_heads = num_heads
        self.flow_downsample = ds
        self.antialias = antialias

    def forward(self, img, features, output_resolution=None, alpha=None,
                base_warp=None, padding_mode="border",
                return_out_of_bounds=False, image_bounds=None,
                warp_policy="cartesian"):
        """features: (N, D, h, w) at flow_size/flow_downsample resolution.
        Returns (out, flow, delta_flow, oob)."""
        K = self.num_heads
        ds = self.flow_downsample
        N = features.shape[0]
        raw_flow = self.flow_out(features)
        Hc, Wc = raw_flow.shape[2], raw_flow.shape[3]
        low_flow = raw_flow.reshape(N, K, 2, Hc, Wc).permute(0, 1, 3, 4, 2)
        mask = self.mask_out(features).reshape(N, K, 9 * ds * ds, Hc, Wc)

        if isinstance(warp_policy, torch.Tensor):
            assignments = (warp_policy.argmax(dim=1) % K)[:, None]
            low_flow = low_flow[torch.arange(N, device=features.device)[:, None],
                                assignments]
            mask = mask[torch.arange(N, device=features.device)[:, None],
                        assignments]
            split = 1
        elif warp_policy == "cartesian":
            split = K
        else:
            raise NotImplementedError(warp_policy)

        low_flow = low_flow.reshape(N * split, Hc, Wc, 2)
        mask = mask.reshape(N * split, -1, Hc, Wc)
        delta_flow = convex_upsample_flow(low_flow, mask, ds)
        fs = ds * Hc
        ident = identity_grid(1, fs, fs, dtype=delta_flow.dtype,
                              device=delta_flow.device)
        flow = ident + delta_flow
        if base_warp is not None:
            flow = apply_affine(base_warp.reshape(-1, 2, 3), flow)
        if alpha is not None:
            flow = ident + _as_alpha(alpha, flow) * (flow - ident)
        if output_resolution is not None and output_resolution != flow.shape[1]:
            flow = interpolate_bilinear(
                flow.permute(0, 3, 1, 2), output_resolution,
                output_resolution).permute(0, 2, 3, 1)
        out_res = flow.shape[1]
        img_rep = img.repeat_interleave(split, dim=0)
        out = _warp(img_rep, flow, self.antialias, padding_mode)
        oob = check_oob(flow, image_bounds, (out_res, out_res), split) \
            if return_out_of_bounds else None
        return out, flow, delta_flow, oob


# ---------------------------------------------------------------------------
# single SpatialTransformer
# ---------------------------------------------------------------------------

class SpatialTransformer(nn.Module):
    """Encoder + one warping head (spatial_transformer.py:388-615)."""

    def __init__(self, cfg: STNConfig, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        stem_ch, blocks, enc_out_ch, ch4 = cfg.encoder_plan()
        self.convs = nn.Sequential(
            ConvLayer(3, stem_ch, 1, **kw),
            *[ResBlock(ic, oc, downsample=down, **kw)
              for ic, oc, down in blocks])
        self.final_conv = ConvLayer(enc_out_ch, ch4, 3, **kw)
        if cfg.is_flow:
            self.warp_head = FlowHead(enc_out_ch, cfg.num_heads,
                                      cfg.flow_downsample, cfg.antialias, **kw)
        else:
            self.final_linear = EqualLinear(ch4 * 4 * 4, ch4,
                                            activation="fused_lrelu", **kw)
            self.warp_head = SimilarityHead(ch4, cfg.num_heads, cfg.antialias,
                                            device=device)

    def features(self, img):
        """Encoder: downsample to flow_size, conv stack, final head features.
        The conv stack runs in ``cfg.compute_dtype``; its output comes back
        to float32 (or a wider input's dtype) before the final linear and
        the warp head."""
        if img.shape[-1] > self.cfg.flow_size:
            img = bilinear_downsample(img, img.shape[-1] // self.cfg.flow_size)
        img = cast_to(img, dtype_of(self.cfg.compute_dtype))
        out = float32_or_wider(self.final_conv(self.convs(img)))
        if not self.cfg.is_flow:
            out = self.final_linear(out.reshape(out.shape[0], -1))
        return out

    def single_forward(self, input_img, output_resolution=None,
                       base_warp=None, input_img_for_sampling=None,
                       alpha=None, padding_mode="border", image_bounds=None,
                       warp_policy="cartesian", return_out_of_bounds=False):
        """One STN application (spatial_transformer.py:569-615): features
        from ``input_img``, the warp applied to ``input_img_for_sampling``
        (default ``input_img``). Returns [out, grid, flow_or_matrix, oob]."""
        source = input_img if input_img_for_sampling is None \
            else input_img_for_sampling
        out_res = output_resolution if output_resolution is not None \
            else self.cfg.flow_size
        return list(self.warp_head(
            source, self.features(input_img), output_resolution=out_res,
            alpha=alpha, base_warp=base_warp, padding_mode=padding_mode,
            return_out_of_bounds=return_out_of_bounds,
            image_bounds=image_bounds, warp_policy=warp_policy))

    def forward(self, input_img, output_resolution=None, iters=1,
                base_warp=None, input_img_for_sampling=None, alpha=None,
                padding_mode="border", image_bounds=None,
                warp_policy="cartesian", return_out_of_bounds=False):
        """STN forward with the warp-composing recursion over ``iters``
        (spatial_transformer.py:472-567). Returns [out, grid,
        flow_or_matrix, oob]."""
        if iters > 1 and self.cfg.is_flow:
            raise ValueError("the iterated forward is only for similarity STNs")
        out = input_img
        source = input_img if input_img_for_sampling is None \
            else input_img_for_sampling
        M = base_warp
        grid = oob = None
        for it in range(iters):
            last = it == iters - 1
            out, grid, M, oob = self.single_forward(
                out, output_resolution=(output_resolution if last
                                        else self.cfg.flow_size),
                base_warp=M, input_img_for_sampling=source,
                alpha=alpha if last else None,
                padding_mode=padding_mode, image_bounds=image_bounds,
                warp_policy=warp_policy,
                return_out_of_bounds=return_out_of_bounds and last)
        return [out, grid, M, oob]


# ---------------------------------------------------------------------------
# ComposedSTN
# ---------------------------------------------------------------------------

class ComposedSTN(nn.Module):
    """The STNs of ``cfg.transforms`` in a chain, each stage's warp threaded
    into the next as its base warp (spatial_transformer.py:48-139)."""

    def __init__(self, cfg: ComposedSTNConfig, *, device=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        self.stns = nn.ModuleList([
            SpatialTransformer(s, device=device, generator=generator)
            for s in cfg.stn_cfgs])

    def forward(self, input_img, output_resolution=None, iters=1,
                warp_policy="cartesian", alpha=None, padding_mode="border",
                image_bounds=None, return_out_of_bounds=False,
                input_img_for_sampling=None, unfold=False,
                return_intermediates=False):
        """Returns [out, grid, flow_or_matrix, sim_out, oob], as
        gangealing_tpu's composed_stn_forward; ``oob`` is None unless
        ``return_out_of_bounds``. Each stage regresses its warp from the
        previous stage's output and applies the chained warp to
        ``input_img_for_sampling`` (default ``input_img``), as training's
        ``--sample_from_full_res`` does with G's full-resolution image.

        ``unfold``: the last stage's out, grid and warp come back as
        (N, K, ...), one entry a head, for the N input images (the JAX
        heads' ``unfold``, models/stn.py:201-205, :303-306).
        ``return_intermediates``: return instead the list of each stage's
        (out, grid), the last one unfolded with ``unfold``."""
        out = input_img
        source = input_img if input_img_for_sampling is None \
            else input_img_for_sampling
        warp = None
        n_minus_1 = len(self.stns) - 1
        K = self.cfg.num_heads
        cartesian = isinstance(warp_policy, str) and warp_policy == "cartesian"
        sim_out = grid = fom = oob = None
        intermediates = []
        for i, stn in enumerate(self.stns):
            last = i == n_minus_1
            wp_t = warp_policy
            if K > 1 and cartesian and i > 0:
                # after stage 0, each of the N*K streams keeps its own head
                eye = torch.eye(K, dtype=out.dtype, device=out.device)
                wp_t = eye.repeat(out.shape[0] // K, 1)
            out, grid, fom, oob = stn(
                out,
                output_resolution=output_resolution if last
                else self.cfg.flow_size,
                iters=iters if i == 0 else 1,
                base_warp=warp, input_img_for_sampling=source,
                alpha=alpha if last else None, padding_mode=padding_mode,
                image_bounds=image_bounds, warp_policy=wp_t,
                return_out_of_bounds=return_out_of_bounds and last)
            if K > 1 and cartesian and i == 0:
                source = source.repeat_interleave(K, dim=0)
            if unfold and last:
                N = input_img.shape[0]
                out, grid, fom = (t.reshape(N, -1, *t.shape[1:])
                                  for t in (out, grid, fom))
            if i == 0:
                sim_out = out
            warp = fom
            intermediates.append((out, grid))
        if return_intermediates:
            return intermediates
        return [out, grid, fom, sim_out, oob]
