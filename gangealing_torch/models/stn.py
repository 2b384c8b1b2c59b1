"""Spatial Transformer Networks: similarity and flow warping heads, the single
STN and the composed STN, as nn.Modules.

Port of gangealing_tpu/models/stn.py (configs, warping heads,
``stn_forward`` and ``composed_stn_forward``, the point functions of one
STN and of the composed STN, flip inference, 4-way flip matching and AR
object propagation). Parameter names are the
reference's torch names, which are also the JAX package's flat keys, so
``ComposedSTN.load_state_dict`` takes a JAX parameter dict (through
io/from_jax.py) or a reference checkpoint's ``t_ema`` strictly.
"""

import math
from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from gangealing_torch.models.classifier import classifier_run_flip_target
from gangealing_torch.models.layers import (
    ConvLayer, EqualConv2d, EqualLinear, ResBlock, cast_to, dtype_of,
    float32_or_wider)
from gangealing_torch.ops.flow import total_variation_loss
from gangealing_torch.ops.grid_sample import (
    affine_grid, grid_sample_auto, identity_grid)
from gangealing_torch.ops.mipmap import mipmap_warp
from gangealing_torch.ops.resample import (
    bilinear_downsample, interpolate_bilinear)
from gangealing_torch.ops.splat import splat2d_pair_auto
from gangealing_torch.utils.profiling import span


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


@span("stn.sample")
def _warp(img, grid, antialias, padding_mode):
    img, grid = img.contiguous(), grid.contiguous()
    if antialias:
        return mipmap_warp(img, grid, max_num_levels=3.5,
                           padding_mode=padding_mode)
    return grid_sample_auto(img, grid, padding_mode=padding_mode)


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

    @span("stn.features")
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

    @span("stn.composed")
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


# ---------------------------------------------------------------------------
# points
# ---------------------------------------------------------------------------

def normalize_points(points, res, out_res):
    """[0, out_res-1] pixel coords -> [-1, 1] grid coords
    (spatial_transformer.py:617-619)."""
    return (points / (out_res - 1) - 0.5) * 2.0 * ((res - 1) / res)


def unnormalize_points(points, res, out_res):
    """[-1, 1] grid coords -> [0, out_res-1] pixel coords
    (spatial_transformer.py:621-623)."""
    return (points / ((res - 1) / res) / 2.0 + 0.5) * (out_res - 1)


def convert_points(points, current_res, target_res):
    points = normalize_points(points, target_res, current_res)
    return unnormalize_points(points, target_res, target_res)


def _invert_similarity(matrix):
    """(N, 2, 3) -> the inverse 3x3, transposed for right-multiplication."""
    return torch.linalg.inv(make_3x3(matrix)).transpose(1, 2)


def _apply_3x3(points, matrix_t):
    """(N, P, 2) points in homogeneous form times (N, 3, 3), the first two
    columns. Written as products and sums (no matmul, so no TF32)."""
    pts = torch.cat([points, torch.ones_like(points[..., :1])], dim=2)
    out = (pts[:, :, 0:1] * matrix_t[:, None, 0, :2]
           + pts[:, :, 1:2] * matrix_t[:, None, 1, :2])
    return out + pts[:, :, 2:3] * matrix_t[:, None, 2, :2]


def _nearest_texels(grid_full, points):
    """Brute-force inversion of a reverse-sampling grid
    (spatial_transformer.py:656-668): for each of the (N, P, 2) points,
    the (x, y) texel of the (N, H, W, 2) grid whose value lies nearest.

    The distance is |p|^2 + |g|^2 - 2 <g, p> over every texel, as the JAX
    package computes it, in f32 from products and sums: no matmul, so
    TF32 never enters, on the card or off it. That form cancels, so two
    texels whose distances nearly tie may swap with any change of rounding
    (another device, another library); ties go to the first texel in
    row-major order, as jnp.argmin and torch.argmin both take it. The
    product holds N * H * W * P floats (49 MB at N 50, 128 x 128, P 15)."""
    N, H, W, _ = grid_full.shape
    g = grid_full.reshape(N, H * W, 2)
    sims = (g[:, :, 0:1] * points[:, None, :, 0]
            + g[:, :, 1:2] * points[:, None, :, 1])  # (N, HW, P)
    d = ((points ** 2).sum(-1)[:, None, :]
         + (g ** 2).sum(-1)[:, :, None] - 2 * sims)
    nn_idx = d.argmin(dim=1)  # (N, P)
    return torch.stack([nn_idx % W, nn_idx // W], dim=-1).to(points.dtype)


def stn_congeal_points(stn, imgA, pointsA, normalize_input_points=True,
                       unnormalize_output_points=False,
                       output_resolution=None, iters=1,
                       input_img_for_sampling=None, return_full=False,
                       **kwargs):
    """Map points in the images ``imgA`` to the congealed space of one
    SpatialTransformer (spatial_transformer.py:631-672): through the
    inverse similarity, or for a flow head the nearest texel of its
    residual flow plus the identity. ``kwargs`` go to ``stn.forward``."""
    source_res = (imgA.shape[-1] if input_img_for_sampling is None
                  else input_img_for_sampling.shape[-1])
    outA, _, fomA, _ = stn(imgA, output_resolution=output_resolution,
                           iters=iters,
                           input_img_for_sampling=input_img_for_sampling,
                           **kwargs)
    if normalize_input_points:
        pointsA = normalize_points(pointsA, source_res, source_res)
    if not stn.cfg.is_flow:
        congealed = _apply_3x3(pointsA, _invert_similarity(fomA))
        if unnormalize_output_points:
            congealed = unnormalize_points(congealed, source_res, source_res)
    else:
        ident = identity_grid(1, fomA.shape[1], fomA.shape[2],
                              dtype=fomA.dtype, device=fomA.device)
        congealed = _nearest_texels(fomA + ident, pointsA)
    if return_full:
        return outA, fomA, congealed
    return congealed


def stn_uncongeal_points(stn, imgB, points_congealed,
                         unnormalize_output_points=True,
                         normalize_input_points=False, output_resolution=None,
                         iters=1, input_img_for_sampling=None,
                         return_congealed_img=False, **kwargs):
    """Map congealed-space points into the images ``imgB`` through one
    SpatialTransformer (spatial_transformer.py:674-707)."""
    source_res = (imgB.shape[-1] if input_img_for_sampling is None
                  else input_img_for_sampling.shape[-1])
    outB, gridB, fomB, _ = stn(imgB, output_resolution=output_resolution,
                               iters=iters,
                               input_img_for_sampling=input_img_for_sampling,
                               **kwargs)
    if normalize_input_points:
        points_congealed = normalize_points(points_congealed, source_res,
                                            imgB.shape[-1])
    if not stn.cfg.is_flow:
        pointsB = _apply_3x3(points_congealed, make_3x3(fomB).transpose(1, 2))
    else:
        pointsB = sample_grid_at_points(gridB, points_congealed)
    if unnormalize_output_points:
        pointsB = unnormalize_points(pointsB, imgB.shape[-1], source_res)
    if return_congealed_img:
        return pointsB, outB
    return pointsB


def stn_transfer_points(stn, imgA, imgB, pointsA, output_resolution=None,
                        iters=1, **kwargs):
    """Points of ``imgA`` carried into ``imgB`` through one
    SpatialTransformer's congealed space."""
    congealed = stn_congeal_points(stn, imgA, pointsA,
                                   output_resolution=output_resolution,
                                   iters=iters, **kwargs)
    return stn_uncongeal_points(stn, imgB, congealed,
                                normalize_input_points=False,
                                output_resolution=output_resolution,
                                iters=iters, **kwargs)


def sample_grid_at_points(grid, points):
    """Sample an (N, H, W, 2) grid at (N, P, 2) normalized points, bilinear
    with border padding (spatial_transformer.py:704). On the card the
    sample is K2, with the grid as a 2-channel image."""
    g_img = grid.permute(0, 3, 1, 2)  # (N, 2, H, W)
    pts = points[:, :, None, :].float()  # (N, P, 1, 2)
    sampled = grid_sample_auto(g_img, pts, padding_mode="border")
    return sampled[..., 0].permute(0, 2, 1)  # (N, P, 2)


def composed_uncongeal_points(model, imgB, points_congealed,
                              output_resolution=None, iters=1,
                              unnormalize_output_points=True,
                              normalize_input_points=False,
                              return_congealed_img=False, **kwargs):
    """Map congealed-space points into the images ``imgB``
    (spatial_transformer.py:141-157): one composed forward, then the final
    grid sampled at the points. ``kwargs`` go to ``model.forward``."""
    if normalize_input_points:
        points_congealed = normalize_points(points_congealed,
                                            imgB.shape[-1],
                                            model.cfg.flow_size)
    out, gridB, _, _, _ = model(imgB, output_resolution=output_resolution,
                                iters=iters, **kwargs)
    pointsB = sample_grid_at_points(gridB, points_congealed)
    if unnormalize_output_points:
        pointsB = unnormalize_points(pointsB, imgB.shape[-1], imgB.shape[-1])
    if return_congealed_img:
        return pointsB, out
    return pointsB


def composed_congeal_points(model, imgA, pointsA, output_resolution=None,
                            iters=1, normalize_input_points=True,
                            unnormalize_output_points=False,
                            return_full=False, **kwargs):
    """Map points in the images ``imgA`` to the composed STN's congealed
    space, stage by stage (spatial_transformer.py:159-182)."""
    outA, warpA, congealed = imgA, None, pointsA
    n_minus_1 = len(model.stns) - 1
    for i, stn in enumerate(model.stns):
        last = i == n_minus_1
        outA, warpA, congealed = stn_congeal_points(
            stn, outA, congealed,
            normalize_input_points=normalize_input_points if i == 0 else True,
            unnormalize_output_points=(unnormalize_output_points if last
                                       else True),
            iters=iters if i == 0 else 1,
            output_resolution=(output_resolution if last
                               else model.cfg.flow_size),
            base_warp=warpA, input_img_for_sampling=imgA, return_full=True,
            **kwargs)
    if return_full:
        return outA, warpA, congealed
    return congealed


def composed_transfer_points(model, imgA, imgB, pointsA,
                             output_resolution=None, iters=1, **kwargs):
    """Points of ``imgA`` carried into ``imgB`` through the congealed space
    (spatial_transformer.py:184-198): the congealing stages on A, then one
    composed forward on B with its grid sampled at the points (K2)."""
    congealed = composed_congeal_points(
        model, imgA, pointsA, output_resolution=output_resolution,
        iters=iters, normalize_input_points=True, **kwargs)
    return composed_uncongeal_points(
        model, imgB, congealed, output_resolution=output_resolution,
        iters=iters, normalize_input_points=True,
        unnormalize_output_points=True, **kwargs)


def composed_forward_with_flip(model, input_img, return_flow=False,
                               return_warp=False, return_inputs=False,
                               return_flip_indices=False, **kwargs):
    """Run the images and their mirrors as one batch; keep whichever
    residual flow is smoother (spatial_transformer.py:200-240)."""
    both = torch.cat([input_img, input_img.flip(3)], dim=0)
    out, warp, flow, _, _ = model(both, **kwargs)
    N = input_img.shape[0]
    congealed, congealedF = out[:N], out[N:]
    warp_, warpF = warp[:N], warp[N:]
    flow_, flowF = flow[:N], flow[N:]
    tv = total_variation_loss(flow_, reduce_batch=False)
    tvF = total_variation_loss(flowF, reduce_batch=False)
    mirror = (tvF < tv).reshape(N, 1, 1, 1)
    outs = [torch.where(mirror, congealedF, congealed)]
    if return_warp:
        warpF = warpF.clone()
        warpF[..., 0] = warpF[..., 0] * -1.0
        outs.append(torch.where(mirror[..., None] if warpF.ndim == 5
                                else mirror, warpF, warp_))
    if return_flow:
        outs.append(torch.where(mirror, flowF, flow_))
    if return_inputs:
        outs.append(torch.where(mirror, input_img.flip(3), input_img))
    if return_flip_indices:
        outs.append(mirror)
    return outs[0] if len(outs) == 1 else outs


def _mirror_x(points, flip, width):
    """The x coordinates of the rows of ``points`` where ``flip`` (N, 1)
    holds, mirrored in an image ``width`` pixels wide."""
    x = torch.where(flip, width - 1 - points[..., 0], points[..., 0])
    return torch.cat([x[..., None], points[..., 1:]], dim=-1)


def composed_match_flows(model, imgA, imgB, pointsA, pointsB=None,
                         permutation=None, **kwargs):
    """Pairwise 4-way flip matching for PCK-Transfer
    (spatial_transformer.py:242-295): A, B and their mirrors in one
    forward at 4N; each pair takes the orientation whose two residual
    flows are smoothest together (the first of equal sums). Returns the
    oriented images and points and the pick (N, 1, 1, 1): 0 neither
    mirrored, 1 A, 2 B, 3 both.

    ``permutation`` reorders the key points of a mirrored image. It is
    applied to ``pointsA`` once where A is mirrored and once more where B
    is, as the reference and the JAX package do."""
    N = imgA.shape[0]
    imgA_f, imgB_f = imgA.flip(3), imgB.flip(3)
    inputs = torch.cat([imgA, imgB, imgA_f, imgB_f], dim=0)
    _, _, flows, _, _ = model(inputs, **kwargs)
    tvA, tvB, tvAf, tvBf = total_variation_loss(
        flows, reduce_batch=False).split(N)
    pick = torch.stack([tvA + tvB, tvAf + tvB, tvA + tvBf,
                        tvAf + tvBf]).argmin(dim=0)
    pick4 = pick.reshape(N, 1, 1, 1)
    imgA = torch.where(pick4 % 2 == 0, imgA, imgA_f)
    imgB = torch.where(pick4 <= 1, imgB, imgB_f)
    flipA = (pick % 2 != 0).reshape(N, 1)
    pointsA = _mirror_x(pointsA, flipA, imgA.shape[-1])
    if permutation is not None:
        perm = torch.as_tensor(permutation, dtype=torch.long,
                               device=pointsA.device)
        pointsA = torch.where(flipA[:, :, None], pointsA[:, perm], pointsA)
    if pointsB is not None:
        flipB = (pick > 1).reshape(N, 1)
        pointsB = _mirror_x(pointsB, flipB, imgB.shape[-1])
        if permutation is not None:
            pointsA = torch.where(flipB[:, :, None], pointsA[:, perm],
                                  pointsA)
        return imgA, imgB, pointsA, pointsB, pick4
    return imgA, imgB, pointsA, pick4


def composed_propagate_object(model, congealed_object_points,
                              congealed_object_values, congealed_mask_values,
                              target_image, sigma, classifier=None,
                              cluster=None, max_sigma=8.0, **uncongeal_kwargs):
    """Propagate a congealed-space RGBA object onto the target images by
    uncongealing its points and splatting them
    (spatial_transformer.py:297-366). Returns (object image (N, C, H, W),
    mask image (N, 1, H, W)).

    The reference's per-image ragged gathers of the visible points become a
    mask: a point whose rounded position leaves the image moves to -1e6,
    which the splat skips. On the card the object and the mask are one K6
    launch, which walks each point's exact window; ``max_sigma`` bounds
    the plain splat's window.

    A clustering model (num_heads > 1) needs its cluster ``classifier``
    and the object's ``cluster``: every target goes through that cluster's
    head, and where the classifier's flip within the cluster says so, the
    splatted object and mask are mirrored, as the JAX package does.
    """
    N = target_image.shape[0]
    supersize = target_image.shape[-1]
    if target_image.shape[-2] != supersize:
        raise ValueError("square inputs only")
    flip = None
    if model.cfg.num_heads > 1:
        if classifier is None or cluster is None:
            raise ValueError("a clustering model needs its cluster "
                             "classifier and the object's cluster")
        _, flip = classifier_run_flip_target(classifier, target_image,
                                             cluster)
        flip = flip.reshape(N, 1, 1, 1)
        uncongeal_kwargs["warp_policy"] = torch.eye(
            model.cfg.num_heads, dtype=target_image.dtype,
            device=target_image.device)[[cluster] * N]
    propagated = composed_uncongeal_points(
        model, target_image, congealed_object_points,
        normalize_input_points=False, unnormalize_output_points=True,
        **uncongeal_kwargs)  # (N, P, 2)
    rounded = torch.round(propagated)
    visible = ((rounded[..., 0] >= 0) & (rounded[..., 1] >= 0)
               & (rounded[..., 0] < supersize) & (rounded[..., 1] < supersize))
    propagated = torch.where(visible[..., None], propagated,
                             torch.full_like(propagated, -1e6))
    dtype = target_image.dtype
    obj, mask = splat2d_pair_auto(propagated,
                                  congealed_object_values.to(dtype),
                                  congealed_mask_values.to(dtype), sigma,
                                  supersize, supersize, max_sigma=max_sigma)
    if flip is not None:
        obj = torch.where(flip, obj.flip(3), obj)
        mask = torch.where(flip, mask.flip(3), mask)
    return obj, mask
