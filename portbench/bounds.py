"""The yardstick's peaks and its counts of a kernel's bytes and operations.

Frozen copies of ``chip_smoke.py``'s ``bound``, ``pyramid_texel_bytes``
and ``sampler_ops``: the least time of a sampler launch, from its shapes
and the points it samples. The peaks are NVIDIA's
published figures for one H100 SXM at its 700 W limit (dense rates).
"""

import math

import torch

from portbench.reference import grid_sample as grid_sample_ops

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# cuDNN runs the float32 configurations' convolutions in TF32 (torch's
# default); their model FLOPs are held against the TF32 tensor-core peak
TF32_FLOPS_PER_S = 495e12


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved, ops):
    """The least time (ms) the card could take for a function that moves
    ``moved`` bytes between memory and the chip and does ``ops`` float32
    operations, and which of the two bounds it: bytes over the HBM rate or
    operations over the f32 rate."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pyramid_texel_bytes(image_shape, grid, levels, padding_mode="border",
                        dcoords=False):
    """Bytes of a native-resolution Gaussian pyramid of an image of
    ``image_shape`` (N, C, H, W) that a mipmap sample at ``grid`` and
    ``levels`` must read: each full-resolution tap that a point reaches with
    a nonzero weight, on its floor and ceil levels (with ``dcoords`` also on
    the levels next to an integer level, whose tent has a slope there),
    rebuilt from the distinct texels of its native (Hp/2^d, Wp/2^d) level
    that interpolate_bilinear weighs with a nonzero weight (on level 0 the
    tap itself). Hp, Wp: the size reflect-padded to a power of 2, as the
    pyramid stores it. C float32 values each. Border padding clamps the
    taps into the image, reflection padding reflects them into it, zeros
    padding drops those outside it."""
    N, C, H, W = image_shape
    size = 2 ** math.ceil(math.log2(W))
    lp = (size - W) // 2
    D = 4
    # the padding rule of the samplers: clamped (border), reflected into
    # the image and clamped (reflection), or left outside (zeros)
    ix = grid_sample_ops._compute_coords(grid[..., 0], W, padding_mode,
                                         False)
    iy = grid_sample_ops._compute_coords(grid[..., 1], H, padding_mode,
                                         False)
    f = levels.floor()
    ls = [f, levels.ceil()]
    if dcoords:
        # the level tent's kinks: f - 1 and f + 1 at an integer level, and
        # f + 2 where |level - (f + 2)| rounds to 1
        whole = levels == f
        kink = levels - (f + 2) == -1
        ls += [torch.where(whole, levels - 1, f).clamp(min=0),
               torch.where(whole, levels + 1, f).clamp(max=D - 1),
               torch.where(kink, f + 2, f).clamp(max=D - 1)]
    n = torch.arange(N, device=grid.device).view(N, 1, 1)

    def coarse(i, d):
        """The coarse indices a full-resolution index i of level d reads
        with a nonzero weight: r0 always, r1 where its weight is not 0."""
        hc = size // 2 ** d
        src = ((i + lp + 0.5) * 2.0 ** -d - 0.5).clamp(min=0)
        src = torch.minimum(src, hc - 1.0)
        r0 = src.floor()
        r1 = torch.minimum(r0 + 1, hc - 1.0)
        return ((r0, torch.ones_like(r0, dtype=torch.bool)),
                (r1, src > r0))

    keys = []
    for lv in ls:
        d = lv.long()
        for y in (iy.floor(), iy.ceil()):
            for x in (ix.floor(), ix.ceil()):
                inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
                for r, rw in coarse(y.clamp(0, H - 1), d):
                    for c, cw in coarse(x.clamp(0, W - 1), d):
                        key = (((n * D + d) * size + r.long()) * size
                               + c.long())
                        keys.append(key[inside & rw & cw])
    return torch.unique(torch.cat(keys)).numel() * C * 4


# Operations per output point (grid point) of each sampler, counted as
# the multiplies and adds of its taps per channel plus about 20 (40 for a
# backward) for the point's coordinates, weights and padding rule.
def sampler_ops(name, points, C):
    per_channel = {"mipmap_sample": 2 * 4 * 2 + 3, "grid_sample": 4 * 2,
                   "mipmap_sample_dcoords": 2 * 4 * 4,
                   "grid_sample_dgrid": 4 * 4,
                   "mipmap_sample_dpyramid": 2 * 9 * 2,
                   "grid_sample_dimg": 4 * 2}[name]
    per_point = 40 if name.endswith(("dcoords", "dgrid", "dpyramid")) \
        else 20
    return points * (C * per_channel + per_point)
