"""K5a's function, d/dpyramid of the mipmap sample, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package and the
port: an image of 32 or 48 px (48 is reflect-padded to 64, so the crop's
offset lp is 16), an affine grid from a zoom-in by 0.4 to a zoom-out by 6
with rotation (levels in [0, 2.5]), a zoom-in by 4 and a border pile (a
zoom-out by 2), in all three padding modes. d/dimage through
``_build_pyramid`` and ``_sample_pyramid`` (the plain version of K1, whose
autograd is K5a's plain version) is held against ``jax.vjp`` of the JAX
package's ``_mipmap_warp_fold`` and, at 32 px (the banded path pads
nothing), of ``_mipmap_warp_banded`` in interpret mode, whose VJP runs the
Pallas ``_dimg_kernel`` itself. The last tests repeat in torch what the
CUDA kernel does: each point's footprint on the two levels its tent
weighs (level 0's 2 x 2 tap at lp, a coarse level's 3 x 3 window with the
rebuild's weights and its clamped entries folded onto the edge texel),
summed by a fixed-order ``index_add_`` and held against the plain
autograd; and the bin's class rule, under which every footprint reaching
a tile's texels lies in one of that tile's four candidate segments, at
both footprint widths. Tolerance: 1e-5 scaled by max(1, max|ref|),
float32 on both sides, sums in another order.
"""

from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gangealing_torch.ops import grid_sample as tgs
from gangealing_torch.ops import mipmap as tmm

jmm = import_module("gangealing_tpu.ops.mipmap")

PADDINGS = ["border", "reflection", "zeros"]
KINDS = ["affine", "zoom", "pile"]
ATOL = 1e-5
# the bin's tiles (csrc/binned.cuh) and classes: interior, last rows,
# corner, last columns
TILE_W, TILE_H = 16, 4


def _grid(kind, N, out, seed):
    rng = np.random.RandomState(seed)
    if kind == "affine":
        s = np.geomspace(0.4, 6.0, N)
        a = rng.uniform(-np.pi, np.pi, N)
        th = np.stack(
            [np.stack([s * np.cos(a), -s * np.sin(a), 0.2 + 0 * s], 1),
             np.stack([s * np.sin(a), s * np.cos(a), -0.1 + 0 * s], 1)], 1)
    else:
        th = np.zeros((N, 2, 3))
        th[:, 0, 0] = th[:, 1, 1] = {"zoom": 0.25, "pile": 2.0}[kind]
        th[:, :, 2] = rng.uniform(-0.1, 0.1, (N, 2))
    return tgs.affine_grid(torch.from_numpy(th.astype(np.float32)),
                           (N, 1, out, out))


def _inputs(kind, size, seed, N=2, C=3, out=16):
    """Image, grid, its warp levels and a cotangent, as numpy."""
    rng = np.random.RandomState(seed)
    img = rng.randn(N, C, size, size).astype(np.float32)
    grid = _grid(kind, N, out, seed + 1)
    levels = tmm.jmax(tmm.mipmap_levels(grid, size, size, 3.5), 0.0)
    cot = rng.randn(N, C, out, out).astype(np.float32)
    return img, grid.numpy(), levels.numpy(), cot


def _close(ours, ref):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(ours), ref, atol=ATOL * scale,
                               rtol=0)


def _port_dimage(img, grid, levels, cot, padding_mode):
    x = torch.from_numpy(img).requires_grad_()
    out = tmm._sample_pyramid(tmm._build_pyramid(x, 4), torch.from_numpy(grid),
                              torch.from_numpy(levels), padding_mode)
    return torch.autograd.grad(out, x, torch.from_numpy(cot))[0].numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("padding_mode", PADDINGS)
@pytest.mark.parametrize("size", [32, 48])
def test_dimage_matches_jax_vjp(size, padding_mode, kind):
    img, grid, levels, cot = _inputs(kind, size, 1)
    _, vjp = jax.vjp(lambda x: jmm._mipmap_warp_fold(
        x, jnp.asarray(grid), 4, jnp.asarray(levels), padding_mode),
        jnp.asarray(img))
    _close(_port_dimage(img, grid, levels, cot, padding_mode),
           vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_dimage_matches_tpu_kernel_interpret(padding_mode, kind):
    """Against the banded Pallas path's VJP, the _dimg_kernel that K5a
    replaces, in interpret mode."""
    img, grid, levels, cot = _inputs(kind, 32, 2)
    _, vjp = jax.vjp(lambda x: jmm._mipmap_warp_banded(
        x, jnp.asarray(grid), 4, jnp.asarray(levels), padding_mode,
        precision="f32", interpret=True), jnp.asarray(img))
    _close(_port_dimage(img, grid, levels, cot, padding_mode),
           vjp(jnp.asarray(cot))[0])


# ---- the kernel's adjoint, repeated in torch ----

def _taps(grid, H, W, padding_mode):
    """Each point's tap as bilinear.cuh's make_taps forms it: the clamped
    corner rows Y0, Y1 and columns X0, X1, and the four corner weights in
    the order (X0, Y0) (X1, Y0) (X0, Y1) (X1, Y1), zero for a corner
    outside the image under zeros padding."""
    x = tgs._compute_coords(grid[..., 0], W, padding_mode, False)
    y = tgs._compute_coords(grid[..., 1], H, padding_mode, False)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx = (1 - (x - x0), x - x0)
    wy = (1 - (y - y0), y - y0)
    cols = [(x0 + k).clamp(0, W - 1).long() for k in (0, 1)]
    rows = [(y0 + k).clamp(0, H - 1).long() for k in (0, 1)]
    w = []
    for k in range(4):
        a, b = k & 1, k >> 1
        wk = wx[a] * wy[b]
        if padding_mode == "zeros":
            xc, yc = x0 + a, y0 + b
            valid = (xc >= 0) & (xc < W) & (yc >= 0) & (yc < H)
            wk = torch.where(valid, wk, torch.zeros_like(wk))
        w.append(wk)
    return rows, cols, w


def _axis(i, side, scale):
    """interpolate_bilinear's source index r0 of full-resolution index i on
    a level of ``side`` and its lerp weights (mipmap_sample.cu resize_axis)."""
    src = ((i.float() + 0.5) * scale - 0.5).clamp(0, side - 1)
    r0 = src.floor()
    return r0.long(), 1 - (src - r0), src - r0


def _entries(shape, grid, levels, padding_mode):
    """Every (point, level) entry K5a bins: image, point, level d, tent
    weight, footprint origin (ky, kx) on level d, and the 3 x 3 weights
    from there (level 0's tap in its top-left 2 x 2)."""
    N = grid.shape[0]
    rows, cols, w = _taps(grid.reshape(N, -1, 2), shape.height, shape.width,
                          padding_mode)
    lp = shape.lp
    Y0, Y1 = rows[0] + lp, rows[1] + lp
    X0, X1 = cols[0] + lp, cols[1] + lp
    lv = levels.reshape(N, -1)
    f = lv.floor().clamp(0, shape.num_levels - 2)
    tents = ((1 - (lv - f).abs()).clamp(min=0),
             (1 - (lv - (f + 1)).abs()).clamp(min=0))
    reaches = sum(wk != 0 for wk in w) > 0
    out = []
    for d in range(shape.num_levels):
        W9 = torch.zeros(*lv.shape, 3, 3)
        if d == 0:
            cx, cy = X1 != X0, Y1 != Y0
            for k in range(4):
                a = torch.where(cy & bool(k >> 1), 1, 0)
                b = torch.where(cx & bool(k & 1), 1, 0)
                W9 += torch.nn.functional.one_hot(a * 3 + b, 9).reshape(
                    *lv.shape, 3, 3) * w[k][..., None, None]
            ky, kx = Y0, X0
        else:
            side = shape.size >> d
            scale = side / shape.size
            y0, y1 = _axis(Y0, side, scale), _axis(Y1, side, scale)
            x0, x1 = _axis(X0, side, scale), _axis(X1, side, scale)
            ky, kx = y0[0], x0[0]
            sy, sx = y1[0] - ky, x1[0] - kx  # 0 or 1
            z = torch.zeros_like(y0[1])
            ry0 = (y0[1], y0[2], z)
            ry1 = [torch.where(sy == 1, a, b) for a, b in
                   zip((z, y1[1], y1[2]), (y1[1], y1[2], z))]
            rx0 = (x0[1], x0[2], z)
            rx1 = [torch.where(sx == 1, a, b) for a, b in
                   zip((z, x1[1], x1[2]), (x1[1], x1[2], z))]
            last_y, last_x = side - 1 - ky, side - 1 - kx
            for a in range(3):
                for b in range(3):
                    A = (ry0[a] * (w[0] * rx0[b] + w[1] * rx1[b])
                         + ry1[a] * (w[2] * rx0[b] + w[3] * rx1[b]))
                    fa = torch.minimum(torch.tensor(a), last_y)
                    fb = torch.minimum(torch.tensor(b), last_x)
                    W9 += torch.nn.functional.one_hot(fa * 3 + fb, 9).reshape(
                        *lv.shape, 3, 3) * A[..., None, None]
        for e, tent in enumerate(tents):
            on = reaches & (f + e == d) & (tent != 0)
            n, p = torch.nonzero(on, as_tuple=True)
            out.append((n, p, d, tent[n, p], ky[n, p], kx[n, p],
                        W9[n, p] * tent[n, p, None, None]))
    return out


def _footprint_adjoint(shape, grid, levels, cot, padding_mode):
    """d/dlevel0 and d/dcoarse summed entry by entry with index_add_."""
    N, C = grid.shape[0], shape.channels
    S, t = shape.size, shape.texel()
    dlevel0 = torch.zeros(N * C * S * S)
    per_image = tmm._coarse_floats(shape)
    dcoarse = torch.zeros(N * per_image)
    off = np.cumsum([0] + [t * s * s for s in shape.sides()[1:]])
    g = cot.reshape(N, C, -1)
    for n, p, d, _, ky, kx, W9 in _entries(shape, grid, levels, padding_mode):
        side = S >> d
        for a in range(3):
            for b in range(3):
                wt = W9[:, a, b]
                r = (ky + a).clamp(max=side - 1)
                c = (kx + b).clamp(max=side - 1)
                for ch in range(C):
                    v = g[n, ch, p] * wt
                    if d == 0:
                        idx = ((n * C + ch) * S + r) * S + c
                        dlevel0.index_add_(0, idx, v)
                    else:
                        idx = (n * per_image + off[d - 1]
                               + (r * side + c) * t + ch)
                        dcoarse.index_add_(0, idx, v)
    return dlevel0.reshape(N, C, S, S), dcoarse.reshape(N, per_image)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("padding_mode", PADDINGS)
@pytest.mark.parametrize("size", [32, 48])
def test_footprint_adjoint_matches_autograd(size, padding_mode, kind):
    """The kernel's per-point footprints, summed in a fixed order, give
    the plain autograd's d/dlevel0 and d/dcoarse (padding channels 0)."""
    _, grid, levels, cot = _inputs(kind, size, 3)
    grid, levels, cot = map(torch.from_numpy, (grid, levels, cot))
    shape = tmm._build_pyramid(torch.zeros(1, 3, size, size), 4).shape
    N = grid.shape[0]
    level0 = torch.zeros(N, 3, shape.size, shape.size, requires_grad=True)
    coarse = torch.zeros(N, tmm._coarse_floats(shape), requires_grad=True)
    ref = torch.autograd.grad(
        tmm._sample_pyramid(tmm.Pyramid(level0, coarse, shape), grid, levels,
                            padding_mode), (level0, coarse), cot)
    ours = _footprint_adjoint(shape, grid, levels, cot, padding_mode)
    for o, r in zip(ours, ref):
        _close(o.numpy(), r.numpy())
    if size == 48:  # taps land at lp: the padding border gets nothing
        lp = shape.lp
        inner = torch.zeros_like(ref[0], dtype=torch.bool)
        inner[..., lp:lp + size, lp:lp + size] = True
        assert bool((ours[0][~inner] == 0).all())


def _tile_class(ky, kx, width):
    """tile_key of csrc/binned.cuh: the origin's tile, and its class."""
    row = ky % TILE_H > TILE_H - width
    col = kx % TILE_W > TILE_W - width
    cls = torch.where(col, torch.where(row, 2, 3), torch.where(row, 1, 0))
    return ky // TILE_H, kx // TILE_W, cls


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", [32, 48])
def test_bin_classes_cover_every_footprint(size, kind):
    """Each entry's key (its origin's tile and class) puts it in the
    candidate segments of every tile whose texels it reaches with a
    nonzero weight: its own tile (any class), the tile to its right
    (classes 2-3), below (1-2) and diagonal (2); at footprint width 2 on
    level 0 and 3 on the coarse levels."""
    _, grid, levels, _ = _inputs(kind, size, 4, out=24)
    grid, levels = torch.from_numpy(grid), torch.from_numpy(levels)
    shape = tmm._build_pyramid(torch.zeros(1, 3, size, size), 4).shape
    widths = set()
    for padding_mode in PADDINGS:
        for _, _, d, _, ky, kx, W9 in _entries(shape, grid, levels,
                                               padding_mode):
            width = 2 if d == 0 else 3
            widths.add(width)
            assert bool((W9[:, width:, :] == 0).all())
            assert bool((W9[:, :, width:] == 0).all())
            ty, tx, cls = _tile_class(ky, kx, width)
            for a in range(3):
                for b in range(3):
                    hit = W9[:, a, b] != 0
                    dy = (ky + a) // TILE_H - ty
                    dx = (kx + b) // TILE_W - tx
                    own = (dy == 0) & (dx == 0)
                    right = (dy == 0) & (dx == 1) & ((cls == 2) | (cls == 3))
                    below = (dy == 1) & (dx == 0) & ((cls == 1) | (cls == 2))
                    diag = (dy == 1) & (dx == 1) & (cls == 2)
                    assert bool((~hit | own | right | below | diag).all())
    assert widths == {2, 3}
