"""The native-resolution Gaussian pyramid that K1 and K3 sample, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package and the
port. ``_build_pyramid`` is held against the JAX package's
``_gaussian_blur_2x`` chain; ``_sample_pyramid``, the plain version of K1
and K3, against its ``_mipmap_warp_fold`` in all three padding modes at a
power-of-2 size and at 48 (reflect-padded to 64), and against the banded
Pallas kernel in interpret mode (atol 1e-5, float32 on both sides). The
gradients through the pyramid path are held against ``jax.grad`` of the
fold path at the ties where a GANgealing run starts, to the tolerance of
``tests/test_torch_sampler_grads.py``. The last tests repeat in torch the
kernels' rebuild of a full-resolution tap from a 3x3 window of a coarse
level, and hold it bit for bit against ``interpolate_bilinear``'s stack,
and K1's single 3x3 filter per level against the tap over the rebuilt
corners.
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
ATOL = 1e-5


def _inputs(seed, size, N=2, C=3, out=16):
    """An image and an affine grid from a zoom-in by 0.4 to a zoom-out by
    6 with rotation and shift, reaching outside the image, with its levels
    (which span [0, 2.5])."""
    rng = np.random.RandomState(seed)
    img = rng.randn(N, C, size, size).astype(np.float32)
    s = np.geomspace(0.4, 6.0, N)
    a = rng.uniform(-np.pi, np.pi, N)
    th = np.stack([np.stack([s * np.cos(a), -s * np.sin(a), 0.2 + 0 * s], 1),
                   np.stack([s * np.sin(a), s * np.cos(a), -0.1 + 0 * s], 1)],
                  1).astype(np.float32)
    grid = tgs.affine_grid(torch.from_numpy(th), (N, C, out, out))
    levels = tmm.jmax(tmm.mipmap_levels(grid, size, size, 3.5), 0.0)
    return img, grid.numpy(), levels.numpy()


def _sample(img, grid, levels, padding_mode):
    return tmm._sample_pyramid(tmm._build_pyramid(img, 4), grid, levels,
                               padding_mode)


@pytest.mark.parametrize("size", [32, 48])
def test_build_pyramid_matches_jax_blur_chain(size):
    img, _, _ = _inputs(0, size)
    pyramid = tmm._build_pyramid(torch.from_numpy(img), 4)
    shape = pyramid.shape
    lp = shape.lp
    rp = shape.size - size - lp
    assert (shape.size, shape.num_levels) == (64 if size == 48 else 32, 4)
    assert tuple(pyramid.coarse.shape) == (
        2, 4 * sum((shape.size >> d) ** 2 for d in range(1, 4)))
    ref = jnp.pad(jnp.asarray(img), ((0, 0), (0, 0), (lp, rp), (lp, rp)),
                  mode="reflect")
    for d, level in enumerate(tmm._pyramid_levels(pyramid)):
        if d:
            ref = jmm._gaussian_blur_2x(ref)
        assert tuple(level.shape) == (2, 3, shape.size >> d, shape.size >> d)
        np.testing.assert_allclose(level.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("padding_mode", PADDINGS)
@pytest.mark.parametrize("size", [32, 48])
def test_sample_pyramid_matches_jax_fold(size, padding_mode):
    img, grid, levels = _inputs(1, size)
    ref = jmm._mipmap_warp_fold(jnp.asarray(img), jnp.asarray(grid), 4,
                                jnp.asarray(levels), padding_mode)
    out = _sample(torch.from_numpy(img), torch.from_numpy(grid),
                  torch.from_numpy(levels), padding_mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_sample_pyramid_matches_tpu_kernel_interpret(padding_mode):
    """``_sample_pyramid`` == the banded Pallas kernel (K1) in interpret
    mode."""
    img, grid, levels = _inputs(2, 32)
    ref = jmm._mipmap_warp_banded(jnp.asarray(img), jnp.asarray(grid), 4,
                                  jnp.asarray(levels), padding_mode,
                                  precision="f32", interpret=True)
    out = _sample(torch.from_numpy(img), torch.from_numpy(grid),
                  torch.from_numpy(levels), padding_mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def _close_scaled(ours, ref):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.detach().numpy(), ref, atol=ATOL * scale,
                               rtol=0)


@pytest.mark.parametrize("padding_mode", PADDINGS)
@pytest.mark.parametrize("out,level_kind", [(32, "integer"), (16, "warp")])
def test_pyramid_grads_match_jax_fold_at_identity(out, level_kind,
                                                  padding_mode):
    """d/dimage, d/dgrid and d/dlevels through ``_build_pyramid`` and
    ``_sample_pyramid`` against ``jax.grad`` of the fold path, on an
    identity grid (every point on an integer coordinate, the first row and
    column on the border clamp): at the source's size with integer levels
    in {0, 1, 2} (the level tent's kinks), and at half size with the warp's
    own levels (about 0.95: levels 0 and 1 both weigh)."""
    rng = np.random.RandomState(3)
    img = rng.randn(2, 3, 32, 32).astype(np.float32)
    grid = tgs.identity_grid(2, out, out).numpy()
    if level_kind == "integer":
        levels = rng.randint(0, 3, (2, out, out)).astype(np.float32)
    else:
        levels = tmm.jmax(tmm.mipmap_levels(torch.from_numpy(grid), 32, 32,
                                            3.5), 0.0).numpy()
    cot = rng.randn(2, 3, out, out).astype(np.float32)
    _, vjp = jax.vjp(lambda x, g, lv: jmm._mipmap_warp_fold(
        x, g, 4, lv, padding_mode), *map(jnp.asarray, (img, grid, levels)))
    ref = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_() for a in (img, grid, levels)]
    _sample(*ts, padding_mode).backward(torch.from_numpy(cot))
    for t, r in zip(ts, ref):
        _close_scaled(t.grad, r)


def _axis(i, side, scale):
    """interpolate_bilinear's source rows of full-resolution index i on a
    level of ``side``: r0, r1 and their weights."""
    src = ((i.float() + 0.5) * scale - 0.5).clamp(0, side - 1)
    f = src.floor()
    r0 = f.long()
    return r0, (r0 + 1).clamp(max=side - 1), 1 - (src - f), src - f


@pytest.mark.parametrize("size", [32, 48])
def test_window_rebuild_and_tap_filter(size):
    """The kernels' window (csrc/mipmap_sample.cu): for a tap's corner rows
    Y0, Y1 = min(Y0 + 1, H - 1) and columns likewise, the 3x3 window from
    r0(Y0), r0(X0) of each coarse level, rows first, then columns, gives
    every corner of ``_rebuild_stack`` bit for bit (K3's rebuild_corners);
    the second row's and column's r0 lie 0 or 1 past the first's. One 3x3
    filter per level gives the tap over those corners (K1's tap_filter)."""
    img, _, _ = _inputs(4, size)
    pyramid = tmm._build_pyramid(torch.from_numpy(img), 4)
    shape = pyramid.shape
    stack = tmm._rebuild_stack(pyramid)
    i0 = torch.arange(size)
    i1 = (i0 + 1).clamp(max=size - 1)
    for d, level in enumerate(tmm._pyramid_levels(pyramid)):
        if d == 0:
            continue
        side, scale = level.shape[-1], level.shape[-1] / shape.size
        ya, yb = (_axis(i + shape.lp, side, scale) for i in (i0, i1))
        ky, kx = (yb[0] - ya[0])[:, None], (yb[0] - ya[0])[None, :]
        assert set(ky.unique().tolist()) <= {0, 1}
        rows = [(ya[0] + k).clamp(max=side - 1)[:, None] for k in range(3)]
        cols = [(ya[0] + k).clamp(max=side - 1)[None, :] for k in range(3)]
        win = [[level[:, :, r, c] for c in cols] for r in rows]
        wy = [w[:, None] for w in ya[2:]] + [w[:, None] for w in yb[2:]]
        wx = [w[None, :] for w in ya[2:]] + [w[None, :] for w in yb[2:]]
        ra = [win[0][j] * wy[0] + win[1][j] * wy[1] for j in range(3)]
        rb = [torch.where(ky == 1, win[1][j], win[0][j]) * wy[2]
              + torch.where(ky == 1, win[2][j], win[1][j]) * wy[3]
              for j in range(3)]

        def cols_of(r, second):
            if not second:
                return r[0] * wx[0] + r[1] * wx[1]
            return (torch.where(kx == 1, r[1], r[0]) * wx[2]
                    + torch.where(kx == 1, r[2], r[1]) * wx[3])

        corners = {(i0, i0): cols_of(ra, False), (i0, i1): cols_of(ra, True),
                   (i1, i0): cols_of(rb, False), (i1, i1): cols_of(rb, True)}
        for (ys, xs), got in corners.items():
            assert torch.equal(got, stack[:, d][:, :, ys[:, None],
                                                xs[None, :]])
        # K1's single 3x3 filter (tap_filter): the tap of weights w over the
        # four corners, within float32 rounding of the corners' own tap
        w = np.random.RandomState(d).rand(4, size, size).astype(np.float32)
        w = torch.from_numpy(w / w.sum(0))
        ref = sum(wk * c for wk, c in zip(w, corners.values()))
        zy, zx = torch.zeros_like(wy[0]), torch.zeros_like(wx[0])
        ry0, rx0 = (wy[0], wy[1], zy), (wx[0], wx[1], zx)
        ry1 = [torch.where(ky == 1, a, b)
               for a, b in zip((zy, wy[2], wy[3]), (wy[2], wy[3], zy))]
        rx1 = [torch.where(kx == 1, a, b)
               for a, b in zip((zx, wx[2], wx[3]), (wx[2], wx[3], zx))]
        filt = sum((ry0[a] * (w[0] * rx0[b] + w[1] * rx1[b])
                    + ry1[a] * (w[2] * rx0[b] + w[3] * rx1[b])) * win[a][b]
                   for a in range(3) for b in range(3))
        np.testing.assert_allclose(filt.numpy(), ref.numpy(), atol=1e-6,
                                   rtol=0)
