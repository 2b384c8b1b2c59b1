"""The port's plain PyTorch ops against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in gangealing_torch. The JAX side runs its CPU path. Tolerance:
atol 1e-5 (float32 on both sides; the ops differ only in summation order).
"""

from importlib import import_module

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gangealing_torch.ops import flow as tflow
from gangealing_torch.ops import grid_sample as tgs
from gangealing_torch.ops import mipmap as tmm
from gangealing_torch.ops import resample as trs

# gangealing_tpu.ops re-exports functions under its module names
jflow = import_module("gangealing_tpu.ops.flow")
jgs = import_module("gangealing_tpu.ops.grid_sample")
jmm = import_module("gangealing_tpu.ops.mipmap")
jrs = import_module("gangealing_tpu.ops.resample")

ATOL = 1e-5


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _theta(rng, N):
    """Affine matrices from a zoom-in by 0.3 to a zoom-out by 7, with random
    rotations and shifts, so that the grids reach outside [-1, 1] and, at
    half the source resolution, the mipmap levels span [0, 2.5]."""
    ang = rng.uniform(-np.pi, np.pi, N)
    s = np.geomspace(0.3, 7.0, N)
    t = rng.uniform(-0.3, 0.3, (N, 2))
    th = np.stack([np.stack([s * np.cos(ang), -s * np.sin(ang), t[:, 0]], 1),
                   np.stack([s * np.sin(ang), s * np.cos(ang), t[:, 1]], 1)], 1)
    return th.astype(np.float32)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["border", "reflection", "zeros"])
def test_grid_sample(rng, mode, align_corners, padding_mode):
    x = _randn(rng, 2, 3, 20, 24)
    g = (rng.rand(2, 9, 11, 2).astype(np.float32) * 2 - 1) * 1.6
    ref = jgs.grid_sample(jnp.asarray(x), jnp.asarray(g), mode=mode,
                          padding_mode=padding_mode,
                          align_corners=align_corners)
    out = tgs.grid_sample(torch.from_numpy(x), torch.from_numpy(g), mode=mode,
                          padding_mode=padding_mode,
                          align_corners=align_corners)
    _close(out, ref)


@pytest.mark.parametrize("align_corners", [False, True])
def test_affine_and_identity_grid(rng, align_corners):
    th = _theta(rng, 3)
    ref = jgs.affine_grid(jnp.asarray(th), (3, 1, 7, 9), align_corners)
    _close(tgs.affine_grid(torch.from_numpy(th), (3, 1, 7, 9), align_corners),
           ref)
    ref = jgs.identity_grid(2, 5, 6, align_corners=align_corners)
    _close(tgs.identity_grid(2, 5, 6, align_corners=align_corners), ref)


# (pad, down): the ConvLayer blur before a 3x3 stride-2 conv, the ResBlock
# skip blur before its 1x1 stride-2 conv, and the JAX package's fold of that
# skip stride into the FIR.
@pytest.mark.parametrize("pad,down", [((2, 2), 1), ((1, 1), 1), ((1, 1), 2)])
def test_upfirdn2d_and_blur(rng, pad, down):
    x = _randn(rng, 2, 3, 16, 16)
    k = (1, 3, 3, 1)
    ref = jrs.upfirdn2d(jnp.asarray(x), jrs.make_kernel(k), down=down, pad=pad)
    out = trs.upfirdn2d(torch.from_numpy(x), trs.fir(k), down=down, pad=pad)
    _close(out, ref)
    if down == 1:
        _close(trs.blur(torch.from_numpy(x), k, pad),
               jrs.blur(jnp.asarray(x), k, pad))


@pytest.mark.parametrize("stride", [2, 4])
def test_bilinear_downsample(rng, stride):
    x = _randn(rng, 2, 3, 32, 32)
    _close(trs.bilinear_downsample(torch.from_numpy(x), stride),
           jrs.bilinear_downsample(jnp.asarray(x), stride))


@pytest.mark.parametrize("out_hw", [(24, 40), (7, 5), (16, 16)])
def test_interpolate_bilinear(rng, out_hw):
    x = _randn(rng, 2, 3, 16, 12)
    _close(trs.interpolate_bilinear(torch.from_numpy(x), *out_hw),
           jrs.interpolate_bilinear(jnp.asarray(x), *out_hw))


@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_leaky_relu(rng, with_bias):
    x = _randn(rng, 2, 5, 4, 4)
    b = _randn(rng, 5) if with_bias else None
    _close(trs.fused_leaky_relu(torch.from_numpy(x),
                                None if b is None else torch.from_numpy(b)),
           jrs.fused_leaky_relu(jnp.asarray(x),
                                None if b is None else jnp.asarray(b)))


def test_mipmap_levels(rng):
    g = np.array(jgs.affine_grid(jnp.asarray(_theta(rng, 3)), (3, 1, 32, 32)))
    ref = jmm.mipmap_levels(jnp.asarray(g), 64, 64, 3.5)
    out = tmm.mipmap_levels(torch.from_numpy(g), 64, 64, 3.5)
    _close(out, ref)
    assert float(out.min()) == 0.0 and float(out.max()) == 2.5


@pytest.mark.parametrize("size", [32, 48])
def test_build_stack(rng, size):
    """48 is not a power of 2: the stack is built on a reflect-padded 64."""
    x = _randn(rng, 2, 3, size, size)
    ref = jmm._build_stack(jnp.asarray(x), 4)
    out = tmm._build_stack(torch.from_numpy(x), 4)
    assert len(out) == len(ref) == 4
    for o, r in zip(out, ref):
        assert o.shape == (2, 3, size, size)
        _close(o, r)


@pytest.mark.parametrize("padding_mode", ["border", "reflection", "zeros"])
def test_mipmap_warp(rng, padding_mode):
    x = _randn(rng, 2, 3, 32, 32)
    g = np.array(jgs.affine_grid(jnp.asarray(_theta(rng, 2)), (2, 3, 16, 16)))
    ref = jmm.mipmap_warp(jnp.asarray(x), jnp.asarray(g),
                          padding_mode=padding_mode, force_path="fold")
    out = tmm.mipmap_warp(torch.from_numpy(x), torch.from_numpy(g),
                          padding_mode=padding_mode)
    _close(out, ref)


@pytest.mark.parametrize("reduce_batch", [False, True])
def test_total_variation_loss(rng, reduce_batch):
    f = _randn(rng, 3, 8, 8, 2)
    _close(tflow.total_variation_loss(torch.from_numpy(f), reduce_batch),
           jflow.total_variation_loss(jnp.asarray(f), reduce_batch))
