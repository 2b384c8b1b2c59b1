"""Gradients of the port's plain samplers against ``jax.grad`` of the JAX
package's, on the CPU.

The JAX grid sample runs its gather path and the JAX mipmap warp its fold
path, as the JAX package's own CPU tests run them. Each case takes the
vector-Jacobian product with the same seeded cotangent on both sides and
compares d/dgrid, d/dlevels and d/dimage at atol 1e-5 scaled by
max(1, max|ref|) (float32 on both sides; only the order of the sums
differs).

The cases put points where the two frameworks' tie rules used to part: an
identity grid (every point on an integer coordinate, the first row and
column on the border clamp, as the first GANgealing step samples), integer
levels (the level tent's kinks; levels 0 and 1 are the common case, since
every magnified pixel sits at level 0), a grid whose neighbours are exactly
one source pixel apart (the level floor), and a perturbed grid.
"""

from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gangealing_torch.ops import grid_sample as tgs
from gangealing_torch.ops import mipmap as tmm

jgs = import_module("gangealing_tpu.ops.grid_sample")
jmm = import_module("gangealing_tpu.ops.mipmap")

PADDINGS = ["border", "reflection", "zeros"]
ATOL = 1e-5


def _close(ours, ref):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.detach().numpy(), ref, atol=ATOL * scale,
                               rtol=0)


def _grid(kind, N, out, H, rng):
    """identity: the identity grid at ``out`` points per side; perturbed:
    the same plus 0.01 noise; unit: points exactly one source pixel apart in
    the level metric, (H - 1) * (g + 1) / 2, spanning the whole image."""
    if kind == "unit":
        g = -1.0 + np.arange(out, dtype=np.float32) * (2.0 / (H - 1))
        gy, gx = np.meshgrid(g, g, indexing="ij")
        return np.broadcast_to(np.stack([gx, gy], -1),
                               (N, out, out, 2)).astype(np.float32).copy()
    grid = tgs.identity_grid(N, out, out).numpy()
    if kind == "perturbed":
        grid = grid + 0.01 * rng.randn(*grid.shape).astype(np.float32)
    return grid


def _vjp_torch(fn, cot, *args):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return [t.grad for t in ts]


def _vjp_jax(fn, cot, *args):
    _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return vjp(jnp.asarray(cot))


@pytest.mark.parametrize("padding_mode", PADDINGS)
@pytest.mark.parametrize("kind", ["identity", "perturbed"])
def test_grid_sample_grads(kind, padding_mode):
    rng = np.random.RandomState(0)
    img = rng.randn(2, 3, 32, 32).astype(np.float32)
    grid = _grid(kind, 2, 32, 32, rng)
    cot = rng.randn(2, 3, 32, 32).astype(np.float32)
    ref = _vjp_jax(lambda x, g: jgs.grid_sample(x, g, padding_mode=padding_mode),
                   cot, img, grid)
    ours = _vjp_torch(lambda x, g: tgs.grid_sample(
        x, g, padding_mode=padding_mode), cot, img, grid)
    for o, r in zip(ours, ref):
        _close(o, r)
    if kind == "identity" and padding_mode != "zeros":
        # the first row and column sit on the clamp: JAX passes half there
        assert float(np.abs(np.asarray(ref[1])[:, 0, :, 0]).max()) > 0


@pytest.mark.parametrize("padding_mode", PADDINGS)
@pytest.mark.parametrize("kind", ["identity", "perturbed"])
@pytest.mark.parametrize("level_kind", ["integer", "fractional"])
def test_mipmap_fold_grads(level_kind, kind, padding_mode):
    """d/dimage, d/dgrid and d/dlevels of the fold warp at given levels:
    integer levels in {0, 1, 2} or fractional ones in [0, 2.5]."""
    rng = np.random.RandomState(1)
    img = rng.randn(2, 3, 32, 32).astype(np.float32)
    grid = _grid(kind, 2, 16, 32, rng)
    if level_kind == "integer":
        levels = rng.randint(0, 3, (2, 16, 16)).astype(np.float32)
    else:
        levels = rng.uniform(0, 2.5, (2, 16, 16)).astype(np.float32)
    cot = rng.randn(2, 3, 16, 16).astype(np.float32)
    ref = _vjp_jax(lambda x, g, lv: jmm._mipmap_warp_fold(
        x, g, 4, lv, padding_mode), cot, img, grid, levels)
    ours = _vjp_torch(lambda x, g, lv: tmm._mipmap_warp_fold(
        x, g, 4, lv, padding_mode), cot, img, grid, levels)
    for o, r in zip(ours, ref):
        _close(o, r)


@pytest.mark.parametrize("padding_mode", PADDINGS)
@pytest.mark.parametrize("kind,size,out", [
    ("identity", 32, 32), ("identity", 32, 16), ("perturbed", 32, 16),
    ("unit", 33, 20)])
def test_mipmap_warp_grads(kind, size, out, padding_mode):
    """The whole warp, levels computed from the grid: identity at the same
    size (level 0 through the clamp of the neighbour distance) and at half
    size, a perturbed grid, and unit spacing on a 33px source (distance
    exactly 1, level exactly 0: the ties of the distance floor, the level
    clip and the warp's min_level)."""
    rng = np.random.RandomState(2)
    img = rng.randn(2, 3, size, size).astype(np.float32)
    grid = _grid(kind, 2, out, size, rng)
    cot = rng.randn(2, 3, out, out).astype(np.float32)
    ref = _vjp_jax(lambda x, g: jmm.mipmap_warp(
        x, g, padding_mode=padding_mode, force_path="fold"), cot, img, grid)
    ours = _vjp_torch(lambda x, g: tmm.mipmap_warp(
        x, g, padding_mode=padding_mode), cot, img, grid)
    for o, r in zip(ours, ref):
        _close(o, r)
