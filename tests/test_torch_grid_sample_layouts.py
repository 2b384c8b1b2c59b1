"""K2's layouts and K5b's deterministic d/dimage.

On the CPU: ``grid_sample_auto`` on a channels_last input and
``sample_grid_at_points`` (whose permuted grid is such an input) give the
same bits as the contiguous formulation they replace, and launch nothing;
the plain d/dimage (autograd of ``grid_sample``) matches ``jax.vjp`` of the
JAX package's ``grid_sample`` and of the Pallas ``_dimg_kernel`` in
interpret mode (``grid_sample_mxu``, f32) on skewed grids: a zoom-in that
puts every point in a sixteenth of the image and a border pile that clamps
three quarters of them onto the edge texels, in the three padding modes,
with H != W and with an image narrower than K5b's 16 x 4 tile. Tolerance
1e-5 scaled by max(1, max|ref|): float32 on both sides, sums in another
order.

On the card (marker ``cuda``): K2 on NCHW and channels_last input, 1 to 4
channels, within 1e-5 of plain; K4 and K5b behind a channels_last input
that needs both gradients; K5b within 1e-5 scaled of the plain autograd on
identity, affine, zoom-in and border-pile grids, the zoom-in's tiles
split over many work items, three launches equal to the bit, every texel
that no point reaches exactly 0 in memory that held NaN, one count a call:

    python -m pytest -p no:cacheprovider -m cuda \
        tests/test_torch_grid_sample_layouts.py
"""

from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gangealing_torch import LAUNCHES
from gangealing_torch.models import stn as tstn
from gangealing_torch.ops import grid_sample as tgs

jgs = import_module("gangealing_tpu.ops.grid_sample")
jpgs = import_module("gangealing_tpu.ops.pallas_grid_sample")

PADDINGS = ["border", "reflection", "zeros"]
ATOL = 1e-5
# (N, C, H, W) of the image and (Ho, Wo) of the grid: H != W, and an image
# narrower than one tile
SHAPES = {"h_ne_w": ((2, 3, 20, 36), (12, 10)),
          "under_a_tile": ((2, 3, 9, 7), (8, 8))}


def _skewed_grid(kind, N, Ho, Wo, seed):
    """zoom: scale 0.25 and a small shift, so every point falls into a
    sixteenth of the image; pile: scale 2, so three quarters of the points
    leave the image (border padding clamps them onto the edge texels)."""
    rng = np.random.RandomState(seed)
    s = {"zoom": 0.25, "pile": 2.0}[kind]
    t = rng.uniform(-0.1, 0.1, (N, 2))
    th = np.zeros((N, 2, 3), np.float32)
    th[:, 0, 0] = th[:, 1, 1] = s
    th[:, :, 2] = t
    return tgs.affine_grid(torch.from_numpy(th), (N, 1, Ho, Wo)).numpy()


def _close(ours, ref):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(ours), ref, atol=ATOL * scale,
                               rtol=0)


def _plain_dimage(img_shape, grid, cot, padding_mode):
    x = torch.zeros(img_shape, requires_grad=True)
    out = tgs.grid_sample(x, torch.from_numpy(grid),
                          padding_mode=padding_mode)
    return torch.autograd.grad(out, x, torch.from_numpy(cot))[0].numpy()


def _case(shape, kind, seed):
    (N, C, H, W), (Ho, Wo) = SHAPES[shape]
    grid = _skewed_grid(kind, N, Ho, Wo, seed)
    cot = np.random.RandomState(seed + 1).randn(N, C, Ho, Wo).astype(
        np.float32)
    img = np.random.RandomState(seed + 2).randn(N, C, H, W).astype(np.float32)
    return img, grid, cot


@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_auto_takes_channels_last_cpu_input_as_before(padding_mode):
    """A channels_last CPU input gives the bits of its contiguous copy
    through the plain version, and launches nothing."""
    img, grid, _ = _case("h_ne_w", "zoom", 0)
    x = torch.from_numpy(img).to(memory_format=torch.channels_last)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert not x.is_contiguous()
    before = dict(LAUNCHES)
    out = tgs.grid_sample_auto(x, torch.from_numpy(grid),
                               padding_mode=padding_mode)
    ref = tgs.grid_sample(x.contiguous(), torch.from_numpy(grid),
                          padding_mode=padding_mode)
    assert torch.equal(out, ref)
    assert LAUNCHES == before


def test_sample_grid_at_points_as_before():
    """sample_grid_at_points hands the permuted grid on as it lies and
    gives the bits of sampling its contiguous copy."""
    rng = np.random.RandomState(3)
    grid = torch.from_numpy(rng.uniform(-1, 1, (3, 16, 12, 2)).astype(
        np.float32))
    points = torch.from_numpy(rng.uniform(-1.1, 1.1, (3, 37, 2)).astype(
        np.float32))
    out = tstn.sample_grid_at_points(grid, points)
    ref = tgs.grid_sample(grid.permute(0, 3, 1, 2).contiguous(),
                          points[:, :, None, :], padding_mode="border")
    assert torch.equal(out, ref[..., 0].permute(0, 2, 1))
    assert tuple(out.shape) == (3, 37, 2)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", ["zoom", "pile"])
@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_plain_dimage_matches_jax_vjp(padding_mode, kind, shape):
    img, grid, cot = _case(shape, kind, 10)
    _, vjp = jax.vjp(lambda x: jgs.grid_sample(
        x, jnp.asarray(grid), padding_mode=padding_mode), jnp.asarray(img))
    ref = vjp(jnp.asarray(cot))[0]
    _close(_plain_dimage(img.shape, grid, cot, padding_mode), ref)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", ["zoom", "pile"])
@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_plain_dimage_matches_tpu_kernel_interpret(padding_mode, kind, shape):
    """The plain d/dimage against the Pallas _dimg_kernel (K5b's TPU
    kernel), reached through grid_sample_mxu's VJP in interpret mode."""
    img, grid, cot = _case(shape, kind, 20)
    _, vjp = jax.vjp(lambda x: jpgs.grid_sample_mxu(
        x, jnp.asarray(grid), padding_mode=padding_mode, precision="f32",
        point_block=128, interpret=True), jnp.asarray(img))
    ref = vjp(jnp.asarray(cot))[0]
    _close(_plain_dimage(img.shape, grid, cot, padding_mode), ref)


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scaled_err(ours, ref):
    return float((ours - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def _card_grid(kind, N, Ho, Wo, H, seed, dev):
    if kind == "identity":
        return tgs.identity_grid(N, Ho, Wo).to(dev)
    if kind == "affine":
        rng = np.random.RandomState(seed)
        a = rng.uniform(-np.pi, np.pi, N)
        s = np.geomspace(0.4, 3.0, N)
        th = np.stack(
            [np.stack([s * np.cos(a), -s * np.sin(a), 0.1 + 0 * s], 1),
             np.stack([s * np.sin(a), s * np.cos(a), -0.2 + 0 * s], 1)],
            1).astype(np.float32)
        return tgs.affine_grid(torch.from_numpy(th), (N, 1, Ho, Wo)).to(dev)
    return torch.from_numpy(_skewed_grid(kind, N, Ho, Wo, seed)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_k2_layouts_match_plain(cuda, padding_mode, C, layout):
    """K2 on both layouts, at a 2-D output (tiles of 4 x 64 points, a
    ragged edge), at a (P, 1) output of odd P (walked as rows of 64, no
    vector loads) and on a grid off a 16-byte boundary."""
    g = torch.Generator().manual_seed(C)
    x = torch.randn(3, C, 40, 52, generator=g).to(cuda)
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    grids = [_card_grid("affine", 3, 70, 66, 40, C, cuda),
             (torch.rand(3, 4061, 1, 2, generator=g) * 2.4 - 1.2).to(cuda)]
    spare = torch.empty(3 * 30 * 66 * 2 + 2, device=cuda)
    spare[2:] = _card_grid("zoom", 3, 30, 66, 40, C, cuda).reshape(-1)
    grids.append(spare[2:].view(3, 30, 66, 2))
    for grid in grids:
        before = LAUNCHES["grid_sample"]
        out = tgs.grid_sample_auto(x, grid, padding_mode=padding_mode)
        torch.cuda.synchronize()
        assert LAUNCHES["grid_sample"] == before + 1
        ref = tgs.grid_sample(x.contiguous(), grid, padding_mode=padding_mode)
        assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_ar_grid_reaches_k2_without_a_copy(cuda):
    """sample_grid_at_points hands K2 the grid's own storage."""
    grid = torch.rand(4, 128, 128, 2, device=cuda) * 2 - 1
    points = torch.rand(4, 4060, 2, device=cuda) * 2 - 1
    calls = []
    real = tgs.grid_sample_cuda

    def record(input, *args):
        calls.append(input)
        return real(input, *args)

    tgs.grid_sample_cuda = record
    try:
        out = tstn.sample_grid_at_points(grid, points)
    finally:
        tgs.grid_sample_cuda = real
    assert len(calls) == 1 and calls[0].data_ptr() == grid.data_ptr()
    ref = tgs.grid_sample(grid.permute(0, 3, 1, 2).contiguous(),
                          points[:, :, None, :])[..., 0].permute(0, 2, 1)
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_backward_kernels_behind_a_channels_last_input(cuda, padding_mode):
    """K4 and K5b when K2's input is channels_last and needs both
    gradients; d/dimage comes back NCHW."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 4, 40, 36, generator=g).to(cuda).to(
        memory_format=torch.channels_last)
    grid = _card_grid("affine", 3, 24, 20, 40, 5, cuda)
    cot = torch.randn(3, 4, 24, 20, generator=g).to(cuda)
    xr, gr = x.contiguous().requires_grad_(), grid.clone().requires_grad_()
    ref = torch.autograd.grad(
        tgs.grid_sample(xr, gr, padding_mode=padding_mode), (xr, gr), cot)
    xc, gc = x.clone().requires_grad_(), grid.clone().requires_grad_()
    before = dict(LAUNCHES)
    ours = torch.autograd.grad(
        tgs.grid_sample_auto(xc, gc, padding_mode=padding_mode), (xc, gc),
        cot)
    torch.cuda.synchronize()
    for k in ("grid_sample", "grid_sample_dgrid", "grid_sample_dimg"):
        assert LAUNCHES[k] == before[k] + 1, k
    for o, r in zip(ours, ref):
        assert _scaled_err(o, r) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["identity", "affine", "zoom", "pile"])
@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_k5b_matches_plain_and_repeats_its_bits(cuda, padding_mode, kind):
    """K5b against the plain autograd, three launches equal to the bit, one
    count a call, and every texel that no point reaches exactly 0 although
    the memory it gets held NaN. The zoom-in puts the 16,384 points of each
    image into a 16 x 16 patch, four 16 x 4 tiles each far past a work
    item's 128 candidates, so those tiles are split and merged."""
    N, C, H, W = 2, 3, 64, 64
    grid = _card_grid(kind, N, 128, 128, H, 7, cuda)
    dout = torch.randn(N, C, 128, 128, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(8))
    x = torch.zeros(N, C, H, W, device=cuda, requires_grad=True)
    ref = torch.autograd.grad(tgs.grid_sample(x, grid,
                                              padding_mode=padding_mode),
                              x, dout)[0]
    runs = []
    for _ in range(3):
        torch.full((N, C, H, W), float("nan"), device=cuda)  # freed at once
        before = LAUNCHES["grid_sample_dimg"]
        runs.append(tgs.grid_sample_dimg(grid, dout, (N, C, H, W),
                                         padding_mode))
        torch.cuda.synchronize()
        assert LAUNCHES["grid_sample_dimg"] == before + 1
    assert _scaled_err(runs[0], ref) <= 1e-5
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert bool(torch.isfinite(runs[0]).all())
    untouched = ref == 0
    if kind == "zoom":
        assert int(untouched.sum()) > N * C * H * W // 2
    assert bool((runs[0][untouched] == 0).all())
