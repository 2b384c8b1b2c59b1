"""The object-and-mask splat pair (``splat2d_pair``) and its callers.

On the CPU: the pair's plain version against two calls of the JAX
package's f32 ``splat2d`` (the object, then the soft-normalised mask) on
the same numpy inputs, within 1e-5 scaled by max(1, max|ref|), with a
quarter of the points at -1e6, points on the edges of K6's 16-pixel tiles,
of its 64 x 32 blocks and of the image, a sigma for each image, H != W, images smaller than one
tile and sigma up to 4 = ``max_sigma``; ``splat_points`` and
``composed_propagate_object`` equal to the bit to the two separate plain
splats they made before the pair; and the pair's wrapper launching nothing
for a CPU tensor.

On the card (marker ``cuda``): K6 through the pair and through the general
``splat2d_cuda`` (a canvas, five channels in two groups, both
normalisations) against the plain version within 1e-5 scaled, on those
inputs and on a label dense enough to overflow the kernel's shared list of
points many times; one launch a call; two launches on the same inputs
equal to the bit; and coordinates off an 8-byte boundary refused.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gangealing_tpu.ops import splat as jsplat
from gangealing_torch import LAUNCHES
from gangealing_torch.models import stn as tstn
from gangealing_torch.ops import splat as tsplat
from gangealing_torch.utils import vis as tvis

from test_torch_ar import ar_images, model, params  # noqa: F401 (fixtures)

TOL = 1e-5

# name: (N, H, W, P, sigma of each image); max_sigma is the largest sigma
CASES = {
    "toy": (2, 24, 20, 60, (1.2, 2.1)),
    "wide": (2, 40, 72, 400, (1.2, 2.5)),
    "under one tile": (3, 9, 13, 50, (0.8, 1.2, 1.6)),
    "sigma 4": (2, 48, 64, 300, (4.0, 3.1)),
}
# a label dense enough (about 2 points a pixel at sigma 4) that each tile
# keeps thousands of points
OVERFLOW = (2, 64, 96, 12000, (4.0, 2.0))


def _pair_inputs(seed, N, H, W, P, sigma, Co=3, Cm=1):
    """Points over the image and a margin of 3 px, the last 10 on the edges
    of 16-pixel tiles, 64 x 32 blocks and the image (two just outside),
    every fourth of the others moved to -1e6; object values in N(0, 1), mask values in
    [0, 1]. Returns numpy arrays and max_sigma."""
    rng = np.random.RandomState(seed)
    coords = (rng.rand(N, P, 2) * np.array([W + 6, H + 6]) - 3).astype(
        np.float32)
    edges = np.array([[31.0, 0.0], [32.0, 31.0], [31.5, 32.0], [0.0, 32.5],
                      [15.5, 16.0], [64.0, 15.999],
                      [W - 1.0, H - 1.0], [W - 0.5, min(H - 1, 31.999)],
                      [W, 5.0], [5.0, H]], np.float32)
    coords[:, -len(edges):] = edges
    coords[:, :-len(edges):4] = -1e6
    obj = rng.randn(N, P, Co).astype(np.float32)
    mask = rng.uniform(0, 1, (N, P, Cm)).astype(np.float32)
    return (coords, obj, mask, np.array(sigma, np.float32)), max(sigma)


def _scaled_err(ours, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(ours) - ref).max()) / max(
        1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_pair_matches_two_jax_splats(case):
    N, H, W = CASES[case][:3]
    (coords, obj, mask, sigma), max_sigma = _pair_inputs(0, *CASES[case])
    refs = [jsplat.splat2d(jnp.zeros((N, v.shape[-1], H, W), jnp.float32),
                           *map(jnp.asarray, (coords, v, sigma)),
                           soft_normalize=soft, max_sigma=max_sigma)
            for v, soft in ((obj, False), (mask, True))]
    ours = tsplat.splat2d_pair(*map(torch.from_numpy,
                                    (coords, obj, mask, sigma)), H, W,
                               max_sigma=max_sigma)
    assert [tuple(o.shape) for o in ours] == [(N, 3, H, W), (N, 1, H, W)]
    for o, r in zip(ours, refs):
        assert _scaled_err(o.numpy(), r) <= TOL


def test_pair_auto_takes_plain_version_on_cpu():
    args, max_sigma = _pair_inputs(1, *CASES["wide"])
    args = tuple(map(torch.from_numpy, args))
    before = dict(LAUNCHES)
    got = tsplat.splat2d_pair_auto(*args, 40, 72, max_sigma=max_sigma)
    ref = tsplat.splat2d_pair(*args, 40, 72, max_sigma=max_sigma)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="must be on"):
        tsplat.splat2d_pair_cuda(*args, 40, 72)
    assert LAUNCHES == before


def test_splat_points_equals_two_plain_splats():
    """The alpha blend of splat_points, as it was made from two plain
    splats, to the bit."""
    rng = np.random.RandomState(2)
    imgs = torch.from_numpy(ar_images(2, 2))
    pts = torch.from_numpy((rng.rand(2, 300, 2) * 72 - 4).astype(np.float32))
    colors = torch.from_numpy(rng.uniform(-1, 1, (2, 300, 3)).astype(
        np.float32))
    alphas = torch.from_numpy(rng.uniform(0.3, 1, (2, 300, 1)).astype(
        np.float32))
    sigma = torch.full((2,), 1.2)
    obj = tsplat.splat2d(torch.zeros_like(imgs), pts, colors, sigma, False,
                         max_sigma=1.2)
    mask = tsplat.splat2d(torch.zeros_like(imgs[:, :1]), pts, alphas, sigma,
                          True, max_sigma=1.2) * 0.8
    ours = tvis.splat_points(imgs, pts, sigma=1.2, opacity=0.8,
                             colors=colors, alpha_channel=alphas)
    assert torch.equal(ours, mask * obj + (1 - mask) * imgs)


def test_composed_propagate_object_equals_two_plain_splats(model):  # noqa: F811
    """The object and the mask, as they were made from two plain splats of
    the uncongealed points, to the bit."""
    imgs = torch.from_numpy(ar_images(12, 2))
    rng = np.random.RandomState(13)
    pts = torch.from_numpy(rng.uniform(-1.05, 1.05, (2, 120, 2)).astype(
        np.float32))
    vals = torch.from_numpy(rng.uniform(-1, 1, (2, 120, 3)).astype(
        np.float32))
    masks = torch.from_numpy(rng.uniform(0.5, 1, (2, 120, 1)).astype(
        np.float32))
    sigma = torch.tensor([1.2, 1.5])
    with torch.no_grad():
        obj, mask = tstn.composed_propagate_object(model, pts, vals, masks,
                                                   imgs, sigma, max_sigma=1.5)
        moved = tstn.composed_uncongeal_points(
            model, imgs, pts, normalize_input_points=False,
            unnormalize_output_points=True)
    rounded = torch.round(moved)
    size = imgs.shape[-1]
    visible = ((rounded >= 0) & (rounded < size)).all(-1, keepdim=True)
    moved = torch.where(visible, moved, torch.full_like(moved, -1e6))
    assert 0 < int(visible.sum()) < visible.numel()
    assert torch.equal(obj, tsplat.splat2d(torch.zeros_like(imgs), moved,
                                           vals, sigma, False, max_sigma=1.5))
    assert torch.equal(mask, tsplat.splat2d(torch.zeros_like(imgs[:, :1]),
                                            moved, masks, sigma, True,
                                            max_sigma=1.5))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _on(dev, arrays):
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES) + ["overflow"])
def test_pair_kernel_matches_plain_and_repeats(cuda, case):
    shape = OVERFLOW if case == "overflow" else CASES[case]
    N, H, W = shape[:3]
    arrays, max_sigma = _pair_inputs(3, *shape)
    args = _on(cuda, arrays)
    before = LAUNCHES["splat"]
    got = tsplat.splat2d_pair_auto(*args, H, W, max_sigma=max_sigma)
    torch.cuda.synchronize()
    assert LAUNCHES["splat"] == before + 1
    ref = tsplat.splat2d_pair(*args, H, W, max_sigma=max_sigma)
    for g, r in zip(got, ref):
        assert _scaled_err(g.cpu().numpy(), r.cpu().numpy()) <= TOL
    again = tsplat.splat2d_pair_cuda(*args, H, W)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["wide", "overflow"])
@pytest.mark.parametrize("soft", [False, True])
def test_splat_kernel_five_channels_on_a_canvas(cuda, case, soft):
    shape = OVERFLOW if case == "overflow" else CASES[case]
    N, H, W = shape[:3]
    (coords, values, _, sigma), max_sigma = _pair_inputs(4, *shape, Co=5)
    canvas = np.random.RandomState(5).randn(N, 5, H, W).astype(np.float32)
    args = _on(cuda, (canvas, coords, values, sigma))
    before = LAUNCHES["splat"]
    out = tsplat.splat2d_auto(*args, soft_normalize=soft,
                              max_sigma=max_sigma)
    torch.cuda.synchronize()
    assert LAUNCHES["splat"] == before + 1
    ref = tsplat.splat2d(*args, soft_normalize=soft, max_sigma=max_sigma)
    assert _scaled_err(out.cpu().numpy(), ref.cpu().numpy()) <= TOL
    assert torch.equal(out, tsplat.splat2d_cuda(*args, soft))


@pytest.mark.cuda
def test_pair_kernel_refuses_misaligned_points(cuda):
    """K6 reads a point as one float2, so the wrapper refuses coordinates
    that do not start on an 8-byte boundary."""
    (coords, obj, mask, sigma), _ = _pair_inputs(6, *CASES["toy"])
    flat = torch.zeros(coords.size + 1, device=cuda)
    flat[1:] = torch.from_numpy(coords).reshape(-1).to(cuda)
    shifted = flat[1:].view(coords.shape)
    before = LAUNCHES["splat"]
    with pytest.raises(ValueError, match="8-byte boundary"):
        tsplat.splat2d_pair_cuda(shifted, *_on(cuda, (obj, mask, sigma)),
                                 24, 20)
    assert LAUNCHES["splat"] == before
