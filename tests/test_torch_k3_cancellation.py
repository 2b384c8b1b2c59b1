"""How far K3's plain version falls from float64 at the cars step's shapes,
and the float64 reading that chip_smoke.py prints when K3 fails its hold.

K3 (d/dgrid and d/dlevels of the mipmap sample) is held on the card
against the plain version's float32 autograd within KERNEL_TOL (1e-5)
scaled by max(1, max|ref|). One smoke read 2.099e-05 scaled at a cars
state (ROADMAP Queue 3). Either the kernel is wrong there, or both float32
sums are far from the truth where their terms cancel. ``chip_smoke.k3_f64``
computes the function in float64 past the texel coordinates (which both
float32 sides form alike), with the sum of the absolute terms at each point.

At the cars step's shapes (160 streams of 128 x 128 points over a 256 px
pyramid of four levels, reflection padding; similarity warps with flips
and a smooth flow, noisy images), three seeded states read on the CPU:
the float32 plain version's d/dgrid within 1.049e-05 of float64 (3.35e-07
scaled, about 30 times under KERNEL_TOL), d/dlevels within 7.53e-08; at
every point within 4.87 float32 epsilons (2^-24) of the sum of its
absolute terms, whose largest is 3.2-3.4 times the largest gradient. So a
float32 sum's cancellation reaches KERNEL_TOL only where the terms are
about 100 times the tensor's largest gradient; the tests assert the
readings' bounds with a margin of two.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gangealing_torch.ops import mipmap as tmm
from gangealing_torch.ops.grid_sample import affine_grid
from gangealing_torch.ops.resample import interpolate_bilinear

STREAMS, POINTS, SIZE, LEVELS = 160, 128, 256, 4
CHUNK = 32
EPS32 = 2.0 ** -24
# the readings' bounds (see above) times two
PLAIN_SCALED_TOL = 7e-7
TERMS_RATIO_TOL = 10 * EPS32


def cars_inputs(seed, n=STREAMS):
    """A cars-shaped K3 input: n noisy 256 px images, their grids (a
    similarity with a mirror for half of them, plus a smooth flow) at 128
    x 128 points, the mipmap levels of those grids and a cotangent."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    low = torch.randn(n, 3, 16, 16, generator=gen)
    img = torch.tanh(2 * interpolate_bilinear(low, SIZE, SIZE)) \
        + 0.3 * torch.randn(n, 3, SIZE, SIZE, generator=gen)
    angle = rng.uniform(-0.5, 0.5, n)
    scale = rng.uniform(0.5, 1.4, n)
    mirror = np.where(rng.rand(n) < 0.5, -1.0, 1.0)
    theta = np.zeros((n, 2, 3), np.float32)
    theta[:, 0, 0] = scale * np.cos(angle) * mirror
    theta[:, 0, 1] = -scale * np.sin(angle)
    theta[:, 1, 0] = scale * np.sin(angle) * mirror
    theta[:, 1, 1] = scale * np.cos(angle)
    theta[:, :, 2] = rng.uniform(-0.3, 0.3, (n, 2))
    grid = affine_grid(torch.from_numpy(theta), (n, 3, POINTS, POINTS))
    flow = interpolate_bilinear(0.05 * torch.randn(n, 2, 8, 8, generator=gen),
                                POINTS, POINTS).permute(0, 2, 3, 1)
    grid = (grid + flow).contiguous()
    levels = tmm.jmax(tmm.mipmap_levels(grid, SIZE, SIZE, 3.5), 0.0)
    dout = 0.05 * torch.randn(n, 3, POINTS, POINTS, generator=gen)
    return img, grid, levels.contiguous(), dout


def plain_k3(pyramid, grid, levels, dout, padding_mode):
    g = grid.clone().requires_grad_()
    lv = levels.clone().requires_grad_()
    out = tmm._sample_pyramid(pyramid, g, lv, padding_mode)
    return torch.autograd.grad(out, (g, lv), dout)


@pytest.fixture
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_k3_against_float64_at_cars_shapes(seed, two_threads):
    img, grid, levels, dout = cars_inputs(seed)
    worst = {0: [0.0, 0.0, 0.0], 1: [0.0, 0.0, 0.0]}  # err, max|ref|, ratio
    for c in range(0, STREAMS, CHUNK):
        part = slice(c, c + CHUNK)
        args = (tmm._build_pyramid(img[part], LEVELS), grid[part],
                levels[part], dout[part], "reflection")
        ours = plain_k3(*args)
        ref = cs.k3_f64(*args)
        for k in (0, 1):
            err = (ours[k].double() - ref[k]).abs()
            w = worst[k]
            w[0] = max(w[0], float(err.max()))
            w[1] = max(w[1], float(ref[k].abs().max()))
            w[2] = max(w[2], float((err / ref[2 + k].clamp_min(1e-30)).max()))
    for k, (err, top, ratio) in worst.items():
        assert err / max(1.0, top) <= PLAIN_SCALED_TOL, (k, err, top)
        assert ratio <= TERMS_RATIO_TOL, (k, ratio / EPS32)
    assert worst[0][1] > 1.0  # the scale applies: d/dgrid reaches past 1


def test_k3_hold_failure_prints_the_float64_reading():
    """A K3 launch whose d/dgrid is off at one point fails ``hold`` after
    printing that point's reading: the kernel's error against float64 is
    the offset, the plain version's is a rounding."""
    img, grid, levels, dout = cars_inputs(5, n=2)
    args = (tmm._build_pyramid(img, LEVELS), grid, levels, dout,
            "reflection")
    dgrid, dlevels = (t.detach().clone() for t in plain_k3(*args))
    dgrid[1, 7, 9, 0] += 1e-2
    calls = [(args, (dgrid, dlevels))]
    messages = []
    where = cs.k3_where(calls)
    with pytest.raises(AssertionError, match="disagrees"):
        cs.hold("mipmap_sample_dcoords", cs.backward_pairs(calls, cs.k3_graph),
                {}, lambda i, at: messages.append(where(i, at)) or "")
    assert len(messages) == 1 and "float64 reading failed" not in messages[0]
    text = messages[0]
    kernel = float(text.split("): kernel ")[1].split(" there")[0])
    plain = float(text.split("plain version ")[1].split(" there")[0])
    assert abs(kernel - 1e-2) < 1e-4 and plain < 1e-5, text
    assert "the sum of the absolute terms there" in text
