"""The port's Gaussian splat against the JAX package's.

On the CPU: the plain ``splat2d`` against the JAX f32 ``splat2d`` within
1e-5 scaled by max(1, max|ref|) (the same f32 arithmetic; only the order of
the scatter's sums differs), with points out of bounds and moved to -1e6,
two sigmas, both ``soft_normalize`` values and a non-blank canvas; against
the TPU kernel (``splat2d_mxu``) in interpret mode within 2e-2, its bf16
matmul accumulation, as tests/test_splat.py runs it; and ``splat2d_auto``
on a CPU tensor launches nothing.

On the card (marker ``cuda``): K6 against the plain version on the same
CUDA tensors, within 1e-5 scaled: its expf differs from torch's in the last
bit, and the plain version's scatter on the card sums in another order.
"""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

from gangealing_tpu.ops import splat as jsplat
from gangealing_torch import LAUNCHES
from gangealing_torch.ops import splat as tsplat

TOL = 1e-5


def _inputs(seed, N=2, C=3, H=24, W=20, P=60, blank=True):
    rng = np.random.RandomState(seed)
    inp = (np.zeros((N, C, H, W), np.float32) if blank
           else rng.randn(N, C, H, W).astype(np.float32))
    coords = (rng.rand(N, P, 2) * np.array([W + 6, H + 6]) - 3).astype(
        np.float32)  # some out of bounds
    coords[0, :4] = -1e6  # as composed_propagate_object hides a point
    values = rng.randn(N, P, C).astype(np.float32)
    sigma = np.array([1.3, 2.1], np.float32)[:N]
    return inp, coords, values, sigma


def _scaled_err(ours, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(ours) - ref).max()) / max(
        1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("blank", [True, False])
@pytest.mark.parametrize("soft", [False, True])
def test_plain_splat_matches_jax(soft, blank):
    inp, coords, values, sigma = _inputs(0, blank=blank)
    ref = jsplat.splat2d(*map(jnp.asarray, (inp, coords, values, sigma)),
                         soft_normalize=soft, max_sigma=2.5)
    ours = tsplat.splat2d(*map(torch.from_numpy, (inp, coords, values,
                                                  sigma)),
                          soft_normalize=soft, max_sigma=2.5)
    assert _scaled_err(ours.numpy(), ref) <= TOL


def test_plain_splat_chunks_match_jax(monkeypatch):
    """Points in many chunks (a small chunk size on both sides) sum as in
    one."""
    monkeypatch.setattr(jsplat, "_CHUNK_ELEMS", 7 * 49)
    monkeypatch.setattr(tsplat, "_CHUNK_ELEMS", 7 * 49)
    inp, coords, values, sigma = _inputs(1, C=1, P=50)
    ref = jsplat.splat2d(*map(jnp.asarray, (inp, coords, values, sigma)),
                         soft_normalize=True, max_sigma=2.5)
    ours = tsplat.splat2d(*map(torch.from_numpy, (inp, coords, values,
                                                  sigma)),
                          soft_normalize=True, max_sigma=2.5)
    assert _scaled_err(ours.numpy(), ref) <= TOL


@pytest.mark.parametrize("soft", [False, True])
def test_plain_splat_matches_tpu_kernel_interpret(soft):
    inp, coords, values, sigma = _inputs(2, W=128, P=40)
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        ref = jsplat.splat2d_mxu(*map(jnp.asarray,
                                      (inp, coords, values, sigma)),
                                 soft_normalize=soft, point_block=128)
    finally:
        pl.pallas_call = orig
    ours = tsplat.splat2d(*map(torch.from_numpy, (inp, coords, values,
                                                  sigma)),
                          soft_normalize=soft, max_sigma=2.1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-2,
                               rtol=2e-2)


def test_splat_auto_takes_plain_version_on_cpu():
    args = tuple(map(torch.from_numpy, _inputs(3)))
    before = dict(LAUNCHES)
    out = tsplat.splat2d_auto(*args, soft_normalize=True, max_sigma=2.5)
    assert torch.equal(out, tsplat.splat2d(*args, soft_normalize=True,
                                           max_sigma=2.5))
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="must be on"):
        tsplat.splat2d_cuda(*args)
    assert LAUNCHES == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("soft", [False, True])
def test_splat_kernel_matches_plain(cuda, soft):
    inp, coords, values, sigma = (torch.from_numpy(a).to(cuda) for a in
                                  _inputs(4, H=40, W=56, P=500,
                                          blank=False))
    before = LAUNCHES["splat"]
    out = tsplat.splat2d_auto(inp, coords, values, sigma,
                              soft_normalize=soft, max_sigma=2.1)
    torch.cuda.synchronize()
    assert LAUNCHES["splat"] == before + 1
    ref = tsplat.splat2d(inp, coords, values, sigma, soft_normalize=soft,
                         max_sigma=2.1)
    assert _scaled_err(out.cpu().numpy(), ref.cpu().numpy()) <= TOL
