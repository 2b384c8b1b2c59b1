"""The plain version of K3 (and K1) at the tie points of chip_smoke.py's K3
tie phase, against ``jax.vjp`` of the JAX package's fold warp, on the CPU.

The points (``chip_smoke.tie_inputs``): every pair of coordinates on texel
centres, texel edges, the border clamp's ends, the reflection padding's
mirror lines and one texel past them, at levels on each integer of a
four-level pyramid, at 2.5 and a float step either side of each integer;
64 and 256 px images, the three padding modes. The port samples the
native-resolution pyramid (``_sample_pyramid``), JAX its Gaussian stack
(``_mipmap_warp_fold``); JAX's tie rules (``jnp.clip``, ``jnp.maximum``,
``floor``) decide. Output, d/dgrid and d/dlevels within 1e-5 scaled by
max(1, max|ref|) (float32 on both sides; the stacks are built by different
ops, a few ulps apart; all read under 1e-7). The card holds K3 and K1 against this plain
version at the same points (``chip_smoke.k3_ties``).
"""

from importlib import import_module

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import chip_smoke as cs
from gangealing_torch.ops import mipmap as tmm

jmm = import_module("gangealing_tpu.ops.mipmap")

ATOL = 1e-5


def _close(ours, ref):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.detach().numpy(), ref, atol=ATOL * scale,
                               rtol=0)


@pytest.mark.parametrize("padding_mode", cs.PADDINGS)
@pytest.mark.parametrize("size", cs.TIE_SIZES)
def test_plain_k3_at_ties_matches_jax(size, padding_mode):
    img, grid, levels, dout = cs.tie_inputs(size)
    g = grid.clone().requires_grad_()
    lv = levels.clone().requires_grad_()
    pyramid = tmm._build_pyramid(img, cs.TIE_LEVELS)
    out = tmm._sample_pyramid(pyramid, g, lv, padding_mode)
    out.backward(dout)
    ref, vjp = jax.vjp(
        lambda a, b: jmm._mipmap_warp_fold(jnp.asarray(img.numpy()), a,
                                           cs.TIE_LEVELS, b, padding_mode),
        jnp.asarray(grid.numpy()), jnp.asarray(levels.numpy()))
    dgrid, dlevels = vjp(jnp.asarray(dout.numpy()))
    _close(out, ref)
    _close(g.grad, dgrid)
    _close(lv.grad, dlevels)
    assert float(np.abs(np.asarray(dgrid)).max()) > 0
