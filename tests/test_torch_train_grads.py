"""The port's GANgealing loss and its step-1 gradients against the JAX
package's, on the CPU.

One small configuration (G 64px, style_dim 32, n_mlp 2; the STN at
flow_size 64; random VGG16 on 64px inputs with the vgg_ssl loss; batch 2;
tv_weight 1000) from the JAX init, where both warps are identities and
every point sits on an integer coordinate and the border clamp, and from
weights perturbed by 0.05.

Tolerances: each loss term rtol 1e-5. The gradient of the total loss with
respect to every STN parameter and the latent learner's coefficients within
2e-3 of that tensor's largest JAX gradient. The loss is piecewise smooth
(ReLUs, max-pools, floors, maxima), and a unit that sits within float32
rounding of a kink takes one side in one framework and the other side in
the other. With some 1e6 units feeding each gradient, one flipped unit
moves it by about 1e-3 of its size: over eight seeds of z the worst tensor
differed by 4e-6 to 1.4e-3, and JAX's own gradients move by 4e-4 when z
changes by 1e-7 relative. The tie-rule fault this test guards against (the
plain samplers' gradients at clamp bounds and integer levels, repaired in
this port) moves the identity-init gradients of the similarity head by
1.5% and of the flow head's last conv by 0.36% to 0.59% of their largest
values, so even its smallest trace is 1.8x the tolerance.
"""

from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gangealing_torch.train import losses as tlosses
from gangealing_torch.train import state as tstate

from test_torch_train_common import (  # noqa: F401
    Setup, jnp_tree, jlosses, rel_err, two_torch_threads)

jflow = import_module("gangealing_tpu.ops.flow")

PSI = 0.7


@pytest.mark.parametrize("perturbed", [False, True])
def test_step1_loss_and_gradients(perturbed):
    s = Setup(perturbed)
    z, noise = s.inputs(6)
    sampler = s.jax_sampler(noise)
    jcfg = s.jcfg

    def total(t_params, ll_params):
        pfn = lambda x, y: s.jploss(s.vgg_params, x, y)
        ploss, df = jlosses.gangealing_loss(
            s.g_params, jcfg.g, t_params, jcfg.t, ll_params, jcfg.ll, pfn,
            jax.random.PRNGKey(0), PSI, 2, z=jnp.asarray(z),
            pair_sampler=sampler)
        tv = jflow.total_variation_loss(df)
        fid = jflow.flow_identity_loss(df)
        return (ploss + jcfg.tv_weight * tv + jcfg.flow_identity_weight * fid,
                (ploss, tv, fid))

    (_, terms), (g_t, g_ll) = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(jnp_tree(s.t_params),
                                               jnp_tree(s.ll_params))
    metrics = tstate.train_step(s.state, s.generator, s.perceptual_fn,
                                torch.from_numpy(z), PSI, 0.0, 0.0,
                                noise=s.torch_noise(noise))
    for k, r in zip(("p", "tv", "f"), terms):
        np.testing.assert_allclose(float(metrics[k]), float(r), rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    worst = {}
    for name, p in s.state.t.named_parameters():
        worst[name] = rel_err(p.grad, g_t[name])
    worst["ll.coefficients"] = rel_err(s.state.ll.coefficients.grad,
                                       g_ll["coefficients"])
    bad = {k: v for k, v in worst.items() if v > 2e-3}
    assert not bad, bad
    # the perceptual term reaches the similarity head through the samplers
    assert float(s.state.t.stns[0].warp_head.linear.weight.grad.abs().max()) > 0
    assert float(np.abs(np.asarray(g_ll["coefficients"])).max()) > 0


def test_loss_with_pair_sampler():
    """gangealing_loss with a pair_sampler in place of the generator (as the
    JAX package's synthetic demo plugs one in): the same fixed pair through
    both packages gives the same perceptual loss and residual flow."""
    s = Setup(perturbed=True)
    rng = np.random.RandomState(11)
    unaligned, target = (np.tanh(rng.randn(2, 3, 64, 64)).astype(np.float32)
                         for _ in range(2))
    ref, ref_df = jlosses.gangealing_loss(
        None, None, jnp_tree(s.t_params), s.jcfg.t, jnp_tree(s.ll_params),
        s.jcfg.ll, lambda x, y: s.jploss(s.vgg_params, x, y),
        jax.random.PRNGKey(0), PSI, 2,
        pair_sampler=lambda *a: (jnp.asarray(unaligned), jnp.asarray(target)))
    with torch.no_grad():
        ours, df = tlosses.gangealing_loss(
            None, s.state.t, s.state.ll, s.perceptual_fn, None, PSI,
            pair_sampler=lambda *a: (torch.from_numpy(unaligned),
                                     torch.from_numpy(target)))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    np.testing.assert_allclose(df.numpy(), np.asarray(ref_df), atol=1e-5,
                               rtol=0)
