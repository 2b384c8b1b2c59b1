"""Shared set-up of the port's training tests: one small GANgealing
configuration built on both sides from the same JAX init, with z and the
generator's noise made by numpy and fed to both.

On the JAX side they go in through ``generator_apply(noise=...)`` inside a
``pair_sampler`` for ``gangealing_loss``. That sampler also stops the
gradient at the latent learner's ``directions`` and ``lat_mean``: they are
buffers in the reference and in the port (only ``coefficients`` is
learned), while the JAX step would hand them to Adam as well.
"""

from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gangealing_torch.io import params_from_jax
from gangealing_torch.models import latent_learner as tll
from gangealing_torch.models import lpips as tlp
from gangealing_torch.models import stn as tstn
from gangealing_torch.models import stylegan2 as tg
from gangealing_torch.train import state as tstate

jsg = import_module("gangealing_tpu.models.stylegan2")
jstn = import_module("gangealing_tpu.models.stn")
jll = import_module("gangealing_tpu.models.latent_learner")
jlp = import_module("gangealing_tpu.models.lpips")
jlosses = import_module("gangealing_tpu.train.losses")
jstate = import_module("gangealing_tpu.train.state")

G = dict(size=64, style_dim=32, n_mlp=2, channel_multiplier=1,
         max_channels=32)
T = dict(transforms=("similarity", "flow"), flow_size=64, supersize=64,
         channel_multiplier=0.25, flow_downsample=4, max_channels=32)
LL = dict(n_comps=2, inject_index=3, n_latent=10, num_heads=1, style_dim=32)
TRAIN = dict(batch=2, tv_weight=1000.0, flow_identity_weight=1.0,
             anneal_psi=100, period=50, loss_fn="vgg_ssl")


@pytest.fixture(autouse=True)
def two_torch_threads():
    """Two torch threads per test process. The suite runs six processes at
    once; with a thread per core in each, their spinning threads slowed the
    training tests tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def perturb(params, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return {k: np.asarray(v) + scale * rng.randn(*np.shape(v)).astype(
        np.float32) for k, v in params.items()}


class Setup:
    """JAX parameter dicts, the JAX train config and the port's modules
    holding the same weights. ``perturbed``: every STN parameter plus 0.05
    noise, so neither warp is an identity."""

    def __init__(self, perturbed=False):
        self.jcfg = jstate.TrainConfig(
            g=jsg.GeneratorConfig(**G), t=jstn.ComposedSTNConfig(**T),
            ll=jll.LatentLearnerConfig(**LL), **TRAIN)
        self.g_params = jsg.generator_init(jax.random.PRNGKey(0), self.jcfg.g)
        t_params = jstn.composed_stn_init(jax.random.PRNGKey(1), self.jcfg.t)
        self.t_params = {k: np.asarray(v) for k, v in t_params.items()}
        if perturbed:
            self.t_params = perturb(self.t_params, 5)
        ll_params = dict(jll.latent_learner_init(jax.random.PRNGKey(2),
                                                 self.jcfg.ll))
        ll_params["coefficients"] = np.random.RandomState(3).randn(
            1, 2).astype(np.float32)
        self.ll_params = {k: np.asarray(v) for k, v in ll_params.items()}
        self.vgg_params = jlp.vgg16_init(jax.random.PRNGKey(4))
        self.jploss = jlp.make_perceptual_loss(
            jlp.PerceptualLossConfig(kind="vgg_ssl"))

        self.cfg = tstate.TrainConfig(
            g=tg.GeneratorConfig(**G), t=tstn.ComposedSTNConfig(**T),
            ll=tll.LatentLearnerConfig(**LL), **TRAIN)
        self.generator = tg.Generator(self.cfg.g)
        self.generator.load_state_dict(params_from_jax(self.g_params),
                                       strict=True)
        self.generator.requires_grad_(False)
        t = tstn.ComposedSTN(self.cfg.t)
        t.load_state_dict(params_from_jax(self.t_params), strict=True)
        ll = tll.LatentLearner(self.cfg.ll)
        ll.load_state_dict(params_from_jax(self.ll_params), strict=True)
        self.state = tstate.TrainState(self.cfg, t, ll)
        vgg = tlp.LPIPS().eval().requires_grad_(False)
        vgg.load_state_dict(params_from_jax(self.vgg_params), strict=True)
        loss = tlp.make_perceptual_loss("vgg_ssl")
        self.perceptual_fn = lambda x, y: loss(vgg, x, y)

    def inputs(self, seed):
        """z (batch, style_dim) and the noise of both generator passes."""
        rng = np.random.RandomState(seed)
        z = rng.randn(TRAIN["batch"], G["style_dim"]).astype(np.float32)
        shapes = self.cfg.g.noise_shapes(TRAIN["batch"])
        noise = [[rng.randn(*s).astype(np.float32) for s in shapes]
                 for _ in range(2)]
        return z, noise

    def jax_sampler(self, noise):
        g_params, jcfg = self.g_params, self.jcfg
        noise_u, noise_a = [[jnp.asarray(n) for n in ns] for ns in noise]

        def sampler(ll_params, key, psi, batch, z):
            ll_p = dict(ll_params)
            for k in ("directions", "lat_mean"):
                ll_p[k] = jax.lax.stop_gradient(ll_p[k])
            unaligned, w = jsg.generator_apply(g_params, jcfg.g, [z],
                                               noise=noise_u,
                                               return_latents=True)
            w_aligned = jll.latent_learner_interpolate(ll_p, jcfg.ll,
                                                       w[:, 0, :], psi)
            aligned, _ = jsg.generator_apply(g_params, jcfg.g, [w_aligned],
                                             input_is_latent=True,
                                             noise=noise_a)
            return unaligned, jlosses.resize_fake2stn(aligned, jcfg.g.size,
                                                      jcfg.t.flow_size)
        return sampler

    def torch_noise(self, noise):
        return tuple([torch.from_numpy(n) for n in ns] for ns in noise)


def jnp_tree(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def rel_err(ours, ref):
    ref = np.asarray(ref)
    ours = ours.detach().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    return float(np.abs(ours - ref).max()) / max(float(np.abs(ref).max()),
                                                 1e-30)
