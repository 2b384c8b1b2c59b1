"""StyleGAN2 config-f at its real depth as the frozen teacher of the port's
train step, held against the benchmark's plain reference on the CPU.

The configuration is the benchmark's ``ffhq_config_f``
(``portbench/configs/ffhq_config_f.json``) with its channels capped so
that the CPU holds it: the generator at 1024 px with all 9 synthesis
blocks, 18 latents and 17 noise inputs, ``max_channels`` 8; the latent
learner's 512 directions injected at latent 6; the similarity-then-flow
STN at 128 (channels capped at 16) sampling the 1024 px fakes; LPIPS at
full width; batch 2. The port runs 2 iterations through the benchmark's
train driver (the loop body: ``train_block`` over ``train_step``) from
seeded weights, and ``portbench/reference/train.py::ReferenceTrainer``
follows them on the same weights and inputs. Compared: every loss term of
both steps, the first gradients of the STN and the latent learner, and
the change of every learned tensor and of the EMA over the 2 steps.

A second case does the same without full-res sampling (the STN samples
the fakes downsampled to 128). Each case's first perceptual term is also
held apart from the other's, so the first case shows that the full-res
path is the one it compares.

The same configuration is also held against the JAX package, which runs
it too: both sides built from one JAX init (G, the STN with 0.05 noise on
every weight so that neither warp is an identity, the latent learner with
seeded coefficients, LPIPS with its calibration layers), z and the noise of
both generator passes from numpy. Compared: the generator's 1024 px image
and W+ latents, then one train step of the port's ``train_step`` against
``make_train_step``'s, full-res sampling on: the loss terms and every
learned tensor's gradient, the latent learner's among them.
"""

import functools
import json
from pathlib import Path

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
from portbench.drivers import train as bench_train

from test_torch_train_common import (
    jll, jlosses, jlp, jnp_tree, jsg, jstate, jstn, perturb, rel_err)

ROOT = Path(__file__).resolve().parent.parent
CONFIG = ROOT / "portbench" / "configs" / "ffhq_config_f.json"
SEED = 2 ** 31 + 22  # more than 32 signed bits hold, as a benchmark seed may
TRAFFIC = dict(kind="train", batch=2, start_iter=75000, log_every=25,
               checked_steps=2, trace_units=1)

# Both sides run float32 on the CPU through the same ATen kernels, in the
# same order up to the loss: the terms came out equal to the bit. 1e-6 (a
# few float32 ulps) leaves room for a sum taken in another order.
LOSS_RTOL = 1e-6
# The port's backward goes through its own autograd Functions (the
# mipmap warp, the FIR resampler) and the reference's through plain ops,
# so gradients are summed in other orders: the worst leaf read 5e-8 of
# the larger of its norm and the median leaf's. 1e-6 is 20 times that
# and ten thousand times under the gap between the two cases' terms.
GRAD_TOL = 1e-6
# Adam's update divides each gradient by its own root mean square, so a
# gradient's relative round-off passes to the change nearly unscaled; the
# change read equal to the bit. 1e-5 leaves the room of GRAD_TOL tenfold.
CHANGE_TOL = 1e-5


def ffhq_small(full_res):
    cfg = json.loads(CONFIG.read_text())
    cfg["generator"]["max_channels"] = 8
    cfg["stn"]["max_channels"] = 16
    cfg["train"]["sample_from_full_res"] = full_res
    return cfg


@functools.cache
def run_case(full_res):
    """(the train cell of ``portbench/drivers``, the port's readings, the
    reference's) of the configuration at ``full_res``: each reading as
    (loss terms of each step, first gradients, learned tensors before,
    after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs several test processes
    try:
        cell = bench_train.build(ffhq_small(full_res), TRAFFIC, SEED,
                                 torch.device("cpu"), {})
        terms, grads, after = cell.passes[0]
        port = (terms, grads, cell.initial, after)
        *ref, _ = cell.reference()
    finally:
        torch.set_num_threads(saved)
    return cell, port, tuple(ref)


def relative_diffs(ours, ref):
    return bench_train.leaf_diffs(ours, ref, list(ref))


@pytest.mark.parametrize("full_res", [True, False],
                         ids=["full_res", "downsampled"])
def test_config_f_train_step_matches_reference(full_res):
    cell, port, ref = run_case(full_res)
    g_cfg = cell.state.cfg.g
    assert g_cfg.size == 1024 and g_cfg.n_latent == 18
    assert len(g_cfg.noise_shapes(1)) == 17
    assert len(cell.generator.to_rgbs) == 8  # 8 blocks after the 4x4 one
    assert cell.state.ll.directions.shape[0] == 512
    assert cell.state.cfg.ll.inject_index == 6
    assert cell.state.cfg.sample_from_full_res is full_res

    terms_o, grads_o, before_o, after_o = port
    terms_r, grads_r, before_r, after_r = ref
    assert len(terms_o) == len(terms_r) == 2
    for step, (a, b) in enumerate(zip(terms_o, terms_r)):
        for name, x, y in zip(("p", "tv", "f"), a, b):
            assert abs(x - y) <= LOSS_RTOL * abs(y), (step, name, x, y)
    assert set(grads_o) == set(grads_r)
    assert any(k.startswith("ll.") for k in grads_r)
    grad_diffs = relative_diffs(grads_o, grads_r)
    worst = max(grad_diffs, key=grad_diffs.get)
    assert grad_diffs[worst] <= GRAD_TOL, (worst, grad_diffs[worst])
    change_o = {k: after_o[k] - before_o[k] for k in after_o}
    change_r = {k: after_r[k] - before_r[k] for k in after_r}
    assert all(float(v.norm()) > 0 for k, v in change_r.items()
               if not k.startswith("t_ema.")), "every learned leaf moves"
    change_diffs = relative_diffs(change_o, change_r)
    worst = max(change_diffs, key=change_diffs.get)
    assert change_diffs[worst] <= CHANGE_TOL, (worst, change_diffs[worst])

    # the other case's first perceptual term lies far outside the
    # tolerance: what this case compares is its own sampling path
    _, other, _ = run_case(not full_res)
    p, p_other = terms_o[0][0], other[0][0][0]
    assert abs(p - p_other) > 100 * LOSS_RTOL * abs(p), (p, p_other)


# The configuration on both packages' configs: the cell's widths with the
# channels capped as above, at batch 2.
JAX_G = dict(size=1024, style_dim=512, n_mlp=8, channel_multiplier=2,
             max_channels=8)
JAX_T = dict(transforms=("similarity", "flow"), flow_size=128,
             supersize=256, channel_multiplier=0.5, flow_downsample=8,
             max_channels=16)
JAX_LL = dict(n_comps=512, inject_index=6, n_latent=18, num_heads=1,
              style_dim=512)
JAX_TRAIN = dict(batch=2, tv_weight=2500.0, flow_identity_weight=1.0,
                 loss_fn="lpips", sample_from_full_res=True,
                 padding_mode="border")
PSI = 0.5
# Images and W+ latents: the generator's test holds 4 resolutions of convs
# at 1e-4; 9 here, each summing in its own order. Read: 1.7e-5 on images
# up to 5.1, 4.7e-6 on the latents.
IMAGE_ATOL = 1e-4
# The step's terms, gradients and Adam moments, as the clustered step's
# test holds them (tests/test_torch_cluster_train.py): terms 1e-5
# relative; each gradient within 2e-2 of its largest JAX value and all of
# them within 2e-3 in relative L2 norm (a unit of the piecewise-smooth
# loss within rounding of a kink takes one side in one framework and the
# other in the other). Read: terms 5e-7, the worst tensor 3.7e-4 (the
# latent learner's coefficients 3.6e-4), all of them 4.8e-5.
TERM_RTOL, GRAD_TOL, GRAD_L2_TOL = 1e-5, 2e-2, 2e-3


class JaxPair:
    """The configuration on both packages, holding the same weights."""

    def __init__(self):
        self.jcfg = jstate.TrainConfig(
            g=jsg.GeneratorConfig(**JAX_G), t=jstn.ComposedSTNConfig(**JAX_T),
            ll=jll.LatentLearnerConfig(**JAX_LL), **JAX_TRAIN)
        self.g_params = jsg.generator_init(jax.random.PRNGKey(0), self.jcfg.g)
        self.t_params = perturb(jstn.composed_stn_init(
            jax.random.PRNGKey(1), self.jcfg.t), 5)
        ll_params = {k: np.asarray(v) for k, v in jll.latent_learner_init(
            jax.random.PRNGKey(2), self.jcfg.ll).items()}
        # a target latent of unit size over the 512 unit-normal directions
        ll_params["coefficients"] = 0.05 * np.random.RandomState(3).randn(
            1, 512).astype(np.float32)
        self.ll_params = ll_params
        self.lpips_params = jlp.vgg16_init(jax.random.PRNGKey(4))
        self.lpips_params.update(jlp.lpips_lins_init(jax.random.PRNGKey(5)))
        self.jploss = jlp.make_perceptual_loss(
            jlp.PerceptualLossConfig(kind="lpips"))

        self.cfg = tstate.TrainConfig(
            g=tg.GeneratorConfig(**JAX_G), t=tstn.ComposedSTNConfig(**JAX_T),
            ll=tll.LatentLearnerConfig(**JAX_LL), **JAX_TRAIN)
        self.generator = tg.Generator(self.cfg.g)
        self.generator.load_state_dict(params_from_jax(self.g_params),
                                       strict=True)
        self.generator.requires_grad_(False)
        t = tstn.ComposedSTN(self.cfg.t)
        t.load_state_dict(params_from_jax(self.t_params), strict=True)
        ll = tll.LatentLearner(self.cfg.ll)
        ll.load_state_dict(params_from_jax(ll_params), strict=True)
        self.state = tstate.TrainState(self.cfg, t, ll)
        model = tlp.LPIPS(use_lins=True).eval().requires_grad_(False)
        model.load_state_dict(params_from_jax(self.lpips_params), strict=True)
        loss = tlp.make_perceptual_loss("lpips")
        self.perceptual_fn = lambda x, y: loss(model, x, y)

    def inputs(self, seed):
        """z and the noise of both generator passes."""
        rng = np.random.RandomState(seed)
        n = JAX_TRAIN["batch"]
        z = rng.randn(n, JAX_G["style_dim"]).astype(np.float32)
        noise = [[rng.randn(*s).astype(np.float32)
                  for s in self.cfg.g.noise_shapes(n)] for _ in range(2)]
        return z, noise

    def jax_sampler(self, noise):
        """JAX's pair source on the given noise; the PCA buffers are
        buffers in the port, so their gradient stops here."""
        g_params, jcfg = self.g_params, self.jcfg
        noise_u, noise_a = [[jnp.asarray(x) for x in ns] for ns in noise]

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


def test_config_f_matches_jax():
    """The generator at 1024 px and one full-res LPIPS train step with 512
    directions at latent 6, the port against the JAX package."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs several test processes
    try:
        s = JaxPair()
        z, noise = s.inputs(7)
        ref_img, ref_lat = jsg.generator_apply(
            s.g_params, s.jcfg.g, [jnp.asarray(z)],
            noise=[jnp.asarray(n) for n in noise[0]], return_latents=True)
        with torch.no_grad():
            img, lat = s.generator(
                [torch.from_numpy(z)],
                noise=[torch.from_numpy(n) for n in noise[0]],
                return_latents=True)
        assert img.shape == (2, 3, 1024, 1024) and lat.shape[1] == 18
        for ours, ref in ((img, ref_img), (lat, ref_lat)):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       atol=IMAGE_ATOL, rtol=0)

        step = jstate.make_train_step(s.jcfg, s.g_params, s.lpips_params,
                                      s.jploss, donate=False,
                                      pair_sampler=s.jax_sampler(noise))
        jst = jstate.init_train_state(jnp_tree(s.t_params),
                                      jnp_tree(s.ll_params))
        jst, terms = step(jst, jnp.asarray(z), jax.random.PRNGKey(0),
                          jnp.float32(PSI), jnp.float32(1e-3),
                          jnp.float32(1e-2))
        metrics = tstate.train_step(
            s.state, s.generator, s.perceptual_fn, torch.from_numpy(z), PSI,
            1e-3, 1e-2, noise=tuple([torch.from_numpy(n) for n in ns]
                                    for ns in noise))
    finally:
        torch.set_num_threads(saved)
    for k in ("p", "tv", "f"):
        np.testing.assert_allclose(float(metrics[k]), float(terms[k]),
                                   rtol=TERM_RTOL, atol=1e-12, err_msg=k)
    assert float(metrics["tv"]) > 0
    bad, ours, refs = {}, [], []
    for part, module in (("t", s.state.t), ("ll", s.state.ll)):
        mu = jst[f"{part}_opt"].mu
        names = dict(module.named_parameters())
        for name in tstate.learnable_key_order(module.state_dict()):
            g_ref = np.asarray(mu[name]) / 0.1  # Adam's first moment
            ours.append(names[name].grad.numpy().ravel())
            refs.append(g_ref.ravel())
            if rel_err(names[name].grad, g_ref) > GRAD_TOL:
                bad[name] = rel_err(names[name].grad, g_ref)
    assert not bad, bad
    g_ll = s.state.ll.coefficients.grad
    assert g_ll.shape == (1, 512) and float(g_ll.abs().max()) > 0
    ours, refs = np.concatenate(ours), np.concatenate(refs)
    assert np.linalg.norm(ours - refs) <= GRAD_L2_TOL * np.linalg.norm(refs)
