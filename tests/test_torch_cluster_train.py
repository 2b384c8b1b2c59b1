"""The port's clustered GANgealing training (cluster assignment, the
clustered loss, one train step, K-Means++, the cold start's coefficients
and one classifier training step) against the JAX package's, on the CPU.

The small configuration of ``test_torch_train_common`` (G 64 px, the STN at
flow_size 64, vgg_ssl, batch 2) with K heads, with and without flips: STN
weights from the JAX init plus 0.05 noise, so that the heads differ, and
seeded latent-learner coefficients, so that the K targets differ. z and
both generator passes' noise (the second at N*K images) come from numpy
and go to both packages; the JAX side samples its pairs through a
``pair_sampler`` that stops the gradient at the PCA buffers, as
``test_torch_train_common`` explains.

Tolerances: assignments, K-Means++ centroids, the classifier's labels,
accuracies and counts exactly, on inputs whose two least distances differ
by at least 1e-4 relative (the distances agree within 1e-6); distances and
loss terms 1e-5 relative; the assigned residual flow 1e-5. Gradients of
the clustered step: each tensor within 2e-2 of its largest JAX value and
all of them together within 2e-3 in relative L2 norm. The loss is
piecewise smooth, and a unit within float32 rounding of a kink takes one
side in one framework and the other in the other
(tests/test_torch_train_grads.py); a clustered step runs 2NK streams
through the STN, four to eight times the unimodal step's. Over z seeds 6
to 13, at K = 2 with flips and K = 4 without, the worst tensor read 4e-6
to 8.6e-3 (mostly in the similarity STN's encoder) and the L2 norm 2e-6
to 1.8e-3, at border padding as at reflection; the gates are those of the
smoke's card-against-CPU step (chip_smoke.py, TRAIN_GRAD_TOL) with the L2
gate over that spread. Adam's moments after the step within 1e-2 (first)
and 2e-2 (second) of the largest, as tests/test_torch_train_steps.py; the
PCA codes against the JAX package's ``PCA.encode`` on its own components
1e-5, and on the port's components within what their 2e-3 tolerance
(tests/test_torch_perceptual.py) allows a code of that size. The
classifier step: cross-entropy 1e-5 relative, gradients within 1e-3 of
each tensor's largest (the classifier has no kinks but its leaky ReLUs'),
parameters within 1e-3 of the step's size lr, or else within 2 lr where
the gradient is under 1e-2 of its tensor's largest.
"""

import dataclasses
from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gangealing_torch.io import params_from_jax
from gangealing_torch.models import classifier as tcls
from gangealing_torch.models import latent_learner as tll
from gangealing_torch.models import lpips as tlp
from gangealing_torch.models import stn as tstn
from gangealing_torch.models import stylegan2 as tg
from gangealing_torch.train import classifier_train as tct
from gangealing_torch.train import clustering as tclu
from gangealing_torch.train import loop as tloop
from gangealing_torch.train import losses as tlosses
from gangealing_torch.train import state as tstate

from test_torch_train_common import (  # noqa: F401
    G, LL, T, TRAIN, jlosses, jll, jlp, jsg, jstate, jstn, jnp_tree, perturb,
    rel_err, two_torch_threads)

jclu = import_module("gangealing_tpu.train.clustering")
jcls = import_module("gangealing_tpu.models.classifier")
jct = import_module("gangealing_tpu.train.classifier_train")

PSI = 0.7
GRAD_TOL, GRAD_L2_TOL, MU_TOL, NU_TOL = 2e-2, 2e-3, 1e-2, 2e-2
TIE_GAP = 1e-4


class ClusterSetup:
    """The training configuration with ``K`` heads (and ``flips``) on both
    sides, holding the same weights."""

    def __init__(self, K, flips):
        self.K, self.flips = K, flips
        ll_kw = dict(LL, num_heads=K)
        self.jcfg = jstate.TrainConfig(
            g=jsg.GeneratorConfig(**G),
            t=jstn.ComposedSTNConfig(**T, num_heads=K),
            ll=jll.LatentLearnerConfig(**ll_kw), flips=flips, **TRAIN)
        self.g_params = jsg.generator_init(jax.random.PRNGKey(0), self.jcfg.g)
        self.t_params = perturb(
            jstn.composed_stn_init(jax.random.PRNGKey(1), self.jcfg.t), 5)
        ll_params = {k: np.asarray(v) for k, v in jll.latent_learner_init(
            jax.random.PRNGKey(2), self.jcfg.ll).items()}
        ll_params["coefficients"] = np.random.RandomState(3).randn(
            K, LL["n_comps"]).astype(np.float32) * 2
        self.ll_params = ll_params
        self.vgg_params = jlp.vgg16_init(jax.random.PRNGKey(4))
        self.jploss = jlp.make_perceptual_loss(
            jlp.PerceptualLossConfig(kind="vgg_ssl"))

        self.cfg = tstate.TrainConfig(
            g=tg.GeneratorConfig(**G),
            t=tstn.ComposedSTNConfig(**T, num_heads=K),
            ll=tll.LatentLearnerConfig(**ll_kw), flips=flips, **TRAIN)
        self.generator = tg.Generator(self.cfg.g)
        self.generator.load_state_dict(params_from_jax(self.g_params),
                                       strict=True)
        self.generator.requires_grad_(False)
        self.t = tstn.ComposedSTN(self.cfg.t)
        self.t.load_state_dict(params_from_jax(self.t_params), strict=True)
        self.ll = tll.LatentLearner(self.cfg.ll)
        self.ll.load_state_dict(params_from_jax(ll_params), strict=True)
        vgg = tlp.LPIPS().eval().requires_grad_(False)
        vgg.load_state_dict(params_from_jax(self.vgg_params), strict=True)
        loss = tlp.make_perceptual_loss("vgg_ssl")
        self.perceptual_fn = lambda x, y: loss(vgg, x, y)
        self.jpfn = lambda x, y: self.jploss(self.vgg_params, x, y)

    def inputs(self, seed):
        """z and the noise of both generator passes, the second at N*K."""
        rng = np.random.RandomState(seed)
        n = TRAIN["batch"]
        z = rng.randn(n, G["style_dim"]).astype(np.float32)
        noise = [[rng.randn(*s).astype(np.float32)
                  for s in self.cfg.g.noise_shapes(b)]
                 for b in (n, n * self.K)]
        return z, noise

    def jax_sampler(self, noise):
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

    def torch_noise(self, noise):
        return tuple([torch.from_numpy(x) for x in ns] for ns in noise)


def _assert_no_near_tie(distances):
    d = np.sort(np.asarray(distances), axis=1)
    gap = (d[:, 1] - d[:, 0]) / np.abs(d[:, 0])
    assert gap.min() > TIE_GAP, gap


CASES = [(2, True), (4, False), (4, True)]


@pytest.mark.parametrize("K,flips", CASES)
def test_cluster_assignment_and_loss_match_jax(K, flips):
    s = ClusterSetup(K, flips)
    z, noise = s.inputs(6)
    kw = dict(sample_from_full_res=True, padding_mode="reflection")
    want = jlosses.assign_fake_images_to_clusters(
        s.g_params, s.jcfg.g, jnp_tree(s.t_params), s.jcfg.t,
        jnp_tree(s.ll_params), s.jcfg.ll, s.jpfn, jax.random.PRNGKey(0), PSI,
        2, K, flips, z=jnp.asarray(z), pair_sampler=s.jax_sampler(noise),
        **kw)
    loss_ref, flow_ref = jlosses.gangealing_cluster_loss(
        s.g_params, s.jcfg.g, jnp_tree(s.t_params), s.jcfg.t,
        jnp_tree(s.ll_params), s.jcfg.ll, s.jpfn, jax.random.PRNGKey(0), PSI,
        2, K, flips, z=jnp.asarray(z), pair_sampler=s.jax_sampler(noise),
        **kw)
    with torch.no_grad():
        args = (s.generator, s.t, s.ll, s.perceptual_fn, torch.from_numpy(z),
                PSI, K, flips)
        ours = tlosses.assign_fake_images_to_clusters(
            *args, noise=s.torch_noise(noise), **kw)
        loss, flow, idx = tlosses.gangealing_cluster_loss(
            *args, noise=s.torch_noise(noise), **kw)
    distances = np.asarray(want[6])
    assert distances.shape == (2, (1 + flips) * K)
    _assert_no_near_tie(distances)
    np.testing.assert_allclose(ours[6].numpy(), distances, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5)
    for o, w in zip(ours[4:6], want[4:6]):  # unaligned, resized
        np.testing.assert_allclose(o.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    assert flow.shape == (2, T["flow_size"], T["flow_size"], 2)
    np.testing.assert_allclose(flow.numpy(), np.asarray(flow_ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("K,flips", [(2, True), (4, False)])
def test_cluster_train_step_matches_jax(K, flips):
    """One clustered step, as the recipe trains (sample_from_full_res,
    reflection padding): loss terms, assignments, gradients and Adam's
    moments against make_train_step's."""
    s = ClusterSetup(K, flips)
    jcfg = dataclasses.replace(s.jcfg, sample_from_full_res=True,
                               padding_mode="reflection")
    cfg = dataclasses.replace(s.cfg, sample_from_full_res=True,
                              padding_mode="reflection")
    z, noise = s.inputs(7)
    sampler = s.jax_sampler(noise)
    idx_ref = jlosses.assign_fake_images_to_clusters(
        s.g_params, jcfg.g, jnp_tree(s.t_params), jcfg.t,
        jnp_tree(s.ll_params), jcfg.ll, s.jpfn, jax.random.PRNGKey(0), PSI,
        2, K, flips, z=jnp.asarray(z), pair_sampler=sampler,
        sample_from_full_res=True, padding_mode="reflection")
    _assert_no_near_tie(idx_ref[6])
    step = jstate.make_train_step(jcfg, s.g_params, s.vgg_params, s.jploss,
                                  donate=False, pair_sampler=sampler)
    jst = jstate.init_train_state(jnp_tree(s.t_params), jnp_tree(s.ll_params))
    jst, terms = step(jst, jnp.asarray(z), jax.random.PRNGKey(0),
                      jnp.float32(PSI), jnp.float32(1e-3), jnp.float32(1e-2))
    state = tstate.TrainState(cfg, s.t, s.ll)
    metrics = tstate.train_step(state, s.generator, s.perceptual_fn,
                                torch.from_numpy(z), PSI, 1e-3, 1e-2,
                                noise=s.torch_noise(noise))
    np.testing.assert_array_equal(metrics["assignments"].numpy(),
                                  np.asarray(idx_ref[1]))
    for k in ("p", "tv", "f"):
        np.testing.assert_allclose(float(metrics[k]), float(terms[k]),
                                   rtol=1e-5, atol=1e-12, err_msg=k)
    assert float(metrics["tv"]) > 0
    bad, ours, refs = {}, [], []
    for part, module, optim in (("t", state.t, state.t_optim),
                                ("ll", state.ll, state.ll_optim)):
        opt = jst[f"{part}_opt"]
        sd = optim.state_dict()["state"]
        names = dict(module.named_parameters())
        for i, name in enumerate(
                tstate.learnable_key_order(module.state_dict())):
            g_ref = np.asarray(opt.mu[name]) / 0.1
            ours.append(names[name].grad.numpy().ravel())
            refs.append(g_ref.ravel())
            errs = (rel_err(names[name].grad, g_ref) / GRAD_TOL,
                    rel_err(sd[i]["exp_avg"], opt.mu[name]) / MU_TOL,
                    rel_err(sd[i]["exp_avg_sq"], opt.nu[name]) / NU_TOL)
            if max(errs) > 1:
                bad[name] = errs
    assert not bad, bad
    ours, refs = np.concatenate(ours), np.concatenate(refs)
    assert np.linalg.norm(ours - refs) <= GRAD_L2_TOL * np.linalg.norm(refs)
    # the regularisers see the assigned flow, which the flow head's
    # gradient shows: every head's last conv moves
    w = state.t.stns[1].warp_head.flow_out[2].weight.grad
    assert float(w.abs().max()) > 0


def test_kmeans_pick_matches_jax():
    """The pick step fed the JAX function's own pool (its latents from
    k_w) and RandomState seed (from k_pick): the same centroids. G's noise
    weights are zero at init, so its images do not depend on the noise."""
    s = ClusterSetup(4, False)
    key = jax.random.PRNGKey(21)
    num_latent, batch_size, inject = 40, 16, 3
    want = jclu.kmeans_plusplus(s.g_params, s.jcfg.g, s.jpfn, 4, num_latent,
                                key, inject_index=inject,
                                batch_size=batch_size)
    k_w, _, k_pick = jax.random.split(key, 3)
    batch_w = torch.from_numpy(np.array(
        jsg.batch_latent(s.g_params, s.jcfg.g, k_w, num_latent)))
    seed = int(jax.random.randint(k_pick, (), 0, 2 ** 31 - 1))
    mean_w, fakes = tclu.kmeans_pool(s.generator, batch_w,
                                     torch.Generator().manual_seed(0),
                                     inject_index=inject,
                                     batch_size=batch_size)
    got = tclu.kmeans_pick(s.generator, s.perceptual_fn, batch_w, mean_w,
                           fakes, 4, np.random.RandomState(seed),
                           inject_index=inject, batch_size=batch_size,
                           rng=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len({tuple(r) for r in got.numpy()}) > 1
    # the whole function, on the port's own pool
    again = tclu.kmeans_plusplus(s.generator, s.perceptual_fn, 3, 24,
                                 torch.Generator().manual_seed(2),
                                 inject_index=inject, batch_size=batch_size)
    assert again.shape == (3, G["style_dim"])


def test_cold_start_coefficients():
    """The codes of the K centroids in the port's PCA against the JAX
    package's PCA.encode on the same pool; the cold start with --debug
    gives the first K latents of its pool those codes."""
    jpca = import_module("gangealing_tpu.models.latent_learner")
    rng = np.random.RandomState(4)
    basis, _ = np.linalg.qr(rng.randn(32, 32))
    scales = np.array([6.0, 4.0] + [1.0] * 30)
    ws = ((rng.randn(1000, 32) * scales) @ basis.T + rng.randn(32)).astype(
        np.float32)
    pca = jpca.PCA(2, ws)
    want = np.asarray(pca.encode(ws[:4]))
    same = tll.pca_encode(torch.from_numpy(ws[:4]),
                          torch.from_numpy(np.asarray(pca.components)),
                          torch.from_numpy(np.asarray(pca.mean)))
    np.testing.assert_allclose(same.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    comps, mean = tll.fit_pca(torch.from_numpy(ws), 2)
    ours = tll.pca_encode(torch.from_numpy(ws[:4]), comps, mean)
    reach = float(np.linalg.norm(ws[:4] - ws.mean(0), axis=1).max())
    np.testing.assert_allclose(ours.numpy(), want, rtol=0,
                               atol=2e-3 * np.sqrt(32) * reach)

    s = ClusterSetup(4, False)
    ll = tll.LatentLearner(s.cfg.ll)
    tloop.cold_start_ll(ll, s.generator, torch.Generator().manual_seed(9),
                        debug=True)
    with torch.no_grad():
        pool = s.generator.batch_latent(1000, torch.Generator().manual_seed(9))
    expect = tll.pca_encode(pool[:4], ll.directions, ll.lat_mean)
    torch.testing.assert_close(ll.coefficients.detach(), expect, rtol=0,
                               atol=1e-6)
    assert ll.coefficients.shape == (4, LL["n_comps"])


def test_classifier_train_step_matches_jax():
    """One step of the classifier trainer against make_classifier_train_step
    (flips, K = 2): the labels, cross-entropy, metrics, gradients and the
    parameters after the Adam step."""
    s = ClusterSetup(2, True)
    jcfg = dataclasses.replace(s.jcfg, sample_from_full_res=True)
    cfg = dataclasses.replace(s.cfg, sample_from_full_res=True)
    cls_cfg = jcls.ClassifierConfig(size=64, supersize=64,
                                    channel_multiplier=0.25, num_heads=4,
                                    max_channels=32)
    cls_params = jct.warm_start_from_stn(
        jcls.classifier_init(jax.random.PRNGKey(5), cls_cfg),
        jnp_tree(s.t_params))
    cls_params = {k: np.asarray(v) for k, v in cls_params.items()}
    z, _ = s.inputs(8)
    lr = 1e-3
    step = jct.make_classifier_train_step(
        jcfg, cls_cfg, s.g_params, jnp_tree(s.t_params),
        jnp_tree(s.ll_params), s.vgg_params, s.jploss)
    opt = jstate.adam().init(jnp_tree(cls_params))
    new_params, opt, jm = step(jnp_tree(cls_params), opt,
                               jax.random.PRNGKey(3), jnp.float32(lr),
                               jnp.asarray(z))
    labels = jlosses.assign_fake_images_to_clusters(
        s.g_params, jcfg.g, jnp_tree(s.t_params), jcfg.t,
        jnp_tree(s.ll_params), jcfg.ll, s.jpfn, jax.random.PRNGKey(3), 0.0,
        2, 2, True, freeze_ll=True, sample_from_full_res=True,
        z=jnp.asarray(z))
    _assert_no_near_tie(labels[6])

    classifier = tcls.Classifier(tcls.ClassifierConfig(**cls_cfg.__dict__))
    classifier.load_state_dict(params_from_jax(cls_params), strict=True)
    trainer = tct.ClassifierTrainer(cfg, classifier, s.generator,
                                    s.t.eval(), s.ll, s.perceptual_fn,
                                    cls_lr=lr)
    m = trainer.step(torch.from_numpy(z), lr,
                     rng=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(m["labels"].numpy(),
                                  np.asarray(labels[1]))
    np.testing.assert_allclose(float(m["cross_entropy"]),
                               float(jm["cross_entropy"]), rtol=1e-5)
    for k in ("acc@1", "acc@2", "gt_counts", "pred_counts"):
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]), k)
    names = tstate.learnable_key_order(classifier.state_dict())
    sd = trainer.optim.state_dict()["state"]
    for i, name in enumerate(names):
        g_ref = np.asarray(opt.mu[name]) / 0.1
        p = dict(classifier.named_parameters())[name]
        assert rel_err(p.grad, g_ref) <= 1e-3, name
        assert rel_err(sd[i]["exp_avg"], opt.mu[name]) <= 1e-3, name
        diff = np.abs(p.detach().numpy() - np.asarray(new_params[name]))
        small = np.abs(g_ref) < 1e-2 * np.abs(g_ref).max()
        slack = 2 * np.spacing(np.abs(np.asarray(new_params[name])))
        assert np.all(diff <= np.where(small, 2 * lr, 1e-3 * lr) + slack), \
            name
