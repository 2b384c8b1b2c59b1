"""The port's perceptual losses, latent learner, PCA and flow identity loss
against the JAX package's, on the CPU.

VGG16 runs on 64px inputs with the JAX package's random init carried over
through ``params_from_jax``. Tolerances, float32 on both sides: VGG features
atol 1e-4 relative to each map's largest value (13 convs summing in their
own order); ``lpips_distance`` in both kinds and the vgg_ssl / lpips losses
rtol 1e-5; the latent learner atol 1e-6; ``flow_identity_loss`` rtol 1e-6.
The PCA is held against the JAX package's scikit-learn ``IncrementalPCA``
on a seeded W pool: means atol 1e-6, directions atol 2e-3 (incremental PCA
is close to, not equal to, the exact PCA: on this pool the three
directions differ by 2.1e-4, 6.5e-4 and 1.7e-3).
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
from gangealing_torch.ops import flow as tflow

jlp = import_module("gangealing_tpu.models.lpips")
jll = import_module("gangealing_tpu.models.latent_learner")
jflow = import_module("gangealing_tpu.ops.flow")


def _vgg_pair(use_lins):
    params = jlp.vgg16_init(jax.random.PRNGKey(0))
    if use_lins:
        params.update(jlp.lpips_lins_init(jax.random.PRNGKey(1)))
    model = tlp.LPIPS(use_lins=use_lins).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    return params, model


def _images(seed, n=2, size=64):
    rng = np.random.RandomState(seed)
    return [np.tanh(rng.randn(n, 3, size, size)).astype(np.float32)
            for _ in range(2)]


def test_vgg_features():
    params, model = _vgg_pair(False)
    x, _ = _images(0)
    ref = jlp.vgg16_features(params, jnp.asarray(x))
    with torch.no_grad():
        ours = model.net(torch.from_numpy(x))
    assert len(ours) == 5
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r,
                                   atol=1e-4 * max(1.0, np.abs(r).max()),
                                   rtol=0)


@pytest.mark.parametrize("kind", ["vgg_ssl", "lpips"])
def test_perceptual_losses(kind):
    params, model = _vgg_pair(kind == "lpips")
    x, y = _images(1)
    jfn = jlp.make_perceptual_loss(jlp.PerceptualLossConfig(kind=kind))
    ref = jfn(params, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        ours = tlp.make_perceptual_loss(kind)(
            model, torch.from_numpy(x), torch.from_numpy(y))
        dist = tlp.lpips_distance(model, torch.from_numpy(x),
                                  torch.from_numpy(y))
    assert ours.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)
    jdist = jlp.lpips_distance(params, jnp.asarray(x), jnp.asarray(y),
                               use_lins=kind == "lpips")
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-5)


def test_import_torchvision_vgg():
    """torchvision names, bare nn.Sequential names and LPIPS names map as
    the JAX importer maps them."""
    rng = np.random.RandomState(2)
    sd = {"features.0.weight": rng.randn(64, 3, 3, 3).astype(np.float32),
          "features.28.bias": rng.randn(512).astype(np.float32),
          "5.weight": rng.randn(128, 64, 3, 3).astype(np.float32),
          "lin0.model.1.weight": rng.randn(1, 64, 1, 1).astype(np.float32),
          "classifier.0.weight": rng.randn(4, 4).astype(np.float32)}
    ref = jlp.import_torchvision_vgg({k: torch.from_numpy(v)
                                      for k, v in sd.items()})
    ours = tlp.import_torchvision_vgg({k: torch.from_numpy(v)
                                       for k, v in sd.items()})
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
    _, model = _vgg_pair(True)
    missing, unexpected = model.load_state_dict(ours, strict=False)
    assert not unexpected


@pytest.mark.parametrize("num_heads", [1, 2])
def test_latent_learner_interpolate(num_heads):
    jcfg = jll.LatentLearnerConfig(n_comps=3, inject_index=4, n_latent=10,
                                   num_heads=num_heads, style_dim=16)
    params = dict(jll.latent_learner_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(3)
    params["coefficients"] = rng.randn(num_heads, 3).astype(np.float32)
    ll = tll.LatentLearner(tll.LatentLearnerConfig(**jcfg.__dict__))
    ll.load_state_dict(params_from_jax(params), strict=True)
    assert [n for n, _ in ll.named_parameters()] == ["coefficients"]
    w = rng.randn(5, 16).astype(np.float32)
    ref = jll.latent_learner_interpolate(
        {k: jnp.asarray(v) for k, v in params.items()}, jcfg, jnp.asarray(w),
        0.3)
    with torch.no_grad():
        ours = ll(torch.from_numpy(w), 0.3)
    assert ours.shape == (5 * num_heads, 10, 16)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_pca_matches_incremental_pca():
    """A 2000-sample pool, 20 dims, with standard deviations 6, 4 and 3
    along three random directions and 1 along the rest: the top 3
    directions and the mean against IncrementalPCA, signs included."""
    rng = np.random.RandomState(4)
    basis, _ = np.linalg.qr(rng.randn(20, 20))
    scales = np.array([6.0, 4.0, 3.0] + [1.0] * 17)
    w = (rng.randn(2000, 20) * scales) @ basis.T + rng.randn(20)
    w = w.astype(np.float32)
    pca = jll.PCA(3, w)
    comps, mean = tll.fit_pca(torch.from_numpy(w), 3)
    np.testing.assert_allclose(mean.numpy(), np.asarray(pca.mean), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(comps.numpy(), np.asarray(pca.components),
                               atol=2e-3, rtol=0)
    ll = tll.LatentLearner(tll.LatentLearnerConfig(n_comps=3, style_dim=20))
    ll.assign_pca(comps, mean)
    assert torch.equal(ll.directions, comps)


def test_flow_identity_loss():
    df = np.random.RandomState(5).randn(2, 8, 8, 2).astype(np.float32)
    np.testing.assert_allclose(
        float(tflow.flow_identity_loss(torch.from_numpy(df))),
        float(jflow.flow_identity_loss(jnp.asarray(df))), rtol=1e-6)
