"""The port's cluster classifier and its helpers against the JAX package's,
on the CPU.

The classifier of tests/test_classifier.py (64 px, channel_multiplier 0.25,
max_channels 32) with K = 2 and 4 clusters, from the JAX init plus seeded
numpy noise of scale 0.05, carried into the port through
``params_from_jax``. Tolerances: logits within 1e-5 of the largest JAX
logit (at least 1); classes, flips and assignments equal, on inputs whose
two largest logits differ by at least 1e-3 of it, far above the logits'
difference; flipped and repeated inputs and warp policies exactly;
warm-started weights and reverse top-K accuracies exactly.
"""

from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gangealing_torch.io import params_from_jax
from gangealing_torch.models import classifier as tcls
from gangealing_torch.models import stn as tstn
from gangealing_torch.train import classifier_train as tct

jcls = import_module("gangealing_tpu.models.classifier")
jstn = import_module("gangealing_tpu.models.stn")
jct = import_module("gangealing_tpu.train.classifier_train")

S = 64
LOGIT_TOL = 1e-5
ARCH = dict(size=S, supersize=S, channel_multiplier=0.25, max_channels=32)


def cls_params(cfg, seed=0, scale=0.05):
    """JAX init of ``cfg`` plus seeded noise, as numpy."""
    p = jcls.classifier_init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.RandomState(seed + 1)
    return {k: np.asarray(v) + scale * rng.randn(*v.shape).astype(np.float32)
            for k, v in p.items()}


def cls_model(cfg, params):
    model = tcls.Classifier(tcls.ClassifierConfig(**cfg.__dict__))
    model.load_state_dict(params_from_jax(params), strict=True)
    return model.eval()


def images(seed, n, size=S):
    """Smooth images in [-1, 1] plus a little noise."""
    rng = np.random.RandomState(seed)
    low = rng.randn(n, 3, 8, 8).astype(np.float32)
    up = np.kron(low, np.ones((1, 1, size // 8, size // 8), np.float32))
    return np.tanh(2 * up + 0.1 * rng.randn(*up.shape).astype(np.float32))


def centred_params(cfg, params, xs, gain=10.0):
    """``params`` with the logits layer scaled by ``gain`` and its bias
    centring each logit's linear part over the images ``xs``, so that
    every class occurs among them."""
    p = dict(params)
    p["to_logits.weight"] = p["to_logits.weight"] * gain
    model = cls_model(cfg, p)
    with torch.no_grad():
        feats = model.final_conv(model.convs(torch.from_numpy(xs))).flatten(1)
        lin = torch.nn.functional.linear(
            feats, model.to_logits.weight * model.to_logits.scale)
    p["to_logits.bias"] = (-lin.mean(0)).numpy()
    return p


def _top2_gap(logits):
    top = np.sort(np.asarray(logits), axis=1)[:, -2:]
    return float((top[:, 1] - top[:, 0]).min())


def _jnp(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("num_heads", [4, 8])
def test_classifier_and_helpers_match_jax(num_heads):
    cfg = jcls.ClassifierConfig(num_heads=num_heads, **ARCH)
    params = cls_params(cfg, seed=num_heads)
    model = cls_model(cfg, params)
    jp = _jnp(params)
    x = images(3, 6)
    ref = np.asarray(jcls.classifier_forward(jp, cfg, jnp.asarray(x)))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        logits = model(xt).numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(logits, ref, atol=LOGIT_TOL * scale,
                                   rtol=0)
        assert _top2_gap(ref) > 1e-3 * scale
        for ignore in (False, True):
            np.testing.assert_array_equal(
                tcls.classifier_assign(model, xt, ignore_flips=ignore),
                np.asarray(jcls.classifier_assign(jp, cfg, jnp.asarray(x),
                                                  ignore_flips=ignore)))
        ours = tcls.classifier_run_flip(model, xt)
        want = jcls.classifier_run_flip(jp, cfg, jnp.asarray(x))
        np.testing.assert_array_equal(ours[0].numpy(), np.asarray(want[0]))
        for o, w in zip(ours[2:], want[2:]):
            np.testing.assert_array_equal(o.numpy(), np.asarray(w))
        k = num_heads // 2
        for target in range(k):
            pair = ref[:, [target, target + k]]
            assert float(np.abs(pair[:, 0] - pair[:, 1]).min()) > 1e-3 * scale
            ours = tcls.classifier_run_flip_target(model, xt, target)
            want = jcls.classifier_run_flip_target(jp, cfg, jnp.asarray(x),
                                                   target)
            for o, w in zip(ours, want):
                np.testing.assert_array_equal(o.numpy(), np.asarray(w))
        ours = tcls.classifier_run_flip_cartesian(model, xt)
        want = jcls.classifier_run_flip_cartesian(jp, cfg, jnp.asarray(x))
        for o, w in zip(ours, want):
            np.testing.assert_array_equal(o.numpy(), np.asarray(w))
    flips = np.asarray(want[0]).reshape(6, k, 3, S, S)
    # both orientations occur among the cartesian copies
    assert any((flips[:, j] != x).any() for j in range(k))


def test_classifier_supersize_downsample_matches_jax():
    """An input twice ``size`` wide is bilinearly halved first."""
    cfg = jcls.ClassifierConfig(num_heads=4, **{**ARCH, "supersize": 2 * S})
    params = cls_params(cfg, seed=7)
    x = images(8, 3, size=2 * S)
    ref = np.asarray(jcls.classifier_forward(_jnp(params), cfg,
                                             jnp.asarray(x)))
    with torch.no_grad():
        ours = cls_model(cfg, params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        ours, ref, atol=LOGIT_TOL * max(1.0, float(np.abs(ref).max())),
        rtol=0)


def test_classifier_state_dict_is_the_jax_schema():
    cfg = jcls.ClassifierConfig(num_heads=8, size=128, supersize=256)
    jkeys = set(jcls.classifier_init(jax.random.PRNGKey(0), cfg))
    ours = tcls.Classifier(tcls.ClassifierConfig(**cfg.__dict__))
    assert set(ours.state_dict()) == jkeys
    for k, v in ours.state_dict().items():
        assert v.shape == tuple(jcls.classifier_init(
            jax.random.PRNGKey(0), cfg)[k].shape), k


@pytest.mark.parametrize("bare", [False, True])
def test_warm_start_from_stn_matches_jax(bare):
    """The similarity STN's weights of the same name and shape are copied,
    from a ComposedSTN's ``stns.0.`` entries or a bare STN's; the rest
    keep the classifier's own init."""
    t_cfg = jstn.ComposedSTNConfig(
        transforms=("similarity", "flow"), flow_size=S, supersize=S,
        channel_multiplier=0.25, flow_downsample=4, max_channels=32,
        num_heads=2)
    t_params = {k: np.asarray(v) for k, v in
                jstn.composed_stn_init(jax.random.PRNGKey(1), t_cfg).items()}
    if bare:
        t_params = {k[len("stns.0."):]: v for k, v in t_params.items()
                    if k.startswith("stns.0.")}
    cfg = jcls.ClassifierConfig(num_heads=4, **ARCH)
    params = cls_params(cfg, seed=2)
    want = jct.warm_start_from_stn(_jnp(params), _jnp(t_params))
    model = cls_model(cfg, params)
    copied = tct.warm_start_from_stn(model, params_from_jax(t_params))
    assert "convs.0.0.weight" in copied and "to_logits.weight" not in copied
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), k)
        assert (k in copied) == (not np.array_equal(np.asarray(want[k]),
                                                    params[k])), k


@pytest.mark.parametrize("k", [1, 2, 3])
def test_reverse_topk_accuracy_matches_jax(k):
    rng = np.random.RandomState(k)
    distances = rng.rand(64, 8).astype(np.float32)
    distances[::7, 3] = distances[::7, 5]  # ties go to the lower index
    logits = rng.randn(64, 8).astype(np.float32)
    ours = tcls.reverse_topk_accuracy(torch.from_numpy(distances),
                                      torch.from_numpy(logits), k=k)
    want = jcls.reverse_topk_accuracy(jnp.asarray(distances),
                                      jnp.asarray(logits), k=k)
    assert float(ours) == float(want)
    d = torch.tensor([[0.1, 0.5, 0.9], [0.9, 0.1, 0.5]])
    lg = torch.tensor([[10.0, 0.0, 0.0], [0.0, 0.0, 10.0]])
    assert float(tcls.reverse_topk_accuracy(d, lg, k=1)) == 0.5
    assert float(tcls.reverse_topk_accuracy(d, lg, k=2)) == 1.0


def test_classifier_config_of_a_composed_stn():
    """load_stn's and the classifier CLI's rule: the STN's input size and
    widths, two logits a head."""
    t_cfg = tstn.ComposedSTNConfig(flow_size=64, channel_multiplier=0.25,
                                   num_heads=3, max_channels=32)
    assert tcls.classifier_config(t_cfg, 128) == tcls.ClassifierConfig(
        size=64, supersize=128, channel_multiplier=0.25, num_heads=6,
        max_channels=32)
