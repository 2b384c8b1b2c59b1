"""The port's apps and CLIs with a clustering model against the JAX
package's, on the CPU: flip and cluster inference by the classifier,
object propagation, propagate_to_images, the AR app with its
cluster-activity video, the training CLI with ``--num_heads`` and
``--flips`` followed by the classifier CLI, and classifier checkpoints
carried both ways.

The STN is tests/test_torch_ar.py's (S=64, channel_multiplier 0.25,
flow_downsample 4, max_channels 32) with K = 2 heads, the JAX init plus
noise of scale 0.2; the classifier is tests/test_torch_classifier.py's
with 2K = 4 logits. Tolerances are tests/test_torch_ar.py's and
tests/test_torch_ar_apps.py's: flips, clusters and warp policies exactly;
points within 1e-3 px, congealed images within 5e-4, splats within 1e-4,
propagated images within 1e-3; the cluster-activity frames, uint8 grids of
splatted averages, within one step of 8 bits (a splat within 1e-4 of
JAX's rounds to the other side of a step now and then).
"""

import argparse
import dataclasses
import os
from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gangealing_torch.apps import common as tcommon
from gangealing_torch.apps import mixed_reality as tmr
from gangealing_torch.apps import propagate_to_images as tprop
from gangealing_torch.cli import train as ttrain_cli
from gangealing_torch.cli import train_cluster_classifier as tcls_cli
from gangealing_torch.io import params_from_jax
from gangealing_torch.models import classifier as tcls
from gangealing_torch.models import stn as tstn
from gangealing_torch.models import stylegan2 as tg

from test_torch_ar import ARCH, ar_images, label_png
from test_torch_classifier import centred_params, cls_model, cls_params
from test_torch_train_common import two_torch_threads  # noqa: F401

jstn = import_module("gangealing_tpu.models.stn")
jcommon = import_module("gangealing_tpu.apps.common")
jcls = import_module("gangealing_tpu.models.classifier")
jmr = import_module("gangealing_tpu.apps.mixed_reality")
jprop = import_module("gangealing_tpu.apps.propagate_to_images")

S, K = 64, 2
ARCH_K = dict(ARCH, num_heads=K)
JCFG = jstn.ComposedSTNConfig(**ARCH_K)
CLS_CFG = jcls.ClassifierConfig(size=S, supersize=S, channel_multiplier=0.25,
                                num_heads=2 * K, max_channels=32)
PT_TOL, OUT_TOL, SPLAT_TOL, PROP_TOL = 1e-3, 5e-4, 1e-4, 1e-3


@pytest.fixture(scope="module")
def params():
    p = jstn.composed_stn_init(jax.random.PRNGKey(0), JCFG)
    rng = np.random.RandomState(1)
    return {k: np.asarray(v) + 0.2 * rng.randn(*v.shape).astype(np.float32)
            for k, v in p.items()}


@pytest.fixture(scope="module")
def cparams():
    """The classifier's JAX init plus noise, centred on the test images
    so that every class occurs among them."""
    xs = np.concatenate([ar_images(seed, 8)
                         for seed in (21, 22, 24, 26, 27)])
    return centred_params(CLS_CFG, cls_params(CLS_CFG, seed=11), xs)


@pytest.fixture(scope="module")
def model(params):
    m = tstn.ComposedSTN(tstn.ComposedSTNConfig(**ARCH_K))
    m.load_state_dict(params_from_jax(params), strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def classifier(cparams):
    return cls_model(CLS_CFG, cparams)


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _close(ours, ref, atol):
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("cluster", [None, 0, 1])
def test_determine_flips_with_a_classifier_matches_jax(params, cparams, model,
                                                       classifier, cluster):
    imgs = ar_images(21, 8)
    ref = jcommon.determine_flips(_j(params), JCFG, jnp.asarray(imgs),
                                  classifier_params=_j(cparams),
                                  classifier_cfg=CLS_CFG, cluster=cluster)
    with torch.no_grad():
        ours = tcommon.determine_flips(model, torch.from_numpy(imgs),
                                       classifier=classifier, cluster=cluster)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    flips = np.asarray(ref[1]).ravel()
    assert 0 < flips.sum() < len(flips)
    if cluster is None:
        assert len(set(np.asarray(ref[3]).tolist())) == K


def test_composed_propagate_object_with_a_classifier_matches_jax(
        params, cparams, model, classifier):
    imgs = ar_images(22, 4)
    rng = np.random.RandomState(23)
    pts = rng.uniform(-1.05, 1.05, (4, 120, 2)).astype(np.float32)
    vals = rng.uniform(-1, 1, (4, 120, 3)).astype(np.float32)
    masks = rng.uniform(0.5, 1, (4, 120, 1)).astype(np.float32)
    sigma = np.array([1.2, 1.5, 1.2, 1.5], np.float32)
    for cluster in range(K):
        ref = jstn.composed_propagate_object(
            _j(params), JCFG, *map(jnp.asarray, (pts, vals, masks, imgs,
                                                 sigma)),
            classifier=(_j(cparams), CLS_CFG), cluster=cluster, max_sigma=1.5)
        with torch.no_grad():
            ours = tstn.composed_propagate_object(
                model, *map(torch.from_numpy, (pts, vals, masks, imgs,
                                               sigma)),
                classifier=classifier, cluster=cluster, max_sigma=1.5)
        for o, r in zip(ours, ref):
            _close(o, r, SPLAT_TOL)
    with pytest.raises(ValueError, match="cluster classifier"):
        tstn.composed_propagate_object(
            model, *map(torch.from_numpy, (pts, vals, masks, imgs, sigma)))


@pytest.mark.parametrize("cluster", [None, 1])
def test_propagate_to_images_with_a_classifier_matches_jax(
        tmp_path, params, cparams, model, classifier, cluster):
    label = label_png(tmp_path / "label.png")
    imgs = ar_images(24, 4)
    kw = dict(label_path=label, batch=2, sigma=1.3, opacity=0.75,
              objects=True, resolution=S, cluster=cluster)
    ref = jprop.propagate_to_images(_j(params), JCFG, imgs,
                                    classifier=(_j(cparams), CLS_CFG), **kw)
    ours = tprop.propagate_to_images(model, imgs, classifier=classifier,
                                     out_dir=str(tmp_path / "vis"), **kw)
    assert set(ours) == set(ref)
    assert ours["congealed"].shape == (4, 3, S, S)
    _close(ours["congealed"], ref["congealed"], OUT_TOL)
    _close(ours["average_congealed"], ref["average_congealed"], OUT_TOL)
    _close(ours["propagated"], ref["propagated"], PROP_TOL)
    with pytest.raises(ValueError, match="cluster classifier"):
        tprop.propagate_to_images(model, imgs)


def _averages(tmp_path):
    """Two average congealed images, ...cluster0.png and ...cluster1.png."""
    from PIL import Image
    rng = np.random.RandomState(25)
    for k in range(K):
        Image.fromarray(rng.randint(0, 256, (S, S, 3), np.uint8)).save(
            tmp_path / f"avg_cluster{k}.png")
    return str(tmp_path / "avg_cluster0.png")


def test_run_gangealing_on_video_with_a_classifier_matches_jax(
        tmp_path, params, cparams, model, classifier):
    """The AR app with the classifier and the cluster-activity video."""
    label = label_png(tmp_path / "label.png")
    average = _averages(tmp_path)
    frames = ar_images(26, 6)
    kw = dict(label_path=label, batch=4, sigma=1.2, resolution=S,
              save_correspondences=True, average_path=average)
    ref = jmr.run_gangealing_on_video(
        _j(params), JCFG, frames, classifier=(_j(cparams), CLS_CFG), **kw)
    out = tmp_path / "mr"
    ours = tmr.run_gangealing_on_video(model, frames, classifier=classifier,
                                       out_dir=str(out), **kw)
    assert set(ours) == set(ref) == {"propagated", "congealed",
                                     "correspondences", "average_frames"}
    _close(ours["correspondences"], ref["correspondences"], PT_TOL)
    _close(ours["congealed"], ref["congealed"], OUT_TOL)
    _close(ours["propagated"], ref["propagated"], PROP_TOL)
    assert len(ours["average_frames"]) == len(frames)
    for o, r in zip(ours["average_frames"], ref["average_frames"]):
        assert o.dtype == np.uint8 and o.shape == r.shape
        assert np.abs(o.astype(int) - r.astype(int)).max() <= 1
    # both clusters are active in some frame: the frames differ
    assert len({o.tobytes() for o in ours["average_frames"]}) == K
    for name in ("propagated.mp4", "congealed.mp4", "average.mp4",
                 "correspondences.pt"):
        assert os.path.getsize(out / name) > 0


def _cli_argv(tmp, iters, *extra):
    return ["--exp-name", "cars", "--results", str(tmp / "results"),
            "--gen_size", "64", "--real_size", "64", "--flow_size", "64",
            "--dim_latent", "32", "--n_mlp", "2", "--batch", "2",
            "--iter", str(iters), "--anneal_psi", "2", "--period", "1",
            "--ndirs", "2", "--inject", "3", "--debug", "--log_every", "1",
            "--ckpt_every", "2", "--vis_every", "0", "--num_heads", "2",
            "--flips", "--sample_from_full_res", "--padding_mode",
            "reflection", "--stn_channel_multiplier", "0.25", "--device",
            "cpu", *extra]


@pytest.fixture
def small_widths(monkeypatch):
    """The flags carry no channel cap; these small architectures have
    one (32 channels), as the JAX package's small tests do."""
    build = ttrain_cli.build_configs

    def capped(args):
        cfg = build(args)
        return dataclasses.replace(
            cfg, g=dataclasses.replace(cfg.g, max_channels=32),
            t=dataclasses.replace(cfg.t, max_channels=32))
    monkeypatch.setattr(ttrain_cli, "build_configs", capped)
    stn_cfg = tcommon.stn_config_from_args
    monkeypatch.setattr(tcommon, "stn_config_from_args",
                        lambda a, supersize=None: dataclasses.replace(
                            stn_cfg(a, supersize), max_channels=32))


def test_train_and_classifier_clis(tmp_path, small_widths):
    """cli.train with --num_heads 2 --flips (the cars recipe's options) for
    2 iterations, then cli.train_cluster_classifier on its checkpoint for
    2: the classifier starts from the similarity STN's encoder, its
    checkpoint is the GANgealing one plus ``classifier``, and it loads
    through load_stn(load_classifier=True) in the port and in the JAX
    package, with the same weights."""
    args = ttrain_cli.training_argparse().parse_args(
        _cli_argv(tmp_path, 2, "--ckpt", "g.pt", "--load_G_only"))
    g = tg.Generator(ttrain_cli.build_configs(args).g,
                     generator=torch.Generator().manual_seed(0))
    torch.save({"g_ema": g.state_dict()}, tmp_path / "g.pt")
    state, _, _, _ = ttrain_cli.main(_cli_argv(
        tmp_path, 2, "--ckpt", str(tmp_path / "g.pt"), "--load_G_only"))
    assert state.cfg.t.num_heads == 2 and state.cfg.flips
    assert state.ll.coefficients.shape == (2, 2)
    assert float(state.ll.coefficients.detach().abs().max()) > 0
    ckpt = str(tmp_path / "results" / "cars" / "checkpoints" / "0000002.pt")
    assert torch.load(ckpt, weights_only=False)["args"].vis_batch_size == 125

    classifier, metrics = tcls_cli.main(_cli_argv(
        tmp_path, 2, "--ckpt", ckpt, "--exp-name", "cls"))
    assert classifier.cfg == tcls.ClassifierConfig(
        size=64, supersize=64, channel_multiplier=0.25, num_heads=4,
        max_channels=32)
    assert np.isfinite(float(metrics["cross_entropy"]))
    assert float(metrics["gt_counts"].sum()) == pytest.approx(1.0)
    out = tmp_path / "results" / "cls" / "checkpoints" / "classifier.pt"
    saved = torch.load(out, weights_only=False)
    assert set(saved) == set(torch.load(ckpt, weights_only=False)) | {
        "classifier"}
    model, cfg, loaded = tcommon.load_stn(str(out), supersize=64,
                                          device="cpu", load_classifier=True)
    assert cfg.num_heads == 2
    for k, v in classifier.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    _, jcfg, jc, jc_cfg = jcommon.load_stn(str(out), supersize=64,
                                           load_classifier=True)
    assert jc_cfg.num_heads == 4 and jcfg.num_heads == 2
    assert set(jc) == set(classifier.state_dict())
    for k, v in classifier.state_dict().items():
        np.testing.assert_array_equal(np.asarray(jc[k]), v.numpy(), k)
    # a second run resumes from the classifier entry
    again, _ = tcls_cli.main(_cli_argv(tmp_path, 1, "--ckpt", str(out),
                                       "--exp-name", "cls2"))
    assert any(not torch.equal(a, b) for a, b in zip(
        again.state_dict().values(), classifier.state_dict().values()))


def test_a_jax_classifier_checkpoint_loads_in_the_port(tmp_path, params,
                                                       cparams, monkeypatch):
    """A checkpoint as the JAX package's classifier CLI writes it (the
    GANgealing checkpoint's entries plus ``classifier`` as torch tensors)
    loads through the port's load_stn(load_classifier=True); the classifier
    gives the JAX classifier's logits. Without the entry it gives None."""
    args = argparse.Namespace(transform=list(ARCH["transforms"]),
                              flow_size=S, stn_channel_multiplier=0.25,
                              num_heads=K, real_size=S, flow_downsample=4)
    ckpt = {"t_ema": {k: torch.from_numpy(v) for k, v in params.items()},
            "args": args}
    torch.save(ckpt, tmp_path / "stn.pt")
    torch.save({**ckpt, "classifier": {k: torch.from_numpy(np.asarray(v))
                                       for k, v in cparams.items()}},
               tmp_path / "classifier.pt")
    stn_cfg = tcommon.stn_config_from_args
    monkeypatch.setattr(tcommon, "stn_config_from_args",
                        lambda a, supersize=None: dataclasses.replace(
                            stn_cfg(a, supersize), max_channels=32))
    _, cfg, classifier = tcommon.load_stn(
        str(tmp_path / "classifier.pt"), supersize=S, device="cpu",
        load_classifier=True)
    assert cfg.num_heads == K and classifier.cfg.num_heads == 2 * K
    assert not classifier.training
    assert tcommon.load_stn(str(tmp_path / "stn.pt"), supersize=S,
                            device="cpu", load_classifier=True)[2] is None
    x = ar_images(27, 3)
    ref = jcls.classifier_forward(_j(cparams), CLS_CFG, jnp.asarray(x))
    with torch.no_grad():
        got = classifier(torch.from_numpy(x))
    _close(got, ref, 1e-5 * max(1.0, float(np.abs(np.asarray(ref)).max())))
