"""The port's AR point functions, flip inference, splatting and blending
against the JAX package's, on the CPU.

The STN is the configuration of tests/test_ar_apps.py (S=64,
channel_multiplier 0.25, flow_downsample 4, max_channels 32): the JAX init
plus seeded numpy noise of scale 0.2, so that both heads warp and mirrored
inputs give flows of clearly different smoothness, carried into the port
through ``params_from_jax``. Tolerances: uncongealed points within 1e-3 px
(the grid agrees within 1e-4 in [-1, 1] units, GRID_TOL of
tests/test_torch_stn.py, and its sample carries that); congealed images
within 5e-4 (OUT_TOL there); flip decisions identical, on inputs whose
smoothness gap is at least 1e-3 relative, far above the 1e-6 relative
difference of the two flows; splat_points within 1e-4, the Laplacian blend
and the border extension within 1e-5 (the same f32 arithmetic in another
summation order); labels exactly.
"""

from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gangealing_torch import LAUNCHES
from gangealing_torch.apps import common as tcommon
from gangealing_torch.io import params_from_jax
from gangealing_torch.models import stn as tstn
from gangealing_torch.ops.flow import total_variation_loss
from gangealing_torch.utils import laplacian as tlap
from gangealing_torch.utils import vis as tvis

jstn = import_module("gangealing_tpu.models.stn")
jcommon = import_module("gangealing_tpu.apps.common")
jlap = import_module("gangealing_tpu.utils.laplacian")
jvis = import_module("gangealing_tpu.utils.vis")

S = 64
ARCH = dict(transforms=("similarity", "flow"), flow_size=S, supersize=S,
            channel_multiplier=0.25, flow_downsample=4, max_channels=32)
PT_TOL, OUT_TOL, SPLAT_TOL, BLEND_TOL = 1e-3, 5e-4, 1e-4, 1e-5


def ar_params(seed=1, scale=0.2):
    """JAX init of the test architecture plus seeded noise, as numpy."""
    p = jstn.composed_stn_init(jax.random.PRNGKey(0),
                               jstn.ComposedSTNConfig(**ARCH))
    rng = np.random.RandomState(seed)
    return {k: np.asarray(v) + scale * rng.randn(*v.shape).astype(np.float32)
            for k, v in p.items()}


def ar_model(params):
    model = tstn.ComposedSTN(tstn.ComposedSTNConfig(**ARCH))
    model.load_state_dict(params_from_jax(params), strict=True)
    return model.eval()


def ar_images(seed, n):
    """Smooth images in [-1, 1]: tanh of upsampled 8x8 noise."""
    low = np.random.RandomState(seed).randn(n, 3, 8, 8).astype(np.float32)
    return np.tanh(2 * np.kron(low, np.ones((1, 1, S // 8, S // 8),
                                            np.float32)))


def label_png(path, size=S):
    """A dense RGBA label: an opaque disc with smoothly varying colors and
    a half-transparent rim."""
    from PIL import Image
    yy, xx = np.mgrid[:size, :size]
    r = np.hypot(xx - size / 2 + 3, yy - size / 2 + 2)
    rgba = np.zeros((size, size, 4), np.uint8)
    rgba[..., 0] = 255 * xx // size
    rgba[..., 1] = 255 * yy // size
    rgba[..., 2] = 128
    rgba[..., 3] = np.where(r < size / 5, 255, np.where(r < size / 4, 128,
                                                        0))
    Image.fromarray(rgba).save(path)
    return str(path)


@pytest.fixture(scope="module")
def params():
    return ar_params()


@pytest.fixture(scope="module")
def jparams(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def model(params):
    return ar_model(params)


JCFG = jstn.ComposedSTNConfig(**ARCH)


def _close(ours, ref, atol):
    np.testing.assert_allclose(
        ours.detach().numpy() if torch.is_tensor(ours) else ours,
        np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("fn", ["normalize_points", "unnormalize_points",
                                "convert_points"])
def test_point_conversions_match_jax(fn):
    pts = np.random.RandomState(0).rand(2, 30, 2).astype(np.float32) * 63
    ref = getattr(jstn, fn)(jnp.asarray(pts), 64, 128)
    _close(getattr(tstn, fn)(torch.from_numpy(pts), 64, 128), ref, 1e-5)


def test_sample_grid_at_points_matches_jax():
    rng = np.random.RandomState(1)
    grid = rng.uniform(-1.2, 1.2, (2, 16, 16, 2)).astype(np.float32)
    pts = rng.uniform(-1.1, 1.1, (2, 50, 2)).astype(np.float32)
    ref = jstn.sample_grid_at_points(jnp.asarray(grid), jnp.asarray(pts))
    _close(tstn.sample_grid_at_points(torch.from_numpy(grid),
                                      torch.from_numpy(pts)), ref, 1e-6)


def test_composed_uncongeal_points_matches_jax(jparams, model):
    imgs = ar_images(2, 2)
    pts = np.random.RandomState(3).rand(2, 80, 2).astype(np.float32) * 63
    ref, ref_img = jstn.composed_uncongeal_points(
        jparams, JCFG, jnp.asarray(imgs), jnp.asarray(pts),
        normalize_input_points=True, return_congealed_img=True,
        padding_mode="border")
    with torch.no_grad():
        ours, img = tstn.composed_uncongeal_points(
            model, torch.from_numpy(imgs), torch.from_numpy(pts),
            normalize_input_points=True, return_congealed_img=True,
            padding_mode="border")
    _close(ours, ref, PT_TOL)
    _close(img, ref_img, OUT_TOL)


def _tv_gap(model, imgs):
    x = torch.from_numpy(imgs)
    with torch.no_grad():
        flow = model(torch.cat([x, x.flip(3)]))[2]
    tv = total_variation_loss(flow, reduce_batch=False)
    n = imgs.shape[0]
    return ((tv[:n] - tv[n:]).abs() / tv[:n]).min()


def test_forward_with_flip_matches_jax(jparams, model):
    imgs = ar_images(4, 6)
    assert _tv_gap(model, imgs) >= 1e-3  # far from a tie
    ref = jstn.composed_forward_with_flip(
        jparams, JCFG, jnp.asarray(imgs), return_flow=True, return_warp=True,
        return_inputs=True, return_flip_indices=True)
    with torch.no_grad():
        ours = tstn.composed_forward_with_flip(
            model, torch.from_numpy(imgs), return_flow=True,
            return_warp=True, return_inputs=True, return_flip_indices=True)
    flips = np.asarray(ref[-1]).ravel()
    assert 0 < flips.sum() < len(flips)  # both decisions occur
    np.testing.assert_array_equal(ours[-1].numpy().ravel(), flips)
    _close(ours[0], ref[0], OUT_TOL)
    for o, r in zip(ours[1:3], ref[1:3]):  # warp, flow
        _close(o, r, 1e-4)
    _close(ours[3], ref[3], 0)


@pytest.mark.parametrize("no_flip_inference", [False, True])
def test_determine_flips_matches_jax(jparams, model, no_flip_inference):
    imgs = ar_images(4, 6)
    ref = jcommon.determine_flips(jparams, JCFG, jnp.asarray(imgs),
                                  no_flip_inference=no_flip_inference)
    with torch.no_grad():
        ours = tcommon.determine_flips(model, torch.from_numpy(imgs),
                                       no_flip_inference=no_flip_inference)
    _close(ours[0], ref[0], 0)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    assert ours[2] == ref[2] == "cartesian"
    np.testing.assert_array_equal(ours[3].numpy(), np.asarray(ref[3]))


def test_determine_flips_refuses_a_classifier(jparams, model):
    """With a cluster classifier (one cluster, two logits) the classifier
    decides the flips and the warp policy is one-hot, as in the JAX
    package; the model's own flip inference is not run."""
    from test_torch_classifier import centred_params, cls_model, cls_params
    jcls = import_module("gangealing_tpu.models.classifier")
    cfg = jcls.ClassifierConfig(size=S, supersize=S, channel_multiplier=0.25,
                                num_heads=2, max_channels=32)
    imgs = ar_images(4, 6)
    cparams = centred_params(cfg, cls_params(cfg, seed=3), imgs)
    ref = jcommon.determine_flips(
        jparams, JCFG, jnp.asarray(imgs),
        classifier_params={k: jnp.asarray(v) for k, v in cparams.items()},
        classifier_cfg=cfg)
    with torch.no_grad():
        ours = tcommon.determine_flips(model, torch.from_numpy(imgs),
                                       classifier=cls_model(cfg, cparams))
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    flips = np.asarray(ref[1]).ravel()
    assert 0 < flips.sum() < len(flips)


def _splat_inputs(seed, n=2, p=300):
    rng = np.random.RandomState(seed)
    imgs = ar_images(seed, n)
    pts = (rng.rand(n, p, 2) * (S + 8) - 4).astype(np.float32)
    colors = rng.uniform(-1, 1, (n, p, 3)).astype(np.float32)
    alphas = rng.uniform(0.3, 1, (n, p, 1)).astype(np.float32)
    return imgs, pts, colors, alphas


@pytest.mark.parametrize("blend_alg", ["alpha", "laplacian",
                                       "laplacian_light"])
def test_splat_points_matches_jax(blend_alg):
    imgs, pts, colors, alphas = _splat_inputs(5)
    ref = jvis.splat_points(jnp.asarray(imgs), jnp.asarray(pts), sigma=1.2,
                            opacity=0.8, colors=jnp.asarray(colors),
                            alpha_channel=jnp.asarray(alphas),
                            blend_alg=blend_alg)
    before = dict(LAUNCHES)
    ours = tvis.splat_points(torch.from_numpy(imgs), torch.from_numpy(pts),
                             sigma=1.2, opacity=0.8,
                             colors=torch.from_numpy(colors),
                             alpha_channel=torch.from_numpy(alphas),
                             blend_alg=blend_alg)
    assert LAUNCHES == before
    _close(ours, ref, SPLAT_TOL)


def test_splat_points_colorscale_and_sigmas_match_jax():
    """Colors from a colorscale, per-image sigmas, (N, K, P, 2) points."""
    imgs, pts, _, _ = _splat_inputs(6, p=40)
    pts4 = pts.reshape(2, 2, 20, 2)
    sig = np.array([0.8, 1.6], np.float32)
    ref = jvis.splat_points(jnp.asarray(imgs), jnp.asarray(pts4),
                            sigma=jnp.asarray(sig), opacity=1.0,
                            colorscale=["plasma", "viridis"])
    ours = tvis.splat_points(torch.from_numpy(imgs), torch.from_numpy(pts4),
                             sigma=torch.from_numpy(sig), opacity=1.0,
                             colorscale=["plasma", "viridis"])
    _close(ours, ref, SPLAT_TOL)


@pytest.mark.parametrize("config", sorted(tlap.BLEND_CONFIGS))
def test_laplacian_blend_matches_jax(config):
    rng = np.random.RandomState(7)
    a, b = (rng.randn(2, 3, S, S).astype(np.float32) for _ in range(2))
    m = rng.rand(2, 1, S, S).astype(np.float32)
    ref = jlap.laplacian_blend(*map(jnp.asarray, (a, b, m)),
                               **jlap.BLEND_CONFIGS[config])
    _close(tlap.laplacian_blend(*map(torch.from_numpy, (a, b, m)),
                                **tlap.BLEND_CONFIGS[config]), ref,
           BLEND_TOL)


def test_extend_object_border_matches_jax():
    rng = np.random.RandomState(8)
    img = rng.randn(1, 3, 32, 32).astype(np.float32)
    mask = np.zeros((1, 1, 32, 32), np.float32)
    mask[..., 10:20, 12:18] = 1
    ref = jlap.extend_object_border(jnp.asarray(img * mask),
                                    jnp.asarray(mask), max_pixel_radius=6)
    _close(tlap.extend_object_border(torch.from_numpy(img * mask),
                                     torch.from_numpy(mask),
                                     max_pixel_radius=6), ref, BLEND_TOL)
    np.testing.assert_array_equal(tlap.gaussian_kernel_1d(11, 0),
                                  jlap.gaussian_kernel_1d(11, 0))


@pytest.mark.parametrize("resolution", [None, 32])
@pytest.mark.parametrize("load_colors", [True, False])
def test_load_dense_label_matches_jax(tmp_path, resolution, load_colors):
    path = label_png(tmp_path / "label.png")
    ref = jvis.load_dense_label(path, resolution=resolution,
                                load_colors=load_colors)
    ours = tvis.load_dense_label(path, resolution=resolution,
                                 load_colors=load_colors)
    for o, r in zip(ours, ref):
        if r is None:
            assert o is None
        else:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_vis_helpers_match_jax(tmp_path):
    imgs = ar_images(9, 5)
    for kw in (dict(), dict(normalize=True, range=(-1, 1)),
               dict(normalize=True), dict(nrow=2, padding=1, pad_value=-1.0)):
        np.testing.assert_array_equal(tvis.images2grid(imgs, **kw),
                                      jvis.images2grid(imgs, **kw))
    np.testing.assert_array_equal(tvis.get_colors(7, "plasma").numpy(),
                                  np.asarray(jvis.get_colors(7, "plasma")))
    assert [tvis.get_colorscale(k) for k in (None, 0, 1, 7)] == \
        [jvis.get_colorscale(k) for k in (None, 0, 1, 7)]
    tvis.save_image(imgs, str(tmp_path / "grid.png"), normalize=True,
                    range=(-1, 1))
    ours = tvis.load_pil(str(tmp_path / "grid.png"), resolution=32)
    _close(ours, jvis.load_pil(str(tmp_path / "grid.png"), resolution=32), 0)


def test_composed_propagate_object_matches_jax(jparams, model):
    """A congealed-space object onto two targets: its points uncongealed,
    the invisible ones dropped, object and mask splatted."""
    imgs = ar_images(10, 2)
    rng = np.random.RandomState(11)
    pts = rng.uniform(-1.05, 1.05, (2, 120, 2)).astype(np.float32)
    vals = rng.uniform(-1, 1, (2, 120, 3)).astype(np.float32)
    masks = rng.uniform(0.5, 1, (2, 120, 1)).astype(np.float32)
    sigma = np.array([1.2, 1.5], np.float32)
    ref = jstn.composed_propagate_object(
        jparams, JCFG, *map(jnp.asarray, (pts, vals, masks, imgs, sigma)),
        max_sigma=1.5)
    with torch.no_grad():
        ours = tstn.composed_propagate_object(
            model, *map(torch.from_numpy, (pts, vals, masks, imgs, sigma)),
            max_sigma=1.5)
    for o, r in zip(ours, ref):
        _close(o, r, SPLAT_TOL)
    # a one-head model takes no classifier's advice, as in the JAX package
    with torch.no_grad():
        again = tstn.composed_propagate_object(
            model, *map(torch.from_numpy, (pts, vals, masks, imgs, sigma)),
            classifier=object(), cluster=0, max_sigma=1.5)
    for o, r in zip(again, ours):
        assert torch.equal(o, r)
